"""Nearest-neighbour data association (Scene_nn equivalent,
pcd_scene.h:48-137; PyTorch port of ``pose_refine_tpu/scene/nn.py``).

The scene is built on the host from a depth image or a cloud (numpy, as in
the reference and the JAX package): points + LINEMOD normals, an optional
voxel downsample, and the kd-tree reorder, whose point order makes
consecutive 128-point chunks spatially tight. The device holds the packed
result table and the flash-NN tables. A query is exact NN by the gated
flash kernel (``backend="bruteforce"``, the JAX package's choice on an
accelerator) or the full scan (``backend="flash"``), then one row gather;
a neighbour is accepted iff dist^2 < max_dist_diff^2 (pcd_scene.h:127).

The kd traversal (``backend="kdtree"``) is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.ops.normals import _OFFSETS
from pose_refine_tpu_torch.scene import nn_flash
from pose_refine_tpu_torch.scene.kdtree import build_kdtree

BACKENDS = ("bruteforce", "flash")


@dataclasses.dataclass(frozen=True)
class SceneNN:
    """NN scene. Build with :func:`SceneNN.from_depth` or
    :func:`SceneNN.from_cloud`."""

    points: torch.Tensor       # (P, 3) float32, kd-reordered
    normals: torch.Tensor      # (P, 3) float32
    table: torch.Tensor        # (P, 8) float32 [pcd xyz, normal xyz, 0, 0]: one-gather lookup
    flash_table: torch.Tensor  # (8, P_pad) field-major [x, y, z, |s|^2, 0...]
    flash_boxes: torch.Tensor  # (P_pad/128, 8) per-chunk boxes (gated kernel pruning)
    flash_balls: torch.Tensor  # (4, P_pad/32) bounding balls (gated kernel pass 1)
    max_dist_diff: float       # the gate in meters, a host float: no sync per query
    backend: str = "bruteforce"

    @classmethod
    def from_cloud(cls, points, normals, max_dist_diff: float = 0.1,
                   leaf_size: int = 10, backend: str = "bruteforce",
                   device: DeviceLike = None) -> "SceneNN":
        """Build from (P, 3) points and normals (meters): kd reorder on the
        host, tables uploaded to ``device``. The default backend is the
        gated flash kernel; the JAX package defaults to the kd traversal,
        which is not ported yet (ROADMAP A9)."""
        if backend == "kdtree":
            raise NotImplementedError(
                "SceneNN backend 'kdtree' (the kd traversal) is not ported to "
                "pose_refine_tpu_torch yet (ROADMAP A9); use 'bruteforce' or 'flash'"
            )
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown SceneNN backend {backend!r}; use 'bruteforce' or 'flash'"
            )
        dev = resolve_device(device)
        tree = build_kdtree(np.asarray(points), np.asarray(normals), leaf_size)
        pts_np = tree.points
        packed = np.concatenate(
            [pts_np, tree.normals, np.zeros((len(pts_np), 2), np.float32)], axis=1
        )
        flash_table = nn_flash.pack_scene(pts_np).to(dev)
        return cls(
            points=torch.as_tensor(pts_np, device=dev),
            normals=torch.as_tensor(tree.normals, device=dev),
            table=torch.as_tensor(packed, device=dev),
            flash_table=flash_table,
            flash_boxes=nn_flash.chunk_boxes(flash_table),
            flash_balls=nn_flash.ball_table(flash_table),
            max_dist_diff=float(max_dist_diff),
            backend=backend,
        )

    @classmethod
    def from_depth(cls, depth, K, max_dist_diff: float = 0.1, leaf_size: int = 10,
                   backend: str = "bruteforce", voxel_mm: float = 0.0,
                   device: DeviceLike = None) -> "SceneNN":
        """init_Scene_nn_cpu equivalent (pcd_scene.cpp:4-37): valid pixels
        of an (H, W) mm depth image -> points + LINEMOD normals -> kd-tree,
        on the host. voxel_mm > 0 voxel-downsamples the cloud first
        (centroid point + renormalized mean normal per voxel)."""
        if isinstance(depth, torch.Tensor):
            depth = depth.cpu().numpy()
        pts, nrm, mask = _depth_scene_arrays_host(depth, K)
        m = mask.reshape(-1)
        p = pts.reshape(-1, 3)[m]
        n = nrm.reshape(-1, 3)[m]
        if voxel_mm > 0.0:
            p, n = voxel_downsample(p, n, voxel_mm / 1000.0)
        return cls.from_cloud(p, n, max_dist_diff, leaf_size, backend, device=device)

    def to(self, device) -> "SceneNN":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(dev) for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})

    def query(self, src: torch.Tensor, plain: bool = False):
        """(..., 3) source points -> (dst (..., 3), normal (..., 3), valid
        (...)). plain=True runs the kernels' plain versions on any device
        (the reference a kernel path is held against)."""
        if self.backend == "flash":
            fn = nn_flash.nn_flash_packed_plain if plain else nn_flash.nn_flash_packed
            idx, dist_sq = fn(src, self.flash_table)
        elif plain:
            idx, dist_sq = nn_flash.nn_flash_gated_plain(src, self.flash_table,
                                                         self.max_dist_diff)
        else:
            idx, dist_sq = nn_flash.nn_flash_gated(src, self.flash_table, self.flash_boxes,
                                                   self.flash_balls, self.max_dist_diff)
        valid = dist_sq < nn_flash.gate_sq(self.max_dist_diff)
        rows = gather_rows(self.table, idx)
        return rows[..., 0:3], rows[..., 3:6], valid


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with idx clamped into [0, P) first. The flash kernels
    return indices into the padded flash table, and the gated kernel's
    guard value IBIG - 1 is out of range of any table: gathered unclamped,
    the JAX package's jnp.take reads NaN rows there, and a CUDA gather a
    device-side assert. A clamped row is finite, and its query is invalid
    under the gate."""
    flat = idx.reshape(-1).clamp(0, table.shape[0] - 1)
    return torch.index_select(table, 0, flat).reshape(*idx.shape, table.shape[1])


def _depth_scene_arrays_host(depth, K, radius: int = 5,
                             difference_threshold: int = 50,
                             distance_threshold: int = 2000):
    """(H, W) mm depth -> (point image (H, W, 3) m, LINEMOD normals
    (H, W, 3), mask (H, W)) in numpy, with the arithmetic of
    ops/normals.py and ops/depth_to_cloud.py (int stencil accumulators,
    f32 products)."""
    d = np.asarray(depth).astype(np.int32)
    h, w = d.shape
    Kf = np.asarray(K, np.float32)
    r = radius
    pad = np.pad(d, r)

    a0 = np.zeros((h, w), np.int32)
    a1 = np.zeros((h, w), np.int32)
    a3 = np.zeros((h, w), np.int32)
    b0 = np.zeros((h, w), np.int32)
    b1 = np.zeros((h, w), np.int32)
    for ox, oy in _OFFSETS:
        dx, dy = ox * r, oy * r
        neighbor = pad[r + dy: r + dy + h, r + dx: r + dx + w]
        delta = neighbor - d
        f = (np.abs(delta) < difference_threshold).astype(np.int32)
        a0 += f * (dx * dx)
        a1 += f * (dx * dy)
        a3 += f * (dy * dy)
        b0 += f * dx * delta
        b1 += f * dy * delta
    det = a0 * a3 - a1 * a1
    ddx = a3 * b0 - a1 * b1
    ddy = -a1 * b0 + a0 * b1
    nx = Kf[0, 0] * ddx.astype(np.float32)
    ny = Kf[1, 1] * ddy.astype(np.float32)
    nz = -det.astype(np.float32) * d.astype(np.float32)
    norm = np.sqrt(nx * nx + ny * ny + nz * nz)
    row = np.arange(h)[:, None]
    col = np.arange(w)[None, :]
    interior = (row >= r) & (row < h - r - 1) & (col >= r) & (col < w - r - 1)
    ok = (d < distance_threshold) & (norm > 0) & interior
    inv = np.where(ok, np.float32(1.0) / np.where(norm > 0, norm, np.float32(1.0)),
                   np.float32(0.0)).astype(np.float32)
    nrm = np.stack([nx * inv, ny * inv, nz * inv], axis=-1)

    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    z = (d.astype(np.float32) / np.float32(1000.0))
    x = (u - Kf[0, 2]) / Kf[0, 0] * z
    y = (v - Kf[1, 2]) / Kf[1, 1] * z
    mask = d > 0
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    pts = np.where(mask[..., None], pts, np.float32(0.0))
    return pts, nrm.astype(np.float32), mask


def voxel_downsample(points, normals, voxel_m: float):
    """Centroid-average points (and renormalize mean normals) per uniform
    voxel of edge ``voxel_m`` meters. Host-side numpy, like the rest of the
    scene build."""
    p = np.asarray(points, np.float64)
    n = np.asarray(normals, np.float64)
    if p.shape[0] == 0:
        return p.astype(np.float32), n.astype(np.float32)
    lo = p.min(axis=0)
    cell = np.floor((p - lo) / float(voxel_m)).astype(np.int64)
    if cell.max() >= (1 << 21):  # 21 bits per axis in the packed key below
        raise ValueError(
            f"cloud spans {cell.max() + 1} voxels on one axis (> 2^21): "
            f"voxel {voxel_m} m is too small for this extent/unit"
        )
    key = (cell[:, 0] << 42) | (cell[:, 1] << 21) | cell[:, 2]
    uniq, inverse = np.unique(key, return_inverse=True)
    cnt = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    ps = np.zeros((len(uniq), 3))
    ns = np.zeros((len(uniq), 3))
    np.add.at(ps, inverse, p)
    np.add.at(ns, inverse, n)
    ps /= cnt[:, None]
    norm = np.linalg.norm(ns, axis=1, keepdims=True)
    ns = np.where(norm > 1e-12, ns / np.maximum(norm, 1e-12), ns)
    return ps.astype(np.float32), ns.astype(np.float32)
