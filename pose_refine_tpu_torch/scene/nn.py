"""Nearest-neighbour data association (Scene_nn equivalent,
pcd_scene.h:48-137; PyTorch port of ``pose_refine_tpu/scene/nn.py``).

``from_depth`` / ``from_cloud`` build the scene on the host (numpy, as in
the reference and the JAX package): points + LINEMOD normals, an optional
voxel downsample, and the kd-tree reorder, whose point order makes
consecutive 128-point chunks spatially tight. ``from_depth_device`` builds
it on the device for the tracking path: the strided or pooled pixel grid in
Morton order. The device holds the packed result table and the flash-NN
tables. A query is exact NN by the gated flash kernel
(``backend="bruteforce"``, the JAX package's choice on an accelerator) or
the full scan (``backend="flash"``), then one row gather (``ops/gather.py``);
a neighbour is accepted iff dist^2 < max_dist_diff^2 (pcd_scene.h:127).
``reduce`` / ``reduce_at`` are a whole ICP pass: the same NN kernel, then
the row lookup and the normal-equation sums fused in the kernel of
``ops/icp_reduce.py``.

``SceneNNStack`` stacks K frames into one set of tables; its query windows
the gated kernel to each pose's frame. The kd traversal
(``backend="kdtree"``) is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.ops.depth_to_cloud import depth_image_to_points
from pose_refine_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from pose_refine_tpu_torch.ops.icp_reduce import assoc_reduce_indexed_cuda, unpack_sums
from pose_refine_tpu_torch.ops.normals import _OFFSETS, estimate_normals
from pose_refine_tpu_torch.scene import nn_flash
from pose_refine_tpu_torch.scene.kdtree import build_kdtree

BACKENDS = ("bruteforce", "flash")
# from_depth_device's pooling keeps a block's pixels within this depth (m)
# of its nearest valid pixel (JAX nn.py's pool_depth_tol default)
POOL_DEPTH_TOL_M = 0.005


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
        [(p, n)] = _host_clouds([depth], K, voxel_mm)
        return cls.from_cloud(p, n, max_dist_diff, leaf_size, backend, device=device)

    @classmethod
    def from_depth_device(cls, depth, K, max_dist_diff: float = 0.1, stride: int = 1,
                          perm=None, pool: int = 1) -> "SceneNN":
        """The NN scene built wholly on ``depth``'s device, with no host
        synchronisation (JAX nn.py:146-255): the tracking path rebuilds it
        every frame. No compaction and no kd tree: LINEMOD normals at full
        resolution, then the strided (``stride``) or centroid-pooled
        (``pool``, see _pool_scene_grid) pixel grid is the scene, in the
        Morton order ``perm`` of that grid (``_grid_morton_perm``; pass it
        as a device tensor, cached per grid shape, or it is uploaded here).

        Invalid pixels are parked at their 128-row chunk's first valid
        point and normal, which keeps chunk boxes tight around the real
        geometry and is exact (a parked row that wins a tie returns its
        anchor's row data); a chunk with no valid pixel parks at 1e6 m,
        where it never wins and its box always prunes. For every query whose
        nearest valid pixel lies in the gate the result equals the
        host-built scene of the same points. K: (3, 3) float32 on the
        device."""
        if stride > 1 and pool > 1:
            raise ValueError("stride and pool are alternative downsamplers; set only one > 1")
        depth = torch.as_tensor(depth)
        dev = depth.device
        nrm = estimate_normals(depth, K)  # full-resolution stencil
        pts, mask = depth_image_to_points(depth, K)
        if stride != 1:
            pts, nrm, mask = (x[::stride, ::stride] for x in (pts, nrm, mask))
        if pool > 1:
            pts, nrm, mask = _pool_scene_grid(pts, nrm, mask, int(pool), POOL_DEPTH_TOL_M)
        h, w = mask.shape
        if perm is None:
            perm = torch.as_tensor(_grid_morton_perm(h, w), device=dev)
        p = pts.reshape(-1, 3)[perm]
        n = nrm.reshape(-1, 3)[perm]
        m = mask.reshape(-1)[perm]

        chunk = nn_flash.S_CHUNK
        nr = p.shape[0]
        pad = (-nr) % chunk
        if pad:
            p = torch.cat([p, p.new_zeros((pad, 3))])
            n = torch.cat([n, n.new_zeros((pad, 3))])
            m = torch.cat([m, m.new_zeros((pad,))])
        mc = m.reshape(-1, chunk)
        pc = p.reshape(-1, chunk, 3)
        nc = n.reshape(-1, chunk, 3)
        first = mc.to(torch.int8).argmax(dim=1)[:, None, None].expand(-1, 1, 3)
        has_valid = mc.any(dim=1)[:, None, None]
        park_p = torch.where(has_valid, torch.gather(pc, 1, first), 1.0e6)
        park_n = torch.where(has_valid, torch.gather(nc, 1, first), 0.0)
        p_tab = torch.where(mc[..., None], pc, park_p).reshape(-1, 3)[:nr]
        n_tab = torch.where(mc[..., None], nc, park_n).reshape(-1, 3)[:nr]
        flash_table = nn_flash.pack_scene(p_tab)
        return cls(
            points=p_tab,
            normals=n_tab,
            table=torch.cat([p_tab, n_tab, p_tab.new_zeros((nr, 2))], dim=1),
            flash_table=flash_table,
            flash_boxes=nn_flash.chunk_boxes(flash_table),
            flash_balls=nn_flash.ball_table(flash_table),
            max_dist_diff=float(max_dist_diff),
            backend="bruteforce",
        )

    def to(self, device) -> "SceneNN":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(dev) for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})

    def _nearest(self, src: torch.Tensor, plain: bool = False):
        """(idx, dist_sq) of the scene's exact nearest neighbour of (..., 3)
        points: the gated kernel, or the full scan (backend "flash")."""
        if self.backend == "flash":
            fn = nn_flash.nn_flash_packed_plain if plain else nn_flash.nn_flash_packed
            return fn(src, self.flash_table)
        if plain:
            return nn_flash.nn_flash_gated_plain(src, self.flash_table, self.max_dist_diff)
        return nn_flash.nn_flash_gated(src, self.flash_table, self.flash_boxes,
                                       self.flash_balls, self.max_dist_diff)

    def query(self, src: torch.Tensor, plain: bool = False):
        """(..., 3) source points -> (dst (..., 3), normal (..., 3), valid
        (...)). plain=True runs the kernels' plain versions on any device
        (the reference a kernel path is held against)."""
        idx, dist_sq = self._nearest(src, plain)
        return _rows_in_gate(self.table, idx, dist_sq, self.max_dist_diff, plain)

    def reduce(self, cloud: torch.Tensor, valid: torch.Tensor):
        """One ICP pass against this scene: (..., P, 3) CUDA clouds and
        (..., P) valid -> (AtA, Atb, count, mse_sum). The NN kernel's (idx,
        dist_sq) feed the kernel of ops/icp_reduce.py, which looks the rows
        up and reduces them without writing them out. Raises for CPU
        tensors; its plain version is ``ops.icp_reduce.assoc_reduce_plain``
        over ``query(plain=True)``."""
        return unpack_sums(assoc_reduce_indexed_cuda(
            cloud, valid, self.table, *self._nearest(cloud),
            nn_flash.gate_sq(self.max_dist_diff)))


def _rows_in_gate(table, idx, dist_sq, max_dist_diff: float, plain: bool):
    """The NN query's second half: (dst, normal, valid) from the flash
    kernels' (idx, dist_sq). The index is clamped into the table before the
    gather: the flash kernels return indices into the padded flash table,
    and the gated kernel's guard value IBIG - 1 lies past any table (the JAX
    package's jnp.take reads NaN rows there). A clamped row is finite, and
    its query is invalid under the gate."""
    valid = dist_sq < nn_flash.gate_sq(max_dist_diff)
    rows = (gather_rows_plain if plain else gather_rows)(table, idx)
    return rows[..., 0:3], rows[..., 3:6], valid


def _host_clouds(depths, K, voxel_mm: float):
    """(points, normals) of the valid pixels of each (H, W) mm frame of
    ``depths``, voxel-downsampled when voxel_mm > 0 (the host pipeline of
    SceneNN.from_depth)."""
    out = []
    for d in depths:
        pts, nrm, mask = _depth_scene_arrays_host(d, K)
        m = mask.reshape(-1)
        p, n = pts.reshape(-1, 3)[m], nrm.reshape(-1, 3)[m]
        if voxel_mm > 0.0:
            p, n = voxel_downsample(p, n, voxel_mm / 1000.0)
        out.append((p, n))
    return out


@dataclasses.dataclass(frozen=True)
class SceneNNStack:
    """K NN scene frames in one set of tables, addressed per pose by a scene
    id (JAX nn.py:309-452): the NN twin of SceneProjectiveStack.

    Every frame is kd-reordered as its own SceneNN would be, then padded to
    the widest frame's S_CHUNK multiple (``frame_rows``), so the flash
    table is K equal-width regions side by side and the gated kernel
    windows its ball pass, box test and chunk scan to a pose's frame: a pose
    costs one frame's scan, and its neighbour is the one the frame's own
    scene gives, ties included. Both backends take the gated kernel, as the
    JAX package's stack does on an accelerator (the kd traversal binds
    per-scene trees)."""

    table: torch.Tensor        # (K*rows, 8) [pcd xyz, normal xyz, 0, 0]; pad rows zero
    points: torch.Tensor       # (K*rows, 3) pad rows parked at 1e6 m
    flash_table: torch.Tensor  # (8, K*rows) per-frame pack_scene tables, side by side
    flash_boxes: torch.Tensor  # (K*rows/128, 8) per-frame chunk boxes, frame-major
    flash_balls: torch.Tensor  # (4, K*rows/32) per-frame bounding balls, frame-major
    max_dist_diff: float       # the gate in meters, a host float
    frame_rows: int = 0
    n_scenes: int = 1
    backend: str = "bruteforce"

    @classmethod
    def from_clouds(cls, clouds, normals, max_dist_diff: float = 0.1, leaf_size: int = 10,
                    backend: str = "bruteforce", device: DeviceLike = None) -> "SceneNNStack":
        """Build from K (points, normals) pairs (lists of (P_k, 3) arrays in
        meters): kd reorder per frame on the host, tables uploaded to
        ``device``."""
        if backend not in BACKENDS:
            raise ValueError(
                f"SceneNNStack supports the 'bruteforce'/'flash' backends, not {backend!r} "
                "(the kd traversal binds per-scene trees)")
        if len(clouds) != len(normals) or not len(clouds):
            raise ValueError("from_clouds wants equal-length non-empty lists")
        dev = resolve_device(device)
        ordered = []
        for p, n in zip(clouds, normals):
            tree = build_kdtree(np.asarray(p), np.asarray(n), leaf_size)
            ordered.append((tree.points, tree.normals))
        rows = max(len(p) for p, _ in ordered)
        rows += (-rows) % nn_flash.S_CHUNK
        packed, far = [], []
        for p, n in ordered:
            pad = rows - len(p)
            packed.append(np.concatenate([
                np.concatenate([p, n, np.zeros((len(p), 2), np.float32)], 1),
                np.zeros((pad, 8), np.float32)], 0))
            far.append(np.concatenate([p, np.full((pad, 3), 1.0e6, np.float32)], 0))
        flash_table = torch.cat([nn_flash.pack_scene(p, rows=rows) for p, _ in ordered],
                                dim=1).to(dev)
        return cls(
            table=torch.as_tensor(np.concatenate(packed), device=dev),
            points=torch.as_tensor(np.concatenate(far), device=dev),
            flash_table=flash_table,
            # rows is a chunk multiple, so the boxes and balls of the stacked
            # table are the per-frame ones, frame-major
            flash_boxes=nn_flash.chunk_boxes(flash_table),
            flash_balls=nn_flash.ball_table(flash_table),
            max_dist_diff=float(max_dist_diff),
            frame_rows=int(rows),
            n_scenes=len(ordered),
            backend=backend,
        )

    @classmethod
    def from_depths(cls, depths, K, max_dist_diff: float = 0.1, leaf_size: int = 10,
                    backend: str = "bruteforce", voxel_mm: float = 0.0,
                    device: DeviceLike = None) -> "SceneNNStack":
        """Build from (K, H, W) mm depth frames: SceneNN.from_depth's host
        pipeline per frame (points, LINEMOD normals, optional voxel
        downsample), stacked."""
        if isinstance(depths, torch.Tensor):
            depths = depths.cpu().numpy()
        frames = np.asarray(depths)
        if frames.ndim != 3 or frames.shape[0] < 1:
            raise ValueError(f"from_depths wants (K, H, W) frames, got {frames.shape}")
        clouds = _host_clouds(frames, K, voxel_mm)
        if any(not len(p) for p, _ in clouds):
            raise ValueError("a scene frame has no valid depth pixels - cannot stack an empty "
                             "NN scene")
        return cls.from_clouds([p for p, _ in clouds], [n for _, n in clouds], max_dist_diff,
                               leaf_size, backend, device=device)

    def query_at(self, sids, plain: bool = False):
        """The query bound to per-pose scene ids: ``sids`` a scalar or an
        (N,) integer tensor (one id per pose of (N, ..., 3) sources),
        clamped to [0, n_scenes) on its device, never read back (JAX
        nn.py:416-452). All poses go to the gated kernel in one launch.
        Returns query(src) -> (dst, normal, valid); plain=True runs the
        kernels' plain versions."""
        sids = self._frame_ids(sids)

        def query(src):
            idx, dist_sq = self._nearest_at(sids, src, plain)
            return _rows_in_gate(self.table, idx, dist_sq, self.max_dist_diff, plain)

        return query

    def _frame_ids(self, sids) -> torch.Tensor:
        """``sids`` on the table's device, clamped to [0, n_scenes), int32."""
        sids = torch.as_tensor(sids, device=self.table.device)
        return sids.clamp(0, self.n_scenes - 1).to(torch.int32)

    def _nearest_at(self, sids, src, plain: bool = False):
        """(idx, dist_sq) of each pose's nearest neighbour within its frame
        (``sids`` (N,) int32, already clamped): one gated launch."""
        if plain:
            return nn_flash.nn_flash_gated_plain(
                src, self.flash_table, self.max_dist_diff, frame_id=sids, frames=self.n_scenes)
        return nn_flash.nn_flash_gated(
            src, self.flash_table, self.flash_boxes, self.flash_balls, self.max_dist_diff,
            frame_id=sids, frames=self.n_scenes)

    def reduce_at(self, sids):
        """``SceneNN.reduce`` bound to per-pose scene ids (see query_at):
        returns reduce(cloud (N, P, 3), valid (N, P)) -> (AtA, Atb, count,
        mse_sum); the stacked gated kernel's indices are rows of the stacked
        table, so the fused kernel needs no per-pose offset."""
        sids = self._frame_ids(sids)

        def reduce(cloud, valid):
            return unpack_sums(assoc_reduce_indexed_cuda(
                cloud, valid, self.table, *self._nearest_at(sids, cloud),
                nn_flash.gate_sq(self.max_dist_diff)))

        return reduce


def _pool_scene_grid(pts, nrm, mask, pool: int, depth_tol: float):
    """Depth-aware centroid pooling of a depth-grid scene over pool x pool
    pixel blocks, the on-device counterpart of voxel_downsample (JAX
    nn.py:466-513): only pixels within depth_tol (m) of their block's
    nearest valid pixel enter the block's centroid and renormalized mean
    normal, so a block across a depth edge keeps its foreground sheet
    instead of a ghost point between the surfaces. Returns the (H/pool,
    W/pool) point and normal grids and the mask of blocks with a point."""
    h, w = mask.shape
    ph, pw = (-h) % pool, (-w) % pool
    if ph or pw:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, pw, 0, ph))
        nrm = torch.nn.functional.pad(nrm, (0, 0, 0, pw, 0, ph))
        mask = torch.nn.functional.pad(mask, (0, pw, 0, ph))
    bh, bw = mask.shape[0] // pool, mask.shape[1] // pool

    def blocks(img):  # (H, W, ...) -> (H/pool, W/pool, ..., pool * pool)
        b = img.reshape(bh, pool, bw, pool, *img.shape[2:]).movedim((1, 3), (-2, -1))
        return b.reshape(*b.shape[:-2], pool * pool)

    z = torch.where(mask, pts[..., 2], torch.inf)
    zmin = blocks(z).amin(dim=-1)
    zmin_up = zmin.repeat_interleave(pool, 0).repeat_interleave(pool, 1)
    v = (mask & (pts[..., 2] <= zmin_up + depth_tol)).to(torch.float32)
    cnt = blocks(v).sum(dim=-1)
    pts_c = blocks(pts * v[..., None]).sum(dim=-1) / cnt.clamp(min=1.0)[..., None]
    n_sum = blocks(nrm * v[..., None]).sum(dim=-1)
    n_len = torch.linalg.vector_norm(n_sum, dim=-1, keepdim=True)
    return pts_c, n_sum / n_len.clamp(min=1e-12), cnt > 0.0


@functools.lru_cache(maxsize=64)
def _grid_morton_perm(h: int, w: int) -> np.ndarray:
    """Morton (Z-curve) permutation of the row-major (h, w) pixel grid, in
    numpy, once per grid shape (JAX nn.py:585-606): gathered by it, 128-row
    chunks of the grid cover compact pixel squares, the tight chunk boxes
    the gated kernel's pruning needs."""
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.uint32), np.arange(w, dtype=np.uint32), indexing="ij"
    )

    def spread(v):  # interleave 16 bits with 1-bit gaps
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    code = spread(xx) | (spread(yy) << np.uint32(1))
    return np.argsort(code.reshape(-1), kind="stable")


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
