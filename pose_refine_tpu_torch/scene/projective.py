"""Projective data association: look the source point up in the scene depth
image via the camera intrinsics (PyTorch port of
``pose_refine_tpu/scene/projective.py``).

The scene is one packed (H*W, 8) float32 table of
[point xyz | normal xyz | 0 0] rows, so the per-point query is a single row
gather (depth_scene.h:7-49), the kernel of ``ops/gather.py`` on a card.
``SceneProjectiveStack`` holds K same-shape frames in one (K*H*W, 8) table
and routes each pose to its frame by adding its frame's row offset to the
gather index. ``reduce`` / ``reduce_at`` are a whole ICP pass - this query
and the normal-equation sums - in the one kernel of ``ops/icp_reduce.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from pose_refine_tpu_torch import geometry
from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.ops.depth_to_cloud import depth_image_to_points
from pose_refine_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from pose_refine_tpu_torch.ops.icp_reduce import assoc_reduce_projective_cuda, unpack_sums
from pose_refine_tpu_torch.ops.normals import estimate_normals


def _build_projective_table(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Points + normals of an (H, W) depth image, or of a (K, H, W) stack
    of them, as the packed (H*W, 8) or (K*H*W, 8) table."""
    pts, _mask = depth_image_to_points(depth, K)
    nrm = estimate_normals(depth, K)
    pts, nrm = pts.reshape(-1, 3), nrm.reshape(-1, 3)
    pad = torch.zeros((pts.shape[0], 2), dtype=torch.float32, device=pts.device)
    return torch.cat([pts, nrm, pad], dim=1)


@dataclasses.dataclass(frozen=True)
class SceneProjective:
    """Scene = packed point+normal table + intrinsics.

    query semantics (depth_scene.h:29-48): project the source point with
    pcd2dep rounding, bounds-check the pixel, gate on scene z > 0 and
    |src.z - dst.z| <= max_dist_diff (0.1 m default, depth_scene.h:9).
    """

    table: torch.Tensor          # (H*W, 8) float32: [pcd xyz, normal xyz, 0, 0]
    K: torch.Tensor              # (3, 3) float32
    max_dist_diff: torch.Tensor  # () float32
    height: int = 480
    width: int = 640

    @classmethod
    def from_depth(cls, depth, K, max_dist_diff: float = 0.1,
                   device: DeviceLike = None) -> "SceneProjective":
        """Build from an (H, W) mm depth image: per-pixel dep2pcd + LINEMOD
        normals (init_Scene_projective_cpu behavior), on ``device``. A depth
        and K already on ``device`` are not copied, and the gate is filled
        on the device, so a build from device tensors never synchronises."""
        dev = resolve_device(device)
        depth = torch.as_tensor(depth, device=dev)
        h, w = depth.shape
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        return cls(
            table=_build_projective_table(depth, K),
            K=K,
            max_dist_diff=torch.full((), float(max_dist_diff), dtype=torch.float32, device=dev),
            height=int(h),
            width=int(w),
        )

    def to(self, device) -> "SceneProjective":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, table=self.table.to(dev), K=self.K.to(dev),
            max_dist_diff=self.max_dist_diff.to(dev),
        )

    @property
    def pcd(self) -> torch.Tensor:
        """(H, W, 3) point image view."""
        return self.table[:, 0:3].reshape(self.height, self.width, 3)

    @property
    def normal(self) -> torch.Tensor:
        """(H, W, 3) normal image view."""
        return self.table[:, 3:6].reshape(self.height, self.width, 3)

    def query(self, src: torch.Tensor, plain: bool = False):
        """(..., 3) source points -> (dst (..., 3), normal (..., 3), valid
        (...)). plain=True gathers with the kernel's plain version on any
        device (the reference a kernel path is held against)."""
        return _project_gate(
            self.table, self.K, self.max_dist_diff, self.height, self.width, src,
            gather=gather_rows_plain if plain else gather_rows,
        )

    def reduce(self, cloud: torch.Tensor, valid: torch.Tensor):
        """One ICP pass against this scene: (..., P, 3) CUDA clouds and
        (..., P) valid -> (AtA, Atb, count, mse_sum), the query and the
        reduction fused in the kernel of ops/icp_reduce.py (the rows are
        never written out). Raises for CPU tensors; its plain version is
        ``ops.icp_reduce.assoc_reduce_plain`` over ``query(plain=True)``."""
        return unpack_sums(assoc_reduce_projective_cuda(
            cloud, valid, self.table, self.K, self.max_dist_diff, self.height, self.width))


def _project_gate(table, K, max_dist_diff, h: int, w: int, src, base=0,
                  gather=gather_rows):
    """The projective query core (depth_scene.h:29-48): pcd2dep rounding
    (truncation toward zero), pixel bounds check, one packed row gather at
    the clipped pixel (offset by ``base`` rows for stacked tables: an int,
    or a tensor broadcast against the pixel index), scene z > 0 and |dz| <=
    gate."""
    xyd = geometry.pcd2dep(src, K)
    x, y = xyd[..., 0], xyd[..., 1]
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    lin = y.clamp(0, h - 1).to(torch.int64) * w + x.clamp(0, w - 1).to(torch.int64)
    rows = gather(table, base + lin)
    dst = rows[..., 0:3]
    nrm = rows[..., 3:6]
    valid = inb & (dst[..., 2] > 0) & ((src[..., 2] - dst[..., 2]).abs() <= max_dist_diff)
    return dst, nrm, valid


@dataclasses.dataclass(frozen=True)
class SceneProjectiveStack:
    """K same-shape projective scene frames in one flat (K*H*W, 8) table,
    addressed per pose by a scene id (JAX projective.py:117-196).

    The reference runs concurrent ICPs against different scene frames on
    one CUDA stream each (README.md:15); here one batch serves them all:
    each pose's row gather is offset by its frame's H*W rows, so a pose
    costs the same gather as against a single scene."""

    table: torch.Tensor          # (K*H*W, 8) float32: [pcd xyz, normal xyz, 0, 0]
    K: torch.Tensor              # (3, 3) float32 (one camera)
    max_dist_diff: torch.Tensor  # () float32
    height: int = 480
    width: int = 640
    n_scenes: int = 1

    @classmethod
    def from_depths(cls, depths, K, max_dist_diff: float = 0.1,
                    device: DeviceLike = None) -> "SceneProjectiveStack":
        """Build from (K, H, W) mm depth frames: the per-frame dep2pcd and
        LINEMOD normals of SceneProjective.from_depth, batched over the
        frames, on ``device``."""
        dev = resolve_device(device)
        depths = torch.as_tensor(depths, device=dev)
        if depths.dim() != 3:
            raise ValueError(f"from_depths wants (K, H, W) frames, got {tuple(depths.shape)}")
        k, h, w = depths.shape
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        return cls(
            table=_build_projective_table(depths, K),
            K=K,
            max_dist_diff=torch.full((), float(max_dist_diff), dtype=torch.float32, device=dev),
            height=int(h),
            width=int(w),
            n_scenes=int(k),
        )

    def lane(self, i: int) -> SceneProjective:
        """Frame ``i`` as a standalone SceneProjective (a view of its rows):
        the parity anchor, refine(scene_ids=ids) equals refining each pose
        against its lane."""
        hw = self.height * self.width
        return SceneProjective(table=self.table[i * hw:(i + 1) * hw], K=self.K,
                               max_dist_diff=self.max_dist_diff, height=self.height,
                               width=self.width)

    def _base(self, sids) -> torch.Tensor:
        """The row offset of each pose's frame: ``sids`` clamped to [0,
        n_scenes) on the table's device, times H*W, as int64."""
        sids = torch.as_tensor(sids, device=self.table.device)
        return sids.clamp(0, self.n_scenes - 1).to(torch.int64) * (self.height * self.width)

    def query_at(self, sids, plain: bool = False):
        """The query bound to per-pose scene ids: ``sids`` a scalar or an
        (N,) integer tensor (one id per pose of (N, ..., 3) sources),
        clamped to [0, n_scenes) on its device - ids on a card are checked
        by shape only and never read back, so an out-of-range id associates
        against the nearest frame (JAX projective.py:177-196). Returns
        query(src) -> (dst, normal, valid). plain=True gathers with the
        kernel's plain version."""
        base = self._base(sids)
        gather = gather_rows_plain if plain else gather_rows

        def query(src):
            b = base.reshape(base.shape + (1,) * (src.dim() - 1 - base.dim()))
            return _project_gate(self.table, self.K, self.max_dist_diff, self.height,
                                 self.width, src, base=b, gather=gather)

        return query

    def reduce_at(self, sids):
        """``SceneProjective.reduce`` bound to per-pose scene ids (see
        query_at): returns reduce(cloud (N, P, 3), valid (N, P)) -> (AtA,
        Atb, count, mse_sum). The kernel takes each pose's row offset; the
        ids never leave the card."""
        base = self._base(sids)

        def reduce(cloud, valid):
            return unpack_sums(assoc_reduce_projective_cuda(
                cloud, valid, self.table, self.K, self.max_dist_diff, self.height, self.width,
                base=base.expand(cloud.shape[:-2]) if base.dim() == 0 else base))

        return reduce
