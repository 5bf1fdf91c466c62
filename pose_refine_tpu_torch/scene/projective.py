"""Projective data association: look the source point up in the scene depth
image via the camera intrinsics (PyTorch port of
``pose_refine_tpu/scene/projective.py``).

The scene is one packed (H*W, 8) float32 table of
[point xyz | normal xyz | 0 0] rows, so the per-point query is a single row
gather (depth_scene.h:7-49), the kernel of ``ops/gather.py`` on a card.
"""

from __future__ import annotations

import dataclasses

import torch

from pose_refine_tpu_torch import geometry
from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.ops.depth_to_cloud import depth_image_to_points
from pose_refine_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from pose_refine_tpu_torch.ops.normals import estimate_normals


def _build_projective_table(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Points + normals of an (H, W) depth image as the packed (H*W, 8)
    table."""
    pts, _mask = depth_image_to_points(depth, K)
    nrm = estimate_normals(depth, K)
    h, w = pts.shape[:2]
    pad = torch.zeros((h * w, 2), dtype=torch.float32, device=pts.device)
    return torch.cat([pts.reshape(-1, 3), nrm.reshape(-1, 3), pad], dim=1)


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


def _project_gate(table, K, max_dist_diff, h: int, w: int, src, base: int = 0,
                  gather=gather_rows):
    """The projective query core (depth_scene.h:29-48): pcd2dep rounding
    (truncation toward zero), pixel bounds check, one packed row gather at
    the clipped pixel (offset by ``base`` rows for stacked tables), scene
    z > 0 and |dz| <= gate."""
    xyd = geometry.pcd2dep(src, K)
    x, y = xyd[..., 0], xyd[..., 1]
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    lin = y.clamp(0, h - 1).to(torch.int64) * w + x.clamp(0, w - 1).to(torch.int64)
    rows = gather(table, base + lin)
    dst = rows[..., 0:3]
    nrm = rows[..., 3:6]
    valid = inb & (dst[..., 2] > 0) & ((src[..., 2] - dst[..., 2]).abs() <= max_dist_diff)
    return dst, nrm, valid
