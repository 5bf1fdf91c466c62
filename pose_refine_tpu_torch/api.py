"""User-facing renderer API (PyTorch port of ``pose_refine_tpu/api.py``),
mirroring the reference ``PoseRenderer`` (pose_renderer.h:9-32,
pose_renderer.cpp:3-76) with tensors instead of cv::Mat.

The reference computes its projection once from the full-resolution K and
re-uses it for down-sampled renders (pose_renderer.cpp:25-36) - NDC is
resolution-independent - and so does this one.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from pose_refine_tpu_torch import geometry
from pose_refine_tpu_torch.device import DeviceLike, resolve_device, to_device
from pose_refine_tpu_torch.mesh import Model, morton_order
from pose_refine_tpu_torch.ops import convert
from pose_refine_tpu_torch.ops import rasterize as rz


class PoseRenderer:
    """Batch depth / mask renderer for one model, on ``device`` (None: the
    card). ``backend`` None renders with the raster kernel on a card (its
    plain version on the CPU); "dense" and "scatter" take the plain
    rasterizers (ops.rasterize.render).

    Example:
        r = PoseRenderer("obj_06.ply", K=LINEMOD_K, width=640, height=480)
        depths = r.render_depth(poses)           # (N, H, W) uint16 mm
        masks  = r.render_mask(poses, down_sample=2)
    """

    def __init__(self, model: Union[str, Model], K=None, width: int = 640, height: int = 480,
                 backend: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = Model.load(model) if isinstance(model, str) else model
        # spatially coherent triangle order for the raster kernel's culling
        self.tris = torch.as_tensor(self.model.tris[morton_order(self.model.tris)],
                                    device=self.device)
        self.backend = backend
        self.K = None
        # the constructor's size is kept without K: it is the default of a
        # later set_K_width_height(K)
        self.width = int(width)
        self.height = int(height)
        self.proj_mat = None
        if K is not None:
            self.set_K_width_height(K, width, height)

    def set_K_width_height(self, K, width: Optional[int] = None, height: Optional[int] = None):
        self.K = np.asarray(K, np.float32)
        self.width = int(self.width if width is None else width)
        self.height = int(self.height if height is None else height)
        self.proj_mat = geometry.compute_proj(self.K, self.width, self.height,
                                              device=self.device)

    def _render_raw(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)) -> torch.Tensor:
        if self.proj_mat is None:  # usage error: must survive python -O
            raise RuntimeError("call set_K_width_height first")
        w = int(self.width / down_sample)
        h = int(self.height / down_sample)
        poses = to_device(poses, self.device, torch.float32)
        if poses.dim() == 2:
            poses = poses[None]
        return rz.render(self.tris, poses, w, h, self.proj_mat, roi=tuple(roi),
                         backend=self.backend)

    def render_depth(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)) -> torch.Tensor:
        """(N, 4, 4) poses -> (N, H, W) uint16 depth in mm."""
        return convert.raw_to_depth_u16(self._render_raw(poses, down_sample, roi))

    def render_mask(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)) -> torch.Tensor:
        """(N, 4, 4) poses -> (N, H, W) uint8 mask (255 = rendered)."""
        return convert.raw_to_mask_u8(self._render_raw(poses, down_sample, roi))

    def render_depth_mask(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)):
        """(N, 4, 4) poses -> (uint16 depth, uint8 mask), one render."""
        return convert.raw_to_depth_mask(self._render_raw(poses, down_sample, roi))

    @staticmethod
    def view_dep(dep) -> np.ndarray:
        """Depth -> false-color uint8 RGB for eyeballing (helper.h:126-136),
        on the host."""
        d = np.asarray(dep.cpu() if isinstance(dep, torch.Tensor) else dep, np.float64)
        lo, hi = d.min(), d.max()
        t = np.zeros_like(d) if hi == lo else (d - lo) / (hi - lo)
        # compact "hot" colormap: black -> red -> yellow -> white
        r = np.clip(3.0 * t, 0, 1)
        g = np.clip(3.0 * t - 1.0, 0, 1)
        b = np.clip(3.0 * t - 2.0, 0, 1)
        return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def get_bbox(depth) -> Tuple[int, int, int, int]:
    """(x, y, w, h) box of the nonzero depth of one (H, W) image
    (helper::get_bbox, helper.h:13-18), on the host."""
    d = np.asarray(depth.cpu() if isinstance(depth, torch.Tensor) else depth)
    ys, xs = np.nonzero(d > 0)
    if len(xs) == 0:
        return (0, 0, 0, 0)
    return (int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
            int(ys.max() - ys.min() + 1))
