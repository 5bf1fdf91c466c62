"""Batch triangle depth rasterization: the screen transform and the dense
reference path (PyTorch port of ``pose_refine_tpu/ops/rasterize.py``).

Semantics are the reference renderer's (renderer.cu:83-187), as in the JAX
package:

  * screen mapping: x/w_clip * W/2 + W/2 with w_clip = camera z
    (renderer.cu:91-98, proj last row [0,0,1,0])
  * barycentric coverage with alpha,beta,gamma in [0, 1] (renderer.cu:126-129)
  * perspective depth frag = (a+b+g) / (a/z0 + b/z1 + g/z2) (renderer.cu:138-139)
  * int32 mm depth = trunc(frag + 0.5); empty pixels = 0 via INT_MAX init
    (renderer.cu:144, renderer.cu:71-80)
  * ROI crop-while-rendering with flipped-y clamps (renderer.cu:107-113)
  * back-face culling disabled, matching renderer.cu:175

``rasterize_dense`` is the exact O(T*H*W) oracle the tests hold the
production path (``ops/rasterize_cuda.py``) against.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pose_refine_tpu_torch.geometry import _trunc_int

INT32_MAX = 2 ** 31 - 1

ROI = Tuple[int, int, int, int]  # (x, y, width, height), 0-size = full frame


def roi_shape(width: int, height: int, roi: ROI) -> Tuple[int, int]:
    """Output (out_w, out_h) for a render, honoring 0-size = full frame."""
    x, y, w, h = roi
    if w > 0 and h > 0:
        if x + w > width or y + h > height:  # user input: never assert
            raise ValueError(f"roi {roi} exceeds the {width}x{height} image")
        return w, h
    return width, height


def screen_fields(tris, poses, proj, width: int, height: int):
    """Screen-space triangle fields for every pose: nine (N, T) float32
    tensors (ax, ay, bx, by, cx, cy, z0, z1, z2).

    tris is (T, 3, 3) shared by all poses or (N, T, 3, 3) per pose (each
    hypothesis may rasterize a different mesh); poses (N, 4, 4)
    model->camera; proj (4, 4) from geometry.compute_proj. Each 3-term
    contraction is a chain of multiply-adds (``addcmul``) in the order
    XLA's CPU dot emits them, which reproduces the JAX package's
    Precision.HIGHEST einsums bit for bit on the CPU.
    """
    poses = torch.as_tensor(poses, dtype=torch.float32)
    tris = torch.as_tensor(tris, dtype=torch.float32, device=poses.device)
    proj = torch.as_tensor(proj, dtype=torch.float32, device=poses.device)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    half_w, half_h = width / 2.0, height / 2.0
    per_pose = tris.dim() == 4

    def dot3(a0, a1, a2, x0, x1, x2):  # (a0*x0 + a1*x1) + a2*x2, fused
        return torch.addcmul(torch.addcmul(a0 * x0, a1, x1), a2, x2)

    out = []
    for v in range(3):
        tv = tris[:, :, v, :] if per_pose else tris[None, :, v, :]  # (N|1, T, 3)
        X, Y, Z = tv[..., 0], tv[..., 1], tv[..., 2]
        cam = [
            dot3(R[:, i, 0:1], R[:, i, 1:2], R[:, i, 2:3], X, Y, Z) + t[:, i : i + 1]
            for i in range(3)
        ]  # 3 x (N, T)
        px = dot3(proj[0, 0], proj[0, 1], proj[0, 2], *cam) + proj[0, 3]
        py = dot3(proj[1, 0], proj[1, 1], proj[1, 2], *cam) + proj[1, 3]
        z = cam[2]
        out.append((px / z * half_w + half_w, py / z * half_h + half_h, z))
    (ax, ay, z0), (bx, by, z1), (cx, cy, z2) = out
    return ax, ay, bx, by, cx, cy, z0, z1, z2


def screen_triangles(tris, poses, proj, width: int, height: int):
    """screen_fields stacked per vertex: pts2 (N, T, 3, 2) screen xy and
    zcam (N, T, 3) camera z (the w_clip)."""
    ax, ay, bx, by, cx, cy, z0, z1, z2 = screen_fields(tris, poses, proj, width, height)
    pts2 = torch.stack(
        [torch.stack([ax, ay], -1), torch.stack([bx, by], -1), torch.stack([cx, cy], -1)],
        dim=-2,
    )
    return pts2, torch.stack([z0, z1, z2], dim=-1)


def _clamp_bounds(width: int, height: int, roi: ROI):
    """Pixel clamp window in the flipped-y P coordinate space
    (renderer.cu:103-113)."""
    x, y, w, h = roi
    if w > 0 and h > 0:
        cmin = (float(x), float(height - 1 - (y + h - 1)))
        cmax = (float(x + w - 1), float(height - 1 - y))
    else:
        cmin = (0.0, 0.0)
        cmax = (float(width - 1), float(height - 1))
    return cmin, cmax


def triangle_bbox(pts2, width: int, height: int, roi: ROI = (0, 0, 0, 0)):
    """Clamped per-triangle screen bbox, reference clamp semantics
    (renderer.cu:100-121). Returns (bbmin, bbmax) float32 (..., 2)."""
    cmin, cmax = _clamp_bounds(width, height, roi)
    vmin = pts2.amin(dim=-2)
    vmax = pts2.amax(dim=-2)
    bbmin = torch.maximum(vmin, torch.tensor(cmin, dtype=torch.float32, device=pts2.device))
    bbmax = torch.minimum(vmax, torch.tensor(cmax, dtype=torch.float32, device=pts2.device))
    return bbmin, bbmax


def fragment_depths(pts2, zcam, px, py):
    """Coverage + int32-mm depth for triangles x pixel positions.

    pts2 (..., 3, 2) and zcam (..., 3) broadcast against pixel coordinates
    px, py (...,) in the flipped-y P space. Returns int32 depths with
    INT32_MAX where the pixel is not covered.
    """
    ax, ay = pts2[..., 0, 0], pts2[..., 0, 1]
    bx, by = pts2[..., 1, 0], pts2[..., 1, 1]
    cx, cy = pts2[..., 2, 0], pts2[..., 2, 1]
    # signed areas (renderer.h:315-317): area(A,B,C) = .5*((C-A)x(B-A))
    area = 0.5 * ((cx - ax) * (by - ay) - (bx - ax) * (cy - ay))
    base_inv = 1.0 / area
    beta = 0.5 * ((cx - ax) * (py - ay) - (px - ax) * (cy - ay)) * base_inv
    gamma = 0.5 * ((px - ax) * (by - ay) - (bx - ax) * (py - ay)) * base_inv
    alpha = 1.0 - beta - gamma

    inside = (
        (alpha >= 0.0) & (beta >= 0.0) & (gamma >= 0.0)
        & (alpha <= 1.0) & (beta <= 1.0) & (gamma <= 1.0)
    )
    z0, z1, z2 = zcam[..., 0], zcam[..., 1], zcam[..., 2]
    denom = alpha / z0 + beta / z1 + gamma / z2
    frag = (alpha + beta + gamma) / denom
    depth = _trunc_int(frag + 0.5)
    return torch.where(inside, depth, torch.full_like(depth, INT32_MAX))


def _bbox_pixel_mask(bbmin, bbmax, px, py):
    """Reference pixel-loop membership: P in [trunc(bbmin+.5), bbmax]
    (renderer.cu:124-125)."""
    x0 = torch.trunc(bbmin[..., 0] + 0.5)
    y0 = torch.trunc(bbmin[..., 1] + 0.5)
    return (px >= x0) & (px <= bbmax[..., 0]) & (py >= y0) & (py <= bbmax[..., 1])


def finalize_depth(fb: torch.Tensor) -> torch.Tensor:
    """INT_MAX (= empty) -> 0, as renderer.cu:71-80."""
    return torch.where(fb == INT32_MAX, torch.zeros_like(fb), fb)


def rasterize_dense(tris, poses, width: int, height: int, proj,
                    roi: ROI = (0, 0, 0, 0), tri_chunk: int = 64):
    """Exact gather formulation: every pixel tests every triangle.

    O(T * H * W) work - the correctness oracle for the production path.
    Returns (N, out_h, out_w) int32 mm, 0 = empty.
    """
    out_w, out_h = roi_shape(width, height, roi)
    pts2, zcam = screen_triangles(tris, poses, proj, width, height)
    n, t = zcam.shape[:2]
    dev = zcam.device
    # flipped-y P coordinates of each output pixel, row-major (renderer.cu:141-142)
    col = torch.arange(out_w, dtype=torch.float32, device=dev) + roi[0]
    row = (height - 1 - roi[1]) - torch.arange(out_h, dtype=torch.float32, device=dev)
    px = col[None, :].expand(out_h, out_w).reshape(-1)
    py = row[:, None].expand(out_h, out_w).reshape(-1)
    fb = torch.full((n, out_h * out_w), INT32_MAX, dtype=torch.int32, device=dev)
    for s in range(0, t, tri_chunk):
        p2 = pts2[:, s : s + tri_chunk, None]  # (N, C, 1, 3, 2)
        zc = zcam[:, s : s + tri_chunk, None]  # (N, C, 1, 3)
        bbmin, bbmax = triangle_bbox(p2, width, height, roi)
        d = fragment_depths(p2, zc, px, py)  # (N, C, P)
        m = _bbox_pixel_mask(bbmin, bbmax, px, py)
        d = torch.where(m, d, torch.full_like(d, INT32_MAX))
        fb = torch.minimum(fb, d.amin(dim=1))
    return finalize_depth(fb).reshape(n, out_h, out_w)


def rasterize_scatter(tris, poses, width: int, height: int, proj,
                      roi: ROI = (0, 0, 0, 0), window: int = 32, tri_chunk: int = 1024):
    """Per-triangle window x window pixel block + a scatter-min (JAX
    ops/rasterize.py:263-318; ``scatter_reduce`` "amin" here). Exact when
    every clamped triangle box fits in ``window`` pixels on both axes (check
    with ``max_bbox_extent``). Plain PyTorch on any device; O(T * window^2)
    work a pose. Returns (N, out_h, out_w) int32 mm, 0 = empty."""
    out_w, out_h = roi_shape(width, height, roi)
    rx, ry = roi[0], roi[1]
    pts2, zcam = screen_triangles(tris, poses, proj, width, height)
    n, t = zcam.shape[:2]
    dev = zcam.device
    dxy = torch.arange(window, dtype=torch.float32, device=dev)
    sink = out_h * out_w  # one slot past the frame takes every non-write
    fb = torch.full((n, sink + 1), INT32_MAX, dtype=torch.int32, device=dev)
    for s in range(0, t, tri_chunk):
        p2 = pts2[:, s:s + tri_chunk]  # (N, C, 3, 2)
        zc = zcam[:, s:s + tri_chunk]  # (N, C, 3)
        bbmin, bbmax = triangle_bbox(p2, width, height, roi)
        x0 = torch.trunc(bbmin[..., 0] + 0.5)
        y0 = torch.trunc(bbmin[..., 1] + 0.5)
        px = (x0[..., None, None] + dxy[None, :]).expand(*x0.shape, window, window)
        py = (y0[..., None, None] + dxy[:, None]).expand(*y0.shape, window, window)
        d = fragment_depths(p2[:, :, None, None], zc[:, :, None, None], px, py)
        m = (px <= bbmax[..., 0, None, None]) & (py <= bbmax[..., 1, None, None])
        d = torch.where(m, d, torch.full_like(d, INT32_MAX))
        rows = (height - 1 - ry - py).to(torch.int64)
        cols = (px - rx).to(torch.int64)
        keep = (d != INT32_MAX) & (rows >= 0) & (rows < out_h) & (cols >= 0) & (cols < out_w)
        lin = torch.where(keep, rows * out_w + cols, sink)
        fb.scatter_reduce_(1, lin.reshape(n, -1), d.reshape(n, -1), "amin")
    return finalize_depth(fb[:, :sink]).reshape(n, out_h, out_w)


def max_bbox_extent(tris, poses, width: int, height: int, proj, roi: ROI = (0, 0, 0, 0)) -> int:
    """The largest clamped triangle-box extent in pixels over all poses: the
    least ``window`` that keeps rasterize_scatter exact (JAX
    ops/rasterize.py:321-328)."""
    pts2, _ = screen_triangles(tris, poses, proj, width, height)
    bbmin, bbmax = triangle_bbox(pts2, width, height, roi)
    x0 = torch.trunc(bbmin + 0.5)
    ext = (torch.floor(bbmax) - x0 + 1.0).clamp(min=0.0)
    return int(ext.max())


def render(tris, poses, width: int, height: int, proj, roi: ROI = (0, 0, 0, 0),
           backend=None, device=None, **kwargs) -> torch.Tensor:
    """Render N poses -> (N, out_h, out_w) int32 depth mm, 0 = empty (JAX
    ops/rasterize.py:331-372). ``backend``: None or "pallas" - the
    production rasterizer, ops.rasterize_cuda.rasterize (the raster kernel
    on a card, its plain version on the CPU); "dense" or "scatter" - the
    plain rasterizers above. ``device`` as for rasterize. JAX's fallback
    from a failing kernel to the scatter path is not ported: a kernel that
    fails raises."""
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC

    if backend in (None, "pallas"):
        return RC.rasterize(tris, poses, width, height, proj, roi=roi, device=device, **kwargs)
    if backend not in ("dense", "scatter"):
        raise ValueError(f"unknown rasterize backend {backend!r}")
    tris, poses, proj = RC._inputs(tris, poses, proj, device)
    if isinstance(tris, RC.IndexedTris):
        tris = tris.gathered()
    fn = rasterize_dense if backend == "dense" else rasterize_scatter
    return fn(tris, poses, width, height, proj, roi, **kwargs)
