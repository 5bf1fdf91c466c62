"""A plain depth renderer with the reference renderer's semantics
(renderer.cu:83-187): screen x = x/z W/2 + W/2 in the flipped-y frame,
barycentric coverage with every weight in [0, 1], perspective depth
(a+b+g) / (a/z0 + b/z1 + g/z2), int32 mm = trunc(depth + 0.5), empty = 0,
the ROI cropped while rendering, no back-face culling.

Each triangle is tested at the pixels of its clamped box, a block of
``window`` x ``window`` pixels from the box's first pixel, and the nearest
depth of each pixel is kept by a scatter-min. ``window`` is the largest
box's extent, so every pixel of every box is tested. The camera transform
is one matrix product, so it runs in TF32 under ``geometry.tf32()``.
"""

from __future__ import annotations

import torch

from reference.geometry import mm

INT32_MAX = 2 ** 31 - 1


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """C's int(): truncation toward zero; NaN and out-of-range values
    saturate as a float->int32 convert does."""
    t = torch.trunc(x)
    bad = torch.isnan(t) | (t < -2.0 ** 31) | (t >= 2.0 ** 31)
    out = torch.where(bad, torch.zeros_like(t), t).to(torch.int32)
    return torch.where(t >= 2.0 ** 31, torch.full_like(out, INT32_MAX), out)


def screen(tris: torch.Tensor, poses: torch.Tensor, proj: torch.Tensor,
           width: int, height: int):
    """((N, T, 3, 2) screen xy in the flipped-y frame, (N, T, 3) camera z)
    of (T, 3, 3) model triangles under (N, 4, 4) model->camera poses."""
    t = tris.shape[0]
    vh = torch.cat([tris.reshape(-1, 3), torch.ones_like(tris.reshape(-1, 3)[:, :1])], 1)
    cam = mm(poses[:, :3, :], vh.T)  # (N, 3, 3T)
    x, y, z = cam[:, 0], cam[:, 1], cam[:, 2]
    px = (proj[0, 0] * x + proj[0, 1] * y + proj[0, 2] * z + proj[0, 3]) / z
    py = (proj[1, 0] * x + proj[1, 1] * y + proj[1, 2] * z + proj[1, 3]) / z
    sx = px * (width / 2.0) + width / 2.0
    sy = py * (height / 2.0) + height / 2.0
    n = poses.shape[0]
    return torch.stack([sx, sy], -1).reshape(n, t, 3, 2), z.reshape(n, t, 3)


def _clamp(width: int, height: int, roi):
    """The pixel clamp of the ROI in the flipped-y frame (renderer.cu:103-113)."""
    x, y, w, h = roi
    if w > 0 and h > 0:
        return ((float(x), float(height - 1 - (y + h - 1))),
                (float(x + w - 1), float(height - 1 - y)))
    return (0.0, 0.0), (float(width - 1), float(height - 1))


def _boxes(pts2, width, height, roi):
    lo, hi = _clamp(width, height, roi)
    bbmin = torch.maximum(pts2.amin(-2), torch.tensor(lo, device=pts2.device))
    bbmax = torch.minimum(pts2.amax(-2), torch.tensor(hi, device=pts2.device))
    return bbmin, bbmax


def _depths(p2, zc, px, py):
    """int32 mm depth of each triangle at pixel (px, py), INT32_MAX where
    the pixel is not covered (renderer.h:315-317, renderer.cu:126-144)."""
    ax, ay, bx, by = p2[..., 0, 0], p2[..., 0, 1], p2[..., 1, 0], p2[..., 1, 1]
    cx, cy = p2[..., 2, 0], p2[..., 2, 1]
    inv = 1.0 / (0.5 * ((cx - ax) * (by - ay) - (bx - ax) * (cy - ay)))
    beta = 0.5 * ((cx - ax) * (py - ay) - (px - ax) * (cy - ay)) * inv
    gamma = 0.5 * ((px - ax) * (by - ay) - (bx - ax) * (py - ay)) * inv
    alpha = 1.0 - beta - gamma
    inside = ((alpha >= 0) & (beta >= 0) & (gamma >= 0)
              & (alpha <= 1) & (beta <= 1) & (gamma <= 1))
    frag = (alpha + beta + gamma) / (alpha / zc[..., 0] + beta / zc[..., 1] + gamma / zc[..., 2])
    d = _trunc_int(frag + 0.5)
    return torch.where(inside, d, torch.full_like(d, INT32_MAX))


def render(tris, poses, width: int, height: int, proj, roi=(0, 0, 0, 0),
           budget: int = 1 << 26):
    """(N, out_h, out_w) int32 mm renders of (T, 3, 3) triangles at (N, 4,
    4) poses, out = the ROI (x, y, w, h) or the whole frame; and (N,) int64
    counts of the (triangle, pixel) pairs a triangle covers inside the ROI
    (the raster's work). ``budget`` caps the pairs tested at once."""
    dev = poses.device
    tris = torch.as_tensor(tris, dtype=torch.float32, device=dev)
    proj = torch.as_tensor(proj, dtype=torch.float32, device=dev)
    rx, ry, rw, rh = roi
    out_w, out_h = (rw, rh) if rw > 0 and rh > 0 else (width, height)
    n, t = poses.shape[0], tris.shape[0]
    pts2, zcam = screen(tris, poses, proj, width, height)
    bbmin, bbmax = _boxes(pts2, width, height, roi)
    x0, y0 = torch.trunc(bbmin[..., 0] + 0.5), torch.trunc(bbmin[..., 1] + 0.5)
    ext = torch.maximum(torch.floor(bbmax[..., 0]) - x0, torch.floor(bbmax[..., 1]) - y0) + 1
    window = max(1, int(ext.max()))
    d = torch.arange(window, dtype=torch.float32, device=dev)
    sink = out_w * out_h
    fb = torch.full((n, sink + 1), INT32_MAX, dtype=torch.int32, device=dev)
    covered = torch.zeros(n, dtype=torch.int64, device=dev)
    step = max(1, budget // max(1, n * window * window))
    for s in range(0, t, step):
        p2, zc = pts2[:, s:s + step, None, None], zcam[:, s:s + step, None, None]
        hi = bbmax[:, s:s + step]
        px = x0[:, s:s + step, None, None] + d[None, None, None, :]
        py = y0[:, s:s + step, None, None] + d[None, None, :, None]
        dep = _depths(p2, zc, px, py)
        keep = (px <= hi[..., 0, None, None]) & (py <= hi[..., 1, None, None]) & (dep != INT32_MAX)
        rows = (height - 1 - ry - py).to(torch.int64)
        cols = (px - rx).to(torch.int64)
        keep &= (rows >= 0) & (rows < out_h) & (cols >= 0) & (cols < out_w)
        covered += keep.reshape(n, -1).sum(1)
        lin = torch.where(keep, rows * out_w + cols, sink).reshape(n, -1)
        fb.scatter_reduce_(1, lin, dep.reshape(n, -1), "amin")
    fb = fb[:, :sink]
    fb = torch.where(fb == INT32_MAX, torch.zeros_like(fb), fb)
    return fb.reshape(n, out_h, out_w), covered
