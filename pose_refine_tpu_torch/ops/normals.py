"""LINEMOD-style surface-normal estimation from a depth image (PyTorch port
of ``pose_refine_tpu/ops/normals.py``).

A stencil form of the reference's per-pixel bilateral-weighted plane fit
(scene/common.cpp:17-107): 8 neighbors at radius r=5, inlier gate
|d_neighbor - d| < 50 mm, center gate d < 2000 mm, 2x2 least-squares solve
per pixel, normal = normalize(fx*ddx, fy*ddy, -det*d). Integer
accumulators fit int32 (|A| <= 8*r^2, |b| <= 8*r*threshold); the one
product that can exceed int32 (det*d) is formed in float32, as the
reference casts to float there.
"""

from __future__ import annotations

import torch

_OFFSETS = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def estimate_normals(depth, K, radius: int = 5, difference_threshold: int = 50,
                     distance_threshold: int = 2000) -> torch.Tensor:
    """(..., H, W) int depth (mm) + K -> (..., H, W, 3) float32 normals; 0
    where invalid (a leading batch of frames shares K).

    Matches get_normal (common.cpp:17-107) including its quirks: the center
    gate is d < distance_threshold (zero-depth pixels are NOT excluded, the
    reference's `l_d > 0` check is commented out), and the valid interior
    is rows/cols [r, dim - r - 2] (its loops stop at dim - r - 1, exclusive).
    """
    depth = torch.as_tensor(depth).to(torch.int32)
    h, w = depth.shape[-2:]
    dev = depth.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    r = radius

    # zero padding; only the interior is kept
    pad = torch.nn.functional.pad(depth, (r, r, r, r))

    a0 = torch.zeros(depth.shape, dtype=torch.int32, device=dev)
    a1 = torch.zeros_like(a0)
    a3 = torch.zeros_like(a0)
    b0 = torch.zeros_like(a0)
    b1 = torch.zeros_like(a0)
    for ox, oy in _OFFSETS:
        dx, dy = ox * r, oy * r
        neighbor = pad[..., r + dy : r + dy + h, r + dx : r + dx + w]
        delta = neighbor - depth
        f = (delta.abs() < difference_threshold).to(torch.int32)
        a0 = a0 + f * (dx * dx)
        a1 = a1 + f * (dx * dy)
        a3 = a3 + f * (dy * dy)
        b0 = b0 + f * dx * delta
        b1 = b1 + f * dy * delta

    det = a0 * a3 - a1 * a1
    ddx = a3 * b0 - a1 * b1
    ddy = -a1 * b0 + a0 * b1

    nx = K[0, 0] * ddx.to(torch.float32)
    ny = K[1, 1] * ddy.to(torch.float32)
    nz = -det.to(torch.float32) * depth.to(torch.float32)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)

    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    interior = (row >= r) & (row < h - r - 1) & (col >= r) & (col < w - r - 1)
    ok = (depth < distance_threshold) & (norm > 0) & interior

    inv = torch.where(ok, 1.0 / torch.where(norm > 0, norm, torch.ones_like(norm)),
                      torch.zeros_like(norm))
    return torch.stack([nx * inv, ny * inv, nz * inv], dim=-1)
