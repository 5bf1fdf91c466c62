"""Production batch depth rasterizer: the hand-written CUDA kernel
``csrc/rasterize.cu``, its wrapper, and its plain PyTorch version.

Replaces ``pose_refine_tpu/ops/rasterize_pallas.py::rasterize_pallas``. The
per-(pose, triangle) setup - barycentric and 1/z coefficients that are
affine in the pixel, plus the clamped bbox - is the JAX package's
``_triangle_setup`` in plain torch; the kernel consumes that table with
one thread per (pose, triangle) and atomicMin (see the note in the .cu
source). The Pallas kernel's block/superblock unions and tile counts are
TPU culling and have no counterpart here.

Dispatch: ``rasterize`` uses the plain version for CPU tensors and the
kernel for CUDA tensors. There is no fallback from the kernel to the plain
version; a kernel that does not build or launch raises.
"""

from __future__ import annotations

import torch

from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.ops.rasterize import (
    ROI,
    _clamp_bounds,
    roi_shape,
    screen_fields,
)

BIG = 3.0e38            # "no depth" sentinel, above any real 1/denom
_INT_LIM = 2147483520.0  # largest float32 below 2**31: depths clamp here

# kernel launches by raster_coef_cuda (chip_smoke.py resets and reads it to
# show the main path went through the kernel)
launches = 0


def triangle_setup(tris, poses, proj, width: int, height: int, roi: ROI):
    """Per-(pose, triangle) affine coefficients + clamped bboxes:
    coef (N, 16, T) float32, contiguous.

      0..2:  beta  = kbx*px + kby*py + kb0
      3..5:  gamma = kgx*px + kgy*py + kg0
      6..8:  denom = ddx*px + ddy*py + dd0   (interpolated 1/z)
      9..12: x_start, y_start, x_max, y_max  (pixel-loop bounds,
             x_start = trunc(clamped_bbmin + 0.5), renderer.cu:124-125)
      13..15: zero

    Degenerate (zero-area or non-finite) triangles get an empty box
    (start BIG, max -BIG), so they never cover a pixel.
    """
    ax, ay, bx, by, cx, cy, z0, z1, z2 = screen_fields(tris, poses, proj, width, height)
    area2 = (cx - ax) * (by - ay) - (bx - ax) * (cy - ay)  # 2*signed area
    inv = 1.0 / area2

    kbx = -(cy - ay) * inv
    kby = (cx - ax) * inv
    kb0 = (ax * (cy - ay) - ay * (cx - ax)) * inv
    kgx = (by - ay) * inv
    kgy = -(bx - ax) * inv
    kg0 = (ay * (bx - ax) - ax * (by - ay)) * inv

    iz0, iz1, iz2 = 1.0 / z0, 1.0 / z1, 1.0 / z2
    diz1 = iz1 - iz0
    diz2 = iz2 - iz0
    ddx = kbx * diz1 + kgx * diz2
    ddy = kby * diz1 + kgy * diz2
    dd0 = kb0 * diz1 + kg0 * diz2 + iz0

    (cmin_x, cmin_y), (cmax_x, cmax_y) = _clamp_bounds(width, height, roi)
    bbmin_x = torch.minimum(torch.minimum(ax, bx), cx).clamp(min=cmin_x)
    bbmin_y = torch.minimum(torch.minimum(ay, by), cy).clamp(min=cmin_y)
    bbmax_x = torch.maximum(torch.maximum(ax, bx), cx).clamp(max=cmax_x)
    bbmax_y = torch.maximum(torch.maximum(ay, by), cy).clamp(max=cmax_y)
    x_start = torch.trunc(bbmin_x + 0.5)
    y_start = torch.trunc(bbmin_y + 0.5)

    bad = ~torch.isfinite(inv) | (area2 == 0.0)
    big = torch.full_like(x_start, BIG)
    x_start = torch.where(bad, big, x_start)
    y_start = torch.where(bad, big, y_start)
    x_max = torch.where(bad, -big, bbmax_x)
    y_max = torch.where(bad, -big, bbmax_y)

    zero = torch.zeros_like(kbx)
    coef = torch.stack(
        [kbx, kby, kb0, kgx, kgy, kg0, ddx, ddy, dd0,
         x_start, y_start, x_max, y_max, zero, zero, zero],
        dim=1,
    )  # (N, 16, T)
    return torch.nan_to_num(coef, nan=0.0, posinf=BIG, neginf=-BIG).contiguous()


def raster_coef_plain(coef: torch.Tensor, out_w: int, out_h: int, height: int,
                      roi: ROI) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a dense evaluation of the same
    coefficient arithmetic over every (triangle, pixel) pair, chunked over
    triangles so one chunk holds about 2**26 (pose, triangle, pixel)
    triples on a card and 2**22 on the CPU. Each product and sum is its
    own rounded op, as in the kernel. The minimum is taken over the float
    depths and rounded once per pixel, as the Pallas kernel does; the
    kernel rounds first and takes the minimum of the integers, which is the
    same number because trunc(d + 0.5) is monotone. Returns (N, out_h,
    out_w) int32 mm."""
    n, _, t = coef.shape
    pair_budget = 1 << 26 if coef.device.type == "cuda" else 1 << 22
    dev = coef.device
    # flipped-y P coordinates: px by column (1, W), py by row (H, 1); the
    # products with them are separable, the sums run over the full grid
    px = (torch.arange(out_w, dtype=torch.float32, device=dev) + roi[0])[None, :]
    py = ((height - 1 - roi[1]) - torch.arange(out_h, dtype=torch.float32, device=dev))[:, None]
    acc = torch.full((n, out_h, out_w), BIG, dtype=torch.float32, device=dev)
    chunk = max(1, pair_budget // max(n * out_h * out_w, 1))
    for s in range(0, t, chunk):
        c = coef[:, :, s : s + chunk, None, None]  # (N, 16, C, 1, 1)
        kbx, kby, kb0, kgx, kgy, kg0, ddx, ddy, dd0 = (c[:, i] for i in range(9))
        xs, ys, xm, ym = c[:, 9], c[:, 10], c[:, 11], c[:, 12]
        beta = kbx * px + kby * py + kb0  # (N, C, H, W)
        gamma = kgx * px + kgy * py + kg0
        alpha = 1.0 - beta - gamma
        denom = ddx * px + ddy * py + dd0
        d = torch.reciprocal(denom)
        cov = (
            (beta >= 0.0) & (gamma >= 0.0) & (alpha >= 0.0)
            & ((px >= xs) & (px <= xm)) & ((py >= ys) & (py <= ym))
            & (d < BIG)  # +inf / NaN depths never win
        )
        acc = torch.minimum(acc, torch.where(cov, d, BIG).amin(dim=1))
    hit = acc < BIG
    val = torch.trunc(acc.clamp(-_INT_LIM, _INT_LIM) + 0.5).to(torch.int32)
    return torch.where(hit, val, torch.zeros_like(val))


def raster_coef_cuda(coef: torch.Tensor, out_w: int, out_h: int, height: int,
                     roi: ROI) -> torch.Tensor:
    """Launch csrc/rasterize.cu on the coefficient table, on the current
    stream, without synchronising. Returns (N, out_h, out_w) int32 mm."""
    global launches
    if coef.device.type != "cuda":
        raise ValueError(f"raster_coef_cuda needs a CUDA tensor, got {coef.device}")
    if coef.dtype != torch.float32 or coef.dim() != 3 or coef.shape[1] != 16:
        raise ValueError(
            f"coef must be (N, 16, T) float32, got {tuple(coef.shape)} {coef.dtype}")
    if not coef.is_contiguous():
        raise ValueError("coef must be contiguous")
    n, _, t = coef.shape
    if max(n, t, out_h * out_w) >= 2 ** 31:
        raise ValueError(f"render too large for int32 sizes: {n} poses, {t} tris")
    from pose_refine_tpu_torch._build import load_kernels

    lib, _info = load_kernels()
    fb = torch.empty((n, out_h, out_w), dtype=torch.int32, device=coef.device)
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream(coef.device).cuda_stream
        err = lib.prt_rasterize(
            coef.data_ptr(), n, t, fb.data_ptr(), out_h, out_w, height,
            int(roi[0]), int(roi[1]), stream,
        )
    if err != 0:
        msg = lib.prt_error_string(err).decode()
        raise RuntimeError(f"rasterize kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return fb


def _inputs(tris, poses, proj, device: DeviceLike):
    if device is None and isinstance(poses, torch.Tensor):
        dev = poses.device
    else:
        dev = resolve_device(device)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    tris = torch.as_tensor(tris, dtype=torch.float32, device=dev)
    proj = torch.as_tensor(proj, dtype=torch.float32, device=dev)
    return tris, poses, proj


def rasterize(tris, poses, width: int, height: int, proj,
              roi: ROI = (0, 0, 0, 0), device: DeviceLike = None) -> torch.Tensor:
    """Render N poses -> (N, out_h, out_w) int32 depth mm, 0 = empty.

    tris (T, 3, 3) shared or (N, T, 3, 3) per pose, poses (N, 4, 4), proj
    (4, 4). ``device`` defaults to the poses tensor's device (or
    device.resolve_device(None) for host arrays). CUDA: the kernel; CPU:
    the plain version."""
    out_w, out_h = roi_shape(width, height, roi)
    tris, poses, proj = _inputs(tris, poses, proj, device)
    coef = triangle_setup(tris, poses, proj, width, height, roi)
    if coef.device.type == "cpu":
        return raster_coef_plain(coef, out_w, out_h, height, roi)
    return raster_coef_cuda(coef, out_w, out_h, height, roi)


def rasterize_plain(tris, poses, width: int, height: int, proj,
                    roi: ROI = (0, 0, 0, 0), device: DeviceLike = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`rasterize` on any device - the
    reference the kernel is held against."""
    out_w, out_h = roi_shape(width, height, roi)
    tris, poses, proj = _inputs(tris, poses, proj, device)
    coef = triangle_setup(tris, poses, proj, width, height, roi)
    return raster_coef_plain(coef, out_w, out_h, height, roi)
