"""Production batch depth rasterizer: the hand-written CUDA kernel
``csrc/rasterize.cu``, its wrapper, and its plain PyTorch version.

Replaces ``pose_refine_tpu/ops/rasterize_pallas.py::rasterize_pallas``.
On a card one render is two launches of ``csrc/rasterize.cu`` (block
union boxes, then one CTA per screen tile that recomputes its triangles'
setup in registers and writes its tile once; see the note in the source),
from the mesh table and the poses straight to the int32 framebuffer. The plain version is the JAX package's ``_triangle_setup`` in
plain torch (``triangle_setup``: a (N, 16, T) coefficient table) and a dense
evaluation of every (triangle, pixel) pair (``raster_coef_plain``); the
kernel performs the same rounded operations, so the two agree bit for bit.

Per-pose meshes: ``tris`` may be (T, 3, 3) shared, (N, T, 3, 3) one per
pose, or an :class:`IndexedTris` (an (M, T, 3, 3) table and an (N,) row per
pose), which the kernel reads in place of a gathered per-pose copy.

Dispatch: ``rasterize`` uses the plain version for CPU tensors and the
kernel for CUDA tensors. There is no fallback from the kernel to the plain
version; a kernel that does not build or launch raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pose_refine_tpu_torch._build import launch, load_kernels
from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.ops.rasterize import (
    ROI,
    _clamp_bounds,
    roi_shape,
    screen_fields,
)

BIG = 3.0e38            # "no depth" sentinel, above any real 1/denom
_INT_LIM = 2147483520.0  # largest float32 below 2**31: depths clamp here

# renders launched by raster_cuda (chip_smoke.py resets and reads it to
# show the main path went through the kernel)
launches = 0


class IndexedTris(NamedTuple):
    """Per-pose meshes by reference: pose i renders ``table[ids[i]]``.

    table (M, T, 3, 3) float32, ids (N,) int32 on the same device. The
    kernel reads the table in place (ids clamped into it); the plain
    version gathers the (N, T, 3, 3) copy."""

    table: torch.Tensor
    ids: torch.Tensor

    def gathered(self) -> torch.Tensor:
        """The (N, T, 3, 3) per-pose copy, ids clamped as the kernel clamps
        them."""
        rows = self.ids.to(torch.int64).clamp(0, self.table.shape[0] - 1)
        return self.table.index_select(0, rows)


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


def _check_render(table, ids, poses, proj):
    """The kernel's input checks: raise on what it does not take."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"raster_cuda needs CUDA tensors, got {dev}")
    named = dict(table=table, poses=poses, proj=proj)
    if ids is not None:
        named["ids"] = ids
    for name, x in named.items():
        want = torch.int32 if name == "ids" else torch.float32
        if x.device != dev or x.dtype != want:
            raise ValueError(f"{name} must be {want} on {dev}, got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dim() != 4 or tuple(table.shape[2:]) != (3, 3):
        raise ValueError(f"table must be (M, T, 3, 3), got {tuple(table.shape)}")
    if poses.dim() != 3 or tuple(poses.shape[1:]) != (4, 4) or tuple(proj.shape) != (4, 4):
        raise ValueError(f"poses must be (N, 4, 4) and proj (4, 4), got "
                         f"{tuple(poses.shape)}, {tuple(proj.shape)}")
    m, n = table.shape[0], poses.shape[0]
    if ids is None and m not in (1, n):
        raise ValueError(f"a table of {m} meshes for {n} poses needs ids")
    if ids is not None and tuple(ids.shape) != (n,):
        raise ValueError(f"ids must be ({n},), got {tuple(ids.shape)}")


def _launch(entry: str, out: torch.Tensor, table, ids, poses, proj, width, height, roi,
            *extra):
    """Call the C entry ``entry`` of csrc/rasterize.cu on the current stream
    with the render's arguments, ``out`` and ``extra``; raise on a CUDA
    error."""
    out_w, out_h = roi_shape(width, height, roi)
    m, t = table.shape[:2]
    launch(load_kernels()[0], entry, table.device,
           (table.data_ptr(), None if ids is None else ids.data_ptr(), m, t, poses.data_ptr(),
            poses.shape[0], proj.data_ptr(), width, height, int(roi[0]), int(roi[1]), out_w,
            out_h, out.data_ptr(), *extra), entry)


def raster_cuda(table: torch.Tensor, ids, poses: torch.Tensor, proj: torch.Tensor,
                width: int, height: int, roi: ROI = (0, 0, 0, 0)) -> torch.Tensor:
    """Launch csrc/rasterize.cu: pose i of ``poses`` (N, 4, 4) renders the
    mesh ``table[ids[i]]`` of table (M, T, 3, 3) (``ids`` None: the one mesh,
    M = 1, or mesh i, M = N), on the current stream, without synchronising.
    Two launches; counts one render in ``launches``. Returns (N, out_h,
    out_w) int32 mm, 0 = empty."""
    global launches
    _check_render(table, ids, poses, proj)
    out_w, out_h = roi_shape(width, height, roi)
    m, t = table.shape[:2]
    n = poses.shape[0]
    tiles = -(-out_w // 32) * -(-out_h // 32)
    if max(m * t, n * tiles, n * -(-t // 256), out_h * out_w) >= 2 ** 31:
        raise ValueError(f"render too large for int32 sizes: {n} poses, {m} x {t} tris")
    fb = torch.empty((n, out_h, out_w), dtype=torch.int32, device=table.device)
    # the block and superblock boxes: 4 floats a 32 and a 256 triangles
    scratch = torch.empty(max(4 * n * (-(-t // 32) + -(-t // 256)), 4), dtype=torch.float32,
                          device=table.device)
    _launch("prt_rasterize", fb, table, ids, poses, proj, width, height, roi, scratch.data_ptr())
    launches += 1
    return fb


def triangle_setup_cuda(table: torch.Tensor, ids, poses: torch.Tensor, proj: torch.Tensor,
                        width: int, height: int, roi: ROI = (0, 0, 0, 0)) -> torch.Tensor:
    """The setup the kernel computes in registers, written out as
    :func:`triangle_setup` lays it out, (N, 16, T): for tests, which compare
    it field by field. Not on any render path; counts no launch."""
    _check_render(table, ids, poses, proj)
    coef = torch.empty((poses.shape[0], 16, table.shape[1]), dtype=torch.float32,
                       device=table.device)
    _launch("prt_raster_setup", coef, table, ids, poses, proj, width, height, roi)
    return coef


def _inputs(tris, poses, proj, device: DeviceLike):
    if device is None and isinstance(poses, torch.Tensor):
        dev = poses.device
    else:
        dev = resolve_device(device)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    proj = torch.as_tensor(proj, dtype=torch.float32, device=dev)
    if isinstance(tris, IndexedTris):
        tris = IndexedTris(torch.as_tensor(tris.table, dtype=torch.float32, device=dev),
                           torch.as_tensor(tris.ids, dtype=torch.int32, device=dev))
    else:
        tris = torch.as_tensor(tris, dtype=torch.float32, device=dev)
    return tris, poses, proj


def _plain(tris, poses, proj, width, height, roi):
    out_w, out_h = roi_shape(width, height, roi)
    if isinstance(tris, IndexedTris):
        tris = tris.gathered()
    coef = triangle_setup(tris, poses, proj, width, height, roi)
    return raster_coef_plain(coef, out_w, out_h, height, roi)


def rasterize(tris, poses, width: int, height: int, proj,
              roi: ROI = (0, 0, 0, 0), device: DeviceLike = None) -> torch.Tensor:
    """Render N poses -> (N, out_h, out_w) int32 depth mm, 0 = empty.

    tris (T, 3, 3) shared, (N, T, 3, 3) per pose, or an IndexedTris; poses
    (N, 4, 4), proj (4, 4). ``device`` defaults to the poses tensor's
    device (or device.resolve_device(None) for host arrays). CUDA: the
    kernel; CPU: the plain version."""
    tris, poses, proj = _inputs(tris, poses, proj, device)
    if poses.device.type == "cpu":
        return _plain(tris, poses, proj, width, height, roi)
    if isinstance(tris, IndexedTris):
        table, ids = tris
    else:
        table, ids = (tris[None] if tris.dim() == 3 else tris), None
    return raster_cuda(table.contiguous(), ids if ids is None else ids.contiguous(),
                       poses.contiguous(), proj.contiguous(), width, height, roi)


def rasterize_plain(tris, poses, width: int, height: int, proj,
                    roi: ROI = (0, 0, 0, 0), device: DeviceLike = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`rasterize` on any device - the
    reference the kernel is held against."""
    tris, poses, proj = _inputs(tris, poses, proj, device)
    return _plain(tris, poses, proj, width, height, roi)
