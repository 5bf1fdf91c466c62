"""Depth image -> point cloud (PyTorch port of
``pose_refine_tpu/ops/depth_to_cloud.py``).

The canonical form is a dense point image + validity mask; the refine path
lifts each hypothesis render with ``window_cloud_batched`` (a crop around
the rendered object, strided) and keeps a fixed budget of points with
``compact_topk``, or, with ``lift="compact"``, keeps every valid pixel in
scan order with ``compact_points`` (the reference's exclusive-scan
compaction, icp.cpp:61-96). All reproduce the JAX functions' results
exactly: the same window, the same kept points in the same order.
``window_lift`` is the refine's whole window lift (crop, compaction,
Morton order), the plain version of the kernel L1 (``ops/lift_cuda.py``).
"""

from __future__ import annotations

import torch

# compact_topk's multiplicative hash: the low 31 bits of Knuth's 2654435761
_HASH_MUL = 2654435761 & 0x7FFFFFFF
# morton codes of a 14-bit (row, col) grid occupy bits 0..27; adding the
# cap keeps invalid-row keys above every valid one without int32 overflow
_MORTON_CODE_CAP = 1 << 28


def depth_image_to_points(depth, K, stride: int = 1, tl_x: int = 0, tl_y: int = 0):
    """(..., H, W) int depth in mm -> ((..., H/s, W/s, 3) float32 points in
    m, (..., H/s, W/s) bool mask). Point math matches dep2pcd
    (common.h:47-61): z = dep/1000, x = (u - cx)/fx * z, y = (v - cy)/fy *
    z; dep == 0 -> invalid."""
    depth = torch.as_tensor(depth)
    if stride != 1:
        depth = depth[..., ::stride, ::stride]
    h, w = depth.shape[-2:]
    K = torch.as_tensor(K, dtype=torch.float32, device=depth.device)
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :] * stride + tl_x
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None] * stride + tl_y
    z = depth.to(torch.float32) / 1000.0
    x = (u - K[0, 2]) / K[0, 0] * z
    y = (v - K[1, 2]) / K[1, 1] * z
    mask = depth > 0
    pts = torch.stack([x, y, z], dim=-1)
    pts = torch.where(mask[..., None], pts, torch.zeros_like(pts))
    return pts, mask


def compact_points(point_image, mask, max_points: int):
    """Compact the valid points of (..., H, W, 3) point images into a static
    (..., max_points, 3) buffer in scan order (JAX depth_to_cloud.py:47-65,
    the reference's exclusive scan, icp.cpp:61-96): a valid pixel's slot is
    the count of valid pixels before it (cumsum - 1); slots past the valid
    count stay zero and invalid; points past ``max_points`` are dropped.
    Plain PyTorch (a cumsum and a scatter) on any device: JAX computes it
    as XLA code, with no kernel of its own.

    Returns (points (..., max_points, 3), slot_valid (..., max_points),
    n_valid (...) - the true count, which may exceed max_points)."""
    point_image = torch.as_tensor(point_image, dtype=torch.float32)
    lead = point_image.shape[:-3]
    dev = point_image.device
    flat_pts = point_image.reshape(lead + (-1, 3))
    flat_mask = torch.as_tensor(mask, device=dev).reshape(lead + (-1,))
    idx = torch.cumsum(flat_mask.to(torch.int64), dim=-1) - 1
    n_valid = flat_mask.sum(dim=-1)
    # dropped pixels go to one slot past the buffer, cut off below
    dest = torch.where(flat_mask & (idx < max_points), idx, max_points)
    out = torch.zeros(lead + (max_points + 1, 3), dtype=torch.float32, device=dev)
    out.scatter_(-2, dest[..., None].expand(dest.shape + (3,)), flat_pts)
    slot = torch.arange(max_points, device=dev)
    slot_valid = slot < n_valid.clamp(max=max_points)[..., None]
    return out[..., :max_points, :], slot_valid, n_valid


def depth_to_cloud(depth, K, max_points: int, stride: int = 1, tl_x: int = 0, tl_y: int = 0):
    """depth2cloud equivalent (icp.h:102-110) with a static point budget:
    depth_image_to_points, then compact_points (JAX depth_to_cloud.py:68-71).
    (..., H, W) int depth in mm -> (points (..., max_points, 3), slot_valid,
    n_valid)."""
    pts, mask = depth_image_to_points(depth, K, stride=stride, tl_x=tl_x, tl_y=tl_y)
    return compact_points(pts, mask, max_points)


def morton_key(idx: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Morton (Z-curve) code of row-major slot indices over an (sh, sw)
    grid: bits of the column interleaved with bits of the row. Sorting by
    this key is sorting by morton rank."""
    if max(sh, sw) > (1 << 14):
        raise ValueError(f"grid ({sh}, {sw}) exceeds 14-bit morton key range")
    idx = idx.to(torch.int64)
    r = torch.div(idx, sw, rounding_mode="floor")
    c = idx - r * sw

    def spread(v):  # interleave 16 bits with 1-bit gaps
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return (spread(c) | (spread(r) << 1)).to(torch.int32)


def _hash_rank(p: int, device) -> torch.Tensor:
    """(r * 506952113 as wrapping int32) mod p, Python-sign remainder, for
    r in [0, p): the JAX package's int32 product and ``%``, computed in
    int64 so the wrap is explicit rather than left to the platform."""
    r = torch.arange(p, dtype=torch.int64, device=device)
    prod = (r * _HASH_MUL) & 0xFFFFFFFF
    prod = torch.where(prod >= 2 ** 31, prod - 2 ** 32, prod)  # as int32
    return torch.remainder(prod, p)


def compact_topk(pts, valid, k: int, spread: bool = True, order_shape=None):
    """Keep k points of each (..., P) cloud via top-k over a rank key + one
    gather (JAX ``compact_topk`` semantics, batched over leading axes).

    Valid points outrank invalid ones; among valid points ``spread=True``
    ranks by a multiplicative hash of the slot so the kept subset is
    spatially uniform (``spread=False``: scan order). The hash is a
    permutation only when P is a power of two; otherwise ranks collide and
    ``lax.top_k``'s tie rule - lower index first - decides which points
    are kept. A stable descending sort reproduces that rule exactly
    (``torch.topk`` promises no tie order).

    order_shape=(sh, sw): emit the kept rows in morton order of their slot
    on that grid (invalid kept rows last) instead of rank order.

    Returns (points (..., k, 3) with invalid rows zeroed, valid (..., k),
    n_valid (...) = number of valid input points).
    """
    p = pts.shape[-2]
    if spread:
        rank = _hash_rank(p, pts.device)
    else:
        rank = torch.arange(p, dtype=torch.int64, device=pts.device)
    r = torch.arange(p, dtype=torch.int64, device=pts.device)
    key = torch.where(valid, -rank, -(p + r))  # all valid outrank all invalid
    _, order = torch.sort(key, dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    if order_shape is not None:
        sh, sw = order_shape
        if sh * sw != p:
            raise ValueError(f"order_shape {order_shape} != {p} input rows")
        mkey = morton_key(idx, sh, sw).to(torch.int64)
        v_pre = torch.gather(valid, -1, idx)
        mkey = torch.where(v_pre, mkey, _MORTON_CODE_CAP + mkey)
        idx = torch.gather(idx, -1, torch.argsort(mkey, dim=-1, stable=True))
    out = torch.gather(pts, -2, idx[..., None].expand(*idx.shape, 3))
    v = torch.gather(valid, -1, idx)
    out = torch.where(v[..., None], out, torch.zeros_like(out))
    return out, v, valid.sum(dim=-1)


def window_cloud(depth, K, window: int = 256, stride: int = 2, tl_x: int = 0, tl_y: int = 0):
    """The window lift of one (H, W) render (JAX depth_to_cloud.py:150-195):
    window_cloud_batched's crop and stride on a batch of one. Returns
    (points (P, 3) m, valid (P,), n_valid ()), P = ceil(win/stride)^2."""
    pts, valid, n_valid = window_cloud_batched(torch.as_tensor(depth)[None], K, window=window,
                                               stride=stride, tl_x=tl_x, tl_y=tl_y)
    return pts[0], valid[0], n_valid[0]


def window_cloud_batched(depth, K, window: int = 256, stride: int = 2,
                         tl_x: int = 0, tl_y: int = 0):
    """Crop a (window, window) region centred on each render's object,
    stride it, and lift it to points: (N, H, W) int depth ->
    (points (N, P, 3) m, valid (N, P), n_valid (N,)), P = ceil(win/stride)^2.

    The crop centre is the midpoint of the object's row/column extent, with
    floor division as in JAX (an empty render has r0 = H, r1 = -1), clipped
    so the window stays inside the image. tl_x/tl_y: origin of ``depth``
    within the full camera frame (ROI renders)."""
    depth = torch.as_tensor(depth)
    n, h, w = depth.shape
    dev = depth.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    win_h, win_w = min(window, h), min(window, w)
    mask = depth > 0

    rows = mask.any(dim=2)  # (N, H)
    cols = mask.any(dim=1)  # (N, W)
    ridx = torch.arange(h, device=dev)[None, :]
    cidx = torch.arange(w, device=dev)[None, :]
    r0 = torch.where(rows, ridx, h).amin(dim=1)
    r1 = torch.where(rows, ridx, -1).amax(dim=1)
    c0 = torch.where(cols, cidx, w).amin(dim=1)
    c1 = torch.where(cols, cidx, -1).amax(dim=1)
    half = window // 2
    cy = (torch.div(r0 + r1, 2, rounding_mode="floor") - half).clamp(0, max(h - window, 0))
    cx = (torch.div(c0 + c1, 2, rounding_mode="floor") - half).clamp(0, max(w - window, 0))

    dy = torch.arange(0, win_h, stride, device=dev)
    dx = torch.arange(0, win_w, stride, device=dev)
    yy = cy[:, None] + dy[None, :]  # (N, sh)
    xx = cx[:, None] + dx[None, :]  # (N, sw)
    sh, sw = dy.shape[0], dx.shape[0]
    lin = (yy[:, :, None] * w + xx[:, None, :]).reshape(n, -1)  # (N, sh*sw)
    sub = torch.gather(depth.reshape(n, -1), 1, lin)  # (N, P)

    u = (tl_x + xx).to(torch.float32)  # (N, sw)
    v = (tl_y + yy).to(torch.float32)  # (N, sh)
    uu = u[:, None, :].expand(n, sh, sw).reshape(n, -1)
    vv = v[:, :, None].expand(n, sh, sw).reshape(n, -1)
    z = sub.to(torch.float32) / 1000.0
    x = (uu - K[0, 2]) / K[0, 0] * z
    y = (vv - K[1, 2]) / K[1, 1] * z
    valid = sub > 0
    pts = torch.stack([x, y, z], dim=-1)
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    return pts, valid, valid.sum(dim=1)


def window_grid(h: int, w: int, window: int, stride: int):
    """(sh, sw): the strided window's grid on an (h, w) render, each side
    ceil(min(window, side) / stride)."""
    return -(-min(window, h) // stride), -(-min(window, w) // stride)


def window_lift(depth, K, *, window: int, stride: int, max_points: int, morton: bool,
                tl_x: int = 0, tl_y: int = 0):
    """The refine's window lift of (N, H, W) int32 renders (JAX
    pipeline.py:111-146): window_cloud_batched's crop, then, when the
    window's P = sh * sw slots exceed ``max_points``, compact_topk's
    selection. ``morton`` (NN scenes): the rows in Morton order of the
    window grid - the kept valid rows, then the kept invalid ones; without
    a selection all P rows, invalid ones interleaved. Plain PyTorch on any
    device: the plain version of the kernel L1 (ops/lift_cuda.py).

    Returns (clouds (N, P', 3) float32 m, invalid rows zero; valid (N, P')),
    P' = min(max_points, P)."""
    depth = torch.as_tensor(depth)
    sh, sw = window_grid(depth.shape[1], depth.shape[2], window, stride)
    clouds, valids, _n = window_cloud_batched(depth, K, window=window, stride=stride,
                                              tl_x=tl_x, tl_y=tl_y)
    if max_points < sh * sw:
        clouds, valids, _n = compact_topk(clouds, valids, max_points,
                                          order_shape=(sh, sw) if morton else None)
    elif morton:
        code = morton_key(torch.arange(sh * sw, device=clouds.device), sh, sw)
        perm = torch.argsort(code, stable=True)
        clouds, valids = clouds[:, perm], valids[:, perm]
    return clouds, valids
