"""Depth -> points, and the refine's window lift: a frozen copy of the
program's semantics (the JAX package's ``window_cloud_batched``,
``compact_topk`` and the Morton order of its pipeline.py:111-146), which
decide which rendered pixels become ICP points."""

from __future__ import annotations

import torch

_HASH_MUL = 2654435761 & 0x7FFFFFFF
_MORTON_CODE_CAP = 1 << 28


def depth_points(depth, K, tl_x: int = 0, tl_y: int = 0):
    """(..., H, W) int mm depth -> ((..., H, W, 3) float32 points in m,
    (..., H, W) bool mask): z = d / 1000, x = (u - cx) / fx z, y = (v -
    cy) / fy z (common.h:47-61); d == 0 is invalid."""
    h, w = depth.shape[-2:]
    K = torch.as_tensor(K, dtype=torch.float32, device=depth.device)
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :] + tl_x
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None] + tl_y
    z = depth.to(torch.float32) / 1000.0
    pts = torch.stack([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z, z], -1)
    mask = depth > 0
    return torch.where(mask[..., None], pts, torch.zeros_like(pts)), mask


def morton_key(idx, sh: int, sw: int):
    """Morton code of row-major slot indices of an (sh, sw) grid."""
    idx = idx.to(torch.int64)
    r = torch.div(idx, sw, rounding_mode="floor")
    c = idx - r * sw

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    return spread(c) | (spread(r) << 1)


def _hash_rank(p: int, device):
    r = torch.arange(p, dtype=torch.int64, device=device)
    prod = (r * _HASH_MUL) & 0xFFFFFFFF
    prod = torch.where(prod >= 2 ** 31, prod - 2 ** 32, prod)
    return torch.remainder(prod, p)


def _select(pts, valid, k: int, order_shape=None):
    """Keep k of each (N, P) cloud's points: valid points first, ranked by
    a multiplicative hash of the slot (ties to the lower slot); with
    order_shape the kept rows in Morton order of the slot, valid first."""
    p = pts.shape[-2]
    rank = _hash_rank(p, pts.device)
    r = torch.arange(p, dtype=torch.int64, device=pts.device)
    key = torch.where(valid, -rank, -(p + r))
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    if order_shape is not None:
        mkey = morton_key(idx, *order_shape)
        mkey = torch.where(torch.gather(valid, -1, idx), mkey, _MORTON_CODE_CAP + mkey)
        idx = torch.gather(idx, -1, torch.argsort(mkey, dim=-1, stable=True))
    out = torch.gather(pts, -2, idx[..., None].expand(*idx.shape, 3))
    v = torch.gather(valid, -1, idx)
    return torch.where(v[..., None], out, torch.zeros_like(out)), v


def window_lift(depth, K, window: int, stride: int, max_points: int, morton: bool,
                tl_x: int = 0, tl_y: int = 0):
    """(N, H, W) renders -> (clouds (N, P', 3) m, valid (N, P')): a window
    x window crop centred on each render's object (floor midpoint of its
    row and column extent, clipped into the image), strided, then at most
    max_points of its P slots (_select); ``morton`` for NN scenes."""
    n, h, w = depth.shape
    dev = depth.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    mask = depth > 0
    rows, cols = mask.any(2), mask.any(1)
    ridx, cidx = torch.arange(h, device=dev)[None], torch.arange(w, device=dev)[None]
    r0 = torch.where(rows, ridx, h).amin(1)
    r1 = torch.where(rows, ridx, -1).amax(1)
    c0 = torch.where(cols, cidx, w).amin(1)
    c1 = torch.where(cols, cidx, -1).amax(1)
    half = window // 2
    cy = (torch.div(r0 + r1, 2, rounding_mode="floor") - half).clamp(0, max(h - window, 0))
    cx = (torch.div(c0 + c1, 2, rounding_mode="floor") - half).clamp(0, max(w - window, 0))
    dy = torch.arange(0, min(window, h), stride, device=dev)
    dx = torch.arange(0, min(window, w), stride, device=dev)
    yy, xx = cy[:, None] + dy[None], cx[:, None] + dx[None]
    sh, sw = dy.shape[0], dx.shape[0]
    lin = (yy[:, :, None] * w + xx[:, None, :]).reshape(n, -1)
    sub = torch.gather(depth.reshape(n, -1), 1, lin)
    uu = (tl_x + xx).to(torch.float32)[:, None, :].expand(n, sh, sw).reshape(n, -1)
    vv = (tl_y + yy).to(torch.float32)[:, :, None].expand(n, sh, sw).reshape(n, -1)
    z = sub.to(torch.float32) / 1000.0
    pts = torch.stack([(uu - K[0, 2]) / K[0, 0] * z, (vv - K[1, 2]) / K[1, 1] * z, z], -1)
    valid = sub > 0
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    if max_points < sh * sw:
        return _select(pts, valid, max_points, (sh, sw) if morton else None)
    if morton:
        perm = torch.argsort(morton_key(torch.arange(sh * sw, device=dev), sh, sw), stable=True)
        return pts[:, perm], valid[:, perm]
    return pts, valid
