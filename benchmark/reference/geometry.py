"""Poses, projection and precision for the reference (frozen copies of the
reference renderer's conventions, renderer.cpp:161-185 and icp.cpp:7-17)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class _Precision:
    tf32 = False


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero, as the tensor cores' conversion does."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's matrix product: full float32, or under ``tf32()``
    TF32 - each float32 operand rounded to TF32 first, whichever kernel
    the library picks for the shape, and the library's TF32 allowed."""
    if _Precision.tf32 and a.dtype == torch.float32:
        a, b = _round_tf32(a), _round_tf32(b)
    return torch.matmul(a, b)


@contextlib.contextmanager
def tf32():
    """The reference's matrix products in TF32 while the block runs (the
    control's precision), and back to full float32 after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    _Precision.tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        _Precision.tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = before


def full_float32():
    """The library's float32 products in full float32 (TF32 off) from here
    on, as the program sets them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compute_proj(K, width: int, height: int, near: float = 10.0, far: float = 10000.0):
    """The reference's OpenGL-style (4, 4) projection from a pinhole K, with
    its y flip (row 1 carries -2 fy / h) and w_clip = +z, in float32."""
    K = np.asarray(K, np.float32)
    fx, s, cx, fy, cy = K[0, 0], K[0, 1], K[0, 2], K[1, 1], K[1, 2]
    w, h = float(width), float(height)
    return np.array([
        [2.0 * fx / w, 2.0 * s / w, 2.0 * cx / w - 1.0, 0.0],
        [0.0, -2.0 * fy / h, 1.0 - 2.0 * cy / h, 0.0],
        [0.0, 0.0, (far + near) / (far - near), -2.0 * far * near / (far - near)],
        [0.0, 0.0, 1.0, 0.0]], np.float32)


def euler_to_rotation(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3) angles [x, y, z] -> Rz @ Ry @ Rx (helper.h:187-209)."""
    x, y, z = theta.unbind(-1)
    cx, sx, cy, sy, cz, sz = x.cos(), x.sin(), y.cos(), y.sin(), z.cos(), z.sin()
    rows = [[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
            [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
            [-sy, cy * sx, cy * cx]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def twist_to_mat4(v6: torch.Tensor) -> torch.Tensor:
    """The ICP update [rx, ry, rz, tx, ty, tz] -> 4x4: Rz Ry Rx and t
    (icp.cpp:7-17)."""
    out = torch.zeros(v6.shape[:-1] + (4, 4), dtype=v6.dtype, device=v6.device)
    out[..., :3, :3] = euler_to_rotation(v6[..., :3])
    out[..., :3, 3] = v6[..., 3:]
    out[..., 3, 3] = 1.0
    return out


def euler_np(theta) -> np.ndarray:
    """Numpy float64 twin of euler_to_rotation, for the input generators."""
    t = np.asarray(theta, np.float64)
    return euler_to_rotation(torch.as_tensor(t)).numpy()


def corner_gap(a, b, half_extent: float) -> np.ndarray:
    """The largest displacement, in the poses' translation unit, of the
    eight corners of a cube of ``half_extent`` about the model origin
    between poses ``a`` and ``b`` ((..., 4, 4) each): one number that moves
    with both the rotation and the translation of a pose."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = half_extent * np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)])
    d = np.einsum("...ij,kj->...ki", a[..., :3, :3] - b[..., :3, :3], c) \
        + (a[..., None, :3, 3] - b[..., None, :3, 3])
    return np.linalg.norm(d, axis=-1).max(axis=-1)
