"""Pose / projection / pixel<->point math (PyTorch port of
``pose_refine_tpu/geometry.py``).

Poses are (..., 4, 4) float32 row-major tensors, intrinsics K are (3, 3),
depths are int mm, points float m. Semantics follow the JAX package
function by function, which follows the reference library:
  * projection matrix construction: renderer.cpp:161-185
  * pixel<->point conversions:      common.h:47-73
  * Euler conventions (Rz@Ry@Rx):   helper.h:187-209 and icp.cpp:7-17
"""

from __future__ import annotations

import numpy as np
import torch

# LINEMOD ("hinter") camera intrinsics used by the reference test suite
# (test.cpp:26).
LINEMOD_K = np.array(
    [[572.4114, 0.0, 325.2611],
     [0.0, 573.57043, 242.04899],
     [0.0, 0.0, 1.0]],
    dtype=np.float32,
)

_INT32_MIN = -(2 ** 31)
_INT32_MAX = 2 ** 31 - 1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def compute_proj(K, width: int, height: int, near: float = 10.0,
                 far: float = 10000.0, device="cpu") -> torch.Tensor:
    """OpenGL-style (4, 4) projection matrix from a pinhole K.

    Mirrors the reference construction (renderer.cpp:161-185) including its
    double-negation "yz flip": row 1 carries -2*fy/h so that +y in camera
    space maps downward in NDC; the rasterizer flips y again at framebuffer
    write. The last row is [0, 0, 1, 0], i.e. w_clip = +z_camera. Built in
    numpy float32 exactly as the JAX package builds it.
    """
    K = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K, dtype=np.float32)
    fx, s, cx = K[0, 0], K[0, 1], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    w, h = float(width), float(height)
    proj = np.array(
        [
            [2.0 * fx / w, 2.0 * s / w, 2.0 * cx / w - 1.0, 0.0],
            [0.0, -2.0 * fy / h, 1.0 - 2.0 * cy / h, 0.0],
            [0.0, 0.0, (far + near) / (far - near), -2.0 * far * near / (far - near)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=np.float32,
    )
    return torch.from_numpy(proj).to(device)


def pose_from_Rt(R, t) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) pose."""
    R = _f32(R)
    t = _f32(t, R.device)
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    out = torch.zeros(batch + (4, 4), dtype=torch.float32, device=R.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def euler_to_rotation(theta) -> torch.Tensor:
    """(..., 3) [x, y, z] angles -> Rz @ Ry @ Rx (helper.h:187-209)."""
    theta = _f32(theta)
    x, y, z = theta[..., 0], theta[..., 1], theta[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotation_to_euler(R) -> torch.Tensor:
    """Inverse of euler_to_rotation (helper.h:165-185): (..., 3, 3) ->
    (..., 3) [x, y, z], the singular branch (sy < 1e-6) with z = 0."""
    R = _f32(R)
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def twist_to_mat4(v6) -> torch.Tensor:
    """6-vector ICP update [rx, ry, rz, tx, ty, tz] -> 4x4 transform:
    Rz(rz) @ Ry(ry) @ Rx(rx) with translation v6[3:6] (icp.cpp:7-17).
    Batched over leading axes."""
    v6 = _f32(v6)
    return pose_from_Rt(euler_to_rotation(v6[..., 0:3]), v6[..., 3:6])


def transform_points(T, pts) -> torch.Tensor:
    """Apply (..., 4, 4) affine transforms to (..., P, 3) points, in full
    float32 (TF32 is kept off by device.resolve_device)."""
    T = _f32(T)
    pts = _f32(pts, T.device)
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """C-style int() cast: truncation toward zero, saturating like XLA's
    float->int32 convert (NaN -> 0, out-of-range -> INT32_MIN/MAX) so the
    result never depends on the platform's undefined overflow behaviour."""
    t = torch.trunc(x)
    lo, hi = float(_INT32_MIN), float(2 ** 31)
    safe = torch.where(torch.isnan(t) | (t < lo) | (t >= hi), torch.zeros_like(t), t)
    out = safe.to(torch.int32)
    out = torch.where(t >= hi, torch.full_like(out, _INT32_MAX), out)
    return torch.where(t < lo, torch.full_like(out, _INT32_MIN), out)


def dep2pcd(x, y, dep_mm, K, tl_x: int = 0, tl_y: int = 0) -> torch.Tensor:
    """Pixel (x, y) + depth in mm -> 3D point in meters (common.h:47-61).
    dep_mm == 0 maps to the zero point."""
    dep_mm = torch.as_tensor(dep_mm)
    K = _f32(K, dep_mm.device)
    z = dep_mm.to(torch.float32) / 1000.0
    px = (_f32(x, dep_mm.device) + tl_x - K[0, 2]) / K[0, 0] * z
    py = (_f32(y, dep_mm.device) + tl_y - K[1, 2]) / K[1, 1] * z
    pt = torch.stack([px, py, z], dim=-1)
    return torch.where((dep_mm == 0)[..., None], torch.zeros_like(pt), pt)


def pcd2dep(pcd, K, tl_x: int = 0, tl_y: int = 0) -> torch.Tensor:
    """3D point in meters -> (x, y, dep_mm) int32 with the reference's
    trunc(v + 0.5) rounding (common.h:63-73)."""
    pcd = _f32(pcd)
    K = _f32(K, pcd.device)
    dep = _trunc_int(pcd[..., 2] * 1000.0 + 0.5)
    x = _trunc_int(pcd[..., 0] / pcd[..., 2] * K[0, 0] + K[0, 2] - tl_x + 0.5)
    y = _trunc_int(pcd[..., 1] / pcd[..., 2] * K[1, 1] + K[1, 2] - tl_y + 0.5)
    return torch.stack([x, y, dep], dim=-1)


def _euler_to_rotation_np(theta) -> np.ndarray:
    """Numpy twin of euler_to_rotation (Rz @ Ry @ Rx, helper.h:187-209),
    float32, for sample_hypotheses' host-only draw."""
    t = np.asarray(theta, np.float32)
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    R = np.empty(t.shape[:-1] + (3, 3), np.float32)
    R[..., 0, 0] = cz * cy
    R[..., 0, 1] = cz * sy * sx - sz * cx
    R[..., 0, 2] = cz * sy * cx + sz * sx
    R[..., 1, 0] = sz * cy
    R[..., 1, 1] = sz * sy * sx + cz * cx
    R[..., 1, 2] = sz * sy * cx - cz * sx
    R[..., 2, 0] = -sy
    R[..., 2, 1] = cy * sx
    R[..., 2, 2] = cy * cx
    return R


def sample_hypotheses(center_pose, n: int, rot_deg: float = 10.0,
                      trans_mm: float = 20.0, rng=None, include_center=False) -> np.ndarray:
    """Draw n pose hypotheses around a detection (JAX geometry.py:194-218):
    uniform per-axis Euler jitter of +-rot_deg degrees left-composed onto
    the rotation, uniform +-trans_mm translation jitter (the reference
    acceptance recipe, test.cpp:29-44, generalized). Host numpy in JAX's
    draw order, so the same ``rng`` (a seed or a numpy Generator) gives the
    same poses bit for bit. Returns (n, 4, 4) float32.

    include_center makes hypothesis 0 the unperturbed center pose (useful
    in tracking loops where the prior is already good)."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    center = np.asarray(center_pose, np.float32)
    ang = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32) * np.float32(np.radians(rot_deg))
    d_rot = _euler_to_rotation_np(ang)
    d_t = rng.uniform(-trans_mm, trans_mm, (n, 3)).astype(np.float32)
    if include_center and n > 0:
        d_rot[0] = np.eye(3, dtype=np.float32)
        d_t[0] = 0.0
    out = np.zeros((n, 4, 4), np.float32)
    out[:, :3, :3] = np.einsum("nij,jk->nik", d_rot, center[:3, :3])
    out[:, :3, 3] = center[:3, 3] + d_t
    out[:, 3, 3] = 1.0
    return out
