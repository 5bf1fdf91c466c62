"""Pose-error metrics: ADD / ADD-S.

The reference's accuracy criterion is recovering a known perturbation and
comparing CPU/CUDA/Open3D transforms side by side (test.cpp:177-192); the
BASELINE north star states it as "ADD pose error matched to 1e-3" between
this pipeline and the reference algorithm. ADD (Hinterstoisser et al.) is
the mean distance between corresponding model points under two poses;
ADD-S is its symmetric-object variant using nearest-point distances.

Units follow the inputs: obj_06 model vertices and pose translations are in
millimeters, so the 1e-3 m target reads as ADD <= 1.0 in mm units.
"""

from __future__ import annotations

import numpy as np


def _transform(T, pts):
    """(..., 4, 4) x (P, 3) -> (..., P, 3) in float64 (metric fidelity -
    f32 rounding of mm-scale coordinates is ~1e-2 mm, too close to the
    1e-3 m = 1 mm parity budget to stack onto the measurement)."""
    T = np.asarray(T, np.float64)
    pts = np.asarray(pts, np.float64)
    return pts @ np.swapaxes(T[..., :3, :3], -1, -2) + T[..., None, :3, 3]


def add_error(T_est, T_ref, model_pts):
    """ADD: mean_i ||T_est x_i - T_ref x_i|| over model points.

    T_est/T_ref: (..., 4, 4) poses (broadcastable); model_pts: (P, 3).
    Returns (...) float64 in the model's units (mm for obj_06).
    """
    a = _transform(T_est, model_pts)
    b = _transform(T_ref, model_pts)
    return np.linalg.norm(a - b, axis=-1).mean(axis=-1)


def adds_error(T_est, T_ref, model_pts, chunk: int = 2048):
    """ADD-S: mean_i min_j ||T_est x_i - T_ref x_j|| (symmetric objects).

    O(P^2) done in chunks on the host; use a vertex subsample for large
    meshes. Same broadcasting and units as add_error.
    """
    a = _transform(T_est, model_pts)  # (..., P, 3)
    b = _transform(T_ref, model_pts)
    P = a.shape[-2]
    mins = np.full(a.shape[:-1], np.inf)
    for s in range(0, P, chunk):
        d = np.linalg.norm(
            a[..., :, None, :] - b[..., None, s : s + chunk, :], axis=-1
        )
        mins = np.minimum(mins, d.min(axis=-1))
    return mins.mean(axis=-1)


def rotation_angle_deg(T_a, T_b):
    """Geodesic rotation distance in degrees between (..., 4, 4) poses.

    Robust to non-orthonormal rotation blocks: 31 left-composed f32 Euler
    updates (the reference ICP's accumulation, icp.cpp:183) drift ~3e-3 off
    orthonormality, which inflates the naive trace formula by degrees while
    the true pose difference is micro-degrees. Project each relative
    rotation onto SO(3) via its SVD polar factor first.
    """
    Ra = np.asarray(T_a, np.float64)[..., :3, :3]
    Rb = np.asarray(T_b, np.float64)[..., :3, :3]
    M = np.einsum("...ij,...kj->...ik", Ra, Rb)  # Ra @ Rb^T
    u, _s, vt = np.linalg.svd(M)
    tr = np.einsum("...ij,...ij->...", u, np.swapaxes(vt, -1, -2))
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
