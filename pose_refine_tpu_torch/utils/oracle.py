"""Pure-numpy scanline rasterizer: the parity oracle.

A faithful re-expression of the reference CPU rasterizer's scanline loop
(renderer.cpp:190-298) and of its ICP outer loop, a copy of the JAX
package's ``pose_refine_tpu/utils/oracle.py``: the port's rasterizer and
ICP are checked against it. Slow (Python loop per triangle) - tests only.
float32 throughout to match the reference arithmetic.
"""

from __future__ import annotations

import numpy as np

INT32_MAX = np.iinfo(np.int32).max


def render_scanline(tris, poses, width, height, proj, roi=(0, 0, 0, 0)):
    """(T,3,3) tris, (N,4,4) poses, (4,4) proj -> (N, out_h, out_w) int32 mm."""
    tris = np.asarray(tris, np.float32)
    poses = np.asarray(poses, np.float32)
    proj = np.asarray(proj, np.float32)
    rx, ry, rw, rh = roi
    out_w, out_h = (rw, rh) if (rw > 0 and rh > 0) else (width, height)

    if rw > 0 and rh > 0:
        cmin = np.array([rx, height - 1 - (ry + rh - 1)], np.float32)
        cmax = np.array([rx + rw - 1, height - 1 - ry], np.float32)
    else:
        cmin = np.array([0, 0], np.float32)
        cmax = np.array([width - 1, height - 1], np.float32)

    out = np.full((len(poses), out_h, out_w), INT32_MAX, np.int32)

    for n, pose in enumerate(poses):
        cam = tris @ pose[:3, :3].T.astype(np.float32) + pose[:3, 3]
        zcam = cam[..., 2].astype(np.float32)  # (T,3)
        pr = cam @ proj[:2, :3].T.astype(np.float32) + proj[:2, 3]
        sx = (pr[..., 0] / zcam * np.float32(width / 2.0) + np.float32(width / 2.0))
        sy = (pr[..., 1] / zcam * np.float32(height / 2.0) + np.float32(height / 2.0))
        pts2 = np.stack([sx, sy], axis=-1).astype(np.float32)  # (T,3,2)

        fb = out[n]
        for t in range(len(tris)):
            p = pts2[t]
            z = zcam[t]
            bbmin = np.maximum(cmin, p.min(axis=0))
            bbmax = np.minimum(cmax, p.max(axis=0))
            x_start = int(np.float32(bbmin[0] + np.float32(0.5)))
            y_start = int(np.float32(bbmin[1] + np.float32(0.5)))
            if x_start > bbmax[0] or y_start > bbmax[1]:
                continue
            ax, ay = p[0]
            bx, by = p[1]
            cx, cy = p[2]
            area = np.float32(0.5) * ((cx - ax) * (by - ay) - (bx - ax) * (cy - ay))
            if area == 0:
                continue
            base_inv = np.float32(1.0) / area
            for yy in range(y_start, int(np.floor(bbmax[1])) + 1):
                for xx in range(x_start, int(np.floor(bbmax[0])) + 1):
                    fx, fy = np.float32(xx), np.float32(yy)
                    beta = np.float32(0.5) * ((cx - ax) * (fy - ay) - (fx - ax) * (cy - ay)) * base_inv
                    gamma = np.float32(0.5) * ((fx - ax) * (by - ay) - (bx - ax) * (fy - ay)) * base_inv
                    alpha = np.float32(1.0) - beta - gamma
                    if alpha < 0 or beta < 0 or gamma < 0 or alpha > 1 or beta > 1 or gamma > 1:
                        continue
                    denom = alpha / z[0] + beta / z[1] + gamma / z[2]
                    frag = (alpha + beta + gamma) / denom
                    d = np.int32(np.float32(frag + np.float32(0.5)))
                    col = xx - rx
                    row = height - 1 - yy - ry
                    if d < fb[row, col]:
                        fb[row, col] = d

    out[out == INT32_MAX] = 0
    return out


def icp_point_to_plane_numpy(cloud, query_fn, max_iteration=30,
                             relative_fitness=1e-5, relative_rmse=1e-5):
    """Reference ICP outer loop (icp.cpp:125-188) in float32 numpy.

    query_fn(points (P,3)) -> (dst (P,3), normal (P,3), valid (P,) bool).
    Returns (T 4x4, fitness, rmse, transformed cloud).
    """
    from pose_refine_tpu_torch import geometry

    cloud = np.array(cloud, np.float32)
    n = len(cloud)
    T = np.eye(4, dtype=np.float32)
    fitness = rmse = 0.0

    for it in range(max_iteration + 1):
        dst, nrm, valid = query_fn(cloud)
        diff = dst - cloud
        b = (diff * nrm).sum(axis=1)
        # A row = [cross(p, n), n]: the reference writes it component-wise as
        # [nz*py - ny*pz, nx*pz - nz*px, ny*px - nx*py, nx, ny, nz] (icp.h:157-163)
        Arow = np.concatenate([np.cross(cloud, nrm), nrm], axis=1).astype(np.float32)
        w = valid.astype(np.float32)[:, None]
        A = Arow * w
        bv = b * valid

        count = float(valid.sum())
        mse_sum = float(((diff ** 2).sum(axis=1) * valid).sum())
        prev_fit, prev_rmse = fitness, rmse
        if count == 0:
            return T, fitness, rmse, cloud
        fitness = count / n
        rmse = float(np.sqrt(mse_sum / count))
        if it == max_iteration:
            return T, fitness, rmse, cloud
        if abs(fitness - prev_fit) < relative_fitness and abs(rmse - prev_rmse) < relative_rmse:
            return T, fitness, rmse, cloud

        AtA = (A.T @ A).astype(np.float64) + 0.01 * np.eye(6)
        Atb = (A.T @ bv).astype(np.float64)
        x = np.linalg.solve(AtA, Atb)
        # numpy end to end: the update's rotation by the host twin of
        # geometry.euler_to_rotation
        x32 = x.astype(np.float32)
        upd = np.eye(4, dtype=np.float32)
        upd[:3, :3] = geometry._euler_to_rotation_np(x32[0:3])
        upd[:3, 3] = x32[3:6]
        cloud = cloud @ upd[:3, :3].T + upd[:3, 3]
        T = upd @ T
    return T, fitness, rmse, cloud
