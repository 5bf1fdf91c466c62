"""Batched point-to-plane ICP with the reference's semantics (icp.cpp:125-188,
icp.h:38-50, 125-209), its scores, and the pose information of a tracked
frame's extra pass.

  * rows: b = (dst - src) . n, A = [src x n, n]; mse sums |dst - src|^2
  * fitness = inliers / valid points, rmse = sqrt(mse / inliers)
  * max_iteration updates and one scoring pass; a pose is done when its
    fitness and rmse change by less than the thresholds, when a pass has
    no inlier (its scores kept) or at the last pass, and then freezes
  * (AtA + 0.01 I) x = Atb, solved in float64 as the reference's LDLT;
    update Rz Ry Rx + t; T <- update @ T

The normal equations and the moves are matrix products, so they run in
TF32 under ``geometry.tf32()``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.geometry import mm, twist_to_mat4

# the tracked frame's covariance calibration (the program's stated
# constants: a x9 inflation, the residual variance floored at the 1 mm
# depth step and 0.29 z / fx of lateral pitch at the render intrinsics)
RENDER_COV_INFLATION = 9.0
DEPTH_QUANT_SIGMA_M = 2.9e-4
LATERAL_QUANT_COEFF = 0.29


class Result(NamedTuple):
    T: torch.Tensor        # (N, 4, 4) meters
    fitness: torch.Tensor  # (N,)
    rmse: torch.Tensor     # (N,)
    cloud: torch.Tensor    # (N, P, 3) the moved clouds
    active: torch.Tensor   # (N,) iterations the latch let run
    moves: torch.Tensor    # (N,) iterations that moved the cloud


def _anchor(cloud, valid):
    """Invalid rows moved onto the cloud's first valid point (inert: every
    sum is masked)."""
    first = valid.to(torch.int8).argmax(-1)
    anchor = cloud[torch.arange(cloud.shape[0], device=cloud.device), first]
    return torch.where(valid[..., None], cloud, anchor[:, None, :])


def _move(T, cloud):
    return mm(cloud, T[:, :3, :3].transpose(1, 2)) + T[:, None, :3, 3]


def equations(cloud, valid, query):
    """One association and reduction pass: (AtA, Atb, count, mse_sum)."""
    dst, nrm, ok = query(cloud)
    v = (ok & valid).to(torch.float32)
    diff = dst - cloud
    b = (diff * nrm).sum(-1)
    a = torch.cat([torch.linalg.cross(cloud, nrm, dim=-1), nrm], -1) * v[..., None]
    at = a.transpose(1, 2)
    return (mm(at, a), mm(at, (b * v)[..., None])[..., 0], v.sum(-1),
            ((diff * diff).sum(-1) * v).sum(-1))


def solve(AtA, Atb):
    eye = torch.eye(6, dtype=torch.float64, device=AtA.device)
    return torch.linalg.solve(AtA.double() + 0.01 * eye, Atb.double()).to(torch.float32)


def icp(cloud, valid, query, max_iteration: int, rel_fitness: float = 1e-5,
        rel_rmse: float = 1e-5) -> Result:
    n = cloud.shape[0]
    dev = cloud.device
    cloud = _anchor(cloud, valid)
    n_total = valid.sum(-1).to(torch.float32)
    T = torch.eye(4, device=dev).expand(n, 4, 4).clone()
    fit = torch.zeros(n, device=dev)
    rmse = torch.zeros(n, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    active = torch.zeros(n, dtype=torch.int64, device=dev)
    moves = torch.zeros_like(active)
    for it in range(max_iteration + 1):
        AtA, Atb, count, mse = equations(cloud, valid, query)
        empty = count == 0
        new_fit = torch.where(empty, fit, count / n_total.clamp(min=1.0))
        new_rmse = torch.where(empty, rmse, torch.sqrt(mse / count.clamp(min=1.0)))
        conv = ((new_fit - fit).abs() < rel_fitness) & ((new_rmse - rmse).abs() < rel_rmse)
        new_done = done | empty | conv | (it == max_iteration)
        active += ~done
        fit = torch.where(done, fit, new_fit)
        rmse = torch.where(done, rmse, new_rmse)
        if it < max_iteration:
            upd = twist_to_mat4(solve(AtA, Atb))
            hold = new_done[:, None, None]
            cloud = torch.where(hold, cloud, _move(upd, cloud))
            T = torch.where(hold, T, mm(upd, T))
            moves += ~new_done
        done = new_done
    return Result(T, fit, rmse, cloud, active, moves)


def scores(T, cloud, valid, query):
    """(fitness, rmse, moved clouds) of (N, P, 3) clouds moved by T."""
    moved = _move(T, _anchor(cloud, valid))
    _, _, count, mse = equations(moved, valid, query)
    return count / valid.sum(-1).to(torch.float32).clamp(min=1.0), \
        torch.sqrt(mse / count.clamp(min=1.0)), moved


def covariance(moved, valid, query, K_render):
    """The render-calibrated covariance of poses whose clouds are ``moved``:
    one pass's information A^T A and residual variance sum(b^2) / (n - 6),
    9 max(sigma2, floor) inv(info + 1e-6 tr(info) / 6 I), the floor the
    depth step's and the lateral pitch's variance at the clouds' mean z."""
    dst, nrm, ok = query(moved)
    v = (ok & valid).to(torch.float32)
    b = ((dst - moved) * nrm).sum(-1) * v
    a = torch.cat([torch.linalg.cross(moved, nrm, dim=-1), nrm], -1) * v[..., None]
    info = mm(a.transpose(1, 2), a)
    count = v.sum(-1)
    sigma2 = (b * b).sum(-1) / (count - 6.0).clamp(min=1.0)
    vv = valid.to(torch.float32)
    mean_z = (moved[..., 2].abs() * vv).sum(-1) / vv.sum(-1).clamp(min=1.0)
    lateral = LATERAL_QUANT_COEFF * mean_z / float(K_render[0][0])
    floor = DEPTH_QUANT_SIGMA_M ** 2 + lateral ** 2
    ridge = (info.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0 * 1e-6).clamp(min=1e-30)
    eye = torch.eye(6, device=info.device)
    inv = torch.linalg.inv((info + ridge[:, None, None] * eye).double()).to(torch.float32)
    return (RENDER_COV_INFLATION * torch.maximum(sigma2, floor))[:, None, None] * inv
