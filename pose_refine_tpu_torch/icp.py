"""Batched point-to-plane ICP on the device (PyTorch port of
``pose_refine_tpu/icp.py``, fused-loop path).

Semantics preserved from the reference (icp.cpp:125-188, icp.cu:156-217)
through the JAX package:
  * residual b = dot(dst - src, n); A row = [cross(src, n), n] (icp.h:144-163)
  * mse accumulates point-to-POINT |dst - src|^2 (icp.h:151-153)
  * fitness = inliers / cloud size; rmse = sqrt(mse/inliers) (icp.cpp:158-159)
  * convergence when |dfitness| < rf AND |drmse| < rr, max_iteration
    iterations plus one extra scoring-only pass (icp.h:38-50, icp.cpp:137-166)
  * count == 0 aborts, keeping the previous scores (icp.cpp:156)
  * solve: (AtA + 0.01*I) x = Atb (icp.cpp:29-45); update composes
    Rz(x2)Ry(x1)Rx(x0) + t (icp.cpp:7-17); T <- update @ T (icp.cpp:183)

The whole pose batch refines at once: a fixed loop of max_iteration + 1
steps with a per-pose done latch and no host synchronisation inside. The
JAX package's chunked while-loop and fused fori are workarounds for its
runtime with identical results. Everything stays float32, as in the JAX
package: the reductions, the solve residual and the pose composition.

One association + reduction pass has two formulations, as in the JAX
package: "matmul" (batched matrix products) and "packed" (the reference's
29-float vector a point, icp.h:125-209, summed in the order of the fused
kernel). Given a scene's ``Association``, a pass on CUDA tensors is one
launch of the fused kernel of ``ops/icp_reduce.py``, which serves both
options: it computes the packed sums, whatever ``reduction`` says. The
association and the count are the same in all of them. "packed" on any
device and the kernel give the same float sums bit for bit; "matmul" differs
from them in the last bits, and an ICP turns last bits into whole iterations
at the hypotheses that do not converge (an association pixel that flips, the
1e-5 latch), so a "matmul" refine and a "packed" one agree closely only
where both converge.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from pose_refine_tpu_torch import geometry
from pose_refine_tpu_torch.ops.icp_reduce import assoc_reduce_plain, packed_sums_plain, unpack_sums

REDUCTIONS = ("matmul", "packed")


class ICPConvergenceCriteria(NamedTuple):
    """Defaults per icp.h:38-50."""

    relative_fitness: float = 1e-5
    relative_rmse: float = 1e-5
    max_iteration: int = 30


class RegistrationResult(NamedTuple):
    """Open3D-style result (icp.h:26-36), batched: every field has the pose
    batch as its leading axes."""

    transformation: torch.Tensor  # (..., 4, 4)
    fitness: torch.Tensor         # (...,) inlier fraction
    inlier_rmse: torch.Tensor     # (...,)
    # valid source points fed to ICP (the fitness divisor, icp.cpp:158);
    # n_points == max_points flags a saturated lift budget
    n_points: Optional[torch.Tensor] = None


class PoseUncertainty(NamedTuple):
    """Per-pose Laplace / Gauss-Newton uncertainty (beyond parity; the
    reference's results carry only fitness and rmse, icp.h:26-36), from one
    extra association pass at the final cloud (``refine_poses(...,
    with_information=True)``). Twist order [omega, t] in [rad, m]
    (icp.h:157-163)."""

    information: torch.Tensor  # (..., 6, 6) J^T J (unscaled)
    sigma2: torch.Tensor       # (...,) unbiased residual variance
    count: torch.Tensor        # (...,) inlier count
    covariance: torch.Tensor   # (..., 6, 6) sigma2 * inv(info + relative ridge)


class Association(NamedTuple):
    """A scene's association bound for one refine. ``query``: (..., 3) points
    -> (dst, normal, valid). ``reduce``: (clouds (N, P, 3), valid (N, P)) ->
    (AtA, Atb, count, mse_sum), the query and the reduction in one step
    (``scene.reduce`` / ``scene.reduce_at(ids)``: one kernel launch). The
    ICP loop takes ``reduce`` for CUDA tensors, and ``query`` plus a plain
    formulation for CPU tensors."""

    query: Callable
    reduce: Callable


def plain_association(plain_query: Callable) -> Association:
    """The Association of the kernels' plain versions: ``plain_query`` (a
    scene's ``query(plain=True)`` or ``query_at(ids, plain=True)``), and as
    its reduce the fused kernel's plain version over that query. What a
    kernel path is held against: the same function in plain PyTorch."""
    return Association(
        plain_query, lambda cloud, valid: unpack_sums(assoc_reduce_plain(cloud, valid, plain_query)))


def _solve_damped(AtA: torch.Tensor, Atb: torch.Tensor, penalty: float = 0.01):
    """(AtA + penalty*I) x = Atb in f32 Cholesky + one refinement step,
    standing in for the reference's f64 LDLT (icp.cpp:29-45). Batched over
    leading axes; ``cholesky_ex`` keeps the check of the factorisation off
    the host."""
    eye = torch.eye(6, dtype=AtA.dtype, device=AtA.device)
    M = AtA + penalty * eye
    L, _info = torch.linalg.cholesky_ex(M)
    b = Atb[..., None]
    x = torch.cholesky_solve(b, L)
    # full-f32 residual (TF32 is off): the refinement step recovers
    # f64-like accuracy only from an exact-precision residual
    r = b - M @ x
    x = x + torch.cholesky_solve(r, L)
    return x[..., 0]


def _weighted_rows(cloud, valid, dst, nrm, q_valid):
    """Mask, residual and masked (..., P, 6) Jacobian rows. Every reduction
    multiplies by ``q_valid & valid``, which keeps padded rows inert."""
    v = (q_valid & valid).to(cloud.dtype)
    diff = dst - cloud
    b = (diff * nrm).sum(dim=-1)
    arow = torch.cat([torch.linalg.cross(cloud, nrm, dim=-1), nrm], dim=-1) * v[..., None]
    return v, diff, b, arow


def _normal_equations(cloud, valid, assoc: Union[Callable, Association],
                      reduction: str = "matmul"):
    """One association + reduction pass: (AtA (..., 6, 6), Atb (..., 6),
    count (...), mse_sum (...)), the reference's transform_reduce over
    thrust__pcd2Ab (icp.h:128-209). ``assoc`` is an Association (CUDA
    tensors: its ``reduce``, the packed sums whatever ``reduction`` says)
    or a bare query callable, reduced here as batched matrix products
    ("matmul") or as the 29-float packed vector ("packed")."""
    if isinstance(assoc, Association):
        if cloud.device.type == "cuda":
            return assoc.reduce(cloud, valid)
        assoc = assoc.query
    dst, nrm, q_valid = assoc(cloud)
    if reduction == "packed":
        return unpack_sums(packed_sums_plain(cloud, valid, dst, nrm, q_valid))
    v, diff, b, arow = _weighted_rows(cloud, valid, dst, nrm, q_valid)
    AtA = arow.transpose(-1, -2) @ arow
    Atb = (arow.transpose(-1, -2) @ (b * v)[..., None])[..., 0]
    count = v.sum(dim=-1)
    mse_sum = ((diff * diff).sum(dim=-1) * v).sum(dim=-1)
    return AtA, Atb, count, mse_sum


def _icp_run(cloud, valid, assoc: Union[Callable, Association],
             criteria: ICPConvergenceCriteria, n_points=None, reduction: str = "matmul"):
    """The ICP outer loop over a (N, P, 3) cloud batch with (N, P) valid;
    ``assoc`` and ``reduction`` as in _normal_equations.

    Returns (RegistrationResult batch, transformed clouds (N, P, 3))."""
    cloud = torch.as_tensor(cloud, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=cloud.device)
    n = cloud.shape[0]
    dev = cloud.device
    # anchor padded rows to the first valid point: their contribution is
    # zero either way (every reduction masks by valid); all-invalid clouds
    # keep row 0 and hit the count == 0 abort
    first = valid.to(torch.int8).argmax(dim=-1)
    anchor = cloud[torch.arange(n, device=dev), first]
    cloud = torch.where(valid[..., None], cloud, anchor[:, None, :])
    if n_points is None:
        n_total = valid.sum(dim=-1).to(torch.float32)
    else:
        n_total = torch.as_tensor(n_points, dtype=torch.float32, device=dev).expand(n)
    max_iter = int(criteria.max_iteration)

    T = torch.eye(4, dtype=torch.float32, device=dev).expand(n, 4, 4).clone()
    fitness = torch.zeros(n, dtype=torch.float32, device=dev)
    rmse = torch.zeros_like(fitness)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for it in range(max_iter + 1):
        AtA, Atb, count, mse_sum = _normal_equations(cloud, valid, assoc, reduction)
        empty = count == 0
        new_fit = torch.where(empty, fitness, count / n_total.clamp(min=1.0))
        new_rmse = torch.where(empty, rmse, torch.sqrt(mse_sum / count.clamp(min=1.0)))
        converged = (
            ((new_fit - fitness).abs() < criteria.relative_fitness)
            & ((new_rmse - rmse).abs() < criteria.relative_rmse)
        )
        new_done = done | empty | converged | (it == max_iter)
        # once done, everything freezes, the scores of the terminating
        # pass included (icp.cpp:162-166)
        fitness = torch.where(done, fitness, new_fit)
        rmse = torch.where(done, rmse, new_rmse)
        if it < max_iter:  # the scoring-only pass updates no pose
            upd = geometry.twist_to_mat4(_solve_damped(AtA, Atb))
            hold = new_done[:, None, None]
            cloud = torch.where(hold, cloud, geometry.transform_points(upd, cloud))
            T = torch.where(hold, T, upd @ T)
        done = new_done
    return RegistrationResult(T, fitness, rmse, n_total), cloud


def pose_information(cloud, valid, query_fn: Union[Callable, Association],
                     robust_delta: float = 0.0, estimation: str = "point_to_plane"):
    """Gauss-Newton information of refined poses: one association and
    reduction pass at the given (already transformed) (..., P, 3) clouds,
    with the solver's rows [p x n, n]. Returns (info (..., 6, 6) = J^T J,
    sigma2 (...) = sum(b^2) / max(n - 6, 1), count (...) = n inliers).
    ``pose_covariance`` turns them into sigma2 * inv(info). The pass needs
    sum(b^2), which is not among the fused kernel's 29 sums: it runs an
    Association's ``query`` (the row gather of ops/gather.py on a card) and
    reduces here, once per refine."""
    if estimation == "point_to_point":
        raise NotImplementedError(
            "pose_information for estimation='point_to_point' is not ported yet (ROADMAP A14)")
    if estimation != "point_to_plane":
        raise ValueError(f"unknown estimation {estimation!r}")
    if float(robust_delta) != 0.0:
        raise NotImplementedError("robust_delta (Huber IRLS) is not ported yet (ROADMAP A14)")
    cloud = torch.as_tensor(cloud, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=cloud.device)
    if isinstance(query_fn, Association):
        query_fn = query_fn.query
    dst, nrm, q_valid = query_fn(cloud)
    v, _diff, b, arow = _weighted_rows(cloud, valid, dst, nrm, q_valid)
    info = arow.transpose(-1, -2) @ arow
    count = v.sum(dim=-1)
    sigma2 = ((b * v) ** 2).sum(dim=-1) / (count - 6.0).clamp(min=1.0)
    return info, sigma2, count


# Calibration of the Laplace covariance for rendered-pipeline measurements
# (the JAX package's constants, icp.py:563-591, and their rationale there):
# the render -> lift -> ICP residuals are quantization-correlated, which the
# curvature underestimates, so the covariance is inflated x9 (x3 std) and
# the residual variance floored at the integer-mm depth quantization plus
# the lateral pixel pitch ~0.29 z / fx at the render intrinsics.
RENDER_COV_INFLATION = 9.0
DEPTH_QUANT_SIGMA_M = 2.9e-4
LATERAL_QUANT_COEFF = 0.29


def pose_covariance(info, sigma2, rel_ridge: float = 1e-6, inflation: float = 1.0,
                    sigma2_floor: float = 0.0):
    """inflation * max(sigma2, sigma2_floor) * inv(info + ridge I) with a
    relative ridge (trace(info)/6 * rel_ridge): unconstrained directions
    come back as large variances, not inf/NaN. Batched over leading axes;
    ``inv_ex`` keeps the singularity check off the host."""
    info = torch.as_tensor(info, dtype=torch.float32)
    scale = info.diagonal(dim1=-2, dim2=-1).sum(dim=-1) / 6.0
    ridge = (scale * rel_ridge).clamp(min=1e-30)
    eye = torch.eye(6, dtype=info.dtype, device=info.device)
    M = info + ridge[..., None, None] * eye
    sigma2 = torch.as_tensor(sigma2, dtype=info.dtype, device=info.device).clamp(min=sigma2_floor)
    inv, _info = torch.linalg.inv_ex(M)
    return (inflation * sigma2)[..., None, None] * inv


def icp_point_to_plane(cloud, valid, query_fn: Union[Callable, Association],
                       criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
                       n_points=None, reduction: str = "matmul",
                       robust_delta: float = 0.0, coarse_iters: int = 0):
    """Refine a (P, 3) cloud, or a (N, P, 3) batch, against a scene.

    query_fn: scene.query - (..., 3) points -> (dst, normal, valid) - or
        an Association of a scene's query and fused reduce.
    n_points: divisor for fitness; defaults to sum(valid).
    reduction: "matmul" or "packed", the formulation of a pass reduced from
        a query (equal up to summation order). It is not consulted for an
        Association on CUDA tensors: its fused kernel computes the packed
        sums for either value.
    Returns (RegistrationResult, transformed cloud), batched like ``cloud``.
    """
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}: expected 'matmul' or 'packed'")
    if float(robust_delta) != 0.0:
        raise NotImplementedError("robust_delta (Huber IRLS) is not ported yet (ROADMAP A14)")
    if int(coarse_iters) != 0:
        raise NotImplementedError("coarse_iters is not ported yet (ROADMAP A14)")
    cloud = torch.as_tensor(cloud, dtype=torch.float32)
    single = cloud.dim() == 2
    if single:
        cloud = cloud[None]
        valid = torch.as_tensor(valid, device=cloud.device)[None]
    res, out = _icp_run(cloud, valid, query_fn, criteria, n_points, reduction)
    if single:
        res = RegistrationResult(*(f[0] for f in res))
        out = out[0]
    return res, out
