"""Batched point-to-plane and point-to-point ICP on the device (PyTorch
port of ``pose_refine_tpu/icp.py``, fused-loop path).

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
runtime with identical results: its ``chunk_iters`` is accepted at JAX's
position and validated as JAX validates it (_check_coarse), with no other
effect. Everything stays float32, as in the JAX
package: the reductions, the solve residual and the pose composition.

One association + reduction pass has two formulations, as in the JAX
package: "matmul" (batched matrix products) and "packed" (the reference's
29-float vector a point, icp.h:125-209, summed in the order of the
iteration kernel). Given a scene's ``Association`` with an ``iterate``
(what pipeline.refine_poses builds for a scene on a card), the whole loop
on CUDA tensors is the iteration kernel of ``ops/icp_reduce.py`` - the
packed pass, the damped solve, the twist, the move and the latch, whatever
``reduction`` says; without one, on any device, a pass is the query and
the chosen formulation, and the solve and update run here in PyTorch. The
association and the count are the same in all of them. "packed" on any
device and the kernel give the same float sums bit for bit; "matmul" differs
from them in the last bits, and an ICP turns last bits into whole iterations
at the hypotheses that do not converge (an association pixel that flips, the
1e-5 latch), so a "matmul" refine and a "packed" one agree closely only
where both converge.

Beyond the reference, as in the JAX package: ``estimation="point_to_point"``
(the residual e = dst - p, three Jacobian rows [-[p]x | I] a point, scene
normals ignored; JAX icp.py:160-213, 318-349) and ``robust_delta`` > 0,
Huber IRLS weights on the plane residual or on |e| (JAX icp.py:102-125).
Both change only the terms of a pass: the iteration kernel computes them
in its two modes, and the scores (count, point-to-point mse) stay
unweighted.

``coarse_iters`` / ``coarse_stride``: the coarse-to-fine point schedule
(JAX icp.py:443-489). The first coarse_iters iterations run on rows 0, cs,
2cs, ... of each anchored cloud with no scores and no latch (a pose with no
inlier holds); then the full cloud is moved by their transform and the
scored loop runs the remaining iterations from zero scores. The fitness
divisor stays the full cloud's. On a card it is the iteration kernel's
coarse mode (a scene's ``iterate``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from pose_refine_tpu_torch import geometry
from pose_refine_tpu_torch.ops.icp_reduce import (
    ICPState,
    huber_weight,
    icp_loop_plain,
    packed_sums_plain,
    unpack_sums,
)

REDUCTIONS = ("matmul", "packed")
ESTIMATIONS = ("point_to_plane", "point_to_point")


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
    -> (dst, normal, valid). ``iterate`` (optional):
    (ICPState, valid, n_total, criteria, robust_delta=0.0,
    point_to_point=False) -> ICPState, the whole loop (``scene.iterate`` /
    ``scene.iterate_at(ids)``: the iteration kernel of ops/icp_reduce.py,
    one launch a refine against a projective scene, an NN launch and an
    iteration launch a pass against an NN scene; or plain_association's
    plain iteration). ``iterate`` also takes coarse_iters and coarse_stride
    (the point schedule: 0 = none).

    The ICP loop runs ``iterate`` when the Association has one; without it,
    ``query`` and the chosen formulation a pass, with the solve and update
    in PyTorch, on any device. pipeline.refine_poses hands a scene's
    ``iterate`` over for a scene on the card only, so on the CPU a scene's
    refine keeps that formulation."""

    query: Callable
    iterate: Optional[Callable] = None


def plain_association(plain_query: Callable) -> Association:
    """The Association of the kernels' plain versions: ``plain_query`` (a
    scene's ``query(plain=True)`` or ``query_at(ids, plain=True)``) and, as
    its iterate, the iteration kernel's plain version over that query
    (ops.icp_reduce.icp_loop_plain). What a kernel path is held against:
    the same function in plain PyTorch, on any device."""
    return Association(
        plain_query,
        lambda state, valid, n_total, criteria, **modes: icp_loop_plain(
            state, valid, n_total, criteria, plain_query, **modes))


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


def _update(AtA, Atb, cloud, T, hold):
    """Where ``hold`` (N,) is false: the damped solve, the twist, the
    clouds' move and T <- upd @ T; where it is true the clouds and T as
    they are. Returns (cloud, T)."""
    upd = geometry.twist_to_mat4(_solve_damped(AtA, Atb))
    hold = hold[:, None, None]
    return (torch.where(hold, cloud, geometry.transform_points(upd, cloud)),
            torch.where(hold, T, upd @ T))


def _check_options(robust_delta, estimation: str) -> float:
    if estimation not in ESTIMATIONS:
        raise ValueError(f"unknown estimation {estimation!r}: expected 'point_to_plane' or "
                         "'point_to_point'")
    return float(robust_delta)


def _weighted_rows(cloud, valid, dst, nrm, q_valid, robust_delta: float = 0.0):
    """Mask, residual, plane residual b, weight w (the mask, Huber-weighted
    when robust_delta > 0) and weighted (..., P, 6) Jacobian rows [p x n, n]
    w (JAX icp.py:113-125). Every reduction multiplies by ``q_valid &
    valid``, which keeps padded rows inert."""
    v = (q_valid & valid).to(cloud.dtype)
    diff = dst - cloud
    b = (diff * nrm).sum(dim=-1)
    w = huber_weight(v, b, robust_delta)
    arow = torch.cat([torch.linalg.cross(cloud, nrm, dim=-1), nrm], dim=-1) * w[..., None]
    return v, diff, b, w, arow


def _p2p_rows(cloud, valid, dst, q_valid, robust_delta: float = 0.0):
    """Mask, residual e = dst - p, weight w (Huber on |e| when robust_delta
    > 0) and the weighted (..., P, 3, 6) Jacobian blocks [-[p]x | I] w (JAX
    icp.py:160-200; n . J is the plane row, so both estimations share the
    twist order and the update)."""
    v = (q_valid & valid).to(cloud.dtype)
    diff = dst - cloud
    w = huber_weight(v, torch.sqrt((diff * diff).sum(dim=-1)), robust_delta)
    px, py, pz = cloud.unbind(dim=-1)
    zero = torch.zeros_like(px)
    negskew = torch.stack([torch.stack([zero, pz, -py], dim=-1),
                           torch.stack([-pz, zero, px], dim=-1),
                           torch.stack([py, -px, zero], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=cloud.dtype, device=cloud.device).expand(negskew.shape)
    J = torch.cat([negskew, eye], dim=-1) * w[..., None, None]
    return v, diff, w, J


def _p2p_equations_from_assoc(cloud, valid, dst, nrm, q_valid, robust_delta: float = 0.0):
    """Point-to-point Gauss-Newton normal equations from an association
    (JAX icp.py:160-205), as batched matrix products: (AtA (..., 6, 6), Atb
    (..., 6), count (...), mse_sum (...)). The scene normals are ignored;
    count and mse are the plane form's."""
    del nrm
    v, diff, w, J = _p2p_rows(cloud, valid, dst, q_valid, robust_delta)
    Jf = J.reshape(J.shape[:-3] + (-1, 6))
    e = (diff * w[..., None]).reshape(Jf.shape[:-1])
    AtA = Jf.transpose(-1, -2) @ Jf
    Atb = (Jf.transpose(-1, -2) @ e[..., None])[..., 0]
    count = v.sum(dim=-1)
    mse_sum = ((diff * diff).sum(dim=-1) * v).sum(dim=-1)
    return AtA, Atb, count, mse_sum


def _p2p_equations(cloud, valid, query_fn: Callable, robust_delta: float = 0.0):
    """One association + point-to-point reduction pass (JAX icp.py:208-213)."""
    return _p2p_equations_from_assoc(cloud, valid, *query_fn(cloud), robust_delta)


def _normal_equations(cloud, valid, assoc: Union[Callable, Association],
                      reduction: str = "matmul", robust_delta: float = 0.0,
                      estimation: str = "point_to_plane"):
    """One association + reduction pass: (AtA (..., 6, 6), Atb (..., 6),
    count (...), mse_sum (...)), the reference's transform_reduce over
    thrust__pcd2Ab (icp.h:128-209). ``assoc`` is an Association (its
    ``query``) or a bare query callable, reduced here as batched matrix
    products ("matmul") or as the 29-float packed vector ("packed"), with
    the terms of ``estimation`` and ``robust_delta``."""
    p2p = estimation == "point_to_point"
    if isinstance(assoc, Association):
        assoc = assoc.query
    dst, nrm, q_valid = assoc(cloud)
    if reduction == "packed":
        return unpack_sums(packed_sums_plain(cloud, valid, dst, nrm, q_valid, robust_delta, p2p))
    if p2p:
        return _p2p_equations_from_assoc(cloud, valid, dst, nrm, q_valid, robust_delta)
    v, diff, b, w, arow = _weighted_rows(cloud, valid, dst, nrm, q_valid, robust_delta)
    AtA = arow.transpose(-1, -2) @ arow
    Atb = (arow.transpose(-1, -2) @ (b * w)[..., None])[..., 0]
    count = v.sum(dim=-1)
    mse_sum = ((diff * diff).sum(dim=-1) * v).sum(dim=-1)
    return AtA, Atb, count, mse_sum


def _check_coarse(coarse_iters, coarse_stride, criteria, chunk_iters=None) -> int:
    """JAX icp.py:441-462's checks of the point schedule; returns the coarse
    iterations (0: none, as for coarse_iters <= 0 in JAX). ``chunk_iters``
    is JAX's early-exit granularity, clipped to [1, max_iteration + 1] as
    JAX clips it: the schedule needs the fused loop, a chunk of the whole
    max_iteration + 1 (ValueError otherwise, JAX's text). It has no other
    effect: the port's loop is one loop of max_iteration + 1 steps with a
    per-pose latch (one launch on a card), never chunks of a while loop.
    None is the fused loop, what PoseRefiner resolves it to under
    coarse_iters."""
    c = int(coarse_iters)
    max_iter = int(criteria.max_iteration)
    total = max_iter + 1
    chunk = total if chunk_iters is None else max(1, min(int(chunk_iters), total))
    if c <= 0:
        return 0
    if chunk < total:
        raise ValueError(
            "coarse_iters > 0 requires a fused loop "
            "(chunk_iters >= max_iteration + 1)"
        )
    if not 0 < c < max_iter:
        raise ValueError(
            f"coarse_iters={c} must leave at least one full-cloud "
            f"iteration before the scoring pass (max_iteration={max_iter})"
        )
    cs = int(coarse_stride)
    if cs < 2:
        raise ValueError(f"coarse_stride={cs} must be >= 2")
    return c


def _icp_start(cloud, valid, n_points=None):
    """The loop's start from a (N, P, 3) cloud batch and (N, P) valid:
    (ICPState of new tensors - the clouds with their padded rows anchored
    to the first valid point, identity transforms, zero scores, nothing
    done -, valid as bool, (N,) fitness divisors: n_points, or each
    cloud's valid count). Anchored rows contribute zero either way (every
    reduction masks by valid); an all-invalid cloud keeps row 0 and hits
    the count == 0 abort."""
    cloud = torch.as_tensor(cloud, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=cloud.device)
    n = cloud.shape[0]
    dev = cloud.device
    first = valid.to(torch.int8).argmax(dim=-1)
    anchor = cloud[torch.arange(n, device=dev), first]
    cloud = torch.where(valid[..., None], cloud, anchor[:, None, :])
    if n_points is None:
        n_total = valid.sum(dim=-1).to(torch.float32)
    else:
        n_total = torch.as_tensor(n_points, dtype=torch.float32, device=dev).expand(n)
    state = ICPState(cloud, torch.eye(4, dtype=torch.float32, device=dev).expand(n, 4, 4).clone(),
                     torch.zeros(n, dtype=torch.float32, device=dev),
                     torch.zeros(n, dtype=torch.float32, device=dev),
                     torch.zeros(n, dtype=torch.bool, device=dev))
    return state, valid, n_total


def _icp_run(cloud, valid, assoc: Union[Callable, Association],
             criteria: ICPConvergenceCriteria, n_points=None, reduction: str = "matmul",
             robust_delta: float = 0.0, estimation: str = "point_to_plane",
             coarse_iters: int = 0, coarse_stride: int = 2, chunk_iters=None):
    """The ICP outer loop over a (N, P, 3) cloud batch with (N, P) valid;
    ``assoc``, ``reduction``, ``robust_delta`` and ``estimation`` as in
    _normal_equations (the JAX package's reduce_fn, icp.py:352-360), and the
    point schedule of coarse_iters / coarse_stride (see the module note),
    checked with ``chunk_iters`` (_check_coarse). An
    Association with an ``iterate`` runs the whole loop through it (the
    iteration kernel, or its plain version); otherwise the loop below
    solves and updates in PyTorch after each pass.

    Returns (RegistrationResult batch, transformed clouds (N, P, 3))."""
    robust_delta = _check_options(robust_delta, estimation)
    c = _check_coarse(coarse_iters, coarse_stride, criteria, chunk_iters)
    state, valid, n_total = _icp_start(cloud, valid, n_points)
    if isinstance(assoc, Association) and assoc.iterate is not None:
        state = assoc.iterate(state, valid, n_total, criteria, robust_delta=robust_delta,
                              point_to_point=estimation == "point_to_point",
                              coarse_iters=c, coarse_stride=int(coarse_stride))
        return RegistrationResult(state.T, state.fitness, state.rmse, n_total), state.cloud
    cloud, T, fitness, rmse, done = state
    if c:
        # the coarse phase (JAX icp.py:465-474): no scores, no latch; a pose
        # with no inlier holds. Then the full cloud moves by its transform
        cs = int(coarse_stride)
        cc, vc = cloud[:, ::cs], valid[:, ::cs]
        for _ in range(c):
            AtA, Atb, count, _mse = _normal_equations(cc, vc, assoc, reduction, robust_delta,
                                                      estimation)
            cc, T = _update(AtA, Atb, cc, T, count == 0)
        cloud = geometry.transform_points(T, cloud)
    max_iter = int(criteria.max_iteration)
    for it in range(c, max_iter + 1):
        AtA, Atb, count, mse_sum = _normal_equations(cloud, valid, assoc, reduction,
                                                     robust_delta, estimation)
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
            cloud, T = _update(AtA, Atb, cloud, T, new_done)
        done = new_done
    return RegistrationResult(T, fitness, rmse, n_total), cloud


def pose_information(cloud, valid, query_fn: Union[Callable, Association],
                     robust_delta: float = 0.0, estimation: str = "point_to_plane"):
    """Gauss-Newton information of refined poses (JAX icp.py:510-560): one
    association and reduction pass at the given (already transformed)
    (..., P, 3) clouds, with the solver's rows - [p x n, n] w, or the
    point-to-point block [-[p]x | I] w. Returns (info (..., 6, 6) = J^T J,
    sigma2 (...), count (...) = n inliers): sigma2 = sum((b w)^2) / max(n -
    6, 1), or sum(|e|^2 w^2) / max(3n - 6, 1) point to point (three
    residual rows a point). ``pose_covariance`` turns them into sigma2 *
    inv(info). The pass needs the residual sum of squares, which is not
    among the iteration kernel's 29 sums: it runs an Association's ``query``
    (the row gather of ops/gather.py on a card) and reduces here, once per
    refine."""
    robust_delta = _check_options(robust_delta, estimation)
    cloud = torch.as_tensor(cloud, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=cloud.device)
    if isinstance(query_fn, Association):
        query_fn = query_fn.query
    dst, nrm, q_valid = query_fn(cloud)
    if estimation == "point_to_point":
        v, diff, w, J = _p2p_rows(cloud, valid, dst, q_valid, robust_delta)
        Jf = J.reshape(J.shape[:-3] + (-1, 6))
        info = Jf.transpose(-1, -2) @ Jf
        count = v.sum(dim=-1)
        rss = ((diff * diff).sum(dim=-1) * (w * w)).sum(dim=-1)
        return info, rss / (3.0 * count - 6.0).clamp(min=1.0), count
    v, _diff, b, w, arow = _weighted_rows(cloud, valid, dst, nrm, q_valid, robust_delta)
    info = arow.transpose(-1, -2) @ arow
    count = v.sum(dim=-1)
    sigma2 = ((b * w) ** 2).sum(dim=-1) / (count - 6.0).clamp(min=1.0)
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


def _icp(cloud, valid, query_fn, criteria, n_points, reduction, chunk_iters, robust_delta,
         coarse_iters, coarse_stride, estimation):
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}: expected 'matmul' or 'packed'")
    cloud = torch.as_tensor(cloud, dtype=torch.float32)
    single = cloud.dim() == 2
    if single:
        cloud = cloud[None]
        valid = torch.as_tensor(valid, device=cloud.device)[None]
    res, out = _icp_run(cloud, valid, query_fn, criteria, n_points, reduction, robust_delta,
                        estimation, coarse_iters, coarse_stride, chunk_iters)
    if single:
        res = RegistrationResult(*(f[0] for f in res))
        out = out[0]
    return res, out


def icp_point_to_plane(cloud, valid, query_fn: Union[Callable, Association],
                       criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
                       n_points=None, reduction: str = "matmul", chunk_iters: int = 8,
                       robust_delta: float = 0.0, coarse_iters: int = 0,
                       coarse_stride: int = 2):
    """Refine a (P, 3) cloud, or a (N, P, 3) batch, against a scene.

    query_fn: scene.query - (..., 3) points -> (dst, normal, valid) - or
        an Association of a scene's query and, optionally, its iterate.
    n_points: divisor for fitness; defaults to sum(valid).
    reduction: "matmul" or "packed", the formulation of a pass reduced from
        a query (equal up to summation order). It is not consulted for an
        Association with an iterate: its iteration kernel computes the
        packed sums for either value.
    chunk_iters: JAX's early-exit granularity, validated as JAX validates
        it (coarse_iters needs chunk_iters >= max_iteration + 1) and
        otherwise without effect: the loop is never chunked (_check_coarse).
    robust_delta: > 0 (meters) Huber-IRLS weights on the plane residual
        with this inlier width; 0 is the reference's least squares. The
        scores stay unweighted.
    coarse_iters, coarse_stride: the coarse-to-fine point schedule (see the
        module note): 0 < coarse_iters < max_iteration, coarse_stride >= 2,
        else ValueError; 0 runs none.
    Returns (RegistrationResult, transformed cloud), batched like ``cloud``.
    """
    return _icp(cloud, valid, query_fn, criteria, n_points, reduction, chunk_iters,
                robust_delta, coarse_iters, coarse_stride, "point_to_plane")


def icp_point_to_point(cloud, valid, query_fn: Union[Callable, Association],
                       criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
                       n_points=None, chunk_iters: int = 8, robust_delta: float = 0.0,
                       coarse_iters: int = 0, coarse_stride: int = 2):
    """Refine with point-to-point Gauss-Newton estimation (JAX
    icp.py:318-349): the loop, scores and options of icp_point_to_plane,
    with the residual e = dst - p (three rows a point, scene normals
    ignored; robust_delta weights on |e|). Pair it with nearest-neighbour
    association: projective association gives ray-aligned residuals, on
    which point-to-point diverges. A pass reduced from a query is the
    matrix-product formulation, as in the JAX package; an Association with
    an iterate takes the iteration kernel's point-to-point mode.
    Returns (RegistrationResult, transformed cloud), batched like ``cloud``.
    """
    return _icp(cloud, valid, query_fn, criteria, n_points, "matmul", chunk_iters,
                robust_delta, coarse_iters, coarse_stride, "point_to_point")


def icp_point_to_plane_batch(clouds, valids, scene,
                             criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
                             chunk_iters: int = 8, robust_delta: float = 0.0):
    """icp_point_to_plane over a pose batch against one shared scene (JAX
    icp.py:619-636): (N, P, 3) clouds and (N, P) valid, each pose's fitness
    divided by its own valid count. CUDA clouds take the scene's iteration
    kernel (``scene.iterate``), CPU clouds its query and the matrix-product
    pass. ``chunk_iters`` is JAX's, checked and without effect, as in
    icp_point_to_plane. Returns (RegistrationResult batch, transformed
    clouds)."""
    clouds = torch.as_tensor(clouds, dtype=torch.float32)
    card = clouds.device.type == "cuda"
    assoc = Association(scene.query, scene.iterate if card else None)
    return icp_point_to_plane(clouds, valids, assoc, criteria, chunk_iters=chunk_iters,
                              robust_delta=robust_delta)
