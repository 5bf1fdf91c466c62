"""A whole ICP iteration of every pose in one launch - the hand-written
CUDA kernel ``csrc/icp_reduce.cu`` (``icp_iterate_kernel``), its wrappers,
and its plain PyTorch version.

The port's own kernel. Its pass, the association lookup and the reduction
to the 29 packed normal-equation sums of every pose, is the counterpart of
the reference's transform_reduce over thrust__pcd2Ab (icp.h:125-209) and of
the JAX package's ``_normal_equations_packed`` (icp.py:215-238) with the
scene query inlined. Per pose, over its P points, with ``v = q_valid &
valid``, ``diff = dst - p``, ``b = diff . n`` and ``a = [p x n, n] * v``:

    sums = sum_p [a_i a_j (21, upper triangle, row-major) | a (b v) (6)
                  | |diff|^2 v | v]                                -> (29,)

in the JAX order (AtA 0..20, Atb 21..26, mse 27, count 28). Two front ends
find ``dst``, ``n`` and ``q_valid``: the projective one projects the point
to a pixel of the scene table (scene/projective.py), the indexed one takes
the NN kernels' index and dist^2 (scene/nn.py: flash or kd). Two modes
change the terms (``packed_terms``): ``robust_delta`` > 0 Huber-weights
them (JAX icp.py:102-125), and ``point_to_point`` takes the three rows
[-[p]x | I] of the point-to-point residual in place of the plane row (JAX
icp.py:160-200); mse and count stay as they are.

The association, and so the count, equals the plain version's exactly. The
other 28 sums are float32 in the kernel's own fixed order (thread, warp
butterfly, warps, the pose's CTAs), which is neither a matrix product's nor
``torch.sum``'s, so they differ from those in their last bits. The plain
pass (``assoc_reduce_plain``) rounds every term and takes every add in that
same order, so the kernel's sums equal it bit for bit.

After the pass, per pose, the kernel runs the scores, the done latch, the
damped 6x6 solve, the Euler twist, the cloud's move and ``T <- upd @ T`` -
the body of JAX ``icp._icp_run``'s ``step`` (icp.py:398-428). Against a
projective scene one launch runs every iteration of a refine (a pose's
CTAs loop until it is done); against an NN scene a launch is one iteration,
between the NN kernel's launches. Its plain version, ``icp_iterate_plain``,
writes each of those operations as one torch call on (N,) tensors in the
kernel's order (no ``torch.linalg``, no matrix product), so a kernel path
equals its plain path bit for bit, as do two launches on equal inputs. The
coarse-to-fine point schedule (JAX icp.py:443-489) is the kernel's coarse
mode: iterations on a strided copy of each cloud without scores or latch,
then the hand-off, which moves the full cloud by the coarse phase's T
(``icp_coarse_plain``, ``handoff_plain``).

How a pose's points split into slabs and threads, and so the order of its
sums, depends on the batch's size (``geometry``). The iteration and its plain
version take an ``order_batch``: a shard of a batch split over devices
(parallel/sharding.py) passes the whole batch's size, and then sums each
pose as the whole batch does on one device.

The ``_cuda`` entry points launch the kernel and raise for CPU tensors;
there is no fallback from the kernel to the plain version, and a kernel that
does not build or launch raises. The ICP loop (icp.py) takes the plain
formulations for CPU tensors itself.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from pose_refine_tpu_torch._build import launch, load_kernels
from pose_refine_tpu_torch.ops.gather import ROW
from pose_refine_tpu_torch.scene import nn_flash

PACKED = 29  # floats per pose: 21 AtA + 6 Atb + mse + count
# jnp.triu_indices(6): the upper triangle of AtA, row-major
_IU, _JU = (list(t) for t in zip(*((i, j) for i in range(6) for j in range(i, 6))))
KERNEL_THREADS = 256  # csrc/icp_reduce.cu kWide: threads a CTA while two CTAs an SM hold the grid
NARROW_THREADS = 128  # csrc/icp_reduce.cu kNarrow: threads a CTA beyond that (four an SM)
MAX_SLABS = 8         # csrc/icp_reduce.cu kMaxSlabs, the portable cluster size
FILL_CTAS = 132       # the H100's SMs: poses are split until as many CTAs run

# launches of the iteration kernel by the _cuda entry points (chip_smoke.py
# resets and reads it to show the main path went through the kernel)
iterate_launches = 0


def huber_weight(v, r, robust_delta: float):
    """The Huber IRLS weight on the residual ``r`` (JAX icp.py:102,
    ``_huber_sqrt_w``), times the mask ``v``: v * sqrt(min(1, delta /
    max(|r|, 1e-12))), one rounded operation a torch call, NaN carried
    through as the kernel carries it. robust_delta <= 0 is no weighting: v
    itself."""
    if robust_delta <= 0.0:
        return v
    delta = torch.tensor(float(robust_delta), dtype=r.dtype, device=r.device)
    return v * torch.sqrt((delta / r.abs().clamp(min=1e-12)).clamp(max=1.0))


def _cross_term(a, b, c, d):
    """a*b - c*d to about one rounding of the result (Kahan's difference of
    products with two fused multiply-adds: the error of c*d is carried
    exactly), as the kernel's ``cross_term``; plainly in float64 (the
    yardstick). Point-to-point rows need it: where the residual lies along
    the point's ray (projective association), p x diff cancels to a few
    rounding errors of its products."""
    if a.dtype == torch.float64:
        return a * b - c * d
    w = c * d
    return nn_flash._fma(a, b, -w) + nn_flash._fma(-c, d, w)


def packed_terms(cloud, valid, dst, nrm, q_valid, robust_delta: float = 0.0,
                 point_to_point: bool = False) -> torch.Tensor:
    """The 29-float vector of every point from a given association, on any
    device and in the clouds' dtype: (..., P, 3) clouds, (..., P) valid, the
    query's (dst, normal, valid) -> (..., P, 29). With ``v = q_valid &
    valid`` and ``w`` = v, or v times the Huber weight (robust_delta > 0) on
    the plane residual b or on |diff| (point_to_point):

    * point to plane (JAX icp.py:113-125): the A row [p x n, n] * w and
      b * w;
    * point to point (JAX icp.py:160-200): J = [-[p]x | I] * w, three rows
      a point, and e = diff * w; the 21 entries of J^T J, each taken over
      the rows in row order, the entries that are zero for every point as
      0, and the 6 of J^T e: (p x diff) w^2 (each cross entry by
      _cross_term) and diff w^2.

    mse and count keep v. One rounded operation a torch call, in the order
    the kernel's body writes them (no fused multiply-add in either), so the
    float32 terms equal the kernel's bit for bit; robust_delta = 0 in plane
    mode is the formulation of before the modes."""
    v = (q_valid & valid).to(cloud.dtype)
    px, py, pz = cloud.unbind(dim=-1)
    dx, dy, dz = (dst - cloud).unbind(dim=-1)
    sq = (dx * dx + dy * dy) + dz * dz
    if point_to_point:
        w = huber_weight(v, torch.sqrt(sq), robust_delta)
        wx, wy, wz = px * w, py * w, pz * w
        ex, ey, ez = dx * w, dy * w, dz * w
        ww, zero = w * w, torch.zeros_like(w)
        ata = [wz * wz + wy * wy, -(wy * wx), -(wz * wx), zero, -(wz * w), wy * w,
               wz * wz + wx * wx, -(wz * wy), wz * w, zero, -(wx * w),
               wy * wy + wx * wx, -(wy * w), wx * w, zero,
               ww, zero, zero, ww, zero, ww]
        atb = [_cross_term(py, dz, pz, dy) * ww, _cross_term(pz, dx, px, dz) * ww,
               _cross_term(px, dy, py, dx) * ww, w * ex, w * ey, w * ez]
    else:
        nx, ny, nz = nrm.unbind(dim=-1)
        b = (dx * nx + dy * ny) + dz * nz
        w = huber_weight(v, b, robust_delta)
        bw = b * w
        row = [(py * nz - pz * ny) * w, (pz * nx - px * nz) * w, (px * ny - py * nx) * w,
               nx * w, ny * w, nz * w]
        ata = [row[i] * row[j] for i, j in zip(_IU, _JU)]
        atb = [r * bw for r in row]
    return torch.stack(ata + atb + [sq * v, v], dim=-1)


def ordered_sum(terms: torch.Tensor, order_batch: Optional[int] = None) -> torch.Tensor:
    """(..., P, 29) terms -> (..., 29) sums in the kernel's order, one
    float add a step: with (slabs, threads) = geometry(poses, P) (poses:
    ``order_batch`` where given, see the module note), a pose's points
    split into that many slabs; in a slab, thread t of ``threads`` adds
    points t, t + threads, ... in rising order; a warp's 32 sums merge by
    halving (the tree of the kernel's butterfly, whose lane l ends with sum
    l); the warps are added in warp order; the slabs in slab order. Float32
    terms give the kernel's float32 sums bit for bit."""
    lead, (p, k) = terms.shape[:-2], terms.shape[-2:]
    terms = terms.reshape(-1, p, k)
    n = terms.shape[0]
    slabs, threads = geometry(order_batch or n, p)
    per_slab = -(-p // slabs)
    total = None
    for s in range(slabs):
        seg = terms[:, s * per_slab:min((s + 1) * per_slab, p)]
        seg = torch.nn.functional.pad(seg, (0, 0, 0, (-seg.shape[1]) % threads))
        seg = seg.reshape(n, -1, threads // 32, 32, k)
        acc = torch.zeros_like(seg[:, 0])
        for step in range(seg.shape[1]):
            acc = acc + seg[:, step]
        for half in (16, 8, 4, 2, 1):
            acc = acc[:, :, :half] + acc[:, :, half:2 * half]
        cta = torch.zeros_like(acc[:, 0, 0])
        for w in range(acc.shape[1]):
            cta = cta + acc[:, w, 0]
        total = cta if total is None else total + cta
    return total.reshape(lead + (k,))


def packed_sums_plain(cloud, valid, dst, nrm, q_valid, robust_delta: float = 0.0,
                      point_to_point: bool = False,
                      order_batch: Optional[int] = None) -> torch.Tensor:
    """The packed formulation from a given association: (..., 29) sums of
    packed_terms over the points, in the kernel's order (ordered_sum)."""
    return ordered_sum(packed_terms(cloud, valid, dst, nrm, q_valid, robust_delta,
                                    point_to_point), order_batch)


def sums_error(sums, cloud, valid, dst, nrm, q_valid, robust_delta: float = 0.0,
               point_to_point: bool = False):
    """How far float32 (..., 29) ``sums`` lie from the float64 sums of the
    same association: (count_equal, worst |sum - sum64| / (sum64 of |terms|)
    over the 28 float sums). A sum that is not finite in float64 (a masked
    point with a non-finite coordinate) must be non-finite in ``sums`` too,
    else the error is inf. The yardstick the tests hold the plain version's
    order to (the kernel's sums equal the plain version's bit for bit)."""
    terms = packed_terms(cloud.double(), valid, dst.double(), nrm.double(), q_valid,
                         robust_delta, point_to_point)
    want, scale = terms.sum(dim=-2), terms.abs().sum(dim=-2)
    count_equal = torch.equal(sums[..., 28].double(), want[..., 28])
    finite = torch.isfinite(want)
    err = (sums.double() - want).abs() / scale.clamp(min=1e-300)
    err = torch.where(finite, err, torch.where(torch.isfinite(sums), torch.inf, 0.0))
    return count_equal, float(err[..., :28].nan_to_num(nan=torch.inf).max())


def assoc_reduce_plain(cloud, valid, query: Callable, robust_delta: float = 0.0,
                       point_to_point: bool = False,
                       order_batch: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's pass on any device: the scene
    query's plain version (``query``: src -> (dst, normal, valid), e.g.
    ``functools.partial(scene.query, plain=True)``) followed by the packed
    formulation, term by term and add by add in the kernel's order: equal
    to the kernel bit for bit. (..., P, 3) clouds -> (..., 29)."""
    return packed_sums_plain(cloud, valid, *query(cloud), robust_delta, point_to_point,
                             order_batch)


@functools.lru_cache(maxsize=None)
def _ata_index(device: torch.device) -> torch.Tensor:
    """(36,) int64 on ``device``: where entry (i, j) of the symmetric AtA
    lies among the 21 packed upper-triangle sums. Cached per device: built
    inside the ICP loop it would cost a host-to-device copy a pass."""
    at = {ij: k for k, ij in enumerate(zip(_IU, _JU))}
    return torch.tensor([at[min(i, j), max(i, j)] for i in range(6) for j in range(6)],
                        device=device)


def unpack_sums(sums: torch.Tensor):
    """(..., 29) packed sums -> (AtA (..., 6, 6) symmetric, Atb (..., 6),
    count (...), mse_sum (...)), as JAX icp.py:236-238 unpacks them: one
    gather, the rest are views."""
    AtA = sums.index_select(-1, _ata_index(sums.device)).reshape(sums.shape[:-1] + (6, 6))
    return AtA, sums[..., 21:27], sums[..., 28], sums[..., 27]


def pack_sums(AtA, Atb, count, mse_sum) -> torch.Tensor:
    """The inverse of unpack_sums: (..., 29) from (AtA, Atb, count, mse_sum)."""
    return torch.cat([AtA[..., _IU, _JU], Atb, mse_sum[..., None], count[..., None]], dim=-1)


def slabs_for(n_poses: int, points: int) -> int:
    """CTAs the kernel gives a pose (its thread block cluster): 1 when the
    poses alone fill the card, else doubled, up to 8, while the CTAs are
    fewer than the SMs and a slab keeps at least one point a thread. A
    function of the shapes alone, so the summation order is too."""
    slabs = 1
    while (slabs < MAX_SLABS and n_poses * slabs < FILL_CTAS
           and points >= 2 * slabs * KERNEL_THREADS):
        slabs *= 2
    return slabs


def geometry(n_poses: int, points: int):
    """(slabs, threads) of the kernel's grid: slabs_for's CTAs a pose, of
    KERNEL_THREADS threads while the grid's CTAs fit two an SM (at most 128
    registers a thread, every CTA resident at once), else of NARROW_THREADS,
    four an SM: a 512-pose launch is then one wave, not two. A function of
    the shapes alone, so the summation order is too."""
    slabs = slabs_for(n_poses, points)
    return slabs, (KERNEL_THREADS if n_poses * slabs <= 2 * FILL_CTAS else NARROW_THREADS)


class ICPState(NamedTuple):
    """The ICP loop's state, batched over N poses: the moved clouds (N, P,
    3), the transforms (N, 4, 4) (row 3 stays [0, 0, 0, 1]), fitness and
    rmse (N,) float32 and the done latch (N,) bool (JAX icp.py:76-82, with
    the iteration counter kept by the caller)."""

    cloud: torch.Tensor
    T: torch.Tensor
    fitness: torch.Tensor
    rmse: torch.Tensor
    done: torch.Tensor


def _cholesky_plain(m):
    """The lower Cholesky factor of a 6x6 matrix of (N,) tensors ``m[i][j]``,
    column by column, one rounded operation a torch call, in the kernel's
    order: d = m_jj - L_j0^2 - ... - L_j,j-1^2, L_jj = sqrt(d), and below it
    L_ij = (m_ij - L_i0 L_j0 - ... - L_i,j-1 L_j,j-1) / L_jj."""
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        d = m[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(d)
        for i in range(j + 1, 6):
            v = m[i][j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v / L[j][j]
    return L


def _cho_solve_plain(L, b):
    """x of L L^T x = b (lists of (N,) tensors): forward, then back
    substitution, each sum in rising k, as the kernel."""
    y = []
    for i in range(6):
        v = b[i]
        for k in range(i):
            v = v - L[i][k] * y[k]
        y.append(v / L[i][i])
    x = [None] * 6
    for i in range(5, -1, -1):
        v = y[i]
        for k in range(i + 1, 6):
            v = v - L[k][i] * x[k]
        x[i] = v / L[i][i]
    return x


def solve_damped_plain(AtA, Atb) -> torch.Tensor:
    """(AtA + 0.01 I) x = Atb in float32 by a Cholesky factor and one
    refinement step from the float32 residual, the stand-in for the
    reference's float64 LDLT (icp.cpp:29-45; JAX icp.py:87-99), written as
    the kernel's tail computes it (no torch.linalg): the damping 0.01, in
    float32, added to the diagonal (csrc/icp_reduce.cu::solve_damped's
    literal); x by the factor; the residual r = b - M x, M x summed over j
    in rising order; x + solve(r). (..., 6, 6), (..., 6) -> (..., 6). A
    pose with no inlier (AtA = 0, Atb = 0) gets x = 0."""
    damping = torch.tensor(0.01, dtype=AtA.dtype, device=AtA.device)
    m = [[AtA[..., i, j] + damping if i == j else AtA[..., i, j] for j in range(6)]
         for i in range(6)]
    b = Atb.unbind(dim=-1)
    L = _cholesky_plain(m)
    x = _cho_solve_plain(L, b)
    r = []
    for i in range(6):
        mx = m[i][0] * x[0]
        for j in range(1, 6):
            mx = mx + m[i][j] * x[j]
        r.append(b[i] - mx)
    return torch.stack([xi + di for xi, di in zip(x, _cho_solve_plain(L, r))], dim=-1)


def _twist_rows(x):
    """The 3x4 rows [R | t] of the update of a twist x (6 (N,) tensors):
    R = Rz(x2) Ry(x1) Rx(x0) by geometry.euler_to_rotation's formulas in
    their order, t = x[3:6]; row-major, 12 (N,) tensors."""
    cx, sx = torch.cos(x[0]), torch.sin(x[0])
    cy, sy = torch.cos(x[1]), torch.sin(x[1])
    cz, sz = torch.cos(x[2]), torch.sin(x[2])
    return [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx, x[3],
            sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx, x[4],
            -sy, cy * sx, cy * cx, x[5]]


def twist_plain(x) -> torch.Tensor:
    """(..., 6) twists [rx, ry, rz, tx, ty, tz] -> (..., 4, 4) updates
    Rz Ry Rx with translation x[3:6] (icp.cpp:7-17), as the kernel's tail
    builds them."""
    u = _twist_rows(x.unbind(dim=-1))
    zero, one = torch.zeros_like(x[..., 0]), torch.ones_like(x[..., 0])
    return torch.stack(u + [zero, zero, zero, one], dim=-1).reshape(x.shape[:-1] + (4, 4))


def transform_plain(u, cloud) -> torch.Tensor:
    """(N, P, 3) clouds moved by the 3x4 rows ``u`` (12 (N,) tensors, see
    _twist_rows): each coordinate ((r0 x + r1 y) + r2 z) + t, as the
    kernel moves a point."""
    px, py, pz = cloud.unbind(dim=-1)
    rows = [[e[:, None] for e in u[4 * i:4 * i + 4]] for i in range(3)]
    return torch.stack([((r[0] * px + r[1] * py) + r[2] * pz) + r[3] for r in rows], dim=-1)


def compose_plain(u, T) -> torch.Tensor:
    """upd @ T of (N, 4, 4) transforms with the update's 3x4 rows ``u``:
    rows 0-2 each entry summed over k in order, ((u_i0 T_0j + u_i1 T_1j) +
    u_i2 T_2j) + u_i3 T_3j; row 3 kept."""
    out = []
    for i in range(3):
        for j in range(4):
            out.append(((u[4 * i] * T[:, 0, j] + u[4 * i + 1] * T[:, 1, j])
                        + u[4 * i + 2] * T[:, 2, j]) + u[4 * i + 3] * T[:, 3, j])
    return torch.cat([torch.stack(out, dim=-1).reshape(-1, 3, 4), T[:, 3:]], dim=1)


def _update_plain(AtA, Atb, cloud, T, hold):
    """Where ``hold`` (N,) is false: the damped solve, the twist, the move
    and T <- upd @ T, as the kernel's update_tail and move compute them;
    where it is true the cloud and T as they are. Returns (cloud, T)."""
    u = _twist_rows(solve_damped_plain(AtA, Atb).unbind(dim=-1))
    hold = hold[:, None, None]
    return (torch.where(hold, cloud, transform_plain(u, cloud)),
            torch.where(hold, T, compose_plain(u, T)))


def icp_iterate_plain(state: ICPState, valid, n_total, query: Callable, it: int,
                      max_iteration: int, relative_fitness: float, relative_rmse: float,
                      robust_delta: float = 0.0, point_to_point: bool = False,
                      order_batch: Optional[int] = None) -> ICPState:
    """One ICP iteration of every pose, the plain version of the kernel's
    (JAX icp.py:398-428): the pass's sums (assoc_reduce_plain over the
    plain ``query``), the scores, the latch ``done | empty | converged |
    it == max_iteration`` (fitness and rmse take the new values where the
    old done is false), then, where the new done is false, the damped
    solve, the twist, the cloud's move and T <- upd @ T. The thresholds are
    float32, as torch compares a float32 tensor with a Python float. On any
    device; (N,) n_total is the fitness divisor. Returns the new state."""
    sums = assoc_reduce_plain(state.cloud, valid, query, robust_delta, point_to_point,
                              order_batch)
    AtA, Atb, count, mse_sum = unpack_sums(sums)
    fitness, rmse, done = state.fitness, state.rmse, state.done
    empty = count == 0
    new_fit = torch.where(empty, fitness, count / n_total.clamp(min=1.0))
    new_rmse = torch.where(empty, rmse, torch.sqrt(mse_sum / count.clamp(min=1.0)))
    rf, rr = (torch.tensor(t, dtype=torch.float32, device=count.device)
              for t in (relative_fitness, relative_rmse))
    converged = ((new_fit - fitness).abs() < rf) & ((new_rmse - rmse).abs() < rr)
    new_done = done | empty | converged | (it == max_iteration)
    fitness = torch.where(done, fitness, new_fit)
    rmse = torch.where(done, rmse, new_rmse)
    cloud, T = state.cloud, state.T
    if it < max_iteration:  # the scoring-only pass moves no pose
        cloud, T = _update_plain(AtA, Atb, cloud, T, new_done)
    return ICPState(cloud, T, fitness, rmse, new_done)


def coarse_start(state: ICPState, valid, coarse_stride: int):
    """The coarse phase's input: rows 0, cs, 2cs, ... of the (N, P, 3)
    anchored clouds as a contiguous copy, beside the state's T, scores and
    latch (the same tensors), and valid's rows alike. Returns (ICPState,
    valid)."""
    cs = int(coarse_stride)
    return (state._replace(cloud=state.cloud[:, ::cs].contiguous()),
            valid[:, ::cs].contiguous())


def icp_coarse_plain(cloud, T, valid, query: Callable, iters: int, robust_delta: float = 0.0,
                     point_to_point: bool = False, order_batch: Optional[int] = None):
    """The coarse phase, plain version of the kernel's coarse mode (JAX
    icp.py:465-474): ``iters`` iterations of the strided (N, Pc, 3) clouds
    with their valid rows - the pass's sums, then, where the count is not
    0, the damped solve, the twist, the move and T <- upd @ T as
    icp_iterate_plain computes them; no scores, no latch, and a pose with
    no inlier holds. Returns (clouds, T)."""
    for _ in range(int(iters)):
        AtA, Atb, count, _mse = unpack_sums(
            assoc_reduce_plain(cloud, valid, query, robust_delta, point_to_point, order_batch))
        cloud, T = _update_plain(AtA, Atb, cloud, T, count == 0)
    return cloud, T


def handoff_plain(T, cloud) -> torch.Tensor:
    """The hand-off (JAX icp.py:476-484): the (N, P, 3) full clouds the
    coarse phase's copy was cut from, moved by its (N, 4, 4) T, each
    coordinate ((T_i0 x + T_i1 y) + T_i2 z) + T_i3 (transform_plain), as
    the kernel's last coarse launch moves them."""
    return transform_plain([T[:, i, j] for i in range(3) for j in range(4)], cloud)


def icp_loop_plain(state: ICPState, valid, n_total, criteria, query: Callable,
                   robust_delta: float = 0.0, point_to_point: bool = False,
                   coarse_iters: int = 0, coarse_stride: int = 2,
                   order_batch: Optional[int] = None) -> ICPState:
    """Every iteration of a refine, 0 to criteria.max_iteration (the last
    one scoring only), through icp_iterate_plain: what the kernel path of
    a scene's ``iterate`` computes. coarse_iters > 0 runs the first
    coarse_iters iterations as the coarse phase (icp_coarse_plain on
    coarse_start's copy, then handoff_plain) and the rest from the state's
    zero scores, as JAX icp.py:476-484 does."""
    max_iter = int(criteria.max_iteration)
    it0 = int(coarse_iters)
    if it0:
        cstate, cvalid = coarse_start(state, valid, coarse_stride)
        _cloud, T = icp_coarse_plain(cstate.cloud, state.T, cvalid, query, it0, robust_delta,
                                     point_to_point, order_batch)
        state = state._replace(cloud=handoff_plain(T, state.cloud), T=T)
    for it in range(it0, max_iter + 1):
        state = icp_iterate_plain(state, valid, n_total, query, it, max_iter,
                                  criteria.relative_fitness, criteria.relative_rmse,
                                  robust_delta, point_to_point, order_batch)
    return state


def _check_front(cloud, valid, table, *, K=None, gate=None, base=None, height=0, width=0,
                 idx=None, dist_sq=None) -> int:
    """The kernel's argument checks (device, dtype, shape, alignment) for
    (..., P, 3) clouds against an (R, 8) table, by the projective front end
    (``idx`` None) or the indexed one; raises ValueError on what it cannot
    launch. Returns the number of poses."""
    dev = cloud.device
    if dev.type != "cuda":
        raise ValueError(f"the icp_iterate kernel needs CUDA tensors, got {dev}")
    if cloud.dim() < 2 or cloud.shape[-1] != 3 or cloud.shape[-2] == 0:
        raise ValueError(f"cloud must be (..., P, 3) with P > 0, got {tuple(cloud.shape)}")
    points = cloud.shape[-2]
    if valid.shape != cloud.shape[:-1]:
        raise ValueError(f"valid must be {tuple(cloud.shape[:-1])}, got {tuple(valid.shape)}")
    if table.dim() != 2 or table.shape[1] != ROW or table.shape[0] == 0:
        raise ValueError(f"table must be (R, {ROW}) with R > 0, got {tuple(table.shape)}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be contiguous and 16-byte aligned")
    n_poses = cloud.numel() // (3 * points)
    if idx is None:
        if tuple(K.shape) != (3, 3) or gate.dim() != 0 or height <= 0 or width <= 0:
            raise ValueError(f"the projective front end wants K (3, 3), a 0-d gate and a frame "
                             f"size, got {tuple(K.shape)}, {tuple(gate.shape)}, "
                             f"{height}x{width}")
        inputs = {"K": (K, torch.float32), "gate": (gate, torch.float32)}
        if base is not None:
            if base.numel() != n_poses:
                raise ValueError(f"base must hold one row offset per pose ({n_poses}), got "
                                 f"{tuple(base.shape)}")
            inputs["base"] = (base, torch.int64)
    else:
        if idx.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"idx must be int32 or int64, got {idx.dtype}")
        if idx.shape != cloud.shape[:-1] or dist_sq.shape != cloud.shape[:-1]:
            raise ValueError(f"idx and dist_sq must be {tuple(cloud.shape[:-1])}, got "
                             f"{tuple(idx.shape)} and {tuple(dist_sq.shape)}")
        inputs = {"idx": (idx, idx.dtype), "dist_sq": (dist_sq, torch.float32)}
    for name, (t, dtype) in {"cloud": (cloud, torch.float32), "valid": (valid, torch.bool),
                             "table": (table, torch.float32), **inputs}.items():
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} on {t.device}")
    if n_poses * MAX_SLABS >= 2 ** 31 or points >= 2 ** 31:
        raise ValueError(f"too large for one launch: {n_poses} poses of {points} points")
    return n_poses


def _front_pointers(K, gate, base, idx, dist_sq):
    """((K, gate, base), (idx, idx bytes, dist_sq)) pointers of the C
    interface for one front end (None where it takes none), and the
    contiguous tensors behind them, which the caller keeps until the
    launch."""
    if idx is None:
        keep = [K.contiguous(), gate.contiguous(), None if base is None else base.contiguous()]
        ptrs = [None if t is None else t.data_ptr() for t in keep]
        return ptrs, [None, 0, None], keep
    keep = [idx.contiguous(), dist_sq.contiguous()]
    return [None, None, None], [keep[0].data_ptr(), idx.element_size(), keep[1].data_ptr()], keep


class _IterateLaunch:
    """The iteration kernel bound to one refine: the argument checks and the
    state's buffers once, then a launch a call. ``state`` (an ICPState of
    (N, P, 3) clouds) is updated in place on the card; ``self.state`` is
    what the launches update (the caller's tensors, or contiguous copies of
    them). The indexed front end takes a new (idx, dist_sq) each call, of
    the first call's shape and dtype (the NN kernels' outputs).
    ``coarse`` runs the coarse mode (state.cloud the strided copy; its
    scores and latch are not touched); ``handoff``, the (N, P, 3) full
    clouds, is moved by T after the launch that a call asks it of."""

    def __init__(self, state: ICPState, valid, n_total, criteria, table, *, K=None, gate=None,
                 base=None, height=0, width=0, idx=None, dist_sq=None, gate_sq=0.0,
                 robust_delta=0.0, point_to_point=False, coarse=False, handoff=None,
                 order_batch=None):
        cloud = state.cloud
        if cloud.dim() != 3:
            raise ValueError(f"the iteration kernel wants (N, P, 3) clouds, got "
                             f"{tuple(cloud.shape)}")
        n_poses = _check_front(cloud, valid, table, K=K, gate=gate, base=base, height=height,
                               width=width, idx=idx, dist_sq=dist_sq)
        dev = cloud.device
        for name, t, shape, dtype in (("T", state.T, (n_poses, 4, 4), torch.float32),
                                      ("fitness", state.fitness, (n_poses,), torch.float32),
                                      ("rmse", state.rmse, (n_poses,), torch.float32),
                                      ("done", state.done, (n_poses,), torch.bool),
                                      ("n_total", n_total, (n_poses,), torch.float32)):
            if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
                raise ValueError(f"{name} must be {shape} {dtype} on {dev}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if handoff is not None and (
                not coarse or handoff.dim() != 3 or handoff.shape[0] != n_poses
                or handoff.shape[2] != 3 or handoff.dtype != torch.float32
                or handoff.device != dev or not handoff.is_contiguous()):
            raise ValueError(f"handoff must be a contiguous (N, P, 3) float32 tensor on {dev} "
                             f"beside a coarse state, got {tuple(handoff.shape)} "
                             f"{handoff.dtype} on {handoff.device}")
        self.lib, _info = load_kernels()
        self.state = ICPState(*(t.contiguous() for t in state))
        self.handoff = handoff
        self.max_iteration = int(criteria.max_iteration)
        self.dev = dev
        self.indexed = idx is not None
        proj_ptrs, idx_ptrs, front = _front_pointers(K, gate, base, idx, dist_sq)
        # the tensors behind the pointers live as long as the launcher
        self._keep = (valid.contiguous(), n_total.contiguous(), table, front)
        points = cloud.shape[-2]
        st = self.state
        # the C interface's arguments but the stream; [13] idx and [15]
        # dist_sq, [24] it0, [25] it_end and [30] the hand-off change from
        # launch to launch
        self.args = [st.cloud.data_ptr(), self._keep[0].data_ptr(), n_poses, points,
                     table.data_ptr(), table.shape[0], *geometry(order_batch or n_poses, points),
                     *proj_ptrs,
                     int(height), int(width), *idx_ptrs, float(gate_sq), float(robust_delta),
                     int(bool(point_to_point)), st.T.data_ptr(), st.fitness.data_ptr(),
                     st.rmse.data_ptr(), st.done.data_ptr(), self._keep[1].data_ptr(), 0, 0,
                     self.max_iteration, float(criteria.relative_fitness),
                     float(criteria.relative_rmse), int(bool(coarse)), None,
                     0 if handoff is None else handoff.shape[1]]

    def __call__(self, it0: int, it_end: int, idx=None, dist_sq=None,
                 handoff: bool = False) -> ICPState:
        """Iterations it0 .. it_end - 1 on the current stream, without
        synchronising; the indexed front end with this iteration's NN
        output; ``handoff`` moves the bound full clouds by T after them."""
        global iterate_launches
        args = self.args
        if self.indexed:
            args[13], args[15] = idx.data_ptr(), dist_sq.data_ptr()
        if handoff and self.handoff is None:
            raise ValueError("this launcher was bound without a hand-off cloud")
        args[24], args[25] = it0, it_end
        args[30] = self.handoff.data_ptr() if handoff else None
        launch(self.lib, "prt_icp_iterate", self.dev, args, "icp_iterate")
        iterate_launches += 1
        return self.state


def icp_iterate_projective_cuda(state: ICPState, valid, n_total, criteria, table, K,
                                max_dist_diff, height: int, width: int, base=None,
                                robust_delta: float = 0.0, point_to_point: bool = False,
                                coarse_iters: int = 0, coarse_stride: int = 2,
                                order_batch: Optional[int] = None) -> ICPState:
    """A refine's whole ICP loop against a projective scene in ONE launch of
    the iteration kernel: iterations 0 .. criteria.max_iteration of every
    pose of ``state`` (CUDA tensors, updated in place and returned) against
    the (R, 8) scene table of ``height`` x ``width`` frames, K (3, 3) and the
    0-d gate ``max_dist_diff`` on the device (the kernel reads them there),
    ``base`` an int64 row offset per pose for stacked frames, robust_delta
    and point_to_point the terms (see packed_terms); ``n_total`` (N,) the
    fitness divisors. coarse_iters > 0 adds one launch before it: the
    coarse phase on coarse_start's copy and the hand-off of the full clouds;
    the ordinary launch then runs iterations coarse_iters ..
    max_iteration. Raises for CPU tensors; its plain version is
    icp_loop_plain over the scene's plain query."""
    state = ICPState(*(t.contiguous() for t in state))
    front = dict(K=K, gate=max_dist_diff, base=base, height=int(height), width=int(width),
                 robust_delta=robust_delta, point_to_point=point_to_point,
                 order_batch=order_batch)
    it0 = int(coarse_iters)
    if it0:
        cstate, cvalid = coarse_start(state, valid, coarse_stride)
        _IterateLaunch(cstate, cvalid, n_total, criteria, table, coarse=True,
                       handoff=state.cloud, **front)(0, it0, handoff=True)
    run = _IterateLaunch(state, valid, n_total, criteria, table, **front)
    return run(it0, run.max_iteration + 1)


def icp_iterate_indexed_cuda(state: ICPState, valid, n_total, criteria, table,
                             nearest: Callable, gate_sq: float, robust_delta: float = 0.0,
                             point_to_point: bool = False, coarse_iters: int = 0,
                             coarse_stride: int = 2,
                             coarse_nearest: Optional[Callable] = None,
                             order_batch: Optional[int] = None) -> ICPState:
    """A refine's ICP loop against an NN scene: each iteration one NN launch
    (``nearest``: (N, P, 3) clouds -> (idx, dist_sq), flash or kd) on the
    moved cloud, then one launch of the iteration kernel with the indexed
    front end (the (N, P) int32 or int64 ``idx``, clamped into the table,
    and dist_sq, valid where dist_sq < gate_sq); the state (CUDA tensors,
    updated in place and returned) stays on the card between them, and the
    checks run once. coarse_iters > 0 runs the first coarse_iters
    iterations the same way on coarse_start's copy (``coarse_nearest``,
    default ``nearest``, takes its shape) in the kernel's coarse mode, the
    last of them handing the full clouds off. Raises for CPU tensors; its
    plain version is icp_loop_plain over the scene's plain query."""
    state = ICPState(*(t.contiguous() for t in state))
    modes = dict(gate_sq=gate_sq, robust_delta=robust_delta, point_to_point=point_to_point,
                 order_batch=order_batch)
    it0 = int(coarse_iters)
    if it0:
        near = nearest if coarse_nearest is None else coarse_nearest
        cstate, cvalid = coarse_start(state, valid, coarse_stride)
        idx, dist_sq = near(cstate.cloud)
        run = _IterateLaunch(cstate, cvalid, n_total, criteria, table, idx=idx, dist_sq=dist_sq,
                             coarse=True, handoff=state.cloud, **modes)
        for it in range(it0):
            if it:
                idx, dist_sq = near(run.state.cloud)
            run(it, it + 1, idx, dist_sq, handoff=it == it0 - 1)
    idx, dist_sq = nearest(state.cloud)
    run = _IterateLaunch(state, valid, n_total, criteria, table, idx=idx, dist_sq=dist_sq,
                         **modes)
    for it in range(it0, run.max_iteration + 1):
        if it > it0:
            idx, dist_sq = nearest(run.state.cloud)
        run(it, it + 1, idx, dist_sq)
    return run.state


def sin_cos_cuda(x: torch.Tensor):
    """(sinf(x), cosf(x)) of a (n,) float32 CUDA tensor by the iteration
    kernel's own trigonometry (a check of it against torch.sin / torch.cos
    on the card, chip_smoke.py [icp-iterate]); not counted. Raises for CPU
    tensors."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"sin_cos_cuda wants a (n,) float32 CUDA tensor, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    x = x.contiguous()
    s, c = torch.empty_like(x), torch.empty_like(x)
    launch(load_kernels()[0], "prt_sin_cos", x.device,
           (x.data_ptr(), x.numel(), s.data_ptr(), c.data_ptr()), "sin_cos")
    return s, c
