"""A whole ICP iteration as the kernel computes it (ops/icp_reduce.py:
``icp_iterate_plain``, kernel ``csrc/icp_reduce.cu::icp_iterate_kernel``) on
the CPU: the damped solve against the JAX package's ``_solve_damped``, the
twist against ``twist_to_mat4``, and the plain-iteration refine against
JAX's ``_icp_run`` (its packed reduction, or its point-to-point one) and
against the port's own CPU loop, on the same numpy inputs. The compiled
kernel's gate is the ``cuda``-marked cases of tests/test_torch_device.py and
chip_smoke.py's ``[icp-iterate]``, which hold it equal to this plain
version bit for bit."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu.ops.rasterize as JR
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import icp as jicp
from pose_refine_tpu import mesh
from pose_refine_tpu.ops import depth_to_cloud as jd2c
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu.scene import projective as jproj
from pose_refine_tpu_torch import icp as ticp
from pose_refine_tpu_torch.ops import icp_reduce as IR
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.scene import projective as tproj
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 160, 120
# the solve against JAX's: |x - x_jax| <= SOLVE_RTOL * max|x_jax| (both
# float32 Cholesky + one refinement step, in different orders). It holds
# for the systems of an ICP pass (cond ~2e3); at cond ~4e4 two float32
# solvers differ by up to ~cond * 2^-24 (JAX's own lies 3e-6 - 1e-4 from
# float64 there), so a badly conditioned system is held to that bound
SOLVE_RTOL = 2e-6
TWIST_ATOL = 2e-7
# a refine through the plain iteration against JAX's _icp_run: the
# whole-slice residue of summation-order ULPs on the near starts (ROADMAP
# C, "Summation order"), verdicts on every start and the far starts within
# FAR_ATOL of the transform (tests/test_torch_icp_reduce.py's bars). On the
# kd NN scene near-tie neighbours turn the ULPs into 0.02-0.03 mm, for the
# port's own CPU loop against JAX alike, so the NN scene's near starts are
# held to NEAR_M_NN; test_kd_near_starts_split_at_near_ties shows both:
NEAR_DEG, NEAR_M, NEAR_M_NN, MAX_DFIT, FAR_ATOL = 0.02, 0.004e-3, 0.03e-3, 5e-3, 2e-3
N_NEAR = 4
# near start 2: the port's CPU loop itself lands more than NEAR_M from JAX
KD_CPU_LOOP_OFF_JAX = 2
# near start 1: the plain iteration and the port's CPU loop associate alike
# until iteration 4, where point 943 lies 2.426486 mm from scene rows 498
# and 497, 2 nm apart, and the two loops' clouds, a few float32 ULPs apart
# after four solves in different orders, pick different rows
KD_TIE_START, KD_TIE_ITER, KD_TIE_POINT, KD_TIE_ROWS = 1, 4, 943, (498, 497)


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def spd_system(rng, n_points=2048, cond=None):
    """(AtA, Atb) of a point-to-plane pass over n_points random points on a
    patch at 0.3 m; ``cond`` squeezes the patch to a sliver so the system
    is badly conditioned (the rotation about its axis is barely seen)."""
    p = rng.normal(size=(n_points, 3)) * [0.04, 0.04 if cond is None else 0.04 / cond, 0.01]
    p = (p + [0, 0, 0.3]).astype(np.float32)
    n = rng.normal(size=(n_points, 3)) * [0.2, 0.2, 1.0]
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    b = rng.normal(0, 0.002, n_points).astype(np.float32)
    a = np.concatenate([np.cross(p, n), n], axis=1)
    return (a.T @ a).astype(np.float32), (a.T @ b).astype(np.float32)


@pytest.mark.parametrize("case", ["spd-0", "spd-1", "spd-2", "empty", "ill-0", "ill-1"])
def test_solve_damped_plain_matches_jax(case):
    """solve_damped_plain against JAX _solve_damped: seeded point-to-plane
    systems to SOLVE_RTOL of x; a pass with no inlier (M = 0.01 I, Atb = 0)
    to x = 0 exactly; badly conditioned slivers (cond > 4e4), where both
    solvers lie within cond * 2^-24 of the float64 solution (the forward
    error a backward-stable float32 solve allows) and so of each other."""
    kind, seed = case.split("-") if "-" in case else (case, "0")
    rng = np.random.default_rng(int(seed))
    if kind == "empty":
        AtA, Atb = np.zeros((6, 6), np.float32), np.zeros(6, np.float32)
    else:
        AtA, Atb = spd_system(rng, cond=30.0 if kind == "ill" else None)
    want = np.asarray(jicp._solve_damped(jnp.asarray(AtA), jnp.asarray(Atb)))
    got = IR.solve_damped_plain(torch.as_tensor(AtA)[None], torch.as_tensor(Atb)[None])[0]
    got = got.numpy()
    if kind == "empty":
        assert (got == 0).all() and (want == 0).all()
        return
    M = AtA.astype(np.float64) + 0.01 * np.eye(6)
    x64 = np.linalg.solve(M, Atb.astype(np.float64))
    cond = np.linalg.cond(M)
    if kind == "spd":
        assert cond < 3e3
        assert np.abs(got - want).max() <= SOLVE_RTOL * np.abs(want).max()
        return
    assert cond > 4e4
    bound = cond * 2.0 ** -24 * np.abs(x64).max()
    assert np.abs(got - x64).max() <= bound and np.abs(want - x64).max() <= bound
    assert np.abs(got - want).max() <= 2 * bound


def test_solve_damped_plain_is_batched():
    """Leading axes are kept, and each system's x equals the one solved
    alone bit for bit (every operation is elementwise over the batch)."""
    rng = np.random.default_rng(3)
    systems = [spd_system(rng, n_points=300) for _ in range(6)]
    AtA = torch.as_tensor(np.stack([s[0] for s in systems])).reshape(2, 3, 6, 6)
    Atb = torch.as_tensor(np.stack([s[1] for s in systems])).reshape(2, 3, 6)
    x = IR.solve_damped_plain(AtA, Atb)
    assert x.shape == (2, 3, 6)
    alone = IR.solve_damped_plain(AtA[1, 2][None], Atb[1, 2][None])[0]
    assert torch.equal(x[1, 2], alone)


def test_twist_plain_matches_jax():
    """twist_plain against JAX twist_to_mat4 to TWIST_ATOL: small ICP
    steps, zero, and angles up to +-pi; row 3 is [0, 0, 0, 1]."""
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(0, 0.02, (40, 6)), rng.uniform(-np.pi, np.pi, (20, 6)),
                        np.zeros((1, 6))]).astype(np.float32)
    want = np.asarray(jgeo.twist_to_mat4(jnp.asarray(x)))
    got = IR.twist_plain(torch.as_tensor(x)).numpy()
    assert got.shape == (61, 4, 4)
    assert np.abs(got - want).max() <= TWIST_ATOL
    assert (got[:, 3] == [0, 0, 0, 1]).all()
    assert (got[-1] == np.eye(4, dtype=np.float32)).all()


def test_transform_and_compose_plain():
    """transform_plain and compose_plain against float64 products of the
    same update (float32 rounding apart), row 3 of T kept exactly."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(0, 0.05, (5, 6)).astype(np.float32))
    u = IR._twist_rows(x.unbind(dim=-1))
    upd = IR.twist_plain(x).double()
    cloud = torch.as_tensor((rng.normal(size=(5, 70, 3)) * 0.05 + [0, 0, 0.3]).astype(np.float32))
    want = cloud.double() @ upd[:, :3, :3].transpose(1, 2) + upd[:, None, :3, 3]
    torch.testing.assert_close(IR.transform_plain(u, cloud).double(), want, rtol=0, atol=2e-7)
    T = IR.twist_plain(torch.as_tensor(rng.normal(0, 0.3, (5, 6)).astype(np.float32)))
    got = IR.compose_plain(u, T)
    torch.testing.assert_close(got.double(), upd @ T.double(), rtol=0, atol=4e-7)
    assert torch.equal(got[:, 3], T[:, 3])


@pytest.fixture(scope="module")
def clouds_and_scene():
    """tests/test_torch_icp_reduce.py's workload: a bumpy sphere's scene at
    the demo's perturbed pose and seven source clouds lifted by the JAX
    window lift + compaction (four starts near the scene's pose, three far
    ones), with the true cloud -> scene transforms in meters; plus the
    depth frames (the first start's render and the scene)."""
    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    K = small_K()
    proj = jgeo.compute_proj(K, W, H)
    R_ren = np.array(
        [[0.34768538, 0.93761126, 0.0],
         [0.70540612, -0.26157897, -0.65877056],
         [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    ang = np.float32(10.0 / 180.0 * 3.14)
    rot = np.asarray(jgeo.euler_to_rotation(np.array([ang, ang, ang])))
    pose1 = np.asarray(jgeo.pose_from_Rt(R_ren, np.array([0, 0, 300], np.float32)))
    pose2 = np.asarray(jgeo.pose_from_Rt(rot @ R_ren, np.array([20, 20, 320], np.float32)))
    rng = np.random.default_rng(5)

    def jitter(pose, rad, mm):
        d = np.asarray(jgeo.euler_to_rotation(rng.uniform(-rad, rad, 3).astype(np.float32)))
        return np.asarray(jgeo.pose_from_Rt(
            d @ pose[:3, :3], pose[:3, 3] + rng.uniform(-mm, mm, 3).astype(np.float32)))

    far = [pose1, jitter(pose1, 0.05, 5), jitter(pose1, 0.05, 5)]
    starts = [jitter(pose2, 0.03, 3) for _ in range(N_NEAR)] + far
    depth = np.asarray(JR.rasterize_dense(m.tris, np.stack(starts + [pose2]), W, H, proj))
    clouds, valids, _ = jd2c.window_cloud_batched(depth[:-1], K, window=96, stride=1)
    clouds, valids, _ = zip(*(jd2c.compact_topk(c, v, 2048) for c, v in zip(clouds, valids)))

    def meters(pose):
        out = pose.astype(np.float64).copy()
        out[:3, 3] /= 1000.0
        return out

    truths = np.stack([meters(pose2) @ np.linalg.inv(meters(s)) for s in starts])
    return np.stack(clouds), np.stack(valids), np.stack([depth[0], depth[-1]]), K, truths


def verdicts(T, truths):
    """rotation < 3 deg and translation < 8 mm of the truth (a pixel of
    the 160x120 frame is 2 mm at the object)."""
    return ((rotation_angle_deg(T, truths) < 3.0)
            & (np.linalg.norm(T[:, :3, 3] - truths[:, :3, 3], axis=-1) < 8e-3))


GATE = 0.1
NN_GATE = 0.02
CASES = {  # scene, (robust_delta, point_to_point)
    "projective": ("projective", (0.0, False)),
    "projective-huber": ("projective", (0.004, False)),
    "stacked": ("stacked", (0.0, False)),
    "kd": ("kd", (0.0, False)),
    "kd-p2p": ("kd", (0.0, True)),
    "kd-huber": ("kd", (0.004, False)),
}


def scenes(kind, frames, K):
    """(plain port query bound to the batch, JAX query per pose) for one
    scene kind; the stacked scene holds [the first start's frame, the
    scene] and routes every pose but the last to the scene."""
    n = N_NEAR + 3
    if kind == "projective":
        t = tproj.SceneProjective.from_depth(frames[1], K, GATE, device="cpu")
        j = jproj.SceneProjective.from_depth(frames[1], K, GATE)
        return functools.partial(t.query, plain=True), [j.query] * n
    if kind == "stacked":
        ids = np.ones(n, np.int32)
        ids[-1] = 0
        t = tproj.SceneProjectiveStack.from_depths(frames, K, GATE, device="cpu")
        j = jproj.SceneProjectiveStack.from_depths(frames, K, GATE)
        return t.query_at(torch.as_tensor(ids), plain=True), [j.query_at(int(i)) for i in ids]
    t = tnn.SceneNN.from_depth(frames[1], K, NN_GATE, backend="kdtree", device="cpu")
    j = jnn.SceneNN.from_depth(frames[1], K, NN_GATE, backend="kdtree")
    return functools.partial(t.query, plain=True), [j.query] * n


def plain_refine(clouds, valids, plain_query, crit, modes):
    """The ICP of every cloud through plain_association's iterate (the
    kernel's plain iteration): (T (N, 4, 4), fitness (N,)) in numpy."""
    res, _cloud = ticp._icp_run(torch.as_tensor(clouds), torch.as_tensor(valids),
                                ticp.plain_association(plain_query), crit,
                                robust_delta=modes[0],
                                estimation="point_to_point" if modes[1] else "point_to_plane")
    return res.transformation.numpy(), res.fitness.numpy()


def hold(T, fit, T_ref, fit_ref, truths, case):
    """Verdicts equal on every start (the near starts recover, but point
    to point, which slides no rotation in 30 iterations, in either
    package); near starts within NEAR_DEG and NEAR_M (NEAR_M_NN on the NN
    scene), far ones within FAR_ATOL; fitness within MAX_DFIT."""
    kind, (_delta, p2p) = CASES[case]
    ok = verdicts(T, truths)
    assert (ok == verdicts(T_ref, truths)).all(), case
    near, far = slice(0, N_NEAR), slice(N_NEAR, None)
    assert ok[near].all() != p2p, case
    assert rotation_angle_deg(T[near], T_ref[near]).max() <= NEAR_DEG, case
    near_m = NEAR_M_NN if kind == "kd" else NEAR_M
    assert np.abs(T[near, :3, 3] - T_ref[near, :3, 3]).max() <= near_m, case
    np.testing.assert_allclose(T[far], T_ref[far], rtol=0, atol=FAR_ATOL, err_msg=case)
    assert np.abs(fit - fit_ref).max() <= MAX_DFIT, case


@pytest.mark.parametrize("case", list(CASES))
def test_plain_iteration_refine_matches_jax(clouds_and_scene, case):
    """A refine through the plain iteration against JAX _icp_run with its
    packed reduction (_normal_equations_packed; point to point: its
    _p2p_equations), 30 iterations: verdicts agree on every start, and the
    converging starts land within NEAR_DEG / NEAR_M and MAX_DFIT of
    fitness (the whole-slice residue ROADMAP C records)."""
    clouds, valids, frames, K, truths = clouds_and_scene
    kind, modes = CASES[case]
    plain_query, jqueries = scenes(kind, frames, K)
    crit = ticp.ICPConvergenceCriteria(max_iteration=30)
    T, fit = plain_refine(clouds, valids, plain_query, crit, modes)
    jcrit = jicp.ICPConvergenceCriteria(max_iteration=30)
    jT, jfit = [], []
    for c, v, q in zip(clouds, valids, jqueries):
        if modes[1]:
            jres, _ = jicp.icp_point_to_point(c, v, q, jcrit, robust_delta=modes[0],
                                              chunk_iters=31)
        else:
            jres, _ = jicp.icp_point_to_plane(c, v, q, jcrit, reduction="packed",
                                              robust_delta=modes[0], chunk_iters=31)
        jT.append(np.asarray(jres.transformation))
        jfit.append(float(jres.fitness))
    assert (fit > 0.5).all() or kind == "stacked"
    hold(T, fit, np.stack(jT), np.asarray(jfit), truths, case)


@pytest.mark.parametrize("case", ["projective", "kd", "kd-p2p"])
def test_plain_iteration_refine_matches_port_cpu_loop(clouds_and_scene, case):
    """The same refine against the port's own CPU loop (the scene's query,
    the packed reduction, torch.linalg in _solve_damped; point to point:
    the matrix products), to the same bar."""
    clouds, valids, frames, K, truths = clouds_and_scene
    kind, modes = CASES[case]
    plain_query, _j = scenes(kind, frames, K)
    crit = ticp.ICPConvergenceCriteria(max_iteration=30)
    T, fit = plain_refine(clouds, valids, plain_query, crit, modes)
    res, _cloud = ticp._icp_run(torch.as_tensor(clouds), torch.as_tensor(valids), plain_query,
                                crit, reduction="packed", robust_delta=modes[0],
                                estimation="point_to_point" if modes[1] else "point_to_plane")
    hold(T, fit, res.transformation.numpy(), res.fitness.numpy(), truths, case)


def test_kd_near_starts_split_at_near_ties(clouds_and_scene):
    """The evidence for NEAR_M_NN on the kd NN scene. Start
    KD_CPU_LOOP_OFF_JAX: the port's CPU loop (query, packed reduction,
    torch.linalg) is itself more than NEAR_M from JAX, while the plain
    iteration stays within NEAR_M of that loop. Start KD_TIE_START: the
    plain iteration and the CPU loop take the same rows until KD_TIE_ITER,
    then split at KD_TIE_POINT between KD_TIE_ROWS, two scene points within
    1e-8 m of equally far, from clouds within 2.4e-7 m of each other; the
    refines then end more than NEAR_M (and at most NEAR_M_NN) apart."""
    clouds, valids, frames, K, _truths = clouds_and_scene
    scene = tnn.SceneNN.from_depth(frames[1], K, NN_GATE, backend="kdtree", device="cpu")
    crit = ticp.ICPConvergenceCriteria(max_iteration=30)

    def recording(log):
        def query(src):
            idx, dist_sq = scene._nearest(src, plain=True)
            log.append((src.clone(), idx.clone()))
            return tnn._rows_in_gate(scene.table, idx, dist_sq, scene.max_dist_diff, True)
        return query

    def both(start):
        c, v = torch.as_tensor(clouds[start:start + 1]), torch.as_tensor(valids[start:start + 1])
        plain_log, loop_log = [], []
        plain, _ = ticp._icp_run(c, v, ticp.plain_association(recording(plain_log)), crit)
        loop, _ = ticp._icp_run(c, v, recording(loop_log), crit, reduction="packed")
        return (plain.transformation[0].numpy(), loop.transformation[0].numpy(),
                plain_log, loop_log)

    def dt(a, b):
        return np.abs(a[:3, 3] - b[:3, 3]).max()

    s = KD_CPU_LOOP_OFF_JAX
    plain_T, loop_T, _, _ = both(s)
    jres, _ = jicp.icp_point_to_plane(
        clouds[s], valids[s], jnn.SceneNN.from_depth(frames[1], K, NN_GATE, backend="kdtree").query,
        jicp.ICPConvergenceCriteria(max_iteration=30), reduction="packed", chunk_iters=31)
    jax_T = np.asarray(jres.transformation)
    assert NEAR_M < dt(loop_T, jax_T) <= NEAR_M_NN
    assert dt(plain_T, loop_T) <= NEAR_M

    plain_T, loop_T, plain_log, loop_log = both(KD_TIE_START)
    valid = torch.as_tensor(valids[KD_TIE_START])
    assert min(len(plain_log), len(loop_log)) > KD_TIE_ITER
    for it, ((c_a, i_a), (c_b, i_b)) in enumerate(zip(plain_log, loop_log)):
        split = ((i_a[0] != i_b[0]) & valid).nonzero()[:, 0].tolist()
        if it < KD_TIE_ITER:
            assert not split, it
            continue
        assert split == [KD_TIE_POINT]
        assert (int(i_a[0, KD_TIE_POINT]), int(i_b[0, KD_TIE_POINT])) == KD_TIE_ROWS
        assert float((c_a[0] - c_b[0]).abs().max()) <= 2.4e-7
        rows = scene.table[list(KD_TIE_ROWS), :3].double()
        for c in (c_a, c_b):
            far = (c[0, KD_TIE_POINT].double() - rows).norm(dim=-1)
            assert float((far[0] - far[1]).abs()) <= 1e-8
        break
    assert NEAR_M < dt(plain_T, loop_T) <= NEAR_M_NN


def small_state(n=5, p=600, seed=2):
    """A projective scene of one 120x160 frame, clouds around it (a pose
    with no valid point at index 2) and the loop's initial state."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(290, 310, (H, W)).astype(np.int32)
    scene = tproj.SceneProjective.from_depth(depth, small_K(), 0.03, device="cpu")
    src = (rng.normal(size=(n, p, 3)) * [0.04, 0.03, 0.005] + [0, 0, 0.3]).astype(np.float32)
    valid = torch.as_tensor(rng.uniform(size=(n, p)) > 0.1)
    valid[2] = False
    state = IR.ICPState(torch.as_tensor(src), torch.eye(4).expand(n, 4, 4).clone(),
                        torch.zeros(n), torch.zeros(n), torch.zeros(n, dtype=torch.bool))
    return scene, state, valid, valid.sum(dim=-1).to(torch.float32)


def test_plain_iteration_latch_and_edges():
    """The latch of icp_iterate_plain: max_iteration = 0 scores once and
    moves nothing; a pose with no valid point is done at once with its
    scores 0 and T the identity; a state that is done at the start is
    returned unchanged bit for bit; each step's fitness and rmse freeze
    once done."""
    scene, state, valid, n_total = small_state()
    query = functools.partial(scene.query, plain=True)
    one = IR.icp_loop_plain(state, valid, n_total, ticp.ICPConvergenceCriteria(max_iteration=0),
                            query)
    assert bool(one.done.all()) and torch.equal(one.cloud, state.cloud)
    assert torch.equal(one.T, state.T) and float(one.fitness[0]) > 0.5
    assert float(one.fitness[2]) == 0.0 and float(one.rmse[2]) == 0.0
    crit = ticp.ICPConvergenceCriteria(max_iteration=8)
    out = IR.icp_loop_plain(state, valid, n_total, crit, query)
    assert bool(out.done.all()) and torch.equal(out.T[2], torch.eye(4))
    assert torch.equal(out.cloud[2], state.cloud[2]) and not torch.equal(out.T[0], state.T[0])
    frozen = IR.icp_loop_plain(out, valid, n_total, crit, query)
    for a, b in zip(frozen, out):
        assert torch.equal(a, b)
    s = state
    for it in range(crit.max_iteration + 1):
        nxt = IR.icp_iterate_plain(s, valid, n_total, query, it, crit.max_iteration,
                                   crit.relative_fitness, crit.relative_rmse)
        assert torch.equal(nxt.fitness[s.done], s.fitness[s.done])
        assert torch.equal(nxt.cloud[nxt.done & s.done], s.cloud[nxt.done & s.done])
        s = nxt
    for a, b in zip(s, out):
        assert torch.equal(a, b)


def test_plain_association_runs_the_plain_iteration():
    """_icp_run hands an Association with an iterate the whole loop:
    plain_association's equals icp_loop_plain on the anchored clouds bit
    for bit; an Association without one keeps the pass-by-pass loop."""
    scene, state, valid, n_total = small_state(seed=6)
    query = functools.partial(scene.query, plain=True)
    crit = ticp.ICPConvergenceCriteria(max_iteration=6)
    res, cloud = ticp._icp_run(state.cloud, valid, ticp.plain_association(query), crit)
    start, _valid, _n_total = ticp._icp_start(state.cloud, valid)
    assert start.cloud.data_ptr() != state.cloud.data_ptr()
    want = IR.icp_loop_plain(start, valid, n_total, crit, query)
    assert torch.equal(res.transformation, want.T) and torch.equal(cloud, want.cloud)
    assert torch.equal(res.fitness, want.fitness) and torch.equal(res.inlier_rmse, want.rmse)

    old, _ = ticp._icp_run(state.cloud, valid, ticp.Association(query), crit)
    bare, _ = ticp._icp_run(state.cloud, valid, query, crit)
    for a, b in zip(old, bare):
        assert torch.equal(a, b)


def test_iterate_wrappers_refuse_cpu_tensors():
    """The iteration kernel's entry points launch or raise; they never
    compute on the CPU themselves (the scenes' iterate included)."""
    scene, state, valid, n_total = small_state()
    crit = ticp.ICPConvergenceCriteria(max_iteration=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scene.iterate(state, valid, n_total, crit)
    with pytest.raises(ValueError, match="CUDA tensors"):
        IR.icp_iterate_indexed_cuda(
            state, valid, n_total, crit, scene.table,
            lambda c: (torch.zeros(c.shape[:-1], dtype=torch.int32), torch.zeros(c.shape[:-1])),
            1e-4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        IR.sin_cos_cuda(torch.zeros(4))
