"""The coarse-to-fine ICP point schedule (``coarse_iters`` /
``coarse_stride``, JAX icp.py:443-489) and ``icp_point_to_plane_batch`` in
the port against the JAX package on the CPU, on the same numpy inputs: the
loop on fixed correspondences, the hand-off, a pose whose strided rows are
all invalid, JAX's ValueErrors, and whole refines on tests/test_icp.py:389's
recipe (projective, and ``scene="nn"`` point to plane and point to point).
The kernel's coarse mode is held against its plain version on the card
(tests/test_torch_device.py, chip_smoke.py's [coarse])."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize_pallas as JRP
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import icp as jicp
from pose_refine_tpu import mesh
from pose_refine_tpu_torch import icp as ticp
from pose_refine_tpu_torch.ops import icp_reduce as IR
from pose_refine_tpu_torch.pipeline import refine_poses
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 160, 120
# tests/test_icp.py:412's refiner and schedule
BASE = dict(max_points=4096, window=64, stride=1)
COARSE = dict(coarse_iters=12, coarse_stride=2)
VERDICT_DEG = 3.0
# the slice bounds (tests/test_torch_slice.py): the sums are float32 in
# another order, which the 1e-5 latch turns into small pose deltas
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)
CASES = {
    "projective": dict(),
    "nn": dict(scene="nn", scene_voxel_mm=2.0),
    "nn_p2p": dict(scene="nn", scene_voxel_mm=2.0, estimation="point_to_point"),
}


def demo_poses():
    """tests/test_icp.py:22's reference recipe: the LINEMOD viewpoint, and
    the same pose turned 10 deg per Euler axis and moved 20 mm."""
    ang = np.float32(10.0 / 180.0 * 3.14)
    rot = np.asarray(jgeo.euler_to_rotation(np.array([ang, ang, ang])))
    pose1 = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0.0, 0.0, 300.0], np.float32)))
    pose2 = np.asarray(jgeo.pose_from_Rt(rot @ R_REN, np.array([20.0, 20.0, 320.0],
                                                               np.float32)))
    return pose1, pose2


@pytest.fixture(scope="module")
def recipe():
    """The bumpy sphere (50, 3) at 160x120 (K / 4), the scene rendered at
    the perturbed pose, and 6 hypotheses: the reference start and 5 draws
    of +-10 deg/axis, +-20 mm around the truth."""
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    pose1, truth = demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene = np.asarray(r.render_depth(truth))[0].astype(np.int32)
    rng = np.random.default_rng(0)
    d_rot = np.asarray(jgeo.euler_to_rotation(rng.uniform(-0.17, 0.17, (5, 3)).astype(np.float32)))
    poses = np.zeros((6, 4, 4), np.float32)
    poses[0] = pose1
    poses[1:, :3, :3] = np.einsum("nij,jk->nik", d_rot, truth[:3, :3])
    poses[1:, :3, 3] = truth[:3, 3] + rng.uniform(-20, 20, (5, 3)).astype(np.float32)
    poses[1:, 3, 3] = 1.0
    return m, K, truth, poses, scene


@pytest.fixture
def pallas_raster(monkeypatch):
    """The JAX refiner's use_pallas=True raster in interpret mode on the CPU:
    the function the port's raster computes bit for bit."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))


def assert_refines_agree(truth, jposes, jres, tposes, tres):
    """100% verdict agreement, the slice bounds at every pose, n_points
    equal."""
    jposes, tposes = np.asarray(jposes), tposes.numpy()
    assert tposes.shape == jposes.shape and np.isfinite(tposes).all()
    np.testing.assert_array_equal(rotation_angle_deg(tposes, truth) < VERDICT_DEG,
                                  rotation_angle_deg(jposes, truth) < VERDICT_DEG)
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() <= MAX_DT_MM
    assert np.abs(tres.fitness.numpy() - np.asarray(jres.fitness)).max() <= MAX_DFIT
    np.testing.assert_array_equal(tres.n_points.numpy(), np.asarray(jres.n_points))


@pytest.mark.parametrize("case", sorted(CASES))
def test_coarse_refine_matches_jax(recipe, pallas_raster, case):
    """PoseRefiner(coarse_iters=12, coarse_stride=2) on tests/test_icp.py:389's
    recipe against the JAX refiner: the slice bounds at every hypothesis.
    The fine phase scores on the full cloud, so n_points is the plain
    loop's divisor (tests/test_icp.py:413-418); the projective start
    recovers as the JAX test demands (< 4 deg, fitness > 0.7)."""
    m, K, truth, poses, scene = recipe
    kw = dict(**BASE, **COARSE, **CASES[case])
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=True, **kw)
    jref.set_scene_depth(scene)
    jposes, jres = jref.refine(poses)
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **kw)
    tref.set_scene_depth(scene)
    tposes, tres = tref.refine(poses)
    assert_refines_agree(truth, jposes, jres, tposes, tres)
    plain = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **BASE,
                            **CASES[case]).set_scene_depth(scene)
    _p, pres = plain.refine(poses[:1], ptt.ICPConvergenceCriteria(max_iteration=2))
    assert float(pres.n_points[0]) == float(tres.n_points[0])
    if case == "projective":
        assert rotation_angle_deg(tposes.numpy()[0], truth) < 4.0
        assert float(tres.fitness[0]) > 0.7


@pytest.mark.parametrize("case", ["projective", "nn"])
def test_coarse_plain_iteration_matches_the_loop(recipe, case):
    """The same coarse refine through plain_association's iterate (the
    kernel's plain version: icp_coarse_plain, handoff_plain and
    icp_iterate_plain, the packed sums in the kernel's order) against the
    loop of icp.py (matrix products): the slice bounds."""
    m, K, truth, poses, scene = recipe
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **BASE, **COARSE,
                          **CASES[case]).set_scene_depth(scene)
    tposes, tres = ref.refine(poses)
    pposes, pres = refine_poses(
        ref.tris, torch.as_tensor(poses), ref.scene, ref.proj, ref._K_render_t,
        width=ref.render_w, height=ref.render_h, max_points=ref.max_points,
        criteria=ptt.ICPConvergenceCriteria(), window=ref.window, stride=ref.stride,
        roi=ref.roi, **COARSE,
        query=ticp.plain_association(functools.partial(ref.scene.query, plain=True)))
    assert_refines_agree(truth, tposes.numpy(), tres, pposes, pres)


def fixed_case(seed, n=400):
    """tests/test_icp_p2p.py's inputs: n points in a 0.2 m cube at z = 0.5,
    the target = the points moved by a small twist, unit normals."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 0.1, size=(n, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    truth = np.asarray(jgeo.twist_to_mat4(
        np.array([0.05, -0.03, 0.06, 0.012, -0.02, 0.017], np.float32)))
    target = (pts @ truth[:3, :3].T + truth[:3, 3]).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, target, nrm, truth


def strided_queries(target, nrm, cs):
    """Fixed correspondences for both packages: row i of the full cloud
    pairs with target i, and the coarse phase's strided copy (fewer rows)
    with target[::cs]."""
    n = len(target)

    def rows(src_rows):
        return (target, nrm) if src_rows == n else (target[::cs], nrm[::cs])

    def jq(src):
        t, nr = rows(src.shape[0])
        return jnp.asarray(t), jnp.asarray(nr), jnp.ones(src.shape[0], bool)

    def tq(src):
        t, nr = rows(src.shape[-2])
        t, nr = torch.as_tensor(t).expand(src.shape), torch.as_tensor(nr).expand(src.shape)
        return t, nr, torch.ones(src.shape[:-1], dtype=torch.bool)

    return jq, tq


@pytest.mark.parametrize("robust_delta", [0.0, 0.02])
@pytest.mark.parametrize("estimation", ["point_to_plane", "point_to_point"])
@pytest.mark.parametrize("cs", [2, 3])
def test_coarse_icp_matches_jax(estimation, cs, robust_delta):
    """icp_point_to_plane / icp_point_to_point with coarse_iters=8 on fixed
    correspondences, with and without Huber weights, against JAX's fused
    loop: T and the cloud within 1e-5 (float32 sums in another order), the
    same fitness; the plain iteration (plain_association's iterate, the
    kernel's plain version) lands on the same result. Every point is
    valid, so the fitness divisor is the full cloud's."""
    pts, target, nrm, truth = fixed_case(0)
    jq, tq = strided_queries(target, nrm, cs)
    valid = np.ones(len(pts), bool)
    crit = dict(max_iteration=20)
    jfn = jicp.icp_point_to_plane if estimation == "point_to_plane" else jicp.icp_point_to_point
    tfn = ticp.icp_point_to_plane if estimation == "point_to_plane" else ticp.icp_point_to_point
    jres, jcloud = jfn(pts, valid, jq, jicp.ICPConvergenceCriteria(**crit), chunk_iters=64,
                       robust_delta=robust_delta, coarse_iters=8, coarse_stride=cs)
    tcrit = ticp.ICPConvergenceCriteria(**crit)
    got = [tfn(torch.as_tensor(pts), torch.as_tensor(valid), q, tcrit, chunk_iters=64,
               robust_delta=robust_delta, coarse_iters=8, coarse_stride=cs)
           for q in (tq, ticp.plain_association(tq))]
    for tres, tcloud in got:
        np.testing.assert_allclose(tres.transformation.numpy(), np.asarray(jres.transformation),
                                   atol=1e-5)
        np.testing.assert_allclose(tcloud.numpy(), np.asarray(jcloud), atol=1e-5)
        assert float(tres.fitness) == float(jres.fitness) == 1.0
        assert float(tres.n_points) == len(pts)
    np.testing.assert_allclose(got[0][0].transformation.numpy(), truth, atol=1e-4)


def test_handoff_matches_jax_transform_points():
    """The hand-off (handoff_plain: ((T_i0 x + T_i1 y) + T_i2 z) + T_i3, the
    kernel's order) against JAX's transform_points(warm.T, cloud) and
    against float64: every coordinate within 2^-22 of the sum of its terms'
    magnitudes (a few float32 roundings) of both."""
    rng = np.random.default_rng(3)
    tw = rng.uniform(-0.2, 0.2, (4, 6)).astype(np.float32)
    T = np.stack([np.asarray(jgeo.twist_to_mat4(t)) for t in tw])
    cloud = rng.uniform(-0.2, 0.2, (4, 500, 3)).astype(np.float32)
    cloud[..., 2] += 0.4
    got = IR.handoff_plain(torch.as_tensor(T), torch.as_tensor(cloud)).numpy()
    want = np.stack([np.asarray(jgeo.transform_points(T[i], cloud[i])) for i in range(4)])
    T64, c64 = T.astype(np.float64), cloud.astype(np.float64)
    exact = np.einsum("nij,npj->npi", T64[:, :3, :3], c64) + T64[:, None, :3, 3]
    scale = np.einsum("nij,npj->npi", np.abs(T64[:, :3, :3]), np.abs(c64)) + np.abs(
        T64[:, None, :3, 3])
    for a in (got, want):
        assert (np.abs(a - exact) <= scale * 2.0 ** -22).all()
    assert (np.abs(got - want) <= scale * 2.0 ** -21).all()


def test_coarse_holds_a_pose_whose_strided_rows_are_invalid():
    """A pose whose rows 0, 2, 4, ... are all invalid has no inlier in the
    coarse phase: it holds (T stays the identity, JAX's `ok = count > 0`)
    through every coarse iteration, then the fine phase refines it from the
    start; a second pose moves at once. The port (its loop and the plain
    iteration) against JAX pose by pose, and icp_coarse_plain's T."""
    pts, target, nrm, _truth = fixed_case(1, n=300)
    jq, tq = strided_queries(target, nrm, 2)
    valid = np.ones((2, len(pts)), bool)
    valid[0, ::2] = False
    crit = dict(max_iteration=12)
    clouds = np.stack([pts, pts])
    tcrit = ticp.ICPConvergenceCriteria(**crit)
    for q in (tq, ticp.plain_association(tq)):
        tres, _ = ticp.icp_point_to_plane(torch.as_tensor(clouds), torch.as_tensor(valid), q,
                                          tcrit, chunk_iters=64, coarse_iters=6)
        for i in range(2):
            jres, _ = jicp.icp_point_to_plane(pts, valid[i], jq,
                                              jicp.ICPConvergenceCriteria(**crit),
                                              chunk_iters=64, coarse_iters=6)
            np.testing.assert_allclose(tres.transformation[i].numpy(),
                                       np.asarray(jres.transformation), atol=1e-5)
            assert float(tres.fitness[i]) == float(jres.fitness)
    state, v, _n = ticp._icp_start(torch.as_tensor(clouds), torch.as_tensor(valid))
    cstate, cvalid = IR.coarse_start(state, v, 2)
    assert not bool(cvalid[0].any())
    cloud_c, T = IR.icp_coarse_plain(cstate.cloud, state.T, cvalid, tq, 6)
    assert torch.equal(T[0], torch.eye(4)) and torch.equal(cloud_c[0], cstate.cloud[0])
    assert not torch.equal(T[1], torch.eye(4))


@pytest.mark.parametrize("kwargs,match", [
    (dict(coarse_iters=30), "scoring"),
    (dict(coarse_iters=8, coarse_stride=1), "coarse_stride"),
])
def test_coarse_validation_matches_jax(recipe, kwargs, match):
    """JAX's ValueErrors with their texts (tests/test_icp.py:432-440), from
    the ICP functions (with JAX's fused chunk_iters, as the JAX side) and
    from a refine; JAX's third ("fused", a short chunk_iters) is held in
    tests/test_torch_jax_api.py."""
    m, K, truth, poses, scene = recipe
    cloud, vmask = np.zeros((64, 3), np.float32), np.ones(64, bool)
    jscene = prt.SceneProjective.from_depth(scene, K)
    tscene = ptt.SceneProjective.from_depth(scene, K, device="cpu")
    with pytest.raises(ValueError, match=match):
        jicp.icp_point_to_plane(cloud, vmask, jscene.query, chunk_iters=64, **kwargs)
    with pytest.raises(ValueError, match=match):
        ticp.icp_point_to_plane(torch.as_tensor(cloud), torch.as_tensor(vmask), tscene.query,
                                chunk_iters=64, **kwargs)
    with pytest.raises(ValueError, match=match):
        ticp.icp_point_to_point(torch.as_tensor(cloud), torch.as_tensor(vmask), tscene.query,
                                chunk_iters=64, **kwargs)
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **BASE, **kwargs)
    ref.set_scene_depth(scene)
    with pytest.raises(ValueError, match=match):
        ref.refine(poses[:1])


def test_icp_point_to_plane_batch_matches_jax(recipe):
    """icp_point_to_plane_batch (JAX icp.py:619-636) over three lifted
    hypothesis renders against one projective scene: the slice bounds on T,
    fitness within 5e-3, each pose's own valid count as its divisor, and
    on the CPU the port's icp_point_to_plane of the same clouds bit for
    bit. The thresholds are 0, so every pose runs all 30 iterations to its
    fixed point: at the 1e-5 latch a pose of this batch stops at
    iterations that differ with the summation order (0.24 deg apart
    between the port's own matrix-product and packed passes; icp.py's
    module note), which is the latch's sensitivity, not the batching's."""
    m, K, truth, poses, scene = recipe
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    depths = np.asarray(r.render_depth(poses[:3])).astype(np.int32)
    clouds, valids, n = (np.asarray(x) for x in jax_lift(depths, K))
    crit = (0.0, 0.0, 30)
    jres, _ = prt.icp_point_to_plane_batch(clouds, valids, prt.SceneProjective.from_depth(
        scene, K), prt.ICPConvergenceCriteria(*crit))
    tscene = ptt.SceneProjective.from_depth(scene, K, device="cpu")
    tres, tcloud = ptt.icp_point_to_plane_batch(
        torch.as_tensor(clouds), torch.as_tensor(valids), tscene, ptt.ICPConvergenceCriteria(*crit))
    one, one_cloud = ticp.icp_point_to_plane(torch.as_tensor(clouds), torch.as_tensor(valids),
                                             tscene.query, ptt.ICPConvergenceCriteria(*crit))
    assert torch.equal(one.transformation, tres.transformation)
    assert torch.equal(one_cloud, tcloud)
    jT, tT = np.asarray(jres.transformation), tres.transformation.numpy()
    assert rotation_angle_deg(tT, jT).max() <= MAX_DROT_DEG
    assert np.abs(tT[:, :3, 3] - jT[:, :3, 3]).max() * 1000.0 <= MAX_DT_MM
    assert np.abs(tres.fitness.numpy() - np.asarray(jres.fitness)).max() <= MAX_DFIT
    np.testing.assert_array_equal(tres.n_points.numpy(), n)
    assert float(tres.fitness.min()) > 0.5


def jax_lift(depths, K, max_points=4096):
    """The compact lift of each render by the JAX package."""
    from pose_refine_tpu.ops.depth_to_cloud import depth_to_cloud

    out = [depth_to_cloud(d, K, max_points) for d in depths]
    return tuple(np.stack([np.asarray(o[i]) for o in out]) for i in range(3))
