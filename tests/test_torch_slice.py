"""The projective refine slice as a whole: the port's PoseRefiner on the
CPU (plain raster) against the JAX package's PoseRefiner on the CPU
(scatter raster), on one scene depth and the same hypotheses."""

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize as JR
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 320, 240
# the bench configuration (bench.py:93-103) with the lift scaled to the
# half-size frame: window 128 -> 64 at stride 2 gives 1024 candidates, and a
# 768-point budget keeps every valid point while still running the top-k
# compaction, as the bench's 2048 of 4096 does
CFG = dict(render_scale=2, max_points=768, window=64, stride=2, decimate_mm=4.0)
ITERS = 24
VERDICT_DEG = 3.0
# Render, lift and association agree bit for bit; the ICP reductions sum in
# another order, and the 1e-5 convergence latch amplifies those ULPs into
# pose deltas of ~1e-2 deg here. The bounds leave that a 4x margin.
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3

R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    return K


@pytest.fixture(scope="module")
def workload():
    """Scene depth of a bumpy sphere at the reference viewpoint, and 12
    hypotheses: 8 from the bench recipe (+-10 deg/axis, +-20 mm) and 4
    with 3.5x the rotation, so that some fail and the verdicts mean
    something."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    K = small_K()
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.17, 0.17, (12, 3)).astype(np.float32)
    ang[8:] *= 3.5
    d_rot = np.asarray(jgeo.euler_to_rotation(ang))
    d_t = rng.uniform(-20, 20, (12, 3)).astype(np.float32)
    poses = np.zeros((12, 4, 4), np.float32)
    poses[:, :3, :3] = np.einsum("nij,jk->nik", d_rot, truth[:3, :3])
    poses[:, :3, 3] = truth[:3, 3] + d_t
    poses[:, 3, 3] = 1.0
    proj = jgeo.compute_proj(K, W, H)
    scene = np.asarray(JR.rasterize_dense(m.tris, truth[None], W, H, proj))[0]
    return m, K, truth, poses, scene


def test_slice_matches_jax(workload):
    m, K, truth, poses, scene = workload
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=False, **CFG)
    jref.set_scene_depth(scene)
    jposes, jres = jref.refine(poses, prt.ICPConvergenceCriteria(max_iteration=ITERS))
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **CFG)
    tref.set_scene_depth(scene)
    tposes, tres = tref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=ITERS))

    # the host planning is the same
    assert tref.roi == jref.roi and tref.window == jref.window
    assert tref.tris.shape == jref.tris.shape
    jposes, tposes = np.asarray(jposes), tposes.numpy()
    assert tposes.shape == (12, 4, 4) and np.isfinite(tposes).all()
    j_ok = rotation_angle_deg(jposes, truth) < VERDICT_DEG
    t_ok = rotation_angle_deg(tposes, truth) < VERDICT_DEG
    np.testing.assert_array_equal(t_ok, j_ok)  # 100% verdict agreement
    assert 0 < j_ok.sum() < len(j_ok)
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() <= MAX_DT_MM
    assert np.abs(tres.fitness.numpy() - np.asarray(jres.fitness)).max() <= MAX_DFIT
    np.testing.assert_array_equal(tres.n_points.numpy(), np.asarray(jres.n_points))
    # ranking uses the same (fitness, -rmse) key
    assert ptt.PoseRefiner.rank(tres)[0] in set(prt.PoseRefiner.rank(jres)[:2].tolist())


def test_auto_planning_matches_jax(workload):
    """window='auto' / max_points='auto', the auto ROI and their hysteresis
    pick the same values frame after frame."""
    m, K, truth, _poses, scene = workload
    kw = dict(render_scale=2, window="auto", max_points="auto", stride=2)
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=False, **kw)
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **kw)
    frames = [scene, np.roll(scene, (6, -9), axis=(0, 1)), np.roll(scene, (40, 50), axis=(0, 1))]
    for frame in frames:
        jref._prepare_frame(frame)
        tref._prepare_frame(frame)
        assert (tref.roi, tref.window, tref.max_points) == (jref.roi, jref.window, jref.max_points)


def test_single_pose_refine_squeezes(workload):
    m, K, truth, poses, scene = workload
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **CFG)
    tref.set_scene_depth(torch.as_tensor(scene))
    pose, res = tref.refine(poses[0], ptt.ICPConvergenceCriteria(max_iteration=4))
    assert pose.shape == (4, 4) and res.fitness.shape == ()


def test_unported_refiner_options_raise(workload):
    """Every refiner option is ported. devices= on the slice: the batch
    split over two shards of the CPU equals the single-device refine bit
    for bit (tests/test_torch_sharding.py has the other paths); devices=1
    is one device. scene="nn_kdtree", robust_delta and
    estimation="point_to_point": tests/test_torch_kdtree.py and
    tests/test_torch_p2p.py hold them against the JAX refiner;
    lift="compact" and coarse_iters: tests/test_torch_api.py and
    tests/test_torch_coarse.py."""
    m, K, _truth, poses, scene = workload
    crit = ptt.ICPConvergenceCriteria(max_iteration=6)
    one = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", devices=1, **CFG)
    split = ptt.PoseRefiner(m, K=K, width=W, height=H, devices=["cpu", "cpu"], **CFG)
    assert one.devices is None and len(split.devices) == 2
    want = one.set_scene_depth(scene).refine(poses[:5], crit)
    got = split.set_scene_depth(scene).refine(poses[:5], crit)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "kwargs,item",
    [({"scene_ids": [0]}, "A15")],
)
def test_unported_refine_options_raise(workload, kwargs, item):
    # with_covariance is ported (tests/test_torch_track.py), schedule= too
    # (tests/test_torch_api.py). scene_ids landed with A15: on a single
    # scene they are the JAX package's ValueError (tests/test_multiscene.py:135)
    m, K, truth, poses, scene = workload
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **CFG)
    tref.set_scene_depth(scene)
    with pytest.raises(ValueError, match="scene_ids"):
        tref.refine(poses[:1], **kwargs)
