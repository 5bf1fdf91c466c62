"""Stacked multi-frame scenes of the port on the CPU against the JAX
package on the same numpy inputs (tests/test_multiscene.py's workload:
three 160x120 frames of the bumpy sphere): SceneProjectiveStack and
SceneNNStack, the plain stacked B3, and refine(scene_ids=) for both scene
kinds, against JAX's refiner and against per-frame refines.

Projective refines compare with JAX's ``use_pallas=False`` refiner, as
tests/test_torch_slice.py does; NN refines with JAX's Pallas raster and
flash-NN in interpret mode, whose associations the port's plain versions
equal (tests/test_torch_nn_slice.py). Tolerances: tables and associations
bit for bit, but the projective table within 1e-6, the bound of
tests/test_torch_lift_scene.py (dep2pcd and the normal stencil's float32
products round otherwise in XLA by an ULP at some pixels); refined poses within the slice bounds
(0.1 deg, 0.2 mm, fitness 5e-3: the ICP convergence latch amplifies
reduction-order ULPs) with 100% verdict agreement.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize_pallas as JRP
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu.scene import nn_pallas as JP
from pose_refine_tpu.scene import projective as jproj
import pose_refine_tpu_torch as ptt
from pose_refine_tpu_torch.scene import nn_flash as NF
from pose_refine_tpu_torch.scene.nn import SceneNN, SceneNNStack
from pose_refine_tpu_torch.scene.projective import SceneProjective, SceneProjectiveStack
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg
from tests.test_icp import reference_demo_poses

torch.set_num_threads(2)

W, H = 160, 120
ITERS = 20
VERDICT_DEG = 3.0
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
REF_CFG = dict(width=W, height=H, max_points=4096, window=64, stride=1, auto_roi=False)
NN_CFG = dict(width=W, height=H, max_points=512, window=64, stride=2, auto_roi=False,
              scene="nn_bruteforce", scene_voxel_mm=3.0)


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def multiscene_frames():
    """tests/test_multiscene.py's three frames: the bumpy sphere at three
    truths around the reference viewpoint (seed 11). Returns (mesh, K,
    truths, (3, H, W) int32 frames)."""
    K = small_K()
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    pose1, _, _ = reference_demo_poses()
    rng = np.random.default_rng(11)
    truths, frames = [], []
    for _ in range(3):
        d_rot = np.asarray(jgeo.euler_to_rotation(rng.uniform(-0.3, 0.3, 3).astype(np.float32)))
        t = pose1[:3, 3] + rng.uniform(-15, 15, 3).astype(np.float32)
        truth = np.asarray(jgeo.pose_from_Rt(d_rot @ pose1[:3, :3], t))
        truths.append(truth)
        frames.append(np.asarray(r.render_depth(truth))[0].astype(np.int32))
    return m, K, np.stack(truths), np.stack(frames)


@pytest.fixture(scope="module")
def setup():
    return multiscene_frames()


def perturbed(truths, rng, per=2):
    """tests/test_multiscene.py's hypotheses: per frame, +-0.1 rad/axis and
    +-8 mm around its truth, with the frame's id."""
    hyps, ids = [], []
    for k, truth in enumerate(truths):
        for _ in range(per):
            d = np.asarray(jgeo.euler_to_rotation(rng.uniform(-0.1, 0.1, 3).astype(np.float32)))
            hyps.append(np.asarray(jgeo.pose_from_Rt(
                d @ truth[:3, :3], truth[:3, 3] + rng.uniform(-8, 8, 3).astype(np.float32))))
            ids.append(k)
    return np.stack(hyps).astype(np.float32), np.asarray(ids, np.int32)


def assert_slice_bounds(tposes, jposes, tfit, jfit, truths, ids):
    tposes, jposes = np.asarray(tposes), np.asarray(jposes)
    assert tposes.shape == jposes.shape and np.isfinite(tposes).all()
    for k in np.unique(ids):
        rows = ids == k
        np.testing.assert_array_equal(rotation_angle_deg(tposes[rows], truths[k]) < VERDICT_DEG,
                                      rotation_angle_deg(jposes[rows], truths[k]) < VERDICT_DEG)
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() <= MAX_DT_MM
    assert np.abs(np.asarray(tfit) - np.asarray(jfit)).max() <= MAX_DFIT


def test_projective_stack_matches_jax(setup):
    """The stacked table against JAX's within the normals tolerance (1e-6),
    lane(i) against JAX's lane, and query_at against the per-frame scene
    bit for bit, out-of-range ids clamped to the nearest frame."""
    m, K, truths, frames = setup
    tstack = SceneProjectiveStack.from_depths(frames, K, device="cpu")
    jstack = jproj.SceneProjectiveStack.from_depths(frames, K)
    assert tstack.n_scenes == 3 and tstack.table.shape == (3 * H * W, 8)
    np.testing.assert_allclose(tstack.table.numpy(), np.asarray(jstack.table), atol=1e-6)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.uniform(-0.1, 0.1, (3, 256, 3)).astype(np.float32)
                          + np.float32([0, 0, 0.3]))
    for i in range(3):
        np.testing.assert_allclose(tstack.lane(i).table.numpy(),
                                   np.asarray(jstack.lane(i).table), atol=1e-6)
        single = SceneProjective.from_depth(frames[i], K, device="cpu")
        for sid in ([i] * 3, [{0: -9, 1: 1, 2: 5}[i]] * 3):  # in range, clamped
            got = tstack.query_at(torch.tensor(sid))(src)
            for g, w in zip(got, single.query(src)):
                assert torch.equal(g, w)
    # one batch, three frames: pose n against frame n
    got = tstack.query_at(torch.tensor([0, 1, 2]))(src)
    for n in range(3):
        want = tstack.lane(n).query(src[n])
        for g, w in zip(got, want):
            assert torch.equal(g[n], w)


def test_refine_multiscene_matches_jax_and_lanes(setup):
    """refine(scene_ids=) against JAX's refiner at the slice bounds, and
    against per-frame refines of the port."""
    m, K, truths, frames = setup
    hyps, ids = perturbed(truths, np.random.default_rng(1))
    crit = ptt.ICPConvergenceCriteria(max_iteration=ITERS)
    tref = ptt.PoseRefiner(m, K=K, device="cpu", **REF_CFG).set_scene_depths(frames)
    tposes, tres = tref.refine(hyps, crit, scene_ids=ids)
    jref = prt.PoseRefiner(m, K=K, use_pallas=False, **REF_CFG).set_scene_depths(frames)
    jposes, jres = jref.refine(hyps, prt.ICPConvergenceCriteria(max_iteration=ITERS),
                               scene_ids=ids)
    assert (tref.roi, tref.window, tref.max_points) == (jref.roi, jref.window, jref.max_points)
    assert_slice_bounds(tposes, jposes, tres.fitness, jres.fitness, truths, ids)
    np.testing.assert_array_equal(tres.n_points.numpy(), np.asarray(jres.n_points))
    single = ptt.PoseRefiner(m, K=K, device="cpu", **REF_CFG)
    for k in range(3):
        single.set_scene_depth(frames[k])
        rows = ids == k
        r_k, res_k = single.refine(hyps[rows], crit)
        np.testing.assert_allclose(tposes[rows].numpy(), r_k.numpy(), atol=1e-5)
        np.testing.assert_allclose(tres.fitness[rows].numpy(), res_k.fitness.numpy(), atol=1e-6)
        assert rotation_angle_deg(r_k.numpy(), truths[k]).max() < VERDICT_DEG


def test_refine_multiscene_covariance_and_async(setup):
    """scene_ids compose with with_covariance and refine_async, and take
    a tensor of ids as they take a host array."""
    m, K, truths, frames = setup
    hyps, ids = perturbed(truths, np.random.default_rng(2), per=1)
    ref = ptt.PoseRefiner(m, K=K, device="cpu", **REF_CFG).set_scene_depths(frames)
    refined, res, unc = ref.refine(hyps, scene_ids=ids, with_covariance=True)
    assert unc.covariance.shape == (3, 6, 6) and bool(torch.isfinite(unc.covariance).all())
    r2, res2 = ref.refine_async(hyps, scene_ids=torch.as_tensor(ids)).wait()
    assert torch.equal(r2, refined) and torch.equal(res2.fitness, res.fitness)
    one, one_res = ref.refine(hyps[1], scene_ids=1)  # one pose, one id: unbatched
    assert one.shape == (4, 4) and one_res.fitness.shape == ()
    # a batch of one sums in another order than a batch of three
    np.testing.assert_allclose(one.numpy(), refined[1].numpy(), atol=1e-5)


def test_refine_multiscene_validation(setup):
    """tests/test_multiscene.py:124-146's errors (the port refuses
    scene="nn_kdtree" at construction, ROADMAP A9)."""
    m, K, truths, frames = setup
    ref = ptt.PoseRefiner(m, K=K, device="cpu", **REF_CFG).set_scene_depths(frames)
    hyps, ids = perturbed(truths, np.random.default_rng(3), per=1)
    with pytest.raises(ValueError, match="scene_ids"):
        ref.refine(hyps)
    with pytest.raises(ValueError, match="does not match"):
        ref.refine(hyps, scene_ids=ids[:2])
    with pytest.raises(ValueError, match=r"in \[0, 3\)"):
        ref.refine(hyps, scene_ids=np.asarray([0, 1, 3], np.int32))
    single = ptt.PoseRefiner(m, K=K, device="cpu", **REF_CFG).set_scene_depth(frames[0])
    with pytest.raises(ValueError, match="single scene"):
        single.refine(hyps, scene_ids=ids)
    with pytest.raises(ValueError, match="scene_cascade"):
        ptt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_bruteforce", device="cpu",
                        scene_cascade=(8.0, 10), max_points=4096).set_scene_depths(frames)
    with pytest.raises(ValueError, match="K, H, W"):
        ref.set_scene_depths(frames[0])
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        ref.refine(hyps, scene_ids=ids, schedule=[(0.25, 10), (0.05, 20)])


def test_nn_stack_matches_jax(setup):
    """SceneNNStack's tables against JAX's bit for bit, and query_at against
    JAX's on the flash backend (the stacked Pallas kernel in interpret
    mode): idx-derived rows, normals and validity bit for bit, clamped ids
    included; and against the port's per-frame scene."""
    m, K, truths, frames = setup
    tstack = SceneNNStack.from_depths(frames, K, backend="flash", device="cpu")
    jstack = jnn.SceneNNStack.from_depths(frames, K, backend="flash")
    assert tstack.n_scenes == 3 and tstack.frame_rows == jstack.frame_rows
    for name in ("table", "points", "flash_table", "flash_boxes"):
        np.testing.assert_array_equal(getattr(tstack, name).numpy(),
                                      np.asarray(getattr(jstack, name)), err_msg=name)
    rng = np.random.default_rng(7)
    src = rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32) + np.float32([0, 0, 0.3])
    for sid, frame in ((0, 0), (1, 1), (2, 2), (5, 2), (-1, 0)):
        want = jstack.query_at(jnp.int32(sid))(jnp.asarray(src))
        got = tstack.query_at(torch.tensor(sid))(torch.as_tensor(src))
        v = np.asarray(want[2])
        assert v.any() and not v.all()
        np.testing.assert_array_equal(got[2].numpy(), v)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.numpy()[v], np.asarray(w)[v])
        single = SceneNN.from_depth(frames[frame], K, device="cpu").query(torch.as_tensor(src))
        assert torch.equal(single[2], got[2])
        assert torch.equal(single[0][got[2]], got[0][got[2]])


def test_stacked_gated_plain_matches_jax():
    """The plain stacked B3 against nn_flash_gated(..., frame_id=k,
    frames=2, interpret=True), mirroring tests/test_property.py:205-240:
    per frame, idx (stacked columns) and dist^2 bit for bit in the gate,
    validity everywhere, and equal to the frame's own full scan with the
    index offset by k * rows, with an exact tie across distant chunks; a
    batch of poses of both frames in one call gives each pose its frame's
    result; without frame_id the stack is scanned as frame 0, JAX's
    default."""
    rng = np.random.default_rng(61)
    rows = 1024
    frames = []
    for k in range(2):
        S = (rng.normal(size=(rows, 3)) * 0.08 + k * 0.3).astype(np.float32)
        S = S[np.lexsort((S[:, 0], S[:, 1], S[:, 2]))]
        frames.append(S)
    frames[1][900] = frames[1][40]  # an exact tie, two chunks apart
    tables = [NF.pack_scene(S) for S in frames]
    stacked = torch.cat(tables, dim=1)
    boxes, balls = NF.chunk_boxes(stacked), NF.ball_table(stacked)
    gate = 0.05
    queries = []
    for k, S in enumerate(frames):
        Q = (S[rng.integers(0, rows, 600)] + rng.normal(0, 0.01, (600, 3))).astype(np.float32)
        Q[:40] += 1.0  # no neighbour in the gate
        if k == 1:
            Q[45] = S[40]
        queries.append(Q)
        ji, jd = map(np.asarray, JP.nn_flash_gated(Q, stacked.numpy(), boxes.numpy(), gate,
                                                   interpret=True, frame_id=k, frames=2))
        ti, td = NF.nn_flash_gated(torch.as_tensor(Q), stacked, boxes, balls, gate,
                                   frame_id=k, frames=2)
        ti, td = ti.numpy(), td.numpy()
        pi, pd = map(np.asarray, NF.nn_flash_packed(torch.as_tensor(Q), tables[k]))
        g2 = np.float32(gate) * np.float32(gate)
        inside = pd < g2
        assert inside.any() and not inside.all()
        np.testing.assert_array_equal(ti[inside], ji[inside])
        np.testing.assert_array_equal(td[inside], jd[inside])
        np.testing.assert_array_equal(td < g2, jd < g2)
        np.testing.assert_array_equal(ti[inside], pi[inside] + k * rows)
        np.testing.assert_array_equal(td[inside], pd[inside])
        if k == 1:
            assert ti[45] == 40 + rows == ji[45]
    both = torch.as_tensor(np.stack(queries[::-1]))  # pose 0 in frame 1, pose 1 in frame 0
    bi, bd = NF.nn_flash_gated(both, stacked, boxes, balls, gate, frame_id=torch.tensor([1, 0]),
                               frames=2)
    for n, k in enumerate((1, 0)):
        ki, kd = NF.nn_flash_gated(both[n], stacked, boxes, balls, gate, frame_id=k, frames=2)
        assert torch.equal(bi[n], ki) and torch.equal(bd[n], kd)
    ji, jd = map(np.asarray, JP.nn_flash_gated(queries[1], stacked.numpy(), boxes.numpy(), gate,
                                               interpret=True, frames=2))
    ti, td = NF.nn_flash_gated(torch.as_tensor(queries[1]), stacked, boxes, balls, gate, frames=2)
    inside = jd < np.float32(gate) * np.float32(gate)
    np.testing.assert_array_equal(td.numpy() < np.float32(gate) ** 2, inside)
    np.testing.assert_array_equal(ti.numpy()[inside], ji[inside])


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX refiner's Pallas raster in interpret mode and its stacked NN
    scenes on the flash backend (the stacked Pallas kernel)."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))
    orig = jnn.SceneNNStack.__dict__["from_depths"].__func__

    def flash(cls, *args, **kwargs):
        return dataclasses.replace(orig(cls, *args, **kwargs), backend="flash")

    monkeypatch.setattr(jnn.SceneNNStack, "from_depths", classmethod(flash))


def test_refine_nn_multiscene_matches_jax(setup, jax_flash):
    """An NN refine(scene_ids=) (3 mm voxel stack, 3 hypotheses, one per
    frame) against JAX's at the slice bounds, and against the port's
    per-frame NN refines."""
    m, K, truths, frames = setup
    hyps, ids = perturbed(truths, np.random.default_rng(8), per=1)
    tref = ptt.PoseRefiner(m, K=K, device="cpu", **NN_CFG).set_scene_depths(frames)
    assert isinstance(tref.scene, SceneNNStack)
    tposes, tres = tref.refine(hyps, ptt.ICPConvergenceCriteria(max_iteration=ITERS),
                               scene_ids=ids)
    jref = prt.PoseRefiner(m, K=K, use_pallas=True, **NN_CFG).set_scene_depths(frames)
    jposes, jres = jref.refine(hyps, prt.ICPConvergenceCriteria(max_iteration=ITERS),
                               scene_ids=ids)
    assert_slice_bounds(tposes, jposes, tres.fitness, jres.fitness, truths, ids)
    single = ptt.PoseRefiner(m, K=K, device="cpu", **NN_CFG)
    for k in range(3):
        single.set_scene_depth(frames[k])
        r_k, res_k = single.refine(hyps[k:k + 1],
                                   ptt.ICPConvergenceCriteria(max_iteration=ITERS))
        np.testing.assert_allclose(tposes[k:k + 1].numpy(), r_k.numpy(), atol=1e-5)
        assert abs(float(tres.fitness[k] - res_k.fitness[0])) <= 1e-6
