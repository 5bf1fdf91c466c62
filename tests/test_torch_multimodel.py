"""MultiModelRefiner of the port on the CPU against the JAX package's on the
same numpy inputs (tests/test_pipeline.py's two meshes at 160x120, the
bumpy spheres (50, 3) and (40, 2), side by side in one frame): the
(M, T, 3, 3) table
bit for bit, refine and track at the slice bounds (0.1 deg, 0.2 mm,
fitness 5e-3, as tests/test_torch_slice.py: the ICP convergence latch
amplifies reduction-order ULPs), the padding triangles, the unbatched
call, its errors, and model ids with stacked scenes
(tests/test_multiscene.py:148-178).

JAX refines with ``use_pallas=False`` (its scatter raster), as in
tests/test_torch_slice.py.
"""

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
import pose_refine_tpu_torch as ptt
from pose_refine_tpu_torch.ops import rasterize_cuda as RC
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg
from tests.test_icp import reference_demo_poses
from tests.test_torch_multiscene import multiscene_frames, perturbed

torch.set_num_threads(2)

W, H = 160, 120
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
CFG = dict(width=W, height=H, max_points=4096, window=64, stride=1)


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def composite(*depths):
    """Min-nonzero depth composite: several objects in one sensor frame
    (tests/test_tracking.py:178)."""
    out = np.zeros_like(depths[0])
    for d in depths:
        out = np.where((d > 0) & ((out == 0) | (d < out)), d, out)
    return out


@pytest.fixture(scope="module")
def setup():
    """The two meshes side by side in one 160x120 frame (tests/
    test_tracking.py:187-203's two-object layout: the reference rotation at
    x = -45 mm and +45 mm, z = 300 mm), and 4 hypotheses of models
    [0, 1, 0, 1], each +-2 deg/axis, +-3 mm around its own object's truth.
    Every hypothesis sees its own object, as in a multi-object frame: a
    mesh refined against another mesh's surface is an ill-posed fit whose
    result moves by degrees with rounding."""
    K = small_K()
    m1 = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    m2 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=2)
    _, pose2, _ = reference_demo_poses()
    truths = np.stack([pose2, pose2]).astype(np.float32)
    truths[0, :3, 3] = [-45.0, 0.0, 300.0]
    truths[1, :3, 3] = [45.0, 0.0, 300.0]
    scene = composite(*[
        np.asarray(prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
                   .render_depth(t))[0].astype(np.int32) for m, t in zip((m1, m2), truths)])
    ids = np.array([0, 1, 0, 1], np.int32)
    return K, m1, m2, truths, scene, ids


def starts_around(truths, ids, seed):
    """One hypothesis per id, +-2 deg/axis and +-3 mm around its truth."""
    rng = np.random.default_rng(seed)
    d = np.asarray(jgeo.euler_to_rotation(
        rng.uniform(-0.035, 0.035, (len(ids), 3)).astype(np.float32)))
    return np.asarray(jgeo.pose_from_Rt(
        d @ truths[ids, :3, :3],
        truths[ids, :3, 3] + rng.uniform(-3, 3, (len(ids), 3)).astype(np.float32)
    )).astype(np.float32)


@pytest.fixture(scope="module")
def multiscene_setup():
    return multiscene_frames()


def assert_slice_bounds(tposes, jposes, tfit, jfit):
    tposes, jposes = np.asarray(tposes), np.asarray(jposes)
    assert tposes.shape == jposes.shape and np.isfinite(tposes).all()
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[..., :3, 3] - jposes[..., :3, 3]).max() <= MAX_DT_MM
    assert np.abs(np.asarray(tfit) - np.asarray(jfit)).max() <= MAX_DFIT


@pytest.mark.parametrize("decimate_mm", [0.0, 6.0])
def test_tris_table_matches_jax(setup, decimate_mm):
    """The (M, T, 3, 3) table (decimation, Morton order, zero-area padding
    at the first vertex) equals JAX's bit for bit; a padding triangle gets
    an empty box in triangle_setup, and a model rendered through its padded
    table equals its own render."""
    K, m1, m2, truths, scene, ids = setup
    t = ptt.MultiModelRefiner([m1, m2], K=K, device="cpu", decimate_mm=decimate_mm, **CFG)
    j = prt.MultiModelRefiner([m1, m2], K=K, use_pallas=False, decimate_mm=decimate_mm, **CFG)
    assert t.tris_table.shape == j.tris_table.shape and t.tris_table.shape[0] == 2
    np.testing.assert_array_equal(t.tris_table.numpy(), np.asarray(j.tris_table))
    n2 = len(t.models[1].tris) if decimate_mm == 0.0 else \
        len(ptt.simplify_vertex_clustering(m2, decimate_mm).tris)
    pad = t.tris_table[1, n2:]
    assert len(pad) > 0 and torch.equal(pad, t.tris_table[1, :1, :1].expand_as(pad))
    pose = torch.as_tensor(truths[1:])
    coef = RC.triangle_setup(t.tris_table[1:], pose, t.proj, W, H, (0, 0, 0, 0))
    assert (coef[0, 9, n2:] > coef[0, 11, n2:]).all()  # x_start > x_max: empty
    padded = RC.rasterize(t.tris_table[1], pose, W, H, t.proj, device="cpu")
    alone = RC.rasterize(t.tris_table[1, :n2], pose, W, H, t.proj, device="cpu")
    assert torch.equal(padded, alone) and int((alone > 0).sum()) > 500


@pytest.mark.parametrize("seed", [3, 4])
def test_refine_matches_jax(setup, seed):
    """A mixed batch [0, 1, 0, 1] against the two-object frame: the port
    against JAX at the slice bounds, each row equal to a single-model
    refine of its mesh bit for bit, and every hypothesis finding its
    object (translation within 2 mm: the coarse (40, 2) sphere's rotation is
    weakly observed at 160x120)."""
    K, m1, m2, truths, scene, ids = setup
    starts = starts_around(truths, ids, seed)
    t = ptt.MultiModelRefiner([m1, m2], K=K, device="cpu", **CFG).set_scene_depth(scene)
    j = prt.MultiModelRefiner([m1, m2], K=K, use_pallas=False, **CFG)
    j.set_scene_depth(scene)
    tposes, tres = t.refine(ids, starts)
    jposes, jres = j.refine(ids, starts)
    assert_slice_bounds(tposes, jposes, tres.fitness, jres.fitness)
    for k, m in enumerate((m1, m2)):
        rows = ids == k
        single = ptt.PoseRefiner(m, K=K, device="cpu", **CFG).set_scene_depth(scene)
        s_poses, s_res = single.refine(starts[rows])
        assert torch.equal(s_poses, tposes[rows]) and torch.equal(s_res.fitness, tres.fitness[rows])
        assert np.abs(tposes.numpy()[rows, :3, 3] - truths[k, :3, 3]).max() < 2.0
    assert float(tres.fitness.min()) > 0.7


def test_track_matches_jax(setup):
    """MultiModelRefiner.track with the covariance against JAX's."""
    K, m1, m2, truths, scene, ids = setup
    ids = np.array([0, 0, 1, 0], np.int32)
    starts = starts_around(truths, ids, 5)
    t = ptt.MultiModelRefiner([m1, m2], K=K, device="cpu", **CFG)
    j = prt.MultiModelRefiner([m1, m2], K=K, use_pallas=False, **CFG)
    tposes, tres, tunc = t.track(scene, ids, starts, with_covariance=True)
    jposes, jres, junc = j.track(scene, ids, starts, with_covariance=True)
    assert_slice_bounds(tposes, jposes, tres.fitness, jres.fitness)
    assert tunc.covariance.shape == (4, 6, 6) and bool(torch.isfinite(tunc.covariance).all())
    assert np.abs(tposes.numpy()[:, :3, 3] - truths[ids, :3, 3]).max() < 2.0


def test_single_pose_and_errors(setup):
    """A scalar id with one (4, 4) pose returns unbatched results; ids out
    of range, a count that does not match the poses, and a missing pose
    argument raise."""
    K, m1, m2, truths, scene, ids = setup
    starts = starts_around(truths, ids, 6)
    t = ptt.MultiModelRefiner([m1, m2], K=K, device="cpu", **CFG).set_scene_depth(scene)
    pose, res = t.refine(0, starts[0])
    assert pose.shape == (4, 4) and res.fitness.shape == ()
    batch, _ = t.refine([0], starts[:1])
    np.testing.assert_allclose(pose.numpy(), batch[0].numpy(), atol=1e-6)
    for bad in ([2], [-1]):
        with pytest.raises(ValueError, match="model_ids"):
            t.refine(bad, starts[:1])
    with pytest.raises(ValueError, match="model ids for"):
        t.refine([0, 1], starts[:3])
    with pytest.raises(TypeError, match="init_poses"):
        t.refine([0])
    with pytest.raises(TypeError, match="init_poses"):
        t.track(scene, [0])
    with pytest.raises(ValueError, match="at least one model"):
        ptt.MultiModelRefiner([], K=K, device="cpu")


def test_multimodel_multiscene(multiscene_setup):
    """Model ids and scene ids together (tests/test_multiscene.py:148-178):
    frame 2 re-rendered with an icosphere, its hypotheses on model 1; every
    pose lands on its frame's truth, and frame 2's rows equal a dedicated
    single-model, single-frame refiner's. The port against JAX at the
    slice bounds (translation alone on the icosphere's rows)."""
    m, K, truths, frames = multiscene_setup
    m2 = mesh.make_icosphere(radius=45.0, subdivisions=3)
    frames = frames.copy()
    frames[2] = np.asarray(prt.PoseRenderer(m2, K=K, width=W, height=H, backend="dense")
                           .render_depth(truths[2]))[0].astype(np.int32)
    cfg = dict(CFG, auto_roi=False)
    hyps, ids = perturbed(truths, np.random.default_rng(5), per=2)
    model_ids = np.where(ids == 2, 1, 0)
    t = ptt.MultiModelRefiner([m, m2], K=K, device="cpu", **cfg).set_scene_depths(frames)
    tposes, tres = t.refine(model_ids, hyps, scene_ids=ids)
    for pose, k in zip(tposes.numpy(), ids):
        assert np.abs(pose[:3, 3] - truths[k][:3, 3]).max() < 4.0
    assert float(tres.fitness.min()) > 0.5
    j = prt.MultiModelRefiner([m, m2], K=K, use_pallas=False, **cfg).set_scene_depths(frames)
    jposes, jres = j.refine(model_ids, hyps, scene_ids=ids)
    # the icosphere's rotation is unobservable (and with it the facets its
    # fitness counts): its rows compare translation only
    bumpy = model_ids == 0
    assert_slice_bounds(tposes[bumpy], np.asarray(jposes)[bumpy], tres.fitness[bumpy],
                        np.asarray(jres.fitness)[bumpy])
    assert np.abs(tposes.numpy()[:, :3, 3] - np.asarray(jposes)[:, :3, 3]).max() <= MAX_DT_MM
    single = ptt.PoseRefiner(m2, K=K, device="cpu", **cfg).set_scene_depth(frames[2])
    rows = ids == 2
    r_k, _ = single.refine(hyps[rows])
    np.testing.assert_allclose(tposes[rows].numpy(), r_k.numpy(), atol=1e-5)
