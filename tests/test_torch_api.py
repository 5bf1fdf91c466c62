"""The reference's user-facing layer and the refiner options of this slice
in the port against the JAX package on the CPU, on the same numpy inputs:
PoseRenderer (depth, mask, depth + mask, down_sample, ROI, the deferred K),
get_bbox, the converters, render's backends and rasterize_scatter,
compact_points / depth_to_cloud, PoseRefiner(lift="compact"),
refine(schedule=) with its conflict error and the replaced gate, fence, and
the options' way through track(). The card's side: tests/test_torch_device.py
and chip_smoke.py's [renderer], [compact] and [schedule]."""

import functools

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize as JR
import pose_refine_tpu.ops.rasterize_pallas as JRP
import pose_refine_tpu_torch as ptt
import pose_refine_tpu_torch.ops.depth_to_cloud  # noqa: F401
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.ops import depth_to_cloud as jd2c
from pose_refine_tpu_torch.ops import depth_to_cloud as td2c
from pose_refine_tpu_torch.ops import rasterize as TR
from pose_refine_tpu_torch.pipeline import _scene_with_gate
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 160, 120
VERDICT_DEG = 3.0
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)
# tests/test_pipeline.py:104-126's schedule
SCHEDULE = [(0.4, 15), (0.1, 20), (0.03, 15)]


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def demo_poses():
    """tests/test_icp.py:22's start and truth."""
    ang = np.float32(10.0 / 180.0 * 3.14)
    rot = np.asarray(jgeo.euler_to_rotation(np.array([ang, ang, ang])))
    pose1 = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0.0, 0.0, 300.0], np.float32)))
    pose2 = np.asarray(jgeo.pose_from_Rt(rot @ R_REN, np.array([20.0, 20.0, 320.0],
                                                               np.float32)))
    return pose1, pose2


@pytest.fixture(scope="module")
def setup():
    """tests/test_pipeline.py's setup: the bumpy sphere (50, 3), K / 4 at
    160x120; the scene at the perturbed pose; the start, the truth and
    tests/test_pipeline.py:111's 25 deg / 40 mm start."""
    K = small_K()
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    pose1, pose2 = demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    big = np.float32(25.0 / 180.0 * np.pi)
    rot = np.asarray(jgeo.euler_to_rotation(np.array([big, big, big])))
    far = np.asarray(jgeo.pose_from_Rt(rot @ pose2[:3, :3], pose2[:3, 3] + np.float32(40.0)))
    return m, K, pose1, pose2, far, scene


@pytest.fixture
def pallas_raster(monkeypatch):
    """The JAX refiner's use_pallas=True raster in interpret mode on the
    CPU: the function the port's raster computes."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))


def renderer_poses(pose1, pose2):
    """Four poses: the two recipe poses and two nearer turned copies."""
    extra = []
    for i, (a, z) in enumerate(((0.3, 260.0), (-0.5, 340.0))):
        rot = np.asarray(jgeo.euler_to_rotation(np.array([a, -a, 0.5 * a], np.float32)))
        extra.append(np.asarray(jgeo.pose_from_Rt(rot @ R_REN,
                                                  np.array([10.0 * i, -5.0, z], np.float32))))
    return np.stack([pose1, pose2, *extra])


@pytest.mark.parametrize("backend", [None, "dense"])
@pytest.mark.parametrize("down_sample,roi", [(1, (0, 0, 0, 0)), (2, (0, 0, 0, 0)),
                                             (1, (24, 16, 96, 80)), (2, (10, 6, 48, 40))])
def test_pose_renderer_matches_jax(setup, backend, down_sample, roi):
    """PoseRenderer's depth, mask and depth + mask (one render) against JAX
    PoseRenderer(backend="dense"), bit for bit, at full size and down_sample
    2 (the projection kept from the full-resolution K), with and without an
    ROI; the port's default backend is the raster kernel's plain version on
    the CPU."""
    m, K, pose1, pose2, _far, _scene = setup
    poses = renderer_poses(pose1, pose2)
    j = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    t = ptt.PoseRenderer(m, K=K, width=W, height=H, backend=backend, device="cpu")
    np.testing.assert_array_equal(t.proj_mat.numpy(), np.asarray(j.proj_mat))
    want_d = np.asarray(j.render_depth(poses, down_sample, roi))
    want_m = np.asarray(j.render_mask(poses, down_sample, roi))
    got_d = t.render_depth(poses, down_sample, roi)
    got_m = t.render_mask(poses, down_sample, roi)
    both = t.render_depth_mask(poses, down_sample, roi)
    assert got_d.dtype == torch.uint16 and got_m.dtype == torch.uint8
    assert (want_d > 0).sum() > 1000
    for got, want in ((got_d, want_d), (got_m, want_m), (both[0], want_d), (both[1], want_m)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_pose_renderer_deferred_K_and_single_pose(setup):
    """The constructor's size survives a later set_K_width_height(K)
    (tests/test_api_edge_cases.py:79), rendering before K raises, a (4, 4)
    pose renders as a batch of one, and view_dep and get_bbox equal JAX's."""
    m, K, pose1, pose2, _far, _scene = setup
    t = ptt.PoseRenderer(m, width=W, height=H, device="cpu")
    with pytest.raises(RuntimeError, match="set_K_width_height"):
        t.render_depth(pose1)
    t.set_K_width_height(K)
    j = prt.PoseRenderer(m, width=W, height=H, backend="dense")
    j.set_K_width_height(K)
    assert (t.width, t.height) == (j.width, j.height) == (W, H)
    got, want = t.render_depth(pose2), np.asarray(j.render_depth(pose2))
    assert tuple(got.shape) == (1, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ptt.PoseRenderer.view_dep(got[0]),
                                  prt.PoseRenderer.view_dep(want[0]))
    assert ptt.get_bbox(got[0]) == prt.get_bbox(want[0]) != (0, 0, 0, 0)
    assert ptt.get_bbox(np.zeros((4, 4))) == prt.get_bbox(np.zeros((4, 4))) == (0, 0, 0, 0)


def test_converters_match_jax():
    """raw_to_depth_u16 (wrapping past 65535 as JAX's convert does),
    raw_to_mask_u8 and raw_to_depth_mask, exact."""
    raw = np.array([[[0, 1, 300, 65535], [65536, 70000, -1, 2 ** 31 - 1]]], np.int32)
    got = [ptt.raw_to_depth_u16(torch.as_tensor(raw)), ptt.raw_to_mask_u8(torch.as_tensor(raw)),
           *ptt.raw_to_depth_mask(torch.as_tensor(raw))]
    want = [prt.raw_to_depth_u16(raw), prt.raw_to_mask_u8(raw), *prt.raw_to_depth_mask(raw)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("roi", [(0, 0, 0, 0), (24, 16, 96, 80)])
@pytest.mark.parametrize("backend", ["dense", "scatter", None, "pallas"])
def test_render_backends_match_jax(setup, backend, roi):
    """render(backend=) against JAX's render of the same backend name, bit
    for bit (JAX's None / "pallas" is its Pallas kernel, in interpret mode
    here; the port's is the raster kernel's plain version), and
    max_bbox_extent equal to JAX's."""
    m, K, pose1, pose2, _far, _scene = setup
    tris = m.tris[mesh.morton_order(m.tris)]
    poses = renderer_poses(pose1, pose2)
    proj = np.asarray(jgeo.compute_proj(K, W, H))
    kw = dict(tri_chunk=256) if backend == "scatter" else {}
    if backend in (None, "pallas"):
        want = JRP.rasterize_pallas(tris, poses, W, H, proj, roi=roi, interpret=True)
    else:
        want = JR.render(tris, poses, W, H, proj, roi=roi, backend=backend, **kw)
    got = ptt.render(tris, poses, W, H, proj, roi=roi, backend=backend, device="cpu", **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TR.max_bbox_extent(torch.as_tensor(tris), torch.as_tensor(poses), W, H,
                              torch.as_tensor(proj), roi) == JR.max_bbox_extent(
                                  tris, poses, W, H, proj, roi)


def test_render_refuses_an_unknown_backend(setup):
    m, K, pose1, _pose2, _far, _scene = setup
    proj = np.asarray(jgeo.compute_proj(K, W, H))
    with pytest.raises(ValueError, match="unknown rasterize backend"):
        ptt.render(m.tris, pose1[None], W, H, proj, backend="opengl", device="cpu")


def random_depth(seed, h=60, w=80):
    """tests/test_depth_to_cloud.py's depth: a block of 250-400 mm."""
    depth = np.zeros((h, w), np.int32)
    depth[10:40, 20:60] = np.random.default_rng(seed).integers(250, 400, size=(30, 40))
    return depth


def assert_within_ulp(got, want, ulps=2):
    """float32 arrays equal up to ``ulps`` units in the last place
    (tests/test_torch_lift_scene.py's helper): XLA's CPU backend turns the
    lift's division by 1000 into a product with its rounded reciprocal,
    which the port does not, so z may differ by 1 ULP and x, y, its
    products, by 2."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    d[(got == 0) & (want == 0)] = 0
    assert d.max() <= ulps


@pytest.mark.parametrize("max_points", [2048, 1200, 100])
def test_compact_points_matches_jax(max_points):
    """compact_points against JAX's on the same point image, bit for bit:
    slots in scan order, the true count, points past the budget dropped
    (tests/test_depth_to_cloud.py:26-50); depth_to_cloud's slots and count
    exact and its coordinates within 2 ULPs of JAX's; a batch of two images
    equals each image alone."""
    K = jgeo.LINEMOD_K
    depths = np.stack([random_depth(0), random_depth(1)])
    depths[1, 20:] = 0
    for d in depths:
        jpts, jmask = jd2c.depth_image_to_points(d, K)
        got = ptt.ops.depth_to_cloud.compact_points(torch.as_tensor(np.asarray(jpts)),
                                                    torch.as_tensor(np.asarray(jmask)),
                                                    max_points)
        want = jd2c.compact_points(jpts, jmask, max_points)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[2]) == (d > 0).sum()
        assert int(got[1].sum()) == min(max_points, (d > 0).sum())
        lifted = ptt.depth_to_cloud(torch.as_tensor(d), K, max_points)
        np.testing.assert_array_equal(lifted[1].numpy(), np.asarray(want[1]))
        assert int(lifted[2]) == int(want[2])
        assert_within_ulp(lifted[0].numpy(), want[0])
    pts, mask = td2c.depth_image_to_points(torch.as_tensor(depths), K)
    batch = td2c.compact_points(pts, mask, max_points)
    for i, d in enumerate(depths):
        one = td2c.compact_points(pts[i], mask[i], max_points)
        for b, o in zip(batch, one):
            assert torch.equal(b[i], o)


@pytest.mark.parametrize("stride,tl", [(1, (0, 0)), (2, (7, 3))])
def test_depth_to_cloud_stride_and_origin_match_jax(stride, tl):
    """depth_to_cloud's stride and crop origin (the true pixel coordinate
    enters the projection): slots and count exact, coordinates within 2
    ULPs of JAX's."""
    K = jgeo.LINEMOD_K
    d = random_depth(2)
    got = ptt.depth_to_cloud(torch.as_tensor(d), K, 1024, stride=stride, tl_x=tl[0], tl_y=tl[1])
    want = jd2c.depth_to_cloud(d, K, 1024, stride=stride, tl_x=tl[0], tl_y=tl[1])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) == (d[::stride, ::stride] > 0).sum()
    assert_within_ulp(got[0].numpy(), want[0])


def assert_refines_agree(truth, jposes, jres, tposes, tres):
    jposes, tposes = np.asarray(jposes), tposes.numpy()
    assert tposes.shape == jposes.shape and np.isfinite(tposes).all()
    np.testing.assert_array_equal(rotation_angle_deg(tposes, truth) < VERDICT_DEG,
                                  rotation_angle_deg(jposes, truth) < VERDICT_DEG)
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[..., :3, 3] - jposes[..., :3, 3]).max() <= MAX_DT_MM
    assert np.abs(tres.fitness.numpy() - np.asarray(jres.fitness)).max() <= MAX_DFIT
    np.testing.assert_array_equal(tres.n_points.numpy(), np.asarray(jres.n_points))


@pytest.mark.parametrize("scene_kind", ["projective", "nn"])
def test_lift_compact_refine_matches_jax(setup, pallas_raster, scene_kind):
    """PoseRefiner(lift="compact") - every valid render pixel in scan
    order, no Morton order - against the JAX refiner, with the auto point
    budget (the compact branch of the planning: the whole object, no
    stride): the same max_points, the slice bounds, n_points equal. The
    lifted coordinates differ from JAX's by up to 2 ULPs (see
    assert_within_ulp); against the NN scene the 25 deg start, which does
    not converge, turns that into a rotation delta above the bounds, so
    there it is held to the verdict and n_points alone."""
    m, K, pose1, pose2, far, scene = setup
    poses = np.stack([pose1, far, renderer_poses(pose1, pose2)[2]])
    kw = dict(lift="compact", max_points="auto", window=64, render_scale=2)
    if scene_kind == "nn":
        kw.update(scene="nn", scene_voxel_mm=2.0)
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=True, **kw)
    jref.set_scene_depth(scene)
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **kw)
    tref.set_scene_depth(scene)
    assert tref.max_points == jref.max_points and tref.roi == jref.roi
    jposes, jres = jref.refine(poses)
    tposes, tres = tref.refine(poses)
    keep = [0, 2] if scene_kind == "nn" else [0, 1, 2]
    assert_refines_agree(pose2, np.asarray(jposes)[keep], jres._replace(
        fitness=np.asarray(jres.fitness)[keep], n_points=np.asarray(jres.n_points)[keep]),
        tposes[keep], tres._replace(fitness=tres.fitness[keep], n_points=tres.n_points[keep]))
    assert (rotation_angle_deg(tposes.numpy()[1], pose2) < VERDICT_DEG) == (
        rotation_angle_deg(np.asarray(jposes)[1], pose2) < VERDICT_DEG)
    np.testing.assert_array_equal(tres.n_points.numpy(), np.asarray(jres.n_points))
    assert float(tres.n_points.max()) < tref.max_points


def test_schedule_matches_jax(setup, pallas_raster):
    """refine(schedule=[(0.4, 15), (0.1, 20), (0.03, 15)]) from
    tests/test_pipeline.py:104-126's 25 deg / 40 mm start: the port and the
    JAX refiner within the slice bounds, both converged (< 5 deg), each no
    worse than its single-level refine; with_covariance only on the last
    level (a third output)."""
    m, K, pose1, pose2, far, scene = setup
    kw = dict(max_points=8192)
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=True, **kw)
    jref.set_scene_depth(scene)
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **kw)
    tref.set_scene_depth(scene)
    starts = np.stack([far, pose1])
    jposes, jres = jref.refine(starts, schedule=SCHEDULE)
    tposes, tres = tref.refine(starts, schedule=SCHEDULE)
    assert_refines_agree(pose2, jposes, jres, tposes, tres)
    single, _ = tref.refine(starts)
    err = rotation_angle_deg(tposes.numpy(), pose2)
    assert err[0] < 5.0 and (err <= rotation_angle_deg(single.numpy(), pose2) + 1e-3).all()
    out = tref.refine(starts, schedule=SCHEDULE, with_covariance=True)
    assert len(out) == 3 and torch.equal(out[0], tposes)
    assert torch.isfinite(out[2].covariance).all()


def test_schedule_coarse_iters_conflict_matches_jax(setup, pallas_raster):
    """tests/test_pipeline.py:361-376: with coarse_iters=12 a level of 10
    iterations is JAX's ValueError (naming both mechanisms); compatible
    levels run, recover (< 5 deg) and agree with JAX within the slice
    bounds."""
    m, K, pose1, pose2, _far, scene = setup
    kw = dict(stride=1, coarse_iters=12, coarse_stride=2)
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=True, **kw)
    jref.set_scene_depth(scene)
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **kw)
    tref.set_scene_depth(scene)
    for ref in (jref, tref):
        with pytest.raises(ValueError, match="schedule") as err:
            ref.refine(pose1, schedule=[(0.25, 10), (0.05, 20)])
        assert "coarse_iters=12" in str(err.value)
    sched = [(0.25, 15), (0.05, 20)]
    jpose, jres = jref.refine(pose1, schedule=sched)
    tpose, tres = tref.refine(pose1, schedule=sched)
    assert rotation_angle_deg(tpose.numpy(), pose2) < 5.0
    assert rotation_angle_deg(tpose.numpy(), np.asarray(jpose)) <= MAX_DROT_DEG
    assert abs(float(tres.fitness) - float(jres.fitness)) <= MAX_DFIT


@pytest.mark.parametrize("kind", ["projective", "nn", "nn_bruteforce"])
def test_schedule_gate_replaces_every_launchers_gate(setup, kind):
    """_scene_with_gate gives the scene JAX's float32 gate (a 0-d float32
    tensor on the table's device, or its value as a host float for NN
    scenes) and shares the tables; a refine against it equals, bit for bit,
    the refine against a scene built with that gate - kd traversal and
    gated NN alike (no cached launcher keeps the old gate) - and differs
    from the one at the old gate."""
    m, K, pose1, pose2, far, scene = setup
    gate = 0.003
    kw = dict(max_points=1024) if kind == "projective" else dict(scene=kind, max_points=1024)
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **kw).set_scene_depth(scene)
    narrow = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", max_dist_diff=gate,
                             **kw).set_scene_depth(scene)
    swapped = _scene_with_gate(ref.scene, gate)
    f32 = float(np.float32(gate))
    if kind == "projective":
        assert swapped.max_dist_diff.dtype == torch.float32
        assert float(swapped.max_dist_diff) == f32
    else:
        assert swapped.max_dist_diff == f32 != gate
        assert swapped.kd is ref.scene.kd or swapped.kd is None
    assert swapped.table is ref.scene.table
    starts = np.stack([far, pose1])
    crit = ptt.ICPConvergenceCriteria(max_iteration=6)
    got = ref.refine(starts, crit, _scene=swapped)
    want = narrow.refine(starts, crit)
    wide = ref.refine(starts, crit)
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    assert torch.equal(got[0], want[0]) and not torch.equal(got[0], wide[0])


def test_fence_returns_in_argument_order(setup):
    """fence(*pending) waits on each PendingResult and returns the outputs
    in argument order, each equal to the synchronous refine of its batch."""
    m, K, pose1, pose2, far, scene = setup
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu",
                          max_points=1024).set_scene_depth(scene)
    crit = ptt.ICPConvergenceCriteria(max_iteration=5)
    batches = [np.stack([pose1]), np.stack([far, pose1]), np.stack([pose2, far, pose1])]
    pending = [ref.refine_async(b, crit) for b in batches]
    out = ptt.fence(*pending)
    assert isinstance(out, list) and len(out) == 3
    for b, (poses, res) in zip(batches, out):
        want_poses, want_res = ref.refine(b, crit)
        assert poses.shape == (len(b), 4, 4)
        assert torch.equal(poses, want_poses) and torch.equal(res.fitness, want_res.fitness)
    assert ptt.fence() == []


def test_track_carries_the_slice_options(setup):
    """track() (the scene rebuilt from the frame) passes lift, coarse_iters
    and coarse_stride to the refine: the tracked poses equal, bit for bit,
    set_scene_depth(frame) + refine() of the same refiner, and differ from a
    tracker without the options."""
    m, K, pose1, pose2, far, scene = setup
    kw = dict(max_points=2048, lift="compact", coarse_iters=8, coarse_stride=3)
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **kw)
    plain = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", max_points=2048)
    starts = np.stack([pose1, far])
    tracked, tres = ref.track(scene, starts)
    other, _ = plain.track(scene, starts)
    ref.set_scene_depth(scene)
    refined, rres = ref.refine(starts)
    assert torch.equal(tracked, refined) and torch.equal(tres.fitness, rres.fitness)
    assert not torch.equal(tracked, other)


def test_multimodel_schedule_recurses_through_the_base_refine(setup):
    """MultiModelRefiner.refine(model_ids, poses, schedule=) runs each level
    through the base class's refine with the per-pose meshes: with one
    model it equals PoseRefiner's scheduled refine bit for bit."""
    m, K, pose1, pose2, far, scene = setup
    sched = [(0.2, 6), (0.05, 6)]
    starts = np.stack([far, pose1])
    mm = ptt.MultiModelRefiner([m], K=K, width=W, height=H, device="cpu",
                               max_points=1024).set_scene_depth(scene)
    single = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu",
                             max_points=1024).set_scene_depth(scene)
    got = mm.refine([0, 0], starts, schedule=sched)
    want = single.refine(starts, schedule=sched)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].fitness, want[1].fitness)
