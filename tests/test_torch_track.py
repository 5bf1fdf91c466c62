"""The tracking slice of the port on the CPU against the JAX package on the
same numpy inputs: the device-built NN scene, the pose uncertainty,
refine(with_covariance=True), PoseRefiner.track for both scene kinds and
the packed session buffer (TrackingSession: tests/test_torch_session.py).

The JAX side renders through its Pallas raster in interpret mode (the
kernel the port's raster equals, tests/test_torch_nn_slice.py) and its
device-built NN scene queries through ``backend="flash"`` (the Pallas
flash-NN in interpret mode, which the port's plain NN equals in the gate):
its default CPU query ``_nn_bruteforce`` rounds otherwise and flips
near-tie neighbours (ROADMAP C). Render, lift and association agree to
float32 rounding; the ICP convergence latch amplifies that into the slice
bounds of tests/test_torch_slice.py (0.1 deg, 0.2 mm, fitness 5e-3).
"""

import dataclasses
import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize as JR
import pose_refine_tpu.ops.rasterize_pallas as JRP
import pose_refine_tpu.pipeline as jpipe
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import icp as jicp
from pose_refine_tpu import mesh
from pose_refine_tpu.ops.depth_to_cloud import depth_image_to_points as jd2p
from pose_refine_tpu.ops.normals import estimate_normals as jnormals
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu.scene import projective as jproj
import pose_refine_tpu_torch as ptt
import pose_refine_tpu_torch.tracking as ttrack
from pose_refine_tpu_torch import icp as ticp
from pose_refine_tpu_torch.pipeline import PendingResult
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.scene import nn_flash as NF
from pose_refine_tpu_torch.scene import projective as tproj
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 160, 120
CFG = dict(width=W, height=H, max_points=1024, window=64, stride=1)
ITERS = 24
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def render(m, pose, K=None):
    K = small_K() if K is None else K
    return np.array(JR.rasterize_dense(m.tris, np.asarray(pose)[None], W, H,
                                       jgeo.compute_proj(K, W, H)))[0]


def drift(truth, rng, rot=0.02, trans=3.0):
    """tests/test_tracking.py's per-frame drift."""
    d = np.asarray(jgeo.euler_to_rotation(rng.uniform(-rot, rot, 3).astype(np.float32)))
    return np.asarray(jgeo.pose_from_Rt(
        d @ truth[:3, :3], truth[:3, 3] + rng.uniform(-trans, trans, 3).astype(np.float32)))


@pytest.fixture(scope="module")
def setup():
    """The bumpy sphere at the reference viewpoint, its 160x120 depth, and
    6 tracking hypotheses (+-3 deg/axis, +-5 mm)."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.05, 0.05, (6, 3)).astype(np.float32)
    d_t = rng.uniform(-5, 5, (6, 3)).astype(np.float32)
    poses = np.asarray(jgeo.pose_from_Rt(
        np.einsum("nij,jk->nik", np.asarray(jgeo.euler_to_rotation(ang)), truth[:3, :3]),
        truth[:3, 3] + d_t))
    return m, truth, poses, render(m, truth)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX refiner's Pallas raster in interpret mode and its
    device-built NN scenes on the flash backend. The fused track programs'
    jit caches are cleared around the patch, so no trace leaks in or out."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))
    orig = jnn.SceneNN.__dict__["from_depth_device"].__func__

    def flash(cls, *args, **kwargs):
        return dataclasses.replace(orig(cls, *args, **kwargs), backend="flash")

    monkeypatch.setattr(jnn.SceneNN, "from_depth_device", classmethod(flash))
    jpipe.track_poses_jit.clear_cache()
    jpipe.track_poses_nn_jit.clear_cache()
    yield
    jpipe.track_poses_jit.clear_cache()
    jpipe.track_poses_nn_jit.clear_cache()


def assert_poses_agree(tposes, jposes, tfit, jfit):
    """The slice bounds between two refined batches."""
    tposes, jposes = np.asarray(tposes), np.asarray(jposes)
    assert tposes.shape == jposes.shape and np.isfinite(tposes).all()
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[..., :3, 3] - jposes[..., :3, 3]).max() <= MAX_DT_MM
    assert np.abs(np.asarray(tfit) - np.asarray(jfit)).max() <= MAX_DFIT


def max_rel(a, b):
    """Largest |a - b| over the largest |b|, per leading index."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    axes = tuple(range(1, b.ndim))
    return (np.abs(a - b).max(axis=axes) / np.abs(b).max(axis=axes)).max()


# ---------------------------------------------------------------- the NN scene


@pytest.mark.parametrize("shape", [(120, 160), (61, 80), (7, 5)])
def test_grid_morton_perm_matches_jax(shape):
    got = tnn._grid_morton_perm(*shape)
    np.testing.assert_array_equal(got, jnn._grid_morton_perm(*shape))
    assert sorted(got.tolist()) == list(range(shape[0] * shape[1]))


@pytest.mark.parametrize("pool", [2, 3])
def test_pool_scene_grid_matches_jax(setup, pool):
    """On the same point, normal and mask grids the pooled grid equals JAX's
    reduce_window pooling: the kept pixels and the masks exactly, block sums
    of 4 terms bit for bit; sums of 9 terms round in another order, within
    2 ULPs."""
    _m, _truth, _poses, depth = setup
    pts, mask = jd2p(jnp.asarray(depth), jnp.asarray(small_K()))
    nrm = jnormals(jnp.asarray(depth), jnp.asarray(small_K()))
    want = [np.asarray(x) for x in jnn._pool_scene_grid(pts, nrm, mask, pool, 0.005)]
    got = [x.numpy() for x in tnn._pool_scene_grid(
        *(torch.as_tensor(np.array(x)) for x in (pts, nrm, mask)), pool, 0.005)]
    np.testing.assert_array_equal(got[2], want[2])
    assert 0 < got[2].sum() < got[2].size
    for g, w in zip(got[:2], want[:2]):
        if pool == 2:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=1.2e-7)


SCENE_FIELDS = ("points", "normals", "table", "flash_table", "flash_boxes")


@pytest.mark.parametrize("kw", [dict(stride=1), dict(stride=2), dict(pool=2)],
                         ids=["stride1", "stride2", "pool2"])
def test_from_depth_device_matches_jax(setup, kw):
    """The device-built scene's tables against JAX's, and its query against
    the JAX scene's flash query.

    The lifted points differ from JAX's by 1 ULP at some pixels (XLA
    evaluates dep2pcd in another order, tests/test_torch_lift_scene.py) and
    the normals by ~1e-7, so strided tables agree within 1e-6 (relative to
    1e6 m for the parked rows). Pooling keeps a pixel iff its depth is
    within 5 mm of its block's nearest, and integer-mm depths sit exactly
    on that edge: a 1-ULP z decides it, and a block whose kept set differs
    moves its centroid by up to a few mm. On the same lifted grids the
    pooling is bit-exact (test_pool_scene_grid_matches_jax); here at most
    3% of the pooled rows differ beyond 1e-6."""
    _m, _truth, _poses, depth = setup
    K = small_K()
    want = jnn.SceneNN.from_depth_device(jnp.asarray(depth), jnp.asarray(K), 0.02, **kw)
    got = tnn.SceneNN.from_depth_device(torch.as_tensor(depth), torch.as_tensor(K), 0.02, **kw)
    assert got.flash_balls.shape == (4, got.flash_table.shape[1] // 32)
    assert got.backend == "bruteforce" and got.max_dist_diff == 0.02
    for f in SCENE_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        close = np.isclose(g, w, rtol=1e-6, atol=1e-6)
        if "pool" in kw:
            assert close.mean() >= 0.97, f
        else:
            assert close.all(), f
    # NN queries: the port's plain gated NN against JAX's flash full scan
    rng = np.random.default_rng(4)
    pts = np.asarray(want.points)
    real = pts[np.abs(pts).max(-1) < 10.0]
    q = (real[rng.integers(0, len(real), 1500)] + rng.normal(0, 0.01, (1500, 3)))
    q = jnp.asarray(q.astype(np.float32))
    dst, nrm, valid = (x.numpy() for x in got.query(torch.as_tensor(np.array(q))))
    jd, jn, jv = map(np.asarray, dataclasses.replace(want, backend="flash").query(q))
    assert 0 < jv.sum() < jv.size
    both = valid & jv
    same = np.isclose(dst, jd, rtol=0, atol=1e-6).all(-1)
    if "pool" in kw:
        # the neighbour rows, by the full scan of each table (the plain
        # scan equals the JAX kernel bit for bit, test_torch_nn_flash.py):
        # wherever both chosen rows agree between the tables, the choice
        # and the validity agree too
        qt = torch.as_tensor(np.array(q))
        ti = NF.nn_flash_packed_plain(qt, got.flash_table)[0].numpy()
        ji = NF.nn_flash_packed_plain(qt, torch.as_tensor(np.asarray(want.flash_table)))[0].numpy()
        row_ok = np.isclose(got.table.numpy(), np.asarray(want.table), rtol=1e-6,
                            atol=1e-6).all(-1)
        sure = row_ok[ti] & row_ok[ji]
        assert sure.mean() >= 0.9
        np.testing.assert_array_equal(ti[sure], ji[sure])
        np.testing.assert_array_equal(valid[sure], jv[sure])
        assert same[both & sure].all()
    else:
        np.testing.assert_array_equal(valid, jv)
        assert same[both].all()
        np.testing.assert_allclose(nrm[both], jn[both], rtol=0, atol=1e-6)


def test_from_depth_device_parks_invalid_rows():
    """Invalid pixels take their chunk's first valid point and normal; a
    chunk with no valid pixel parks at 1e6 m with a zero normal."""
    depth = np.zeros((16, 16), np.int32)
    depth[2:6, 3:9] = 300
    K = small_K()
    scene = tnn.SceneNN.from_depth_device(torch.as_tensor(depth), torch.as_tensor(K))
    perm = tnn._grid_morton_perm(16, 16)
    valid = (depth.reshape(-1) > 0)[perm]
    pts = scene.points.numpy()
    for c in range(2):
        rows = slice(128 * c, 128 * (c + 1))
        v = valid[rows]
        if v.any():
            first = pts[rows][np.argmax(v)]
            np.testing.assert_array_equal(pts[rows][~v], np.broadcast_to(first, ((~v).sum(), 3)))
        else:
            assert (pts[rows] == 1.0e6).all() and (scene.normals.numpy()[rows] == 0).all()
    with pytest.raises(ValueError, match="alternative downsamplers"):
        tnn.SceneNN.from_depth_device(torch.as_tensor(depth), torch.as_tensor(K), stride=2,
                                      pool=2)


# ------------------------------------------------------------ the uncertainty


@pytest.mark.parametrize("shape", ["bumpy", "icosphere"])
def test_pose_information_matches_jax(shape):
    """pose_information / pose_covariance on the same clouds against the
    same scene depth. The scene tables agree within 2e-7, so info and sigma2
    agree within 1e-4 relative and the counts exactly. On the bumpy sphere
    the covariance agrees within 1e-3 relative; the icosphere leaves every
    rotation unobservable, its covariance is ridge-dominated (a 1e-6
    relative ridge of a near-singular matrix), and only info, sigma2 and
    count are compared."""
    m = (mesh.make_bumpy_sphere(radius=50.0, subdivisions=3) if shape == "bumpy"
         else mesh.make_icosphere(radius=50.0, subdivisions=3))
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    depth = render(m, truth)
    K = small_K()
    pts, mask = map(np.asarray, jd2p(jnp.asarray(depth), jnp.asarray(K)))
    cloud = pts.reshape(-1, 3)
    valid = mask.reshape(-1)
    # two clouds: the scene's own points moved by 2 and by 4 mm along a
    # small twist, as a refined cloud sits near its scene
    T = [np.asarray(jgeo.twist_to_mat4(np.array(v, np.float32)))
         for v in ([0.01, -0.02, 0.015, 0.002, -0.001, 0.001],
                   [-0.02, 0.01, 0.03, -0.004, 0.002, 0.0])]
    clouds = np.stack([cloud @ t[:3, :3].T + t[:3, 3] for t in T]).astype(np.float32)
    valids = np.stack([valid, valid])
    jscene = jproj.SceneProjective.from_depth(depth, K, 0.1)
    tscene = tproj.SceneProjective.from_depth(depth, K, 0.1, device="cpu")
    want = [jicp.pose_information(jnp.asarray(c), jnp.asarray(v), jscene.query)
            for c, v in zip(clouds, valids)]
    info, sigma2, count = ticp.pose_information(torch.as_tensor(clouds),
                                                torch.as_tensor(valids), tscene.query)
    j_info = np.stack([np.asarray(w[0]) for w in want])
    j_sigma2 = np.array([float(w[1]) for w in want])
    np.testing.assert_array_equal(count.numpy(), [float(w[2]) for w in want])
    assert max_rel(info.numpy(), j_info) <= 1e-4
    np.testing.assert_allclose(sigma2.numpy(), j_sigma2, rtol=1e-4)
    floor = np.float32(jicp.DEPTH_QUANT_SIGMA_M ** 2)
    tcov = ticp.pose_covariance(info, sigma2, inflation=ticp.RENDER_COV_INFLATION,
                                sigma2_floor=torch.full((2,), float(floor)))
    assert tcov.shape == (2, 6, 6) and torch.isfinite(tcov).all()
    if shape == "bumpy":
        jcov = np.stack([np.asarray(jicp.pose_covariance(
            w[0], w[1], inflation=jicp.RENDER_COV_INFLATION, sigma2_floor=floor))
            for w in want])
        assert max_rel(tcov.numpy(), jcov) <= 1e-3
    # point to point and Huber weights (JAX icp.py:510-560), to the same bars
    for kw in (dict(estimation="point_to_point"), dict(robust_delta=0.002),
               dict(estimation="point_to_point", robust_delta=0.002)):
        want = [jicp.pose_information(jnp.asarray(c), jnp.asarray(v), jscene.query, **kw)
                for c, v in zip(clouds, valids)]
        info, sigma2, count = ticp.pose_information(torch.as_tensor(clouds),
                                                    torch.as_tensor(valids), tscene.query, **kw)
        np.testing.assert_array_equal(count.numpy(), [float(w[2]) for w in want])
        assert max_rel(info.numpy(), np.stack([np.asarray(w[0]) for w in want])) <= 1e-4, kw
        np.testing.assert_allclose(sigma2.numpy(), [float(w[1]) for w in want], rtol=1e-4)


def test_pose_covariance_matches_jax():
    """The relative ridge, the sigma2 floor and the inflation on random
    well-conditioned information matrices (float32 inverse, 1e-4)."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 40, 6)).astype(np.float32)
    info = np.einsum("npi,npj->nij", a, a).astype(np.float32)
    sigma2 = rng.uniform(1e-9, 1e-6, 5).astype(np.float32)
    floor = np.float32(3e-7)
    want = np.asarray(jicp.pose_covariance(info, sigma2, inflation=9.0, sigma2_floor=floor))
    got = ticp.pose_covariance(torch.as_tensor(info), torch.as_tensor(sigma2), inflation=9.0,
                               sigma2_floor=float(floor))
    assert max_rel(got.numpy(), want) <= 1e-4
    assert (ticp.RENDER_COV_INFLATION, ticp.DEPTH_QUANT_SIGMA_M, ticp.LATERAL_QUANT_COEFF) == (
        jicp.RENDER_COV_INFLATION, jicp.DEPTH_QUANT_SIGMA_M, jicp.LATERAL_QUANT_COEFF)


def assert_uncertainty_agrees(tu, ju, keep=slice(None), tol=1e-2, count_tol=0):
    """Counts within ``count_tol``; info, sigma2 and the covariance within
    ``tol`` relative (refined poses that differ at the slice bounds move
    the final clouds, and with them the sums)."""
    ju = [np.asarray(x)[keep] for x in ju]
    tu = [x.numpy()[keep] for x in tu]
    assert np.abs(tu[2] - ju[2]).max() <= count_tol
    assert max_rel(tu[0], ju[0]) <= tol
    np.testing.assert_allclose(tu[1], ju[1], rtol=tol)
    assert max_rel(tu[3], ju[3]) <= tol


def test_refine_with_covariance_matches_jax(jax_kernels):
    """refine(with_covariance=True) on tests/test_torch_slice.py's workload
    against the JAX refiner on its Pallas raster: the poses at the slice
    bounds and the uncertainty of the recovered hypotheses (rotation under
    3 deg; the 3.5x-rotation ones stop wherever the latch holds them)."""
    from tests.test_torch_slice import CFG as SLICE_CFG
    from tests.test_torch_slice import H as SH
    from tests.test_torch_slice import ITERS as SLICE_ITERS
    from tests.test_torch_slice import W as SW

    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.17, 0.17, (12, 3)).astype(np.float32)
    ang[8:] *= 3.5
    d_t = rng.uniform(-20, 20, (12, 3)).astype(np.float32)
    poses = np.asarray(jgeo.pose_from_Rt(
        np.einsum("nij,jk->nik", np.asarray(jgeo.euler_to_rotation(ang)), truth[:3, :3]),
        truth[:3, 3] + d_t))
    scene = np.asarray(JR.rasterize_dense(m.tris, truth[None], SW, SH,
                                          jgeo.compute_proj(K, SW, SH)))[0]
    jref = prt.PoseRefiner(m, K=K, width=SW, height=SH, use_pallas=True, **SLICE_CFG)
    jref.set_scene_depth(scene)
    jposes, jres, junc = jref.refine(poses, prt.ICPConvergenceCriteria(max_iteration=SLICE_ITERS),
                                     with_covariance=True)
    tref = ptt.PoseRefiner(m, K=K, width=SW, height=SH, device="cpu", **SLICE_CFG)
    tref.set_scene_depth(scene)
    tposes, tres, tunc = tref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=SLICE_ITERS),
                                     with_covariance=True)
    assert isinstance(tunc, ptt.PoseUncertainty) and tunc.covariance.shape == (12, 6, 6)
    ok = rotation_angle_deg(np.asarray(jposes), truth) < 3.0
    assert ok.sum() >= 8
    assert_poses_agree(tposes.numpy(), jposes, tres.fitness.numpy(), jres.fitness)
    # a pose 0.1 deg away can move one of ~450 points across the 0.1 m gate,
    # and that point's residual moves sigma2 by ~2%
    assert_uncertainty_agrees(tunc, junc, keep=ok, tol=3e-2, count_tol=1)
    # a single pose squeezes every output
    pose, res, unc = tref.refine(poses[0], ptt.ICPConvergenceCriteria(max_iteration=4),
                                 with_covariance=True)
    assert pose.shape == (4, 4) and res.fitness.shape == () and unc.covariance.shape == (6, 6)


def test_cascade_covariance_comes_from_the_full_resolution_pass(setup):
    """With scene_cascade, the coarse pre-pass computes no uncertainty: the
    covariance is that of the full-resolution pass, started where the
    pre-pass left the poses."""
    m, truth, poses, depth = setup
    kw = dict(scene="nn_bruteforce", device="cpu", **CFG)
    crit = ptt.ICPConvergenceCriteria(max_iteration=4)
    ref = ptt.PoseRefiner(m, K=small_K(), scene_cascade=(4.0, 3), **kw)
    ref.set_scene_depth(depth)
    out = ref.refine(poses, crit, with_covariance=True)
    coarse, _ = ref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=3),
                           _scene=ref._scene_coarse)
    full = ptt.PoseRefiner(m, K=small_K(), **kw)
    full.set_scene_depth(depth)
    want = full.refine(coarse, crit, with_covariance=True)
    for a, b in zip(out[2], want[2]):
        assert torch.equal(a, b)
    assert torch.equal(out[0], want[0])


# ------------------------------------------------------------------- track()


TRACK_CASES = {
    "projective": dict(scene="projective"),
    "nn": dict(scene="nn_bruteforce"),
    "nn_stride2": dict(scene="nn_bruteforce", scene_stride=2),
}


@pytest.mark.parametrize("case", sorted(TRACK_CASES))
def test_track_matches_jax(setup, jax_kernels, case):
    """PoseRefiner.track (with_covariance) against JAX's track_poses_jit /
    track_poses_nn_jit through its refiner: the slice bounds on poses and
    fitness, equal point counts, the uncertainty within 3% relative (the NN
    scene's normals differ by ~1e-7; the sums feel the refined poses), and
    the packed buffers within the same bounds."""
    m, truth, poses, depth = setup
    kw = TRACK_CASES[case]
    crit = dict(max_iteration=ITERS)
    jref = prt.PoseRefiner(m, K=small_K(), use_pallas=True, **kw, **CFG)
    jposes, jres, junc = jref.track(depth, poses, prt.ICPConvergenceCriteria(**crit),
                                    with_covariance=True)
    tref = ptt.PoseRefiner(m, K=small_K(), device="cpu", **kw, **CFG)
    tposes, tres, tunc = tref.track(depth, poses, ptt.ICPConvergenceCriteria(**crit),
                                    with_covariance=True)
    assert tref.roi == jref.roi and tref.window == jref.window
    assert_poses_agree(tposes.numpy(), jposes, tres.fitness.numpy(), jres.fitness)
    np.testing.assert_array_equal(tres.n_points.numpy(), np.asarray(jres.n_points))
    assert_uncertainty_agrees(tunc, junc, tol=3e-2)
    assert tref.scene is None  # track() leaves the refiner's scene alone
    # the packed session buffers of both
    jbuf = np.asarray(jref.track(depth, poses, prt.ICPConvergenceCriteria(**crit),
                                 with_covariance=True, _pack_outputs=True))
    tbuf = tref.track(depth, poses, ptt.ICPConvergenceCriteria(**crit), with_covariance=True,
                      _pack_outputs=True).numpy()
    assert tbuf.shape == jbuf.shape == (6, 71)
    t_ref, t_res, t_cov = ttrack._unpack_outputs(tbuf, True)
    j_ref, j_res, j_cov = ttrack._unpack_outputs(jbuf, True)
    assert_poses_agree(t_ref, j_ref, t_res.fitness, j_res.fitness)
    np.testing.assert_array_equal(t_res.n_points, j_res.n_points)
    assert max_rel(t_cov, j_cov) <= 3e-2


def test_packed_buffer_layout_and_unpack_round_trip(setup):
    """[refined 16 | transformation 16 | fitness | rmse | n_points | cov 36],
    and _unpack_outputs gives back exactly what track() returns."""
    m, truth, poses, depth = setup
    ref = ptt.PoseRefiner(m, K=small_K(), device="cpu", **CFG)
    crit = ptt.ICPConvergenceCriteria(max_iteration=6)
    refined, res, unc = ref.track(depth, poses, crit, with_covariance=True)
    buf = ref.track(depth, poses, crit, with_covariance=True, _pack_outputs=True)
    assert buf.shape == (6, 71) and buf.dtype == torch.float32
    assert torch.equal(buf[:, :16].reshape(6, 4, 4), refined)
    assert torch.equal(buf[:, 35:].reshape(6, 6, 6), unc.covariance)
    r, results, cov = ttrack._unpack_outputs(buf.numpy(), True)
    np.testing.assert_array_equal(r, refined.numpy())
    np.testing.assert_array_equal(results.transformation, res.transformation.numpy())
    np.testing.assert_array_equal(results.fitness, res.fitness.numpy())
    np.testing.assert_array_equal(results.inlier_rmse, res.inlier_rmse.numpy())
    assert results.n_points.dtype == np.int32
    np.testing.assert_array_equal(results.n_points, res.n_points.numpy())
    assert cov.dtype == np.float64
    np.testing.assert_array_equal(cov, unc.covariance.numpy())
    assert ttrack._unpack_outputs(buf.numpy(), False)[1].n_points is None
    # the enqueueing twins hand back the same outputs
    pending = ref.track_packed_async(depth, poses, crit)
    assert isinstance(pending, PendingResult)
    assert torch.equal(pending.wait()[0], buf)
    a_ref, a_res = ref.track_async(depth, poses, crit).wait()
    assert torch.equal(a_ref, refined) and torch.equal(a_res.fitness, res.fitness)
    single = ref.track(depth, poses[0], crit)
    assert single[0].shape == (4, 4) and single[1].fitness.shape == ()


def test_enqueues_park_the_saturation_check(setup, caplog):
    """refine_async returns what refine returns, and the once-per-frame
    lift-saturation readback waits for the next synchronous call instead
    of being spent in the enqueue."""
    m, truth, poses, depth = setup
    ref = ptt.PoseRefiner(m, K=small_K(), device="cpu", **dict(CFG, max_points=64))
    crit = ptt.ICPConvergenceCriteria(max_iteration=2)
    ref.set_scene_depth(depth)
    with caplog.at_level(logging.WARNING, logger="pose_refine_tpu_torch"):
        got = ref.refine_async(poses, crit).wait()
        assert "saturated" not in caplog.text and ref._check_saturation
        want = ref.refine(poses, crit)
        assert "saturated" in caplog.text and not ref._check_saturation
    for a, b in zip(got, want):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else all(map(torch.equal, a, b))


def test_track_validation(setup):
    m, truth, poses, depth = setup
    K = small_K()
    ref = ptt.PoseRefiner(m, K=K, device="cpu", **CFG)
    with pytest.raises(ValueError, match="_pack_outputs"):
        ref.track(depth, poses, _pack_outputs=True)
    with pytest.raises(ValueError, match="_pack_outputs"):
        ref.track(depth, poses[0], with_covariance=True, _pack_outputs=True)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        ref.track(np.zeros((H, W, 3), np.int32), poses)
    with pytest.raises(ValueError, match="init_poses"):
        ref.track(depth, poses[:, :3])
    cascade = ptt.PoseRefiner(m, K=K, device="cpu", scene="nn", scene_cascade=(2.0, 4), **CFG)
    with pytest.raises(ValueError, match="scene_stride or scene_pool"):
        cascade.track(depth, poses)
    with pytest.raises(ValueError, match="scene_pool must be >= 1"):
        ptt.PoseRefiner(m, K=K, device="cpu", scene="nn", scene_pool=0, **CFG)
    with pytest.raises(ValueError, match="alternative NN-scene downsamplers"):
        ptt.PoseRefiner(m, K=K, device="cpu", scene="nn", scene_pool=2, scene_stride=2, **CFG)
    # the JAX package's refusal (JAX pipeline.py:1253-1258): a kd tree is
    # built on the host, so track() cannot rebuild it per frame
    with pytest.raises(ValueError, match="cannot fuse a kd-tree scene build"):
        ptt.PoseRefiner(m, K=K, device="cpu", scene="nn_kdtree", **CFG).track(depth, poses)


def test_scene_pool_auto_matches_jax(setup):
    """scene_pool="auto" maps scene_voxel_mm to the pool factor from the
    first frame with depth, as JAX does: 2 mm at ~0.3 m with the full
    LINEMOD fx (0.52 mm pixels) is pool 4; an empty frame defers it."""
    m, truth, poses, depth = setup
    for K, want in ((jgeo.LINEMOD_K, 4), (small_K(), 1)):
        kw = dict(scene="nn_bruteforce", scene_voxel_mm=2.0, width=W, height=H)
        jref = prt.PoseRefiner(m, K=K, use_pallas=False, **kw)
        tref = ptt.PoseRefiner(m, K=K, device="cpu", **kw)
        assert tref._resolve_scene_pool(np.zeros_like(depth)) == 1
        assert tref._scene_pool_cache is None
        got = tref._resolve_scene_pool(torch.as_tensor(depth))
        assert got == jref._resolve_scene_pool(depth) == want
        assert tref._resolve_scene_pool(np.zeros_like(depth)) == want  # cached
        perm = tref._scene_perm(depth.shape, got)
        np.testing.assert_array_equal(
            perm.numpy(), jnn._grid_morton_perm(-(-H // got), -(-W // got)))


def test_host_frames_always_plan(setup):
    """Frames on the host (numpy or CPU tensors) re-plan the ROI on every
    track(); only frames on a card reuse the standing plan."""
    m, truth, poses, depth = setup
    ref = ptt.PoseRefiner(m, K=small_K(), device="cpu", **CFG)
    crit = ptt.ICPConvergenceCriteria(max_iteration=1)
    ref.track(torch.as_tensor(depth), poses, crit)
    roi = ref.roi
    ref.track(torch.as_tensor(np.roll(depth, (30, 40), axis=(0, 1))), poses, crit)
    assert ref.roi != roi and ref._frame_planned
