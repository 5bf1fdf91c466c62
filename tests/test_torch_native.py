"""The port's native C++ components (pose_refine_tpu_torch/native, copies of
the JAX package's sources, built at first use into the package's git-ignored
_build/) against the JAX package's: the native kd tree equals JAX's native
tree and the port's numpy tree bit for bit; the reference-algorithm CPU
renderer and ICP equal JAX's; concurrent builders in several processes each
leave a whole library."""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from pose_refine_tpu import native as jnative
from pose_refine_tpu.scene import kdtree as jkd
from pose_refine_tpu_torch import geometry, mesh, native
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize_plain
from pose_refine_tpu_torch.scene import kdtree as tkd
from pose_refine_tpu_torch.scene.nn import _depth_scene_arrays_host

torch.set_num_threads(2)

TREE = ("points", "normals", "parent", "child", "split_dim", "split_v", "bbox", "bounds")


def cloud(n, seed, quantise=True):
    """n points of a normal cloud; 1 mm quantisation makes split ties."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 50.0
    pts = (np.round(pts) if quantise else pts) / 1000.0
    return pts.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("n,leaf,quantise", [(1, 10, True), (11, 10, True), (700, 4, True),
                                             (5000, 10, True), (20000, 10, False)])
def test_native_tree_matches_jax_and_numpy(n, leaf, quantise):
    assert native.native_available(), native.unavailable_reason()
    pts, nrm = cloud(n, seed=n, quantise=quantise)
    got = tkd.build_kdtree(pts, nrm, leaf, backend="native")
    auto = tkd.build_kdtree(pts, nrm, leaf)
    numpy_tree = tkd.build_kdtree(pts, nrm, leaf, backend="numpy")
    jax_tree = jkd.build_kdtree(pts, nrm, leaf, backend="native")
    for f in TREE:
        for other in (auto, numpy_tree, jax_tree):
            a, b = getattr(got, f), getattr(other, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_auto_takes_numpy_without_native_and_native_raises(monkeypatch):
    pts, nrm = cloud(300, seed=1)
    want = tkd.build_kdtree(pts, nrm, backend="numpy")
    monkeypatch.setattr(native, "build_kdtree_native", lambda *a, **k: None)
    got = tkd.build_kdtree(pts, nrm)
    for f in TREE:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(RuntimeError, match="native kd-tree builder unavailable"):
        tkd.build_kdtree(pts, nrm, backend="native")


@pytest.fixture(scope="module")
def baseline_case():
    """The bumpy sphere at 160x120: a truth render as the scene, 6
    hypotheses +-10 deg / +-20 mm (the bench's jitter) lifted as bench.py's
    agreement cell lifts them."""
    W, H = 160, 120
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    truth = geometry.pose_from_Rt(np.eye(3, dtype=np.float32),
                                  np.array([0, 0, 300], np.float32)).numpy()
    poses = ptt.sample_hypotheses(truth, 6, rng=4)
    proj = geometry.compute_proj(K, W, H).numpy()
    scene = rasterize_plain(torch.as_tensor(m.tris), torch.as_tensor(truth[None]), W, H,
                            torch.as_tensor(proj))[0].numpy()
    return m, K, W, H, poses, proj, scene


def lift(depths, K, n_pts=4096):
    """bench.py:399-420's full scan-order lift of each render."""
    clouds = np.zeros((len(depths), n_pts, 3), np.float32)
    valid = np.zeros((len(depths), n_pts), bool)
    for i, d in enumerate(depths):
        vs, us = np.nonzero(d > 0)
        z = d[vs, us].astype(np.float32) / 1000.0
        pts = np.stack([(us.astype(np.float32) - K[0, 2]) / K[0, 0] * z,
                        (vs.astype(np.float32) - K[1, 2]) / K[1, 1] * z, z], -1)[:n_pts]
        clouds[i, :len(pts)] = pts
        valid[i, :len(pts)] = True
    return clouds, valid


def test_cpu_baselines_match_jax(baseline_case):
    """The reference-algorithm renderer and ICP of the two packages' builds
    of the same sources agree bit for bit; the ICP leaves the caller's
    (shared-memory) cloud untouched and pulls the hypotheses in."""
    m, K, W, H, poses, proj, scene = baseline_case
    got = native.cpu_render_baseline(m.tris, poses, proj, W, H)
    np.testing.assert_array_equal(got, jnative.cpu_render_baseline(m.tris, poses, proj, W, H))
    # a pose renders alone as in the batch (OpenMP splits over poses only)
    np.testing.assert_array_equal(native.cpu_render_baseline(m.tris, poses[3:4], proj, W, H)[0],
                                  got[3])
    # the scanline baseline against the port's raster: tests/test_rasterize.py's gate
    plain = rasterize_plain(torch.as_tensor(m.tris), torch.as_tensor(poses), W, H,
                            torch.as_tensor(proj)).numpy()
    assert (np.abs(plain.astype(np.int64) - got) > 1).mean() < 2e-4
    clouds, valid = lift(got, K)
    t = torch.as_tensor(clouds)
    before = t.clone()
    pts, nrm, _mask = _depth_scene_arrays_host(scene, K)
    T, fit, rmse = native.cpu_icp_baseline(t.numpy(), valid, pts, nrm, K)
    assert torch.equal(t, before)
    jT, jfit, jrmse = jnative.cpu_icp_baseline(clouds, valid, pts, nrm, K)
    np.testing.assert_array_equal(T, jT)
    np.testing.assert_array_equal(fit, jfit)
    np.testing.assert_array_equal(rmse, jrmse)
    assert (fit > 0.5).all() and native.cpu_threads() >= 1


def _build_in(root, barrier):
    barrier.wait(timeout=60)
    path = native.build(root)
    lib = native.load(path)
    return int(lib.cpu_threads())


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Four processes that build into one empty directory at once (as test
    workers may) each compile to a file of their own and rename it into
    place: every one loads a working library, no temporary file is left."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Manager() as manager, ctx.Pool(4) as pool:
        barrier = manager.Barrier(4)
        threads = pool.starmap(_build_in, [(str(tmp_path), barrier)] * 4, chunksize=1)
    assert all(t >= 1 for t in threads)
    [out_dir] = list(tmp_path.iterdir())
    assert sorted(os.listdir(out_dir)) == [native.LIB_NAME]
    assert native.build(tmp_path) == out_dir / native.LIB_NAME
