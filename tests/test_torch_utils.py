"""The port's small functions and host utilities against the JAX package:
sample_hypotheses and the Euler helpers, the single-image window lift,
the matrix-product NN query, the numpy oracle against the port's raster,
the timers, the profiling hooks, the viz helpers, models/, and an import
of every module the port added beside them that leaves jax out."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh as jmesh
from pose_refine_tpu.ops import depth_to_cloud as jd2c
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu_torch import geometry as tgeo
from pose_refine_tpu_torch import mesh as tmesh
from pose_refine_tpu_torch import models
from pose_refine_tpu_torch.ops import depth_to_cloud as td2c
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize_plain
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.utils import oracle, profiling, timer, viz
from tests.test_torch_lift_scene import assert_within_ulp, blob_depths
from tests.test_torch_lift_scene import small_K as lift_K

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


@pytest.mark.parametrize("kw", [dict(rng=0), dict(rng=7, rot_deg=25.0, trans_mm=40.0),
                                dict(rng=3, include_center=True)])
def test_sample_hypotheses_match_jax(kw):
    """The same draws in the same order: bit for bit, for a seed and for a
    Generator (which both advance alike)."""
    center = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([5, -3, 300], np.float32)))
    want = jgeo.sample_hypotheses(center, 9, **kw)
    got = ptt.sample_hypotheses(center, 9, **kw)
    assert got.dtype == np.float32 and got.shape == (9, 4, 4)
    np.testing.assert_array_equal(got, want)
    ga, gb = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        np.testing.assert_array_equal(ptt.sample_hypotheses(center, 4, rng=ga),
                                      jgeo.sample_hypotheses(center, 4, rng=gb))
    if kw.get("include_center"):
        np.testing.assert_array_equal(got[0], center)


def test_euler_helpers_match_jax():
    rng = np.random.default_rng(0)
    theta = rng.uniform(-1.4, 1.4, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(tgeo._euler_to_rotation_np(theta),
                                  jgeo._euler_to_rotation_np(theta))
    R = np.asarray(jgeo.euler_to_rotation(theta))
    # XLA's and torch's atan2 / sqrt differ in the last bits
    got = tgeo.rotation_to_euler(R).numpy()
    np.testing.assert_allclose(got, np.asarray(jgeo.rotation_to_euler(R)), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, theta, rtol=0, atol=5e-6)
    # the singular branch (y = +-90 deg): z = 0, x carries the rest
    sing = np.asarray(jgeo.euler_to_rotation(np.float32([[0.3, np.pi / 2, 0.0]])))
    np.testing.assert_allclose(tgeo.rotation_to_euler(sing).numpy(),
                               np.asarray(jgeo.rotation_to_euler(sing)), rtol=0, atol=2e-6)
    assert tgeo.rotation_to_euler(sing)[0, 2] == 0.0


@pytest.mark.parametrize("window,stride", [(64, 2), (48, 3)])
def test_window_cloud_matches_jax(window, stride):
    """The single-image lift: JAX window_cloud's crop, stride, valid mask
    and count exactly, the empty image included. Its points are the port's
    batched lift's bit for bit, so within 1 ULP of JAX's batched lift
    (tests/test_torch_lift_scene.py's bound); JAX's own single-image
    program rounds up to 3 ULPs from its batched one (XLA fuses the two
    differently), so the port is within 4 of it."""
    K = lift_K()
    kw = dict(window=window, stride=stride, tl_x=8, tl_y=4)
    for depth in blob_depths(3, seed=window):
        jp, jv, jn = jd2c.window_cloud(depth, K, **kw)
        jb = np.asarray(jd2c.window_cloud_batched(depth[None], K, **kw)[0][0])
        tp, tv, tn = td2c.window_cloud(torch.as_tensor(depth), K, **kw)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert int(tn) == int(jn)
        assert torch.equal(tp, td2c.window_cloud_batched(torch.as_tensor(depth[None]), K,
                                                         **kw)[0][0])
        assert_within_ulp(tp.numpy(), jb)
        assert_within_ulp(jb, jp, ulps=3)
        assert_within_ulp(tp.numpy(), jp, ulps=4)


def test_nn_bruteforce_matches_jax():
    """The matrix-product NN query: the same neighbours; dist^2 within the
    cancellation error of |p|^2 - 2 p.q + |q|^2 in float32 (the two
    packages' products round differently)."""
    rng = np.random.default_rng(1)
    scene = (rng.normal(size=(5000, 3)) * 0.05).astype(np.float32)
    q = (rng.normal(size=(2, 700, 3)) * 0.05).astype(np.float32)
    ji, jd = map(np.asarray, jnn._nn_bruteforce(q, scene))
    ti, td = tnn._nn_bruteforce(torch.as_tensor(q), scene)
    assert ti.shape == (2, 700) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    scale = (q * q).sum(-1) + (scene[ji] ** 2).sum(-1)
    assert (np.abs(td.numpy() - jd) <= 8 * np.finfo(np.float32).eps * scale).all()
    exact = ((q[..., None, :].astype(np.float64) - scene.astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(ti.numpy(), exact.argmin(-1))


def test_scanline_oracle_matches_port_raster():
    """tests/test_rasterize.py's gate for JAX's dense raster, held on the
    port's plain raster: under 2e-4 of pixels more than 1 mm apart."""
    W, H = 160, 120
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    rng = np.random.default_rng(42)
    m = tmesh.make_icosphere(radius=40.0, subdivisions=2)
    ang = rng.uniform(-np.pi, np.pi, (4, 3)).astype(np.float32)
    t = np.stack([rng.uniform(-20, 20, 4), rng.uniform(-20, 20, 4),
                  rng.uniform(240, 360, 4)], -1).astype(np.float32)
    poses = tgeo.pose_from_Rt(tgeo.euler_to_rotation(ang), t)
    proj = tgeo.compute_proj(K, W, H)
    got = rasterize_plain(torch.as_tensor(m.tris), poses, W, H, proj).numpy()
    want = oracle.render_scanline(m.tris, poses.numpy(), W, H, proj.numpy())
    assert (want > 0).sum() > 500
    assert (np.abs(got.astype(np.int64) - want.astype(np.int64)) > 1).mean() < 2e-4


def test_icp_oracle_matches_jax_oracle():
    """The copied numpy ICP loop is JAX's (it calls the port's Euler twin)."""
    from pose_refine_tpu.utils import oracle as joracle

    rng = np.random.default_rng(0)
    dst = rng.normal(size=(300, 3)).astype(np.float32) * 0.05 + [0, 0, 0.3]
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cloud = dst + np.float32([0.004, -0.002, 0.003])

    def query(p):
        return dst, nrm, np.ones(len(p), bool)

    want = joracle.icp_point_to_plane_numpy(cloud, query, max_iteration=5)
    got = oracle.icp_point_to_plane_numpy(cloud, query, max_iteration=5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]


def test_timers():
    st = profiling.StepTimer()
    assert st.mean == 0.0
    for _ in range(3):
        with st:
            pass
    assert st.count == 3 and st.total >= st.worst >= 0.0 and st.mean == st.total / 3
    t = timer.Timer()
    assert t.elapsed() >= 0.0
    assert timer.time_jitted(lambda x: x + 1, torch.ones(4), warmup=1, iters=3) >= 0.0
    assert timer._card_of((torch.ones(1), {"a": [torch.ones(2)]})) is None


def test_memory_stats_and_trace(tmp_path, capsys):
    """No allocator statistics for the CPU; a trace writes a Chrome trace."""
    assert profiling.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() is None
        assert "unavailable" in profiling.log_memory_usage("mem")
    with profiling.trace(str(tmp_path), annotate="block") as logdir:
        with profiling.annotate("inner"):
            torch.ones(8).sum()
    files = list(Path(logdir).glob("trace_*.json"))
    assert len(files) == 1 and "inner" in files[0].read_text()


def test_viz_helpers(tmp_path):
    pts = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    viz.save_point_cloud(str(tmp_path / "c.ply"), pts, normals=pts,
                         valid=np.array([1, 0, 1, 1, 0], bool))
    assert "element vertex 3" in (tmp_path / "c.ply").read_text()
    depth = np.zeros((8, 16), np.int32)
    depth[2:6, 4:12] = 300
    depth[3, 5] = 250
    viz.save_depth_ppm(str(tmp_path / "d.ppm"), depth)
    assert (tmp_path / "d.ppm").read_bytes().startswith(b"P6 16 8 255\n")
    art = viz.ascii_depth(depth, cols=16)
    assert "#" in art or "o" in art
    assert viz.ascii_depth(np.zeros((4, 4))) == "(empty)"


def test_models_reexport_the_port_mesh():
    assert models.Model is tmesh.Model and models.make_icosphere is tmesh.make_icosphere
    np.testing.assert_array_equal(models.make_bumpy_sphere(40.0, 1).tris,
                                  jmesh.make_bumpy_sphere(40.0, 1).tris)


def test_new_modules_import_without_jax():
    """Importing the modules added beside the kernels (and using the native
    library) keeps jax out of the process."""
    code = (
        "import sys\n"
        "import pose_refine_tpu_torch as ptt\n"
        "from pose_refine_tpu_torch import models, native, parallel\n"
        "from pose_refine_tpu_torch.parallel import sharding\n"
        "from pose_refine_tpu_torch.utils import oracle, profiling, serialization, timer, viz\n"
        "ptt.sample_hypotheses(ptt.geometry.LINEMOD_K[[0, 1, 2, 2]][:, [0, 1, 2, 2]], 2, rng=0)\n"
        "native.native_available()\n"
        "assert 'jax' not in sys.modules and 'pose_refine_tpu' not in sys.modules, "
        "sorted(m for m in sys.modules if 'jax' in m or m.startswith('pose_refine_tpu.'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
