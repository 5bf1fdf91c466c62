"""The NN refine slice as a whole: the port's PoseRefiner(scene=
"nn_bruteforce") on the CPU (plain raster, plain flash-NN) against the JAX
package's PoseRefiner on the CPU, on tests/test_torch_slice.py's workload.

The JAX refiner renders through its Pallas raster in interpret mode, the
TPU kernel the port's raster replaces, and its scenes take
``backend="flash"`` (the Pallas flash-NN in interpret mode), whose
associations the port's plain gated NN equals bit for bit in the gate
(tests/test_torch_nn_flash.py). Against those the whole slice holds the
slice bounds. Two other JAX CPU paths round otherwise, and on this
sphere, whose rotation NN ICP observes weakly, the ICP convergence latch
amplifies their one-ULP or one-millimetre differences into pose deltas:

* ``use_pallas=False`` renders by scatter, which puts one pixel of one
  hypothesis 1 mm deeper than the Pallas kernel and the port
  (test_jax_raster_paths_split_at_one_pixel); that moves the cascade's
  hypothesis 1 by 0.52 deg, so that comparison holds the verdicts, the
  point counts, fitness and translation only;
* the default CPU query, ``_nn_bruteforce``, scores with a matmul that
  rounds otherwise and flips near-tie neighbours (up to 0.77 deg), so the
  comparison with it stays at the query level (tests/test_torch_nn_scene.py).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize as JR
import pose_refine_tpu.ops.rasterize_pallas as JRP
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 320, 240
# tests/test_torch_slice.py's scaled bench configuration
CFG = dict(render_scale=2, max_points=768, window=64, stride=2, decimate_mm=4.0)
ITERS = 24
VERDICT_DEG = 3.0
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)
CASES = {
    "voxel0": (dict(), ITERS),
    "voxel2": (dict(scene_voxel_mm=2.0), ITERS),
    # bench.py's cascade (2.0, 16) + 4 full-resolution iterations
    "cascade": (dict(scene_cascade=(2.0, 16)), 4),
}


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    return K


@pytest.fixture(scope="module")
def workload():
    """tests/test_torch_slice.py's workload: the bumpy sphere's scene depth
    at the reference viewpoint and 12 hypotheses, 4 of them with 3.5x the
    rotation."""
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


@pytest.fixture
def pallas_raster(monkeypatch):
    """The JAX refiner's use_pallas=True raster, in interpret mode on the
    CPU (refine_poses_jit imports rasterize_pallas when it traces)."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))


def jax_refine(m, K, scene_depth, poses, iters, use_pallas=True, **kw):
    """The JAX refiner on flash scenes: (poses, results, refiner)."""
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=use_pallas,
                           scene="nn_bruteforce", **kw, **CFG)
    jref.set_scene_depth(scene_depth)
    jax_flash(jref)
    jposes, jres = jref.refine(poses, prt.ICPConvergenceCriteria(max_iteration=iters))
    return np.asarray(jposes), jres, jref


def port_refine(m, K, scene_depth, poses, iters, **kw):
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", scene="nn_bruteforce",
                           **kw, **CFG)
    tref.set_scene_depth(scene_depth)
    tposes, tres = tref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=iters))
    return tposes, tres, tref


def jax_flash(jref):
    """The JAX refiner's scenes on its flash-NN backend."""
    jref.scene = dataclasses.replace(jref.scene, backend="flash")
    if jref._scene_coarse is not None:
        jref._scene_coarse = dataclasses.replace(jref._scene_coarse, backend="flash")


def assert_slices_agree(truth, jposes, jres, tposes, tres, keep=slice(None),
                        max_drot_deg=MAX_DROT_DEG):
    """100% verdict agreement and the slice bounds over the poses ``keep``;
    returns the rotation deltas (deg)."""
    jposes, tposes = np.asarray(jposes)[keep], tposes.numpy()[keep]
    assert tposes.shape == jposes.shape and np.isfinite(tposes).all()
    j_ok = rotation_angle_deg(jposes, truth) < VERDICT_DEG
    np.testing.assert_array_equal(rotation_angle_deg(tposes, truth) < VERDICT_DEG, j_ok)
    assert j_ok.sum() >= 8  # the +-10 deg hypotheses recover
    drot = rotation_angle_deg(tposes, jposes)
    if max_drot_deg is not None:
        assert drot.max() <= max_drot_deg
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() <= MAX_DT_MM
    jfit, tfit = np.asarray(jres.fitness)[keep], tres.fitness.numpy()[keep]
    assert np.abs(tfit - jfit).max() <= MAX_DFIT
    np.testing.assert_array_equal(tres.n_points.numpy()[keep], np.asarray(jres.n_points)[keep])
    return drot


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn_slice_matches_jax(workload, pallas_raster, case):
    m, K, truth, poses, scene = workload
    kw, iters = CASES[case]
    jposes, jres, jref = jax_refine(m, K, scene, poses, iters, **kw)
    tposes, tres, tref = port_refine(m, K, scene, poses, iters, **kw)
    assert tref.roi == jref.roi and tref.window == jref.window
    assert tref.scene.points.shape[0] == jref.scene.points.shape[0]
    assert_slices_agree(truth, jposes, jres, tposes, tres)


def test_nn_slice_against_jax_scatter_raster(workload):
    """The cascade case against the JAX refiner as tests/test_torch_slice.py
    runs it (use_pallas=False, scatter raster): 100% verdict agreement,
    equal point counts, the fitness and translation bounds. The rotation
    delta is 0.52 deg on hypothesis 1, whose render differs by one pixel
    (see test_jax_raster_paths_split_at_one_pixel), and within the slice
    bound on the others."""
    m, K, truth, poses, scene = workload
    kw, iters = CASES["cascade"]
    jposes, jres, _ = jax_refine(m, K, scene, poses, iters, use_pallas=False, **kw)
    tposes, tres, _ = port_refine(m, K, scene, poses, iters, **kw)
    drot = assert_slices_agree(truth, jposes, jres, tposes, tres, max_drot_deg=None)
    assert np.delete(drot, 1).max() <= MAX_DROT_DEG
    assert drot[1] < 1.0


def test_jax_raster_paths_split_at_one_pixel(workload):
    """On this workload the JAX package's two CPU raster paths disagree:
    the scatter raster (use_pallas=False) puts one pixel of hypothesis 1
    1 mm deeper than the Pallas kernel in interpret mode. The port's
    raster equals the Pallas kernel everywhere."""
    m, K, truth, poses, scene = workload
    tref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **CFG)
    tref.set_scene_depth(scene)
    args = (tref.render_w, tref.render_h)
    tris, proj = jnp.asarray(tref.tris.numpy()), jnp.asarray(tref.proj.numpy())
    port = ptt.rasterize(tref.tris, torch.as_tensor(poses), *args, tref.proj,
                         roi=tref.roi).numpy()
    pallas = np.asarray(JRP.rasterize_pallas(tris, jnp.asarray(poses), *args, proj,
                                             roi=tref.roi, interpret=True))
    scatter = np.asarray(JR.rasterize_scatter(tris, jnp.asarray(poses), *args, proj,
                                              roi=tref.roi))
    np.testing.assert_array_equal(port, pallas)
    n, y, x = np.nonzero(scatter != pallas)
    assert n.tolist() == [1]
    assert int(scatter[1, y[0], x[0]]) - int(pallas[1, y[0], x[0]]) == 1


def test_nn_slice_from_cloud_matches_jax(workload, pallas_raster):
    """set_scene_cloud with scene_voxel_mm, and a hypothesis 0.3 m behind
    the scene: every query of its cloud lies beyond the gate, the ICP
    aborts on count 0, and the pose comes back finite and unchanged."""
    m, K, truth, poses, scene = workload
    pts, nrm, mask = jnn._depth_scene_arrays_host(scene, K)
    pts, nrm = pts[mask], nrm[mask]
    poses = poses.copy()
    poses[3, 2, 3] += 300.0
    kw = dict(scene="nn", scene_voxel_mm=2.0, width=W, height=H, **CFG)
    jref = prt.PoseRefiner(m, K=K, use_pallas=True, **kw)
    jref.set_scene_cloud(pts, nrm)
    jax_flash(jref)
    jposes, jres = jref.refine(poses, prt.ICPConvergenceCriteria(max_iteration=ITERS))
    tref = ptt.PoseRefiner(m, K=K, device="cpu", **kw)
    tref.set_scene_cloud(torch.as_tensor(pts), torch.as_tensor(nrm))
    assert tref.scene.points.shape[0] == jref.scene.points.shape[0]
    tposes, tres = tref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=ITERS))
    assert torch.isfinite(tposes).all() and float(tres.fitness[3]) == 0.0
    assert torch.equal(tposes[3], torch.as_tensor(poses[3]))
    assert_slices_agree(truth, jposes, jres, tposes, tres, keep=np.arange(12) != 3)


@pytest.mark.parametrize(
    "kwargs,match",
    [({"scene": "projective", "scene_cascade": (2.0, 8)}, "NN-scene feature"),
     ({"scene": "nn", "scene_cascade": (0.0, 8)}, "coarse_voxel_mm > 0"),
     ({"scene": "nn", "scene_voxel_mm": 4.0, "scene_cascade": (2.0, 8)}, "coarser")],
)
def test_scene_cascade_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ptt.PoseRefiner(mesh.make_icosphere(40.0, 1), K=small_K(), width=W, height=H,
                        device="cpu", **kwargs)


def test_unported_nn_options_raise():
    """Every NN option is ported: devices= splits the batch (an int names
    that many cards, so more than the machine has raises;
    tests/test_torch_sharding.py holds a split NN refine to the single
    one). scene_stride and scene_pool are ported with track()
    (test_torch_track.py), lift="compact" with the point schedule
    (test_torch_api.py)."""
    with pytest.raises(ValueError, match="CUDA cards present"):
        ptt.PoseRefiner(mesh.make_icosphere(40.0, 1), K=small_K(), width=W, height=H,
                        device="cpu", scene="nn", devices=torch.cuda.device_count() + 2)
    ref = ptt.PoseRefiner(mesh.make_icosphere(40.0, 1), K=small_K(), width=W, height=H,
                          scene="nn", devices=["cpu", "cpu"])
    assert ref.device.type == "cpu" and len(ref.devices) == 2


def test_set_scene_depths_raises():
    """set_scene_depths takes (K, H, W) frames; one (H, W) frame is the JAX
    package's ValueError (tests/test_multiscene.py:144)."""
    ref = ptt.PoseRefiner(mesh.make_icosphere(40.0, 1), K=small_K(), width=W, height=H,
                          device="cpu", scene="nn")
    with pytest.raises(ValueError, match="K, H, W"):
        ref.set_scene_depths(np.zeros((H, W), np.int32))
