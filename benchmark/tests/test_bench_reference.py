"""The reference agrees with the program at a tiny size on the CPU, piece
by piece where the program states the same function (the decimated mesh,
the render, the window lift, the normals, the voxel cloud, the ROI, the
filter) and as a whole refine (within the check's limits)."""

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from core import inputs
from core.traffic import _rng
from pose_refine_tpu_torch.mesh import Model, simplify_vertex_clustering
from pose_refine_tpu_torch.ops.depth_to_cloud import window_lift as prog_lift
from pose_refine_tpu_torch.ops.normals import estimate_normals
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize_plain
from pose_refine_tpu_torch.scene.nn import voxel_downsample
from pose_refine_tpu_torch.utils.fusion import PoseTracker
from reference import track
from reference.geometry import compute_proj
from reference.lift import window_lift
from reference.plan import RoiPlanner, decimate
from reference.render import render
from reference.scene import linemod_normals, voxel_average

K = ptt.LINEMOD_K
CAM = {"width": 640, "height": 480, "K": K.tolist()}


@pytest.fixture(scope="module")
def scene():
    v, f = inputs.bumpy_sphere(40.0, 5, 0.25)
    rng = _rng(3_000_000_201, 1)
    truth = inputs.truth_poses(rng, 1, (300, 360), 40)
    frame = inputs.render_frames(v, f, truth, CAM, "cpu")[0]
    return v, f, truth[0], frame, inputs.perturb(rng, truth[0], 6, 10, 20)


def test_decimation_equals_the_program(scene):
    v, f = scene[:2]
    prog = simplify_vertex_clustering(Model.from_vertices_faces(v, f), 4.0)
    assert np.array_equal(decimate(v, f, 4.0), prog.tris)


def test_render_and_lift_equal_the_program(scene):
    v, f, _, frame, hyps = scene
    tris = torch.as_tensor(decimate(v, f, 4.0))
    roi = RoiPlanner(640, 480, 2).observe(frame)
    proj = compute_proj(K, 640, 480)
    mine, covered = render(tris, torch.as_tensor(hyps), 320, 240, proj, roi)
    prog = rasterize_plain(tris, torch.as_tensor(hyps), 320, 240, torch.as_tensor(proj), roi=roi)
    # the camera transform is one product here and a chain of fused
    # multiply-adds there: a pixel whose depth + 0.5 lies within rounding
    # of an integer may round the other way
    assert (mine != prog).float().mean() < 1e-3 and (mine - prog).abs().max() <= 1
    assert (covered > 0).all()
    Kr = K.copy()
    Kr[:2] /= 2
    for morton in (False, True):
        a = window_lift(prog, Kr, 128, 2, 2048, morton, roi[0], roi[1])
        b = prog_lift(prog, Kr, window=128, stride=2, max_points=2048, morton=morton,
                      tl_x=roi[0], tl_y=roi[1])
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_scene_pieces_equal_the_program(scene):
    frame = scene[3]
    d = torch.as_tensor(frame)
    assert torch.equal(linemod_normals(d, K), estimate_normals(d, K))
    rng = np.random.default_rng(0)
    p = rng.uniform(-0.05, 0.05, (5000, 3)).astype(np.float32) + np.float32(0.3)
    n = rng.standard_normal((5000, 3)).astype(np.float32)
    a, b = voxel_average(p, n, 0.002), voxel_downsample(p, n, 0.002)
    assert np.array_equal(a[0], b[0]) and np.allclose(a[1], b[1], atol=1e-6)


def test_roi_planning_equals_the_program(scene, tmp_path):
    v, f, truth, frame, _ = scene
    frames = inputs.render_frames(v, f, np.stack([truth, inputs.perturb(
        _rng(5, 1), truth, 1, 0, 30)[0]]), CAM, "cpu")
    refiner = ptt.PoseRefiner(ptt.Model.from_vertices_faces(v, f), K=K, device="cpu",
                              render_scale=2, decimate_mm=4.0, window=128, max_points=2048)
    plan = RoiPlanner(640, 480, 2)
    for fr in (frames[0], frames[1], frames[0], frames[1]):
        refiner.set_scene_depth(fr)
        assert plan.observe(fr) == refiner.roi


def test_filter_samples_and_fuses_as_the_program():
    start = inputs.perturb(_rng(9, 1), inputs.truth_poses(_rng(9, 2), 1, (300, 360), 40)[0],
                           1, 3, 10)[0]
    noise = (np.radians(2.0), 0.005)
    mine, prog = track.Filter(start, noise), PoseTracker(start, process_noise=noise)
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for k in range(3):
        mine.predict()
        prog.predict()
        ha, hb = mine.hypotheses(16, ra), prog.hypotheses(16, seed=rb)
        assert np.array_equal(ha, hb)
        meas = ha[3]
        cov = np.diag([1e-5] * 3 + [1e-6] * 3) * (k + 1)
        assert mine.update(meas, cov, 0.9) == prog.update(meas, cov, quality=0.9,
                                                         min_quality=0.6)
        assert np.array_equal(mine.pose_mm, prog.pose_mm)
