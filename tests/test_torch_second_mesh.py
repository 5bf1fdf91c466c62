"""The port on the second real-shape fixture, the thin L-bracket
(tests/data/bracket.ply), mirroring tests/test_second_mesh.py: the
acceptance recipe (10 deg/axis + 20 mm) with the auto lift sizes on the
scene depth the JAX renderer gives, against the JAX package's refiner on the
same inputs - and the open finding that 4 mm decimation breaks the recovery,
which the port reproduces (13.8 deg, fitness 0.47, as the JAX package)."""

import os

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh as jmesh
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg
from tests.test_icp import reference_demo_poses

torch.set_num_threads(2)

W, H = 160, 120
PLY = os.path.join(os.path.dirname(__file__), "data", "bracket.ply")


@pytest.fixture(scope="module")
def setup():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    pose1, pose2, _ = reference_demo_poses()
    renderer = prt.PoseRenderer(jmesh.Model.load(PLY, verbose=False), K=K, width=W, height=H,
                                backend="dense")
    scene_depth = np.asarray(renderer.render_depth(pose2))[0].astype(np.int32)
    return K, pose1, pose2, scene_depth


def refine(package, K, pose1, scene_depth, **kw):
    """(refined pose, fitness, refiner) of the recipe through one package."""
    model = package.Model.load(PLY, verbose=False)
    refiner = package.PoseRefiner(model, K=K, width=W, height=H, window="auto",
                                  max_points="auto", **kw)
    refiner.set_scene_depth(scene_depth)
    refined, results = refiner.refine(pose1)
    return np.asarray(refined), float(results.fitness), refiner


def test_bracket_recovery_matches_jax(setup):
    """The undecimated recipe: the same auto window and point budget as the
    JAX refiner, its bar (< 4 deg, < 6 mm, fitness > 0.7), and its pose
    within the slice bounds (0.1 deg, 0.2 mm, fitness 5e-3)."""
    K, pose1, pose2, scene_depth = setup
    t_pose, t_fit, t_ref = refine(ptt, K, pose1, scene_depth, device="cpu")
    j_pose, j_fit, j_ref = refine(prt, K, pose1, scene_depth, use_pallas=False)
    assert (t_ref.window, t_ref.max_points, t_ref.roi) == (j_ref.window, j_ref.max_points,
                                                           j_ref.roi)
    assert float(rotation_angle_deg(t_pose, pose2)) < 4.0
    assert np.abs(t_pose[:3, 3] - pose2[:3, 3]).max() < 6.0 and t_fit > 0.7
    assert float(rotation_angle_deg(t_pose, j_pose)) <= 0.1
    assert np.abs(t_pose[:3, 3] - j_pose[:3, 3]).max() <= 0.2 and abs(t_fit - j_fit) <= 5e-3


@pytest.mark.slow
@pytest.mark.xfail(
    strict=True,
    reason="open finding mirrored from tests/test_second_mesh.py: decimate_mm=4 breaks "
    "bracket recovery (13.8 deg, fitness 0.47) in the port as in the JAX package",
)
def test_bracket_decimation_still_recovers(setup):
    """4 mm vertex-clustering decimation (the production render-mesh
    configuration) must stay recovery-dominant on the thin plate: cells are
    close to the 6 mm thickness, the adversarial case for clustering."""
    K, pose1, pose2, scene_depth = setup
    t_pose, t_fit, _ref = refine(ptt, K, pose1, scene_depth, device="cpu", decimate_mm=4.0)
    assert float(rotation_angle_deg(t_pose, pose2)) < 4.0
    assert t_fit > 0.7
