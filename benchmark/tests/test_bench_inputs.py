"""The input generators repeat exactly for a seed, and make what their
cells say: the bumpy sphere at LINEMOD obj_06's triangle count, truths in
range, hypotheses within the perturbation, a closed trajectory with small
steps, frames that show the object."""

import numpy as np
import pytest
import torch

from core import inputs
from core.traffic import _rng
from reference.geometry import euler_np

K = [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]]
CAM = {"width": 640, "height": 480, "K": K}
SEED = 3_000_000_017


def test_mesh_repeats_and_has_the_stated_size():
    v, f = inputs.bumpy_sphere(40.0, 5, 0.25)
    v2, f2 = inputs.bumpy_sphere(40.0, 5, 0.25)
    assert np.array_equal(v, v2) and np.array_equal(f, f2)
    assert f.shape == (20480, 3) and v.shape == (10242, 3)
    r = np.linalg.norm(v, axis=1)
    assert 40 * 0.75 <= r.min() and r.max() <= 40 * 1.25
    # every edge is shared by two faces: a closed surface
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_ply_round_trip_through_the_program_loader(tmp_path, monkeypatch):
    from pose_refine_tpu_torch.mesh import load_ply
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    v, f = inputs.bumpy_sphere(40.0, 2, 0.25)
    path = inputs.write_ply(v, f)
    assert path.startswith(str(tmp_path))
    lv, lf = load_ply(path)
    assert np.array_equal(lv, v) and np.array_equal(lf, f)


@pytest.mark.parametrize("seed", [SEED, 7])
def test_poses_repeat_for_a_seed(seed):
    def draw():
        rng = _rng(seed, 1)
        t = inputs.truth_poses(rng, 16, (300, 360), 40)
        return t, inputs.perturb(rng, t[3], 256, 10, 20), \
            inputs.trajectory(rng, 64, (300, 360), 40, 0.035, 5.0)
    a, b = draw(), draw()
    for x, y in zip(a, b):
        assert x.dtype == np.float32 and np.array_equal(x, y)
    assert not np.array_equal(draw()[0], inputs.truth_poses(_rng(seed + 1, 1), 16, (300, 360), 40))


def test_truths_and_hypotheses_in_range():
    rng = _rng(SEED, 1)
    t = inputs.truth_poses(rng, 200, (300, 360), 40)
    R = t[:, :3, :3].astype(np.float64)
    assert np.allclose(R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-5)
    assert (t[:, 2, 3] >= 300).all() and (t[:, 2, 3] <= 360).all()
    assert (np.abs(t[:, :2, 3]) <= 40).all()
    h = inputs.perturb(rng, t[0], 500, 10, 20)
    assert (np.abs(h[:, :3, 3] - t[0, :3, 3]) <= 20 + 1e-3).all()
    d = h[:, :3, :3].astype(np.float64) @ t[0, :3, :3].T.astype(np.float64)
    ang = np.degrees(np.arccos(np.clip((np.trace(d, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() <= np.sqrt(3) * 10 + 0.01


def test_trajectory_is_closed_and_steps_are_small():
    traj = inputs.trajectory(_rng(SEED, 1), 64, (300, 360), 40, 0.035, 5.0)
    nxt = np.roll(traj, -1, axis=0)
    step_t = np.abs(nxt[:, :3, 3] - traj[:, :3, 3])
    assert step_t.max() <= 5.0 + 1e-3
    rel = nxt[:, :3, :3].astype(np.float64) @ traj[:, :3, :3].transpose(0, 2, 1)
    ang = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert ang.max() <= np.sqrt(3) * 0.035 + 1e-4
    assert (traj[:, 2, 3] >= 300).all() and (traj[:, 2, 3] <= 360).all()


def test_frames_repeat_and_show_the_object():
    v, f = inputs.bumpy_sphere(40.0, 5, 0.25)
    t = inputs.truth_poses(_rng(SEED, 1), 2, (300, 360), 40)
    a = inputs.render_frames(v, f, t, CAM, "cpu")
    b = inputs.render_frames(v, f, t, CAM, "cpu")
    assert a.dtype == np.int32 and a.shape == (2, 480, 640) and np.array_equal(a, b)
    for frame, pose in zip(a, t):
        z = frame[frame > 0]
        assert 8000 < z.size < 40000
        assert pose[2, 3] - 51 <= z.min() and z.max() <= pose[2, 3] + 51


def test_euler_matches_the_stated_order():
    x, y, z = 0.1, -0.2, 0.3
    Rx = np.array([[1, 0, 0], [0, np.cos(x), -np.sin(x)], [0, np.sin(x), np.cos(x)]])
    Ry = np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0], [-np.sin(y), 0, np.cos(y)]])
    Rz = np.array([[np.cos(z), -np.sin(z), 0], [np.sin(z), np.cos(z), 0], [0, 0, 1]])
    assert np.allclose(euler_np([x, y, z]), Rz @ Ry @ Rx)
    assert torch.get_default_dtype() == torch.float32
