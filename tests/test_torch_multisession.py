"""MultiObjectSession and TrackingSession(MultiModelRefiner) of the port on
the CPU: against the JAX package's session on tests/test_tracking.py's
two-object recipe (160x120: a bumpy sphere (40, 3) at x = -45 mm and an
icosphere (30, 3) at x = +45 mm, z = 300 mm, min-nonzero composites,
drifting 0.015 rad / 2 mm per frame), and the session contracts of
tests/test_tracking.py:163-275 and :519-654 (per-object gating, atomic
rollback, bit-exact resume, step_async).

The JAX side runs as in tests/test_torch_session.py: its Pallas raster in
interpret mode. Tolerances: the same accepted frames; on the first frame,
whose hypotheses are the same draws, every refined hypothesis within the
slice's 0.2 mm and 5e-3 fitness, and in rotation within 0.1 deg on the
icosphere and 1 deg on the bumpy sphere; fused translations within
0.25 mm, fused rotations within 1 deg (bumpy sphere) and 1.5 deg
(icosphere). The port measured up to 0.72 deg on the first frame's bumpy
rows, and 0.23 mm, 0.94 deg (bumpy) and 1.11 deg (icosphere) fused over 3
frames. These are ROADMAP C's weakly observed rotations:
test_jax_multi_session_is_start_sensitive shows JAX's own session moving
further than every bound above when its starts move by 0.01 mm, because
each session draws its hypotheses around its own fused pose and so picks
other winners. A multi-model track equals the single-model track of each
mesh bit for bit (tests/test_torch_multimodel.py).
"""

import json

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
from pose_refine_tpu import mesh
import pose_refine_tpu_torch as ptt
import pose_refine_tpu_torch.tracking as ttrack
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg
from tests.test_icp import reference_demo_poses
from tests.test_torch_track import H, W, drift, jax_kernels, render, small_K  # noqa: F401

torch.set_num_threads(2)

MULTI_CFG = dict(width=W, height=H, max_points=8192, window=96, stride=1)
MAX_DT_MM = 0.25
MAX_SESSION_DROT_DEG = (1.0, 1.5)  # fused rotation: bumpy sphere, icosphere
MAX_ROW_DROT_DEG = (1.0, 0.1)  # first-frame refined rows, the same draws
MAX_DFIT = 5e-3


def assert_state_equal(a, b):
    """Two state dicts equal, nested dicts and lists of dicts included."""
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            assert_state_equal(va, vb)
        elif isinstance(va, list) and va and isinstance(va[0], dict):
            assert len(va) == len(vb)
            for ea, eb in zip(va, vb):
                assert_state_equal(ea, eb)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, k


def composite(*depths):
    """Min-nonzero depth composite: several objects in one sensor frame."""
    out = np.zeros_like(depths[0])
    for d in depths:
        out = np.where((d > 0) & ((out == 0) | (d < out)), d, out)
    return out


@pytest.fixture(scope="module")
def objects():
    return make_objects()


def make_objects():
    """(bumpy, icosphere, pose_a, pose_b, 4 drifting (truth_a, truth_b,
    int32 frame) of rng 13)."""
    bumpy = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    ico = mesh.make_icosphere(radius=30.0, subdivisions=3)
    _, pose2, _ = reference_demo_poses()
    pose_a, pose_b = pose2.copy(), pose2.copy()
    pose_a[:3, 3] = [-45.0, 0.0, 300.0]
    pose_b[:3, 3] = [45.0, 0.0, 300.0]
    rng = np.random.default_rng(13)
    ta, tb, frames = pose_a.copy(), pose_b.copy(), []
    for _ in range(4):
        ta = drift(ta, rng, rot=0.015, trans=2.0)
        tb = drift(tb, rng, rot=0.015, trans=2.0)
        frames.append((ta.copy(), tb.copy(),
                       composite(render(bumpy, ta), render(ico, tb)).astype(np.int32)))
    return bumpy, ico, pose_a, pose_b, frames


def port_refiner(objects):
    bumpy, ico = objects[:2]
    return ptt.MultiModelRefiner([bumpy, ico], K=small_K(), device="cpu", **MULTI_CFG)


def port_session(objects, seed=1, n=3, **kw):
    _b, _i, pose_a, pose_b, _f = objects
    return ptt.MultiObjectSession(port_refiner(objects), [(0, pose_a), (1, pose_b)],
                                  n_hypotheses=n, seed=seed, **kw)


def jax_session_steps(objects, shift_mm=0.0):
    """Three frames of JAX's MultiObjectSession (3 hypotheses, seed 1), its
    starts moved by shift_mm along every axis."""
    bumpy, ico, pose_a, pose_b, frames = objects
    starts = [p.copy() for p in (pose_a, pose_b)]
    for p in starts:
        p[:3, 3] += shift_mm
    jref = prt.MultiModelRefiner([bumpy, ico], K=small_K(), use_pallas=True, **MULTI_CFG)
    jses = prt.MultiObjectSession(jref, [(0, starts[0]), (1, starts[1])], n_hypotheses=3,
                                  seed=1)
    return [jses.step(depth) for _ta, _tb, depth in frames[:3]]


def session_spread(a_steps, b_steps):
    """Largest differences between two sessions' steps: first-frame refined
    rows (translation mm, rotation deg and fitness, per object) and fused
    poses over every frame (translation mm, rotation deg per object)."""
    row_dt, row_drot, row_dfit = [], [], []
    for a, b in zip(a_steps[0], b_steps[0]):
        row_dt.append(np.abs(a.refined[:, :3, 3] - b.refined[:, :3, 3]).max())
        row_drot.append(rotation_angle_deg(a.refined, b.refined).max())
        row_dfit.append(np.abs(np.asarray(a.results.fitness)
                               - np.asarray(b.results.fitness)).max())
    dt = max(np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max()
             for sa, sb in zip(a_steps, b_steps) for a, b in zip(sa, sb))
    drot = [max(rotation_angle_deg(sa[k].pose, sb[k].pose) for sa, sb in zip(a_steps, b_steps))
            for k in range(2)]
    return max(row_dt), row_drot, max(row_dfit), dt, drot


def test_jax_multi_session_is_start_sensitive(objects, jax_kernels):
    """Why the session bounds are what they are: JAX's own session, its
    starts moved by 0.01 mm, moves further than every bound the port is
    held to (measured: first-frame bumpy rows 1.26 deg, fused 0.25 mm,
    1.88 deg bumpy and 2.18 deg icosphere)."""
    _dt_rows, row_drot, _dfit, dt, drot = session_spread(
        jax_session_steps(objects, shift_mm=0.01), jax_session_steps(objects))
    assert row_drot[0] > MAX_ROW_DROT_DEG[0]
    assert dt >= MAX_DT_MM
    assert all(d > bound for d, bound in zip(drot, MAX_SESSION_DROT_DEG))


def test_multi_object_session_matches_jax(objects, jax_kernels):
    """Three frames of one fused track per frame for both objects: the
    port's session against JAX's from the same starts, seed and frames."""
    jsteps = jax_session_steps(objects)
    tses = port_session(objects)
    tsteps = []
    for (ta, tb, depth), js in zip(objects[4][:3], jsteps):
        ts = tses.step(depth)
        tsteps.append(ts)
        assert len(ts) == 2
        for t, j, truth in zip(ts, js, (ta, tb)):
            assert t.accepted == j.accepted and t.accepted
            assert t.refined.shape == (3, 4, 4) and t.covariance.shape == (6, 6)
            assert np.abs(t.pose[:3, 3] - truth[:3, 3]).max() < 6.0
    row_dt, row_drot, row_dfit, dt, drot = session_spread(tsteps, jsteps)
    assert row_dt <= 0.2 and row_dfit <= MAX_DFIT
    assert all(d <= bound for d, bound in zip(row_drot, MAX_ROW_DROT_DEG))
    assert dt <= MAX_DT_MM
    assert all(d <= bound for d, bound in zip(drot, MAX_SESSION_DROT_DEG))
    np.testing.assert_array_equal(tses.poses, np.stack([ts[0].pose, ts[1].pose]))
    assert tses.n_frames == 3


def test_multi_object_step_async(objects):
    """step_async: one fused track per frame enqueued before the previous
    frame is fused; results lag one frame; flush() drains; step() and
    state_dict() refuse while a frame is in flight."""
    session = port_session(objects, seed=1)
    frames = objects[4]
    got = []
    for i, (_ta, _tb, depth) in enumerate(frames[:3]):
        steps = session.step_async(depth)
        if i == 0:
            assert steps is None
            with pytest.raises(RuntimeError, match="flush"):
                session.state_dict()
            with pytest.raises(RuntimeError, match="flush"):
                session.step(depth)
        else:
            got.append(steps)
    got.append(session.flush())
    assert session.flush() is None and session.n_frames == 3
    for steps, (ta, tb, _d) in zip(got, frames):
        for step, truth in zip(steps, (ta, tb)):
            assert step.accepted and np.abs(step.pose[:3, 3] - truth[:3, 3]).max() < 6.0
    assert all(s.accepted for s in session.step(frames[3][2]))


def test_multi_object_per_object_gating(objects):
    """An object missing from the frame rejects only its own measurement."""
    bumpy, ico, pose_a, pose_b, _frames = objects
    session = port_session(objects, seed=2, n=2)
    steps = session.step(composite(render(bumpy, pose_a), render(ico, pose_b)).astype(np.int32))
    assert steps[0].accepted and steps[1].accepted
    before_a = session.trackers[0].pose_mm.copy()
    steps = session.step(render(ico, pose_b).astype(np.int32))
    assert not steps[0].accepted and steps[0].fitness < 0.6
    assert steps[1].accepted
    np.testing.assert_array_equal(steps[0].pose, before_a)


def test_multi_object_resume_bit_exact(objects):
    """state_dict / from_state resume the exact loop; a state naming a model
    the refiner lacks is refused."""
    frames = objects[4]
    session = port_session(objects, seed=3, max_innovation=(0.5, 0.05))
    session.step(frames[0][2])
    state = session.state_dict()
    want = [s.pose for s in session.step(frames[1][2])]
    resumed = ptt.MultiObjectSession.from_state(session.refiner, state)
    assert resumed.n_frames == 1 and resumed.max_innovation == (0.5, 0.05)
    for g, w in zip(resumed.step(frames[1][2]), want):
        np.testing.assert_array_equal(g.pose, w)
    with pytest.raises(ValueError, match="out of range"):
        ptt.MultiObjectSession.from_state(session.refiner, dict(state, model_ids=[0, 2]))
    with pytest.raises(ValueError, match="MultiModelRefiner"):
        ptt.MultiObjectSession.from_state(
            ptt.PoseRefiner(objects[0], K=small_K(), device="cpu", **MULTI_CFG), state)


def test_multi_object_rollback(objects, monkeypatch):
    """The atomic contract (tests/test_tracking.py:519-654): a step rejected
    inside track() leaves every filter and the rng stream as they were; a
    failed fuse in step_async, and a flush failing after the first object
    fused, restore the filters, the stream and the in-flight frame, and a
    corrected retry carries on."""
    frames = objects[4]
    session = port_session(objects, seed=9)
    before = session.state_dict()
    with pytest.raises(ValueError, match="motions"):
        session.step(frames[0][2], motions_mm=[None])
    bad = np.zeros((H, W, 3), np.int32)
    with pytest.raises(ValueError):
        session.step(bad)
    with pytest.raises(ValueError):
        session.step_async(bad)
    assert session._inflight is None
    assert_state_equal(before, session.state_dict())

    assert session.step_async(frames[0][2]) is None
    rng_before = json.dumps(session._rng.bit_generator.state)
    trackers_before = [t.state_dict() for t in session.trackers]
    inflight = session._inflight

    def boom(*a, **k):
        raise np.linalg.LinAlgError("synthetic fuse failure")

    monkeypatch.setattr(ttrack, "_fuse_ranked_best", boom)
    with pytest.raises(np.linalg.LinAlgError):
        session.step_async(frames[1][2])
    monkeypatch.undo()
    real, calls = ttrack._fuse_ranked_best, []

    def boom_second(*a, **k):
        calls.append(1)
        if len(calls) >= 2:  # the first object fuses, the second fails
            raise np.linalg.LinAlgError("synthetic mid-list failure")
        return real(*a, **k)

    monkeypatch.setattr(ttrack, "_fuse_ranked_best", boom_second)
    with pytest.raises(np.linalg.LinAlgError):
        session.flush()
    monkeypatch.undo()
    assert session._inflight is inflight and session.n_frames == 0
    assert json.dumps(session._rng.bit_generator.state) == rng_before
    for b, t in zip(trackers_before, session.trackers):
        assert_state_equal(b, t.state_dict())
    steps = session.step_async(frames[1][2])
    assert steps is not None and all(s.accepted for s in steps)
    assert all(s.accepted for s in session.flush()) and session.n_frames == 2


def test_multi_object_validation(objects):
    """tests/test_tracking.py:266-277's errors."""
    _b, _i, pose_a, pose_b, frames = objects
    refiner = port_refiner(objects)
    with pytest.raises(ValueError, match="at least one"):
        ptt.MultiObjectSession(refiner, [])
    with pytest.raises(ValueError, match="out of range"):
        ptt.MultiObjectSession(refiner, [(2, pose_a)])
    session = ptt.MultiObjectSession(refiner, [(0, pose_a), (1, pose_b)])
    with pytest.raises(ValueError, match="motions"):
        session.step(frames[0][2], motions_mm=[None])


def test_tracking_session_with_multi_model_refiner(objects):
    """A TrackingSession on a MultiModelRefiner pins every hypothesis to
    the session's model (tests/test_tracking.py:163-175): model_id is
    required, before the session moves, and then routes the track."""
    bumpy, ico, pose_a, pose_b, frames = objects
    refiner = port_refiner(objects)
    session = ptt.TrackingSession(refiner, pose_b, n_hypotheses=2, seed=6)
    depth = composite(render(bumpy, pose_a), render(ico, pose_b)).astype(np.int32)
    before = session.state_dict()
    with pytest.raises(ValueError, match="model_id"):
        session.step(depth)
    with pytest.raises(ValueError, match="model_id"):
        session.step_async(depth)
    assert_state_equal(before, session.state_dict())
    step = session.step(depth, model_id=1)
    assert step.accepted and step.fitness > 0.7
    assert np.abs(step.pose[:3, 3] - pose_b[:3, 3]).max() < 3.0
    assert session.step_async(frames[0][2], model_id=1) is None
    assert session.flush().accepted
