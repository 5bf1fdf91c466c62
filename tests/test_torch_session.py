"""TrackingSession of the port on the CPU: against the JAX package's session
on tests/test_tracking.py's drift recipe (160x120 bumpy sphere, 3
hypotheses, 3 frames), and its own contracts - step_async's filter order,
bit-exact resume, rollback of a failed step.

The JAX side runs as in tests/test_torch_track.py: its Pallas raster in
interpret mode, its device-built NN scenes on the flash backend.
"""

import json

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
import pose_refine_tpu_torch as ptt
import pose_refine_tpu_torch.tracking as ttrack
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg
from tests.test_torch_track import (  # noqa: F401  (fixtures)
    H,
    MAX_DT_MM,
    R_REN,
    W,
    drift,
    jax_kernels,
    render,
    small_K,
)

torch.set_num_threads(2)

SESSION_CFG = dict(width=W, height=H, max_points=4096, window=64, stride=1)
# fused rotations of two sessions: this sphere's rotation is weakly observed
# at 160x120 (test_jax_refiner_rotation_is_start_sensitive)
MAX_SESSION_DROT_DEG = 1.0


@pytest.fixture(scope="module")
def bumpy():
    return mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)


def session_frames(m, n=3, seed=7):
    """(start pose, truths, int32 frames) of tests/test_tracking.py's drift."""
    rng = np.random.default_rng(seed)
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    start = truth.copy()
    truths, frames = [], []
    for _ in range(n):
        truth = drift(truth, rng)
        truths.append(truth.copy())
        frames.append(render(m, truth).astype(np.int32))
    return start, truths, frames


def test_jax_refiner_rotation_is_start_sensitive(bumpy, jax_kernels):
    """Why two sessions are held to 1 deg in rotation: the JAX refiner itself
    moves refined hypotheses by more than 0.1 deg (measured up to 0.46 deg)
    when their starts move by 0.007 deg, at the session's first-frame
    hypothesis spread, while translations move < 0.1 mm. A session's
    hypotheses are drawn around its fused pose, so rounding-level
    differences between two sessions grow to that size."""
    start, _truths, frames = session_frames(bumpy)
    ref = prt.PoseRefiner(bumpy, K=small_K(), use_pallas=True, **SESSION_CFG)
    tracker = prt.PoseTracker(start)
    tracker.predict()
    hyps = tracker.hypotheses(8, seed=np.random.default_rng(1))
    tilt = np.asarray(jgeo.euler_to_rotation(np.array([7e-5, -7e-5, 7e-5], np.float32)))
    moved = hyps.copy()
    moved[:, :3, :3] = tilt @ hyps[:, :3, :3]
    assert rotation_angle_deg(hyps, moved).max() < 0.01
    a = np.asarray(ref.track(frames[0], hyps)[0])
    b = np.asarray(ref.track(frames[0], moved)[0])
    assert rotation_angle_deg(a, b).max() > 0.1
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() < 0.1


@pytest.mark.parametrize("scene,kw", [("projective", {}), ("nn_bruteforce", dict(scene_stride=2))],
                         ids=["projective", "nn_stride2"])
def test_session_matches_jax(bumpy, jax_kernels, scene, kw):
    """A 3-frame TrackingSession, the port against JAX's from the same start,
    seed and frames: the same accept flags, the same winner on the first
    frame (the same hypotheses), fused translations within the slice bound
    (0.2 mm), fused rotations within 1 deg (measured 0.24 deg projective,
    0.86 deg NN: see test_jax_refiner_rotation_is_start_sensitive), and
    both within 6 mm of the truth."""
    start, truths, frames = session_frames(bumpy)
    cfg = dict(scene=scene, **kw, **SESSION_CFG)
    jses = prt.TrackingSession(prt.PoseRefiner(bumpy, K=small_K(), use_pallas=True, **cfg),
                               start, n_hypotheses=3, seed=1)
    tses = ptt.TrackingSession(ptt.PoseRefiner(bumpy, K=small_K(), device="cpu", **cfg),
                               start, n_hypotheses=3, seed=1)
    for i, (frame, truth) in enumerate(zip(frames, truths)):
        js, ts = jses.step(frame), tses.step(frame)
        assert ts.accepted == js.accepted and ts.accepted
        if i == 0:
            assert ts.best == js.best
        assert np.isfinite(ts.pose).all() and ts.covariance.shape == (6, 6)
        assert np.abs(ts.pose[:3, 3] - js.pose[:3, 3]).max() <= MAX_DT_MM
        assert rotation_angle_deg(ts.pose, js.pose) <= MAX_SESSION_DROT_DEG
        assert np.abs(ts.pose[:3, 3] - truth[:3, 3]).max() < 6.0
    assert tses.n_rejected == jses.n_rejected == 0 and tses.n_frames == 3


@pytest.fixture(scope="module")
def session_setup(bumpy):
    start, truths, frames = session_frames(bumpy, n=3, seed=11)
    return bumpy, start, truths, frames


def port_session(m, start, seed=1, **kw):
    ref = ptt.PoseRefiner(m, K=small_K(), device="cpu", **SESSION_CFG)
    return ptt.TrackingSession(ref, start, n_hypotheses=3, seed=seed, **kw)


def test_step_async_matches_step(session_setup, monkeypatch):
    """step_async + flush gives the sequence step gives: the same frames
    fused in the same order with the same accept flags, every estimate
    within 6 mm of the truth, and - replaying the measurements step_async
    fused through a fresh filter in step's order (predict, then update) -
    the same estimates bit for bit. (Its hypotheses are centred one frame
    behind, so its measurements themselves differ from step's.)"""
    m, start, truths, frames = session_setup
    sync_s, async_s = port_session(m, start), port_session(m, start)
    want = [sync_s.step(f) for f in frames]
    fused = []
    pull = ttrack._pull_packed

    def spy(refiner, packed):
        fused.append(pull(refiner, packed))
        return fused[-1]

    monkeypatch.setattr(ttrack, "_pull_packed", spy)
    got = [async_s.step_async(f) for f in frames]
    assert got[0] is None
    got = got[1:] + [async_s.flush()]
    assert async_s.flush() is None and async_s.n_frames == sync_s.n_frames == 3
    replay = ptt.PoseTracker(start)
    for g, w, truth, measured in zip(got, want, truths, fused):
        assert g.accepted == w.accepted and g.accepted
        assert np.abs(g.pose[:3, 3] - truth[:3, 3]).max() < 6.0
        ttrack._advance_tracker(replay, "random_walk", None)
        r = ttrack._fuse_ranked_best(replay, *measured, async_s.gate_chi2,
                                     async_s.max_innovation, async_s.min_quality)
        assert r.accepted == g.accepted and r.best == g.best
        np.testing.assert_array_equal(r.pose, g.pose)
    # a frame in flight blocks step(); after flush, step works again
    assert async_s.step_async(frames[-1]) is None
    with pytest.raises(RuntimeError, match="flush"):
        async_s.step(frames[-1])
    assert async_s.flush().accepted
    assert async_s.step(frames[-1]).accepted


def test_from_state_resumes_bit_exact(session_setup):
    m, start, truths, frames = session_setup
    session = port_session(m, start, seed=5, max_innovation=(0.5, 0.05))
    session.step(frames[0])
    state = session.state_dict()
    want = [session.step(f).pose for f in frames[1:]]
    resumed = ptt.TrackingSession.from_state(session.refiner, state)
    assert resumed.n_frames == 1 and resumed.max_innovation == (0.5, 0.05)
    for f, w in zip(frames[1:], want):
        np.testing.assert_array_equal(resumed.step(f).pose, w)
    bad = dict(session.state_dict(), n_hypotheses=0)
    with pytest.raises(ValueError, match="n_hypotheses"):
        ptt.TrackingSession.from_state(session.refiner, bad)


def assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_state_equal(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_failed_step_leaves_session_unchanged(session_setup, monkeypatch):
    """A failing step() / step_async() / flush() leaves filter, hypothesis
    stream, frame count and the in-flight frame as they were, and a
    corrected retry carries on (tests/test_tracking.py:449-593)."""
    m, start, truths, frames = session_setup
    session = port_session(m, start, seed=6)
    before = session.state_dict()
    bad = np.zeros((H, W, 3), np.int32)
    with pytest.raises(ValueError, match="model_id"):
        session.step(frames[0], model_id=0)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        session.step(bad)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        session.step_async(bad)
    assert session._inflight is None
    assert_state_equal(before, session.state_dict())

    assert session.step_async(frames[0]) is None
    rng_before = json.dumps(session._rng.bit_generator.state)
    tracker_before = session.tracker.state_dict()
    inflight = session._inflight

    def boom(*a, **k):
        raise np.linalg.LinAlgError("synthetic fuse failure")

    monkeypatch.setattr(ttrack, "_fuse_ranked_best", boom)
    with pytest.raises(np.linalg.LinAlgError):
        session.step_async(frames[1])
    with pytest.raises(np.linalg.LinAlgError):
        session.flush()
    monkeypatch.undo()
    assert session._inflight is inflight and session.n_frames == 0
    assert json.dumps(session._rng.bit_generator.state) == rng_before
    assert_state_equal(tracker_before, session.tracker.state_dict())
    step = session.step_async(frames[1])
    assert step is not None and step.accepted
    assert session.flush().accepted and session.n_frames == 2


def test_multi_object_session_raises(bumpy):
    """A MultiObjectSession needs a MultiModelRefiner (JAX
    tests/test_tracking.py:269)."""
    ref = ptt.PoseRefiner(bumpy, K=small_K(), device="cpu", **SESSION_CFG)
    with pytest.raises(ValueError, match="MultiModelRefiner"):
        ptt.MultiObjectSession(ref, [(0, np.eye(4, dtype=np.float32))])
