"""Host planning of a frame: the port's PoseRefiner._prepare_frame against
the JAX package's, frame by frame (ROI, lift sizes, the object's extent,
the logged warnings), and the object record of _object_stats against the
per-pixel formula it replaces (np.nonzero of the mask)."""

import logging

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh

torch.set_num_threads(2)

W, H = 320, 240
LOGGERS = ("pose_refine_tpu", "pose_refine_tpu_torch")


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    return K


@pytest.fixture(scope="module")
def model():
    return mesh.make_icosphere(radius=50.0, subdivisions=1)


def disk(cy, cx, r, value=320, h=H, w=W, dtype=np.int32):
    yy, xx = np.mgrid[:h, :w]
    frame = np.zeros((h, w), dtype)
    frame[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = value
    return frame


def float_frame():
    """A float frame in mm with negative pixels and NaN holes, inside the
    object and around it: only the positive finite pixels are the object."""
    frame = disk(110, 170, 45, 330.5, dtype=np.float32)
    frame[100:104, 160:200] = np.nan
    frame[5:9, 5:60] = -12.0
    frame[200:203, 250:300] = np.nan
    frame[120, 150] = -1.0
    return frame


def one_pixel():
    frame = np.zeros((H, W), np.int32)
    frame[131, 207] = 315
    return frame


FRAMES = {
    "empty": lambda: np.zeros((H, W), np.int32),
    "one_pixel": one_pixel,
    "top_border": lambda: disk(10, 150, 40),
    "bottom_border": lambda: disk(H - 15, 120, 40),
    "left_border": lambda: disk(120, 12, 50),
    "right_border": lambda: disk(100, W - 8, 50),
    "whole_frame": lambda: np.full((H, W), 300, np.uint16),
    "meters": lambda: disk(120, 160, 40, 0.32, dtype=np.float32),
    "float_nan_negative": float_frame,
}


def refiners(model, auto_roi, lift="window"):
    kw = dict(render_scale=2, window="auto", max_points="auto", stride=2,
              auto_roi=auto_roi, lift=lift)
    jref = prt.PoseRefiner(model, K=small_K(), width=W, height=H, use_pallas=False, **kw)
    tref = ptt.PoseRefiner(model, K=small_K(), width=W, height=H, device="cpu", **kw)
    return jref, tref


def plan(ref):
    return (ref.roi, ref.window, ref.max_points, ref._obj_extent_px,
            ref._frame_planned, ref._check_saturation)


def logged(caplog, name):
    return [(r.levelname, r.getMessage()) for r in caplog.records
            if r.name == name and not r.getMessage().startswith("scene built")]


@pytest.fixture()
def logs(caplog):
    for name in LOGGERS:
        caplog.set_level(logging.INFO, logger=name)
    return caplog


@pytest.mark.parametrize("lift", ["window", "compact"])
@pytest.mark.parametrize("auto_roi", [True, False], ids=["roi", "no_roi"])
@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_plan_matches_jax(model, logs, name, auto_roi, lift):
    """One frame planned from a fresh refiner: the same plan and the same
    log lines as the JAX package's planning (np.nonzero of the mask)."""
    frame = FRAMES[name]()
    jref, tref = refiners(model, auto_roi, lift)
    jref._prepare_frame(frame)
    tref._prepare_frame(frame)
    assert plan(tref) == plan(jref)
    assert logged(logs, "pose_refine_tpu_torch") == logged(logs, "pose_refine_tpu")
    if name == "meters":
        assert any("look like meters" in m for _, m in logged(logs, "pose_refine_tpu_torch"))
    if name == "float_nan_negative":  # np.max is NaN: no meters warning, as before
        assert not any("meters" in m for _, m in logged(logs, "pose_refine_tpu_torch"))


@pytest.mark.parametrize("auto_roi", [True, False], ids=["roi", "no_roi"])
def test_stack_plan_matches_jax(model, logs, auto_roi):
    """set_scene_depths plans the stack's max projection: four frames whose
    objects lie apart give one box around all four."""
    frames = np.stack([disk(40, 50, 20), disk(60, 260, 25), disk(190, 70, 30),
                       disk(180, 240, 15)])
    frames[2, 10:14, 10:14] = -3
    jref, tref = refiners(model, auto_roi)
    jref._prepare_frame(frames.max(axis=0))
    tref.set_scene_depths(frames)
    assert plan(tref) == plan(jref)
    assert logged(logs, "pose_refine_tpu_torch") == logged(logs, "pose_refine_tpu")


def hysteresis_frames():
    """The sequence of test_auto_planning_matches_jax, then objects that
    grow and shrink across one 32 px window quantum and one 256-point
    quantum, by a little and by a lot, and an empty frame between."""
    base = disk(120, 160, 40)
    seq = [base, np.roll(base, (6, -9), axis=(0, 1)), np.roll(base, (40, 50), axis=(0, 1))]
    for r in (40, 38, 41, 33, 30, 52, 50, 45, 58, 20, 22):
        seq.append(disk(118, 150, r))
    seq.append(np.zeros((H, W), np.int32))
    seq += [disk(120, 160, 42), np.roll(disk(120, 160, 42), (0, 70), axis=(0, 1)),
            np.roll(disk(120, 160, 42), (-3, 4), axis=(0, 1))]
    return seq


@pytest.mark.parametrize("auto_roi", [True, False], ids=["roi", "no_roi"])
def test_hysteresis_plan_matches_jax(model, logs, auto_roi):
    jref, tref = refiners(model, auto_roi)
    seen = set()
    for frame in hysteresis_frames():
        jref._prepare_frame(frame)
        tref._prepare_frame(frame)
        assert plan(tref) == plan(jref)
        seen.add((tref.window, tref.max_points))
    assert logged(logs, "pose_refine_tpu_torch") == logged(logs, "pose_refine_tpu")
    # the sequence moved both knobs, each more than once
    assert len({w for w, _ in seen}) >= 3 and len({p for _, p in seen}) >= 3


@pytest.mark.parametrize("past", [0, 1], ids=["on_guard", "past_guard"])
@pytest.mark.parametrize("side", ["left", "top", "right", "bottom"])
def test_roi_guard_edge_matches_jax(model, logs, side, past):
    """The ROI hysteresis at its edge: a 60 x 40 px object moved so that one
    side lies exactly on the guard margin keeps the crop; one render pixel
    further re-crops."""
    w, h = 640, 480
    kw = dict(render_scale=2, window="auto", max_points="auto", stride=2)
    jref = prt.PoseRefiner(model, K=jgeo.LINEMOD_K, width=w, height=h, use_pallas=False, **kw)
    tref = ptt.PoseRefiner(model, K=jgeo.LINEMOD_K, width=w, height=h, device="cpu", **kw)

    def rect(r0, c0):
        frame = np.zeros((h, w), np.int32)
        frame[r0:r0 + 40, c0:c0 + 60] = 320
        return frame

    jref._prepare_frame(rect(220, 290))
    tref._prepare_frame(rect(220, 290))
    assert plan(tref) == plan(jref)
    roi = x0, y0, rw, rh = tref.roi
    guard = max(12, (int(tref.roi_margin * tref._obj_extent_px) + 16) // 2)
    r0, c0 = 220, 290
    if side == "left":
        c0 = 2 * (x0 + guard - past)
    elif side == "top":
        r0 = 2 * (y0 + guard - past)
    elif side == "right":
        c0 = 2 * (x0 + rw - guard + past) - 59
    else:
        r0 = 2 * (y0 + rh - guard + past) - 39
    frame = rect(r0, c0)
    jref._prepare_frame(frame)
    tref._prepare_frame(frame)
    assert plan(tref) == plan(jref)
    assert (tref.roi == roi) == (past == 0)
    assert logged(logs, "pose_refine_tpu_torch") == logged(logs, "pose_refine_tpu")


def random_frames(rng, h, w, dtype):
    """Seeded frames of every kind the record has to survive: sparse noise
    over the whole frame, a dense blob in a random box, a box against the
    borders, one pixel, and an empty frame."""
    out = []
    for density in (0.001, 0.05, 0.6):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        y1, x1 = rng.integers(y0, h + 1), rng.integers(x0, w + 1)
        frame = np.zeros((h, w), np.float64)
        keep = rng.random((y1 - y0, x1 - x0)) < density
        frame[y0:y1, x0:x1] = np.where(keep, rng.uniform(1, 2000, keep.shape), 0)
        out.append(frame)
    out.append(np.where(rng.random((h, w)) < 0.01, rng.uniform(1, 2000, (h, w)), 0))
    edge = np.zeros((h, w))
    edge[: h // 3, w // 2:] = 250
    out.append(edge)
    dot = np.zeros((h, w))
    dot[rng.integers(h), rng.integers(w)] = 1
    out.append(dot)
    out.append(np.zeros((h, w)))
    if dtype == np.float32:
        for frame in out[:4]:
            frame[rng.random((h, w)) < 0.02] = np.nan
            frame[rng.random((h, w)) < 0.02] = -rng.uniform(0.5, 50)
    return [f.astype(dtype) for f in out]


@pytest.mark.parametrize("shape", [(480, 640), (120, 160)], ids=["640x480", "160x120"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.float32],
                         ids=["int32", "uint16", "float32"])
def test_object_stats_match_nonzero(model, shape, dtype):
    """The record's count, box and extent equal np.nonzero(depth > 0)'s
    count, min and max, and its maximum np.max's, NaN included."""
    tref = ptt.PoseRefiner(model, K=small_K(), width=W, height=H, device="cpu",
                           render_scale=2)
    rng = np.random.default_rng(1234 + shape[0] + np.dtype(dtype).num)
    for depth in random_frames(rng, *shape, dtype):
        got = tref._object_stats(depth)
        ys, xs = np.nonzero(depth > 0)
        assert got.count == len(xs)
        if len(xs):
            assert (got.y0, got.y1, got.x0, got.x1) == (ys.min(), ys.max(), xs.min(), xs.max())
            assert got.extent == int(max(xs.max() - xs.min(), ys.max() - ys.min())) // 2
        else:
            assert (got.y0, got.y1, got.x0, got.x1, got.extent) == (None, None, None, None, 0)
        np.testing.assert_equal(got.d_max, float(np.max(depth)))
        assert all(type(v) is int for v in got[:6] if v is not None)
