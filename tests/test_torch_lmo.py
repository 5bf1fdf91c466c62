"""MultiModelRefiner of the port on the CPU against the benchmark's plain
per-model reference (``benchmark/reference/multimodel.py``, which renders
each hypothesis with its own model's triangles), at a small size: three
seeded stand-in meshes of different triangle counts (the lmo-frame512
cell's kind, ``benchmark/kinds/multirefine.py``) in one 160x120 frame, 12
hypotheses, held to the cell's limits (``benchmark/limits/lmo-frame512.json``);
answers computed with every pose's model id rotated by one fail them. Also
the counters and the span of the per-pose meshes, and the window warning of
a frame whose objects together exceed the window while each fits.
"""

import importlib.util
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from pose_refine_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path.insert(0, str(BENCH))

from core import check, inputs  # noqa: E402
from reference.geometry import corner_gap, full_float32  # noqa: E402
from reference.multimodel import MultiRefiner  # noqa: E402

torch.set_num_threads(2)

W, H = 160, 120
K = [[143.10285, 0.0, 81.315275], [0.0, 143.39261, 60.5122475], [0.0, 0.0, 1.0]]
CAMERA = {"width": W, "height": H, "K": K}
# the cell's refiner at a quarter of its frame: full-resolution renders,
# a 64-pixel window, 512 points, 4 mm decimation, 24 iterations
CFG = {"camera": CAMERA,
       "refiner": {"scene": "projective", "render_scale": 1, "decimate_mm": 4.0, "window": 64,
                   "stride": 2, "max_points": 512, "max_dist_diff": 0.1},
       "criteria": {"relative_fitness": 1e-5, "relative_rmse": 1e-5, "max_iteration": 24}}
# three stand-ins: (diameter mm, icosphere subdivision, bump)
MODELS = [(70.0, 3, 0.30), (110.0, 4, 0.17), (90.0, 3, 0.24)]
LIMITS = json.loads((BENCH / "limits" / "lmo-frame512.json").read_text())
SEED = 3_000_000_027
PER_MODEL = 4


def _kind():
    spec = importlib.util.spec_from_file_location("bench_kind_multirefine",
                                                  BENCH / "kinds" / "multirefine.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KIND = _kind()


def _refiner(meshes, window=None):
    opts = dict(CFG["refiner"])
    if window is not None:
        opts["window"] = window
    return ptt.MultiModelRefiner(
        [ptt.Model.from_vertices_faces(v, f) for v, f in meshes],
        K=np.asarray(K, np.float32), width=W, height=H, device="cpu", **opts)


@pytest.fixture(scope="module")
def case():
    return make_case()


def make_case():
    """The meshes, one frame of the three at their truths (x -70, 0, +70 mm,
    z 360-420 mm, rotations uniform), 4 hypotheses of each model (+-10 deg
    an axis, +-10 mm), the model ids, and the program's refiner with that
    frame set."""
    full_float32()
    rng = traffic_rng(SEED)
    meshes = [KIND.stand_in({"shape": "bumpy_sphere", "diameter_mm": d, "subdivisions": s,
                             "bump": b}) for d, s, b in MODELS]
    t = np.array([[-70.0, 5.0, 380.0], [0.0, -10.0, 420.0], [70.0, 8.0, 360.0]])
    truths = inputs.poses(inputs.uniform_rotations(rng, 3), t)[None]
    frame = KIND.compose(meshes, truths, CAMERA, "cpu")[0]
    ids = np.repeat(np.arange(3, dtype=np.int32), PER_MODEL)
    hyps = np.concatenate([inputs.perturb(rng, truths[0, k], PER_MODEL, 10, 10)
                           for k in range(3)])
    ref = _refiner(meshes)
    ref.set_scene_depth(frame)
    return meshes, truths, frame, ids, hyps, ref


def traffic_rng(seed):
    return np.random.default_rng([seed, 1])


def judged(case, poses, fitness, rmse):
    """The check's numbers of answers (poses, fitness, rmse) to the case's
    hypotheses, judged by the plain per-model reference."""
    meshes, _truths, frame, ids, hyps, ref = case
    mref = MultiRefiner(CFG, meshes, "cpu")
    scene = mref.scene(frame)
    roi = ref.roi
    refined = mref.refine_models(scene, hyps, ids, roi, 24)[0].numpy()
    halves = np.array([check.half_extent(v) for v, _ in meshes])
    gaps = {"pose_gap_mm": [np.array([corner_gap(poses[j], refined[j], halves[k])
                                      for j, k in enumerate(ids)])]}
    fit, err = mref.judge_models(scene, hyps, ids, poses, roi)
    f_gap, r_gap = check.rescore_gaps(fitness, rmse, fit.numpy(), err.numpy())
    gaps["fitness_gap"], gaps["rmse_gap_um"] = [f_gap], [r_gap]
    return check.numbers(gaps, LIMITS)


def test_frame_holds_the_three_models_and_the_ids_their_own_tables(case):
    meshes, _truths, frame, ids, hyps, ref = case
    assert frame.shape == (H, W) and (frame > 0).sum() > 2000
    assert len(set(ref.model_tris.tolist())) == 3
    mref = MultiRefiner(CFG, meshes, "cpu")
    # the program's decimation and the reference's frozen copy agree
    assert [t.shape[0] for t in mref.tables] == ref.model_tris.tolist()
    assert ref.tris_table.shape[:2] == (3, ref.model_tris.max())
    for (v, _), (d, _s, _b) in zip(meshes, MODELS):
        assert KIND.diameter(v) == pytest.approx(d, rel=1e-6)


def test_refine_within_the_cells_limits(case):
    _meshes, _truths, _frame, ids, hyps, ref = case
    crit = ptt.ICPConvergenceCriteria(**CFG["criteria"])
    poses, res = ref.refine(ids, hyps, criteria=crit)
    got = judged(case, poses.numpy(), res.fitness.numpy(), res.inlier_rmse.numpy())
    assert all(v <= LIMITS[k] for k, v in got.items()), (got, LIMITS)


def test_ids_rotated_by_one_fail_the_limits(case):
    _meshes, _truths, _frame, ids, hyps, ref = case
    crit = ptt.ICPConvergenceCriteria(**CFG["criteria"])
    poses, res = ref.refine((ids + 1) % 3, hyps, criteria=crit)
    got = judged(case, poses.numpy(), res.fitness.numpy(), res.inlier_rmse.numpy())
    assert [k for k, v in got.items() if not v <= LIMITS[k]], (got, LIMITS)


def test_counters_and_span_of_the_per_pose_meshes(case):
    _meshes, _truths, _frame, ids, hyps, ref = case
    crit = ptt.ICPConvergenceCriteria(max_iteration=2)
    before = profiling.counters()
    profiling.clear_spans()
    for k in range(2):
        ref.refine(ids[k:], hyps[k:], criteria=crit)
        assert len(profiling.spans("prt.refine.models")) == k + 1
    after = profiling.counters()
    n = 2 * len(ids) - 1
    t_max = ref.tris_table.shape[1]
    own = int(ref.model_tris[ids].sum() + ref.model_tris[ids[1:]].sum())
    assert after["pipeline.model_poses"] - before["pipeline.model_poses"] == n
    assert after["pipeline.model_slots"] - before["pipeline.model_slots"] == n * t_max
    assert after["pipeline.padded_slots"] - before["pipeline.padded_slots"] == n * t_max - own
    assert own < n * t_max
    rec = profiling.spans("prt.refine.models")[0]
    assert rec.parent is None and rec.end_ns >= rec.start_ns


def _warnings(caplog):
    return [r for r in caplog.records if r.levelno == logging.WARNING
            and "exceeds the window lift" in r.getMessage()]


def test_window_warning_judges_each_object_not_their_union(case, caplog):
    """Four frames of the three objects, each drawn anew: their union spans
    more than the 64-pixel window, each object less. MultiModelRefiner warns
    on none of them, where a PoseRefiner (one object a frame: the union is
    its extent) warns on every one; with a 24-pixel window, which one
    object exceeds, MultiModelRefiner warns on every frame."""
    meshes = case[0]
    rng = traffic_rng(SEED + 1)
    t = np.array([[-110.0, 5.0, 380.0], [0.0, -10.0, 420.0], [110.0, 8.0, 360.0]])
    frames = KIND.compose(meshes, np.stack([
        inputs.poses(inputs.uniform_rotations(rng, 3), t + rng.uniform(-8, 8, (3, 3)))
        for _ in range(4)]), CAMERA, "cpu")
    caplog.set_level(logging.WARNING, logger="pose_refine_tpu_torch")

    def count(refiner):
        caplog.clear()
        for f in frames:
            refiner.set_scene_depth(f)
        return len(_warnings(caplog))

    multi = _refiner(meshes)
    assert count(multi) == 0
    assert multi._obj_extent_px > 64
    single = ptt.PoseRefiner(ptt.Model.from_vertices_faces(*meshes[0]),
                             K=np.asarray(K, np.float32), width=W, height=H, device="cpu",
                             **CFG["refiner"])
    assert count(single) == 4
    assert count(_refiner(meshes, window=24)) == 4
