"""Whether what the timed path produced is correct, by the reference: the
pieces the traffic kinds share, and the numbers compared.

Each answer is judged by what it says. A refined hypothesis says "from
this hypothesis, the ICP ends at this pose with this fitness and rmse":
the reference refines the same hypothesis itself, and re-scores the
answer's pose (the transform it implies, applied to the reference's own
lift of the hypothesis). A tracked frame also says "this is the
measurement's covariance and the fused pose": the reference ranks the
frame's answers by its own re-scores, computes the covariance at the
winner's pose and fuses the winner itself.

A kind's ``gaps`` returns, per answer or frame:
  pose_gap_mm    the largest corner displacement (mm) between the answer
                 and the reference's own refine of the same hypothesis
  start_gap_mm   (tracking) the same, of the session's first frames
  fitness_gap    the gap between an answer's fitness and the reference's
                 re-score of its pose (a fraction of the cloud's points)
  rmse_gap_um    the gap (um) between an answer's rmse and that re-score's
  cov_gap_rel    (tracking) the largest gap between a frame's covariance
                 and the reference's, over the reference's largest entry
  fused_gap_um   (tracking) the corner displacement (um) between a frame's
                 fused pose and the reference's fusion of the frame

A cell's limits file names each number compared as ``<gap>_p<q>``: the
q-th percentile of that gap over the sampled answers. Percentiles, not
the widest gaps: projective association looks a point up at the pixel it
rounds to, so where a point lies within rounding of a pixel's edge, two
float32 computations of the same answer associate it with neighbouring
pixels, and an ICP path or a re-score turns that into gaps of up to
millimetres at a few percent of the answers, on sound runs. A non-finite
answer is counted as failed and fails the run by itself.
"""

from __future__ import annotations

import re

import numpy as np

from core import bounds
from reference.plan import RoiPlanner

NUMBER = re.compile(r"^(?P<gap>.+)_p(?P<q>\d+)$")


def numbers(gaps: dict, limits: dict) -> dict:
    """{number: value} of each number the limits name: the percentile of
    its gap over the sampled answers (NaN if any gap is NaN)."""
    out = {}
    for name in limits:
        m = NUMBER.match(name)
        values = np.concatenate([np.ravel(v) for v in gaps[m["gap"]]])
        out[name] = float(np.percentile(values, int(m["q"])))
    return out


def half_extent(vertices) -> float:
    return float(np.linalg.norm(np.asarray(vertices, np.float64), axis=1).max())


def rois(tr, ref) -> dict:
    """The ROI each logged render call rendered in: the refiner's planning
    replayed over every frame the program was handed, in order."""
    plan = RoiPlanner(ref.width, ref.height, ref.scale)
    out = {}
    for i, (what, f) in enumerate(tr.calls):
        if what in ("scene", "track"):
            plan.observe(tr.frames[f])
        if what in ("refine", "track"):
            out[i] = plan.roi
    return out


def scenes(ref, frames):
    """frame index -> the reference's scene of it, built once."""
    cache = {}

    def get(f):
        if f not in cache:
            cache[f] = ref.scene(frames[f])
        return cache[f]
    return get


def rescore_gaps(fit, rmse, r_fit, r_rmse) -> tuple:
    """(fitness gaps, rmse gaps in um) of answers against the reference's
    re-scores of their poses."""
    def gap(a, b):
        return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return gap(fit, r_fit), gap(rmse, r_rmse) * 1e6


def refine_work(ref, tris: int, n: int, out_w: int, out_h: int, valid, covered, res,
                nearest_points: int, iters: int) -> dict:
    """{family: (bytes, operations)} of one refine of ``n`` hypotheses as the
    reference ran it (its renders' covered pixels, its lift's valid rows,
    its latch's iterations)."""
    slots = valid.shape[1]
    nv = valid.sum(1)
    kept = int(nv.sum())
    w = {"rasterize": bounds.raster(n, tris, int(covered.sum()), out_w, out_h),
         "window_lift": bounds.lift(n, out_w, out_h, slots, kept)}
    pi, mi = int((res.active * nv).sum()), int((res.moves * nv).sum())
    if nearest_points:
        w["icp_iterate"] = bounds.iterate(n, slots, iters + 1, 8, bounds.INDEXED_FRONT_OPS, pi,
                                          int(res.active.sum()), mi)
        w["nn_kdtree"] = bounds.nearest(n * slots, nearest_points, iters + 1)
    else:
        w["icp_iterate"] = bounds.iterate(n, slots, 1, 0, bounds.PROJECTIVE_FRONT_OPS, pi,
                                          int(res.active.sum()), mi)
    return w


def add_work(total: dict, w: dict):
    for k, (b, o) in w.items():
        tb, to = total.get(k, (0, 0))
        total[k] = (tb + b, to + o)


def call_work(tr, ref, todo: dict, iters: int) -> dict:
    """The summed work of render calls ``todo`` ({call: (frame, hypotheses)}),
    each refined by the reference in its logged ROI."""
    roi_of = rois(tr, ref)
    scene = scenes(ref, tr.frames)
    total = {}
    for i in sorted(todo):
        f, init = todo[i]
        roi = roi_of[i]
        sc = scene(f)
        _, res, valid, covered = ref.refine(sc, init, roi, iters)
        out_w, out_h = (roi[2], roi[3]) if roi[2] > 0 else (ref.rw, ref.rh)
        pts = sc.points.shape[0] if hasattr(sc, "points") else 0
        add_work(total, refine_work(ref, ref.tris.shape[0], len(init), out_w, out_h, valid,
                                    covered, res, pts, iters))
    return total
