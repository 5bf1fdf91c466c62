"""Mix kind "refine": each request hands a frame to set_scene_depth
(``scene`` "per_request", cycling through the mix's frames) or refines
against the scene set once in set-up (``scene`` "once"), refines one batch
of hypotheses and copies the poses, fitness and rmse to the host.

Mix keys: hypotheses, frames, hypothesis_batches (a multiple of frames),
scene, z_mm, xy_mm (the truths), rot_deg, trans_mm (the hypotheses about
their frame's truth), warmup_requests, profile_requests, check_requests,
check_hypotheses (the sample: that many answers of that many requests).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

from core import check, inputs, traffic
from core.trace import Spans
from reference.geometry import corner_gap, tf32


class Request(NamedTuple):
    """One refine request of the window: its call in ``calls``, its frame and
    hypothesis batch, its latency and what it returned on the host."""
    call: int
    frame: int
    batch: int
    latency_s: float
    poses: np.ndarray
    fitness: np.ndarray
    rmse: np.ndarray


class Traffic(traffic.Traffic):
    def _inputs(self, rng):
        m = self.mix
        n_frames, n_batches = int(m["frames"]), int(m["hypothesis_batches"])
        if n_batches % n_frames:
            raise ValueError("hypothesis_batches must be a multiple of frames")
        self.truths = inputs.truth_poses(rng, n_frames, m["z_mm"], m["xy_mm"])
        self.frames = self.render(self.truths)
        self.batches = np.stack([
            inputs.perturb(rng, self.truths[b % n_frames], self.hypotheses, m["rot_deg"],
                           m["trans_mm"]) for b in range(n_batches)])
        self.per_request = m["scene"] == "per_request"
        self.crit = self.ptt.ICPConvergenceCriteria(**self.cfg["criteria"])
        self.iters = int(self.cfg["criteria"]["max_iteration"])
        self.n = 0
        if not self.per_request:
            self._scene(0)

    def _scene(self, f: int):
        self.calls.append(("scene", f))
        self.refiner.set_scene_depth(self.frames[f])

    def request(self, spans: Spans) -> Request:
        i = self.n
        self.n += 1
        f, b = i % len(self.frames), i % len(self.batches)
        t0 = time.perf_counter()
        if self.per_request:
            with spans.span("scene.set"):
                self._scene(f)
        with spans.span("refine.call"):
            poses, res = self.refiner.refine(self.batches[b], self.crit)
        self.calls.append(("refine", b))
        with spans.span("readback"):
            out = (poses.cpu().numpy(), res.fitness.cpu().numpy(), res.inlier_rmse.cpu().numpy())
        return Request(len(self.calls) - 1, f if self.per_request else 0, b,
                       time.perf_counter() - t0, *out)

    def warmup(self):
        for _ in range(int(self.mix["warmup_requests"])):
            self.request(Spans())

    def stretch(self, spans: Spans) -> int:
        for _ in range(int(self.mix["profile_requests"])):
            self.request(spans)
        return int(self.mix["profile_requests"])

    def window(self, seconds: float, spans: Spans):
        """(requests, window seconds, poses completed)."""
        reqs = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            reqs.append(self.request(spans))
        return reqs, time.perf_counter() - t0, len(reqs) * self.hypotheses

    def answers(self, reqs):
        return [r.latency_s for r in reqs], [(r.poses, r.fitness, r.rmse) for r in reqs]

    def sample(self, reqs, seed: int) -> list:
        """[(request index, hypothesis indices)] of the answers checked."""
        rng = traffic._rng(seed, 2)
        m = self.mix
        pick = np.sort(rng.choice(len(reqs), size=min(int(m["check_requests"]), len(reqs)),
                                  replace=False))
        return [(int(i), np.sort(rng.choice(self.hypotheses, int(m["check_hypotheses"]),
                                            replace=False))) for i in pick]

    def gaps(self, ref, reqs, sample) -> dict:
        roi_of = check.rois(self, ref)
        scene = check.scenes(ref, self.frames)
        half = check.half_extent(self.vertices)
        out = {"pose_gap_mm": [], "fitness_gap": [], "rmse_gap_um": []}
        for i, idx in sample:
            r = reqs[i]
            init = self.batches[r.batch][idx]
            roi = roi_of[r.call]
            refined = ref.refine(scene(r.frame), init, roi, self.iters)[0].cpu().numpy()
            out["pose_gap_mm"].append(corner_gap(r.poses[idx], refined, half))
            fit, rmse, _, _ = ref.judge(scene(r.frame), init, r.poses[idx], roi)
            f_gap, r_gap = check.rescore_gaps(r.fitness[idx], r.rmse[idx], fit.cpu().numpy(),
                                              rmse.cpu().numpy())
            out["fitness_gap"].append(f_gap)
            out["rmse_gap_um"].append(r_gap)
        return out

    def control(self, ref, reqs, sample) -> list:
        """The requests with the sampled answers computed by the reference in
        TF32."""
        roi_of = check.rois(self, ref)
        scene = check.scenes(ref, self.frames)
        out = list(reqs)
        for i, idx in sample:
            r = reqs[i]
            with tf32():
                refined, res, _, _ = ref.refine(scene(r.frame), self.batches[r.batch][idx],
                                                roi_of[r.call], self.iters)
            poses, fit, rmse = r.poses.copy(), r.fitness.copy(), r.rmse.copy()
            poses[idx] = refined.cpu().numpy()
            fit[idx], rmse[idx] = res.fitness.cpu().numpy(), res.rmse.cpu().numpy()
            out[i] = r._replace(poses=poses, fitness=fit, rmse=rmse)
        return out

    def work(self, ref, calls) -> dict:
        todo, frame = {}, 0
        for i, (what, x) in enumerate(self.calls):
            if what == "scene":
                frame = x
            elif i in calls:
                todo[i] = (frame, self.batches[x])
        return check.call_work(self, ref, todo, self.iters)
