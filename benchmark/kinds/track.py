"""Mix kind "track": one TrackingSession fed through step_async as fast as
it returns, flushed at the end; a frame's result is the TrackStep the next
step_async (or the flush) returns.

Mix keys: hypotheses, frames (a closed trajectory's period), z_mm, xy_mm,
step_rad, step_mm (the trajectory), process_noise, detector_error (the
session's start about frame 0's truth), warmup_frames, profile_requests,
check_frames (the sample), check_start_frames (the session's first
frames, judged apart as ``start_gap_mm``). A frame's ICP runs the
reference's ``track.ITERATIONS``.

The check replays the session's filter along the program's own fused
measurements, so that it samples each frame's hypotheses as the session
did; the stage this follows from the program's state (its ranking and
fusion) is judged by itself at every sampled frame, by the reference's own
ranking of the re-scored answers, its covariance and its fusion, and the
start by itself: the session's first frames, whose hypotheses the
reference samples about the start pose alone. A session that lost its
object has hypotheses out of every point's reach, which the program and
the reference then both leave where they are; only its start shows it.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from core import check, inputs, traffic
from core.trace import Spans
from reference import track as ref_track
from reference.geometry import corner_gap, tf32


class Traffic(traffic.Traffic):
    def _inputs(self, rng):
        m = self.mix
        self.truths = inputs.trajectory(rng, int(m["frames"]), m["z_mm"], m["xy_mm"],
                                        m["step_rad"], m["step_mm"])
        self.frames = self.render(self.truths)
        err = m["detector_error"]
        self.start = inputs.perturb(rng, self.truths[0], 1, err["rot_deg"], err["trans_mm"])[0]
        self.noise = (float(np.radians(m["process_noise"]["rot_deg"])),
                      m["process_noise"]["trans_mm"] / 1000.0)
        self.session_seed = int(rng.integers(2 ** 31))
        self.ops = []     # the session's ("step", k) and ("flush", None), in order
        self.call = {}    # session frame -> its track call in ``calls``
        self.steps = {}   # session frame -> TrackStep
        self.latency = {}
        self._handoff = {}
        self.k = 0
        self.session = None

    def _session(self, seed: int):
        return self.ptt.TrackingSession(self.refiner, self.start, n_hypotheses=self.hypotheses,
                                        process_noise=self.noise, seed=seed)

    def warmup(self):
        s = self._session(self.session_seed + 1)
        for k in range(int(self.mix["warmup_frames"])):
            self.calls.append(("track", k % len(self.frames)))
            s.step_async(self.frames[k % len(self.frames)])
        s.flush()
        self.session = self._session(self.session_seed)

    def release(self):
        self.refiner = self.session = None

    def _done(self, step, now: float):
        if step is not None:
            j = len(self.steps)
            self.steps[j] = step
            self.latency[j] = now - self._handoff[j]

    def request(self, spans: Spans):
        k = self.k
        self.k += 1
        f = k % len(self.frames)
        self.calls.append(("track", f))
        self.call[k] = len(self.calls) - 1
        self.ops.append(("step", k))
        self._handoff[k] = time.perf_counter()
        with spans.span("track.step"):
            prev = self.session.step_async(self.frames[f])
        self._done(prev, time.perf_counter())

    def flush(self):
        self.ops.append(("flush", None))
        self._done(self.session.flush(), time.perf_counter())

    def stretch(self, spans: Spans) -> int:
        n = int(self.mix["profile_requests"])
        for _ in range(n):
            self.request(spans)
        self.flush()
        return n

    def window(self, seconds: float, spans: Spans):
        """({session frame: TrackStep} of the window, window seconds, poses
        completed)."""
        first = self.k
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.request(spans)
        self.flush()
        done = {j: self.steps[j] for j in range(first, self.k)}
        return done, time.perf_counter() - t0, len(done) * self.hypotheses

    def answers(self, done):
        return ([self.latency[j] for j in done],
                [(s.refined, s.results.fitness, s.results.inlier_rmse, s.pose)
                 for s in done.values()])

    def sample(self, done, seed: int) -> set:
        rng = traffic._rng(seed, 3)
        size = min(int(self.mix["check_frames"]), len(done))
        return set(int(j) for j in rng.choice(list(done), size=size, replace=False))

    def _replay(self):
        """The session's filter over its own steps and flushes, as the
        pipelined session runs it: frame k's hypotheses are sampled from the
        belief after the frames fused so far, predicted for the frame in
        flight and for k; then the frame in flight is fused. Yields (frame j,
        its hypotheses, the live filter) where j is fused; the caller
        predicts and updates it."""
        filt = ref_track.Filter(self.start, self.noise)
        rng = np.random.default_rng(self.session_seed)
        hyps, inflight = {}, None
        for op, k in self.ops:
            if op == "step":
                tmp = filt.copy()
                if inflight is not None:
                    tmp.predict()
                tmp.predict()
                hyps[k] = tmp.hypotheses(self.hypotheses, rng)
                if inflight is not None:
                    yield inflight, hyps[inflight], filt
                inflight = k
            elif inflight is not None:
                yield inflight, hyps[inflight], filt
                inflight = None

    @staticmethod
    def _fuse(filt, st):
        """Fuse a frame's answer as the session did: its best hypothesis by
        its own (fitness, -rmse), with its covariance and fitness."""
        fit = np.asarray(st.results.fitness, np.float64)
        best = int(ref_track.rank(fit, np.asarray(st.results.inlier_rmse, np.float64))[0])
        filt.predict()
        filt.update(st.refined[best], st.covariance, fit[best])

    def _frame(self, j: int):
        return self.frames[self.calls[self.call[j]][1]]

    def gaps(self, ref, done, sample) -> dict:
        steps = {**self.steps, **done}
        roi_of = check.rois(self, ref)
        half = check.half_extent(self.vertices)
        start = range(int(self.mix["check_start_frames"]))
        out = {k: [] for k in ("pose_gap_mm", "start_gap_mm", "fitness_gap", "rmse_gap_um",
                               "cov_gap_rel", "fused_gap_um")}
        for j, hyps, filt in self._replay():
            st = steps[j]
            if j in sample or j in start:
                scene = ref.scene(self._frame(j))
                roi = roi_of[self.call[j]]
                refined = ref.refine(scene, hyps, roi, ref_track.ITERATIONS)[0].cpu().numpy()
                gap = corner_gap(st.refined, refined, half)
                if j in start:
                    out["start_gap_mm"].append(gap)
            if j in sample:
                out["pose_gap_mm"].append(gap)
                r_fit, r_rmse, moved, valid = ref.judge(scene, hyps, st.refined, roi)
                r_fit = r_fit.cpu().numpy().astype(np.float64)
                r_rmse = r_rmse.cpu().numpy().astype(np.float64)
                f_gap, r_gap = check.rescore_gaps(st.results.fitness, st.results.inlier_rmse,
                                                  r_fit, r_rmse)
                out["fitness_gap"].append(f_gap)
                out["rmse_gap_um"].append(r_gap)
                # the frame's measurement and fusion as the reference makes
                # them from the answers: its ranking, covariance and filter
                best = int(ref_track.rank(r_fit, r_rmse)[0])
                cov = ref.covariance(scene, moved[best:best + 1], valid[best:best + 1])[0]
                cov = cov.cpu().numpy().astype(np.float64) + ref_track.ensemble_cov(
                    st.refined, r_fit, r_rmse, best)
                out["cov_gap_rel"].append(np.abs(cov - st.covariance).max() / np.abs(cov).max())
                prior = filt.copy()
                prior.predict()
                prior.update(st.refined[best], cov, r_fit[best])
                out["fused_gap_um"].append(1000.0 * corner_gap(prior.pose_mm, st.pose, half))
            self._fuse(filt, st)
        return out

    def control(self, ref, done, sample) -> dict:
        """Every frame of the session computed by the reference in TF32 and
        its filter: refined, its covariance computed, ranked and fused."""
        roi_of = check.rois(self, ref)
        steps = {}
        for j, hyps, filt in self._replay():
            scene = ref.scene(self._frame(j))
            with tf32():
                refined, res, valid, _ = ref.refine(scene, hyps, roi_of[self.call[j]],
                                                    ref_track.ITERATIONS)
                cov = ref.covariance(scene, res.cloud, valid)
            refined = refined.cpu().numpy()
            fit = res.fitness.cpu().numpy()
            rmse = res.rmse.cpu().numpy()
            best = int(ref_track.rank(fit, rmse)[0])
            total = cov[best].cpu().numpy().astype(np.float64) + ref_track.ensemble_cov(
                refined, fit, rmse, best)
            filt.predict()
            filt.update(refined[best], total, fit[best])
            steps[j] = SimpleNamespace(refined=refined, covariance=total, pose=filt.pose_mm,
                                       results=SimpleNamespace(fitness=fit, inlier_rmse=rmse))
        return steps

    def work(self, ref, calls) -> dict:
        todo = {}
        for j, hyps, filt in self._replay():
            if self.call[j] in calls:
                todo[self.call[j]] = (self.calls[self.call[j]][1], hyps)
            self._fuse(filt, self.steps[j])
        return check.call_work(self, ref, todo, ref_track.ITERATIONS)
