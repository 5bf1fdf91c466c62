"""Per-frame tracking of one object (PyTorch port of
``pose_refine_tpu/tracking.py``).

``TrackingSession`` wires a :class:`~pose_refine_tpu_torch.pipeline.PoseRefiner`
to a :class:`~pose_refine_tpu_torch.utils.fusion.PoseTracker`:

    predict (motion model)
      -> sample hypotheses from the filter's own belief
      -> one track() per frame (scene build + refinement + measurement
         covariance, with_covariance=True)
      -> rank hypotheses by (fitness, -rmse)
      -> multi-gated fusion (chi-square innovation gate + independent
         fitness quality gate [+ optional hard innovation cap])

The reference stops at per-frame refinement (its test.cpp:29-44);
the uncertainty, fusion and gating are beyond parity. All loop bookkeeping is
host numpy: the device work of a frame is its track() plus one readback of
the (N, 71) packed buffer.

``MultiObjectSession`` tracks several objects of a ``MultiModelRefiner`` in
one track() per frame; both sessions run one loop (``_SessionLoop``), a
TrackingSession being that loop with one object. A session saves to
``.npz`` between frames with ``utils.serialization.save`` and resumes
bit for bit with ``load(path, refiner=...)`` (its ``state_dict`` /
``from_state``).
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional

import numpy as np

from pose_refine_tpu_torch import icp
from pose_refine_tpu_torch.pipeline import MultiModelRefiner, PendingResult, PoseRefiner
from pose_refine_tpu_torch.utils.fusion import CHI2_6_99, PoseTracker, se3_log
from pose_refine_tpu_torch.utils.profiling import span

_MOTIONS = ("random_walk", "constant_velocity")


def _set_loop_config(self, motion, n_hypotheses, hypothesis_scale,
                     min_quality, gate_chi2, max_innovation,
                     from_state: bool = False):
    """Validate and assign the per-frame loop config, for __init__ and
    from_state alike: a corrupted state errors with the invariants __init__
    enforces."""
    motion = str(motion)
    if motion not in _MOTIONS:
        raise ValueError(
            f"state has unknown motion {motion!r}" if from_state
            else f"motion must be one of {_MOTIONS}, got {motion!r}")
    if int(n_hypotheses) < 1:
        raise ValueError(
            f"{'state ' if from_state else ''}n_hypotheses must be >= 1, "
            f"got {n_hypotheses}")
    if not float(hypothesis_scale) > 0.0:
        raise ValueError(
            f"{'state ' if from_state else ''}hypothesis_scale must be "
            f"> 0, got {hypothesis_scale}")
    self.motion = motion
    self.n_hypotheses = int(n_hypotheses)
    self.hypothesis_scale = float(hypothesis_scale)
    self.min_quality = None if min_quality is None else float(min_quality)
    self.gate_chi2 = None if gate_chi2 is None else float(gate_chi2)
    self.max_innovation = (
        None if max_innovation is None
        else tuple(float(v) for v in max_innovation))


class TrackStep(NamedTuple):
    """Everything one ``TrackingSession.step`` produced (host numpy).

    pose:       (4, 4) fused estimate after this frame (the prediction if
                the measurement was rejected).
    accepted:   True if the best refinement passed every gate and was fused.
    best:       index of the winning hypothesis (into refined/results rows).
    fitness:    the winner's inlier fraction (the quality-gate signal).
    refined:    (N, 4, 4) all refined hypotheses.
    results:    the batch RegistrationResult (numpy fields).
    covariance: (6, 6) the measurement covariance the filter fused [rad, m]
                twist: the winner's render-calibrated Laplace covariance
                plus the hypothesis-ensemble scatter (see _ensemble_cov).
    """

    pose: np.ndarray
    accepted: bool
    best: int
    fitness: float
    refined: np.ndarray
    results: icp.RegistrationResult
    covariance: np.ndarray


def _advance_tracker(tracker: PoseTracker, motion: str, motion_mm) -> None:
    """One motion-model time update: an explicit odometry increment wins,
    else the session's model. The one advance of step, step_async, the fuse
    and the hypothesis extrapolation: they must extrapolate identically."""
    if motion_mm is not None:
        tracker.predict(motion_mm)
    elif motion == "constant_velocity":
        tracker.predict_cv()
    else:
        tracker.predict()


def _unpack_outputs(buf: np.ndarray, has_np: bool):
    """Host-side inverse of pipeline._pack_track_outputs' (N, 71) buffer
    ([refined 16 | transformation 16 | fitness | rmse | n_points | cov 36]):
    (refined, results, cov float64). Point counts <= max_points are exact
    in float32, so the int32 round trip is lossless."""
    n = buf.shape[0]
    results_np = icp.RegistrationResult(
        transformation=buf[:, 16:32].reshape(n, 4, 4),
        fitness=buf[:, 32],
        inlier_rmse=buf[:, 33],
        n_points=buf[:, 34].astype(np.int32) if has_np else None,
    )
    cov_np = buf[:, 35:71].reshape(n, 6, 6).astype(np.float64)
    return buf[:, :16].reshape(n, 4, 4), results_np, cov_np


def _pull_packed(refiner, packed):
    """Read one frame's packed buffer to the host (a PendingResult waits on
    its event; a device tensor is copied) and unpack it, running the
    refiner's saturation guard on the buffer's own n_points column."""
    if isinstance(packed, PendingResult):
        packed = packed.wait()[0]
    refined_np, results_np, cov_np = _unpack_outputs(packed.cpu().numpy(), True)
    refiner._warn_if_saturated_host(results_np.n_points)
    return refined_np, results_np, cov_np


# hypotheses below this fitness diverged (or track another basin) and must
# not pollute the ensemble scatter (JAX tracking.py:142-155)
_ENSEMBLE_MIN_FITNESS = 0.5
# ... and rows that did not reach the winner's basin floor measure
# convergence distance, not measurement repeatability
_ENSEMBLE_FITNESS_TOL = 0.05
_ENSEMBLE_RMSE_TOL = 0.25  # relative, plus the depth-quantization floor


def _ensemble_cov(refined_np, fitness_np, best: int, rmse_np=None) -> np.ndarray:
    """Hypothesis-scatter measurement covariance term (6x6, [rad, m] twist):
    the scatter of the converged hypotheses about the winner, which sees
    the per-frame basin wander of weakly constrained directions that no
    per-fit statistic sees (JAX tracking.py:158-200)."""
    ens = np.zeros((6, 6))
    k = 0
    try:
        inv_best = np.linalg.inv(PoseTracker._to_m(refined_np[best]))
    except np.linalg.LinAlgError:
        return ens
    min_fit = max(_ENSEMBLE_MIN_FITNESS,
                  float(fitness_np[best]) - _ENSEMBLE_FITNESS_TOL)
    max_rmse = None
    if rmse_np is not None:
        br = float(rmse_np[best])
        max_rmse = br + max(_ENSEMBLE_RMSE_TOL * br, icp.DEPTH_QUANT_SIGMA_M)
    for i in range(len(refined_np)):
        if i == best or not (fitness_np[i] >= min_fit):
            continue
        if max_rmse is not None and not (rmse_np[i] <= max_rmse):
            continue
        try:
            e = se3_log(PoseTracker._to_m(refined_np[i]) @ inv_best)
        except ValueError:
            continue  # ~180 deg apart: a wrong-basin row, not scatter
        if not np.isfinite(e).all():
            continue
        ens += np.outer(e, e)
        k += 1
    return ens / k if k else ens


def _fuse_ranked_best(tracker: PoseTracker, refined_np: np.ndarray,
                      results_np: icp.RegistrationResult, cov_np: np.ndarray,
                      gate_chi2, max_innovation, min_quality) -> TrackStep:
    """Rank one object's refined hypotheses by (fitness, -rmse) and fuse the
    winner through the tracker's gates. All inputs are host numpy."""
    best = int(PoseRefiner.rank(results_np)[0])
    fitness = float(results_np.fitness[best])
    cov = cov_np[best] + _ensemble_cov(
        refined_np, results_np.fitness, best, results_np.inlier_rmse)
    accepted = tracker.update(
        refined_np[best],
        cov,
        gate_chi2=gate_chi2,
        max_innovation=max_innovation,
        quality=fitness if min_quality is not None else None,
        min_quality=min_quality,
    )
    return TrackStep(
        pose=tracker.pose_mm,
        accepted=accepted,
        best=best,
        fitness=fitness,
        refined=refined_np,
        results=results_np,
        covariance=cov,
    )


class _SessionLoop:
    """The per-frame loop both sessions run: every object's belief-sampled
    hypotheses go into one track() per frame (per-pose model ids route each
    to its object's mesh on a MultiModelRefiner), and each object's filter
    then ranks and fuses its own rows. Every call is atomic: on a failure
    the filters, the hypothesis rng stream and the in-flight frame roll
    back. TrackingSession is this loop with one object."""

    def __init__(self, refiner, trackers, motion, n_hypotheses, hypothesis_scale,
                 min_quality, gate_chi2, max_innovation, seed):
        _set_loop_config(self, motion, n_hypotheses, hypothesis_scale,
                         min_quality, gate_chi2, max_innovation)
        self.refiner = refiner
        self.trackers = trackers
        self._rng = np.random.default_rng(seed)
        self.n_frames = 0
        self._inflight = None  # step_async's pending (PendingResult, motions)

    def _advance(self, tracker: PoseTracker, motion_mm):
        _advance_tracker(tracker, self.motion, motion_mm)

    def _sample(self, tracker: PoseTracker) -> np.ndarray:
        return tracker.hypotheses(self.n_hypotheses, scale=self.hypothesis_scale, seed=self._rng)

    def _track(self, frame_depth, hyp_blocks, model_ids, async_: bool):
        """One track() over every object's hypothesis block, with the (K*n,
        71) session buffer as output (a PendingResult when async_).
        model_ids: one per object, or None for a single-model refiner."""
        args = (np.concatenate(hyp_blocks),)
        if model_ids is not None:
            args = (np.repeat(np.asarray(model_ids, np.int32), self.n_hypotheses),) + args
        if async_:
            return self.refiner.track_packed_async(frame_depth, *args)
        return self.refiner.track(frame_depth, *args, with_covariance=True, _pack_outputs=True)

    def _fuse_all(self, packed) -> list:
        """Read the frame's buffer, slice it per object and gate/fuse each
        tracker; one TrackStep per object."""
        with span("prt.step.fuse"):
            refined_np, results_np, cov_np = _pull_packed(self.refiner, packed)
            n = self.n_hypotheses
            steps = []
            for i, tracker in enumerate(self.trackers):
                rows = slice(i * n, (i + 1) * n)
                steps.append(_fuse_ranked_best(
                    tracker, refined_np[rows],
                    icp.RegistrationResult(*(None if f is None else f[rows] for f in results_np)),
                    cov_np[rows], self.gate_chi2, self.max_innovation, self.min_quality))
            self.n_frames += 1
            return steps

    def _restore(self, rng_state, tracker_states, inflight):
        if rng_state is not None:
            self._rng.bit_generator.state = rng_state
        self.trackers = [PoseTracker.from_state(s) for s in tracker_states]
        self._inflight = inflight

    def _step(self, frame_depth, motions, model_ids) -> list:
        if self._inflight is not None:
            raise RuntimeError(
                "a step_async frame is still in flight - call flush() "
                "before synchronous step()"
            )
        # track() validates the frame only after the filters predicted and
        # the rng stream moved: snapshot both and roll back on any failure,
        # so a corrected retry replays the exact same hypothesis stream
        with span("prt.step"):
            rng_state = self._rng.bit_generator.state
            tracker_states = [t.state_dict() for t in self.trackers]
            try:
                with span("prt.step.sample"):
                    hyp_blocks = []
                    for tracker, motion_mm in zip(self.trackers, motions):
                        self._advance(tracker, motion_mm)
                        hyp_blocks.append(self._sample(tracker))
                return self._fuse_all(self._track(frame_depth, hyp_blocks, model_ids, async_=False))
            except BaseException:
                self._restore(rng_state, tracker_states, None)
                raise

    # -- pipelined (double-buffered) stepping ------------------------------
    # step() waits for each frame before it enqueues the next. step_async()
    # enqueues frame k first and only then waits for frame k-1, whose
    # readback was queued right behind its own work: the card computes
    # frame k while the host fuses frame k-1 and prepares frame k+1. The
    # price is one frame of latency, and hypothesis centers extrapolated
    # from a belief that lags by the in-flight frame; the filters themselves
    # predict and update in order at fuse time.

    def _fuse_inflight(self) -> Optional[list]:
        """Wait for and fuse the in-flight frame (None if nothing is
        pending), predicting for that frame immediately before its update,
        so the estimate sequence is that of unpipelined stepping with the
        same measurements."""
        if self._inflight is None:
            return None
        packed, motions = self._inflight
        self._inflight = None
        for tracker, motion_mm in zip(self.trackers, motions):
            self._advance(tracker, motion_mm)
        return self._fuse_all(packed)

    def _step_async(self, frame_depth, motions, model_ids) -> Optional[list]:
        # the enqueue can reject the frame after sampling consumed the rng
        # stream: roll the stream back (the filters are untouched: the
        # hypotheses extrapolate throwaway copies across the in-flight
        # frame plus this one)
        with span("prt.step"):
            rng_state = self._rng.bit_generator.state
            try:
                with span("prt.step.sample"):
                    hyp_blocks = []
                    for i, (tracker, motion_mm) in enumerate(zip(self.trackers, motions)):
                        tmp = PoseTracker.from_state(tracker.state_dict())
                        if self._inflight is not None:
                            self._advance(tmp, self._inflight[1][i])
                        self._advance(tmp, motion_mm)
                        hyp_blocks.append(self._sample(tmp))
                packed = self._track(frame_depth, hyp_blocks, model_ids, async_=True)
            except BaseException:
                self._rng.bit_generator.state = rng_state
                raise
            # fusing the previous frame can fail too (e.g. LinAlgError in a
            # filter update): restore rng, filters and the pending frame, and
            # drop this frame's result; a corrected retry re-enqueues it with
            # the same hypotheses
            prev_inflight = self._inflight
            tracker_states = [t.state_dict() for t in self.trackers]
            try:
                prev = self._fuse_inflight()
            except BaseException:
                self._restore(rng_state, tracker_states, prev_inflight)
                raise
            self._inflight = (packed, motions)
            return prev

    def _flush(self) -> Optional[list]:
        with span("prt.step"):
            prev_inflight = self._inflight
            tracker_states = [t.state_dict() for t in self.trackers]
            try:
                return self._fuse_inflight()
            except BaseException:
                self._restore(None, tracker_states, prev_inflight)
                raise

    # -- checkpoint/resume: the refiner is rebuilt by the caller; the
    # session state is the filters, the hypothesis rng stream and the loop
    # config (utils.serialization stores it in the JAX package's .npz)

    def _loop_state(self) -> dict:
        if self._inflight is not None:
            raise RuntimeError(
                "a step_async frame is still in flight - call flush() "
                "before state_dict()"
            )
        return {
            "rng_state_json": json.dumps(self._rng.bit_generator.state),
            "motion": self.motion,
            "n_hypotheses": self.n_hypotheses,
            "hypothesis_scale": self.hypothesis_scale,
            "min_quality": self.min_quality,
            "gate_chi2": self.gate_chi2,
            "max_innovation": self.max_innovation,
            "n_frames": self.n_frames,
        }

    @classmethod
    def _resume(cls, refiner, trackers, state):
        """A session of ``cls`` from _loop_state's keys of ``state``."""
        self = cls.__new__(cls)
        self.refiner = refiner
        self.trackers = trackers
        _set_loop_config(
            self, state["motion"], state["n_hypotheses"],
            state["hypothesis_scale"], state["min_quality"],
            state["gate_chi2"], state["max_innovation"], from_state=True)
        self._rng = np.random.default_rng(0)
        self._rng.bit_generator.state = json.loads(str(state["rng_state_json"]))
        self.n_frames = int(state["n_frames"])
        self._inflight = None
        return self


class TrackingSession(_SessionLoop):
    """Per-frame tracking loop around one object: refiner + fusion filter.

    Args:
      refiner: a configured PoseRefiner; its scene kind decides the
        per-frame scene build ('projective' or the device-built NN scene;
        see PoseRefiner.track). With a MultiModelRefiner every step names
        the session's model (``model_id``).
      init_pose: (4, 4) detector pose for frame 0, translation in mm.
      init_cov / process_noise: forwarded to PoseTracker (defaults: diffuse
        5 deg / 20 mm prior; 1 deg / 5 mm per-frame random walk). Make
        init_cov as wide as the detector's actual error: an init pose
        several sigma outside the prior makes the innovation gate reject
        the (correct) first refinement.
      motion: 'random_walk' (default) or 'constant_velocity' (fast smooth
        motion). A per-step ``motion_mm`` (odometry) overrides either model
        for that frame.
      n_hypotheses: refined hypotheses per frame, sampled from the current
        belief (row 0 is always the mean pose).
      hypothesis_scale: widens (>1) / narrows (<1) the belief sampling.
      min_quality: fitness quality gate (None disables).
      gate_chi2: chi-square innovation gate (None disables); max_innovation:
        optional (rot_rad, trans_m) hard cap - both forwarded to
        PoseTracker.update.
      seed: hypothesis-sampling rng seed (resume restores the exact stream).

    Example:

        session = TrackingSession(refiner, detector_pose)
        for depth in frames:
            step = session.step(depth)
            use(step.pose)          # fused estimate, gated against slips
    """

    def __init__(
        self,
        refiner: PoseRefiner,
        init_pose,
        *,
        init_cov=None,
        process_noise=None,
        motion: str = "random_walk",
        n_hypotheses: int = 4,
        hypothesis_scale: float = 1.0,
        min_quality: Optional[float] = 0.6,
        gate_chi2: Optional[float] = CHI2_6_99,
        max_innovation=None,
        seed=0,
    ):
        super().__init__(refiner, [PoseTracker(init_pose, init_cov=init_cov,
                                               process_noise=process_noise)],
                         motion, n_hypotheses, hypothesis_scale, min_quality, gate_chi2,
                         max_innovation, seed)

    @property
    def tracker(self) -> PoseTracker:
        return self.trackers[0]

    @property
    def pose(self) -> np.ndarray:
        """Current fused (4, 4) estimate, translation in mm."""
        return self.tracker.pose_mm

    @property
    def n_rejected(self) -> int:
        """Measurements rejected by any gate since the session started."""
        return self.tracker.n_rejected

    def _model_ids(self, model_id, call: str):
        """[model_id] with a MultiModelRefiner, which needs it; None with a
        plain refiner, which refuses one (JAX tracking.py:331-339)."""
        if isinstance(self.refiner, MultiModelRefiner):
            if model_id is None:
                raise ValueError(f"refiner is a MultiModelRefiner: {call}() needs model_id")
            return [int(model_id)]
        if model_id is not None:
            raise ValueError("model_id is only valid with MultiModelRefiner")
        return None

    def step(self, frame_depth, motion_mm=None, model_id=None) -> TrackStep:
        """Consume one depth frame; returns a :class:`TrackStep`.

        motion_mm: optional (4, 4) LEFT-applied camera-frame motion
        increment (odometry, external prediction) used instead of the
        session's motion model for this frame. model_id: required with a
        MultiModelRefiner, refused otherwise. A failed call leaves the
        session as it was (filter, hypothesis stream, frame count)."""
        return self._step(frame_depth, [motion_mm], self._model_ids(model_id, "step"))[0]

    def step_async(self, frame_depth, motion_mm=None,
                   model_id=None) -> Optional[TrackStep]:
        """Pipelined tracking: enqueue this frame, then wait for and fuse
        the PREVIOUS frame and return its :class:`TrackStep` (None on the
        first call - results lag one frame). Call :meth:`flush` after the
        last frame to collect the final step.

            session = TrackingSession(refiner, detector_pose)
            for depth in frames:
                step = session.step_async(depth)
                if step is not None:
                    use(step.pose)
            use(session.flush().pose)
        """
        steps = self._step_async(frame_depth, [motion_mm],
                                 self._model_ids(model_id, "step_async"))
        return None if steps is None else steps[0]

    def flush(self) -> Optional[TrackStep]:
        """Wait for and fuse the last step_async frame (None if nothing is
        in flight); atomic like step(): on a failure the tracker rolls back
        and the frame stays in flight for a retry."""
        steps = self._flush()
        return None if steps is None else steps[0]

    def state_dict(self):
        """Exact loop state as plain values - ``from_state(refiner, state)``
        resumes bit-exactly."""
        return {"tracker": self.tracker.state_dict(), **self._loop_state()}

    @classmethod
    def from_state(cls, refiner: PoseRefiner, state) -> "TrackingSession":
        """Inverse of :meth:`state_dict` given a freshly configured refiner."""
        return cls._resume(refiner, [PoseTracker.from_state(state["tracker"])], state)


class MultiObjectSession(_SessionLoop):
    """Track several objects in one sensor stream with one track() per
    frame (JAX tracking.py:555-847).

    Each frame, every object's belief-sampled hypotheses go into a single
    MultiModelRefiner.track batch (per-pose model ids route each hypothesis
    to its object's mesh), refined together with their measurement
    covariances; each object's filter then ranks and fuses its own rows. K
    objects cost one batch per frame, not K.

    Args:
      refiner: a MultiModelRefiner over all tracked meshes.
      objects: list of (model_id, init_pose_mm) pairs, one per tracked
        object instance (several instances may share a model_id).
      remaining kwargs: shared loop config, exactly TrackingSession's.

    Example:

        refiner = MultiModelRefiner([mesh_a, mesh_b], K=K, device="cuda")
        session = MultiObjectSession(refiner, [(0, pose_a), (1, pose_b)])
        for depth in frames:
            steps = session.step(depth)      # one batch for both objects
            use(steps[0].pose, steps[1].pose)
    """

    def __init__(
        self,
        refiner: MultiModelRefiner,
        objects,
        *,
        init_cov=None,
        process_noise=None,
        motion: str = "random_walk",
        n_hypotheses: int = 4,
        hypothesis_scale: float = 1.0,
        min_quality: Optional[float] = 0.6,
        gate_chi2: Optional[float] = CHI2_6_99,
        max_innovation=None,
        seed=0,
    ):
        if not isinstance(refiner, MultiModelRefiner):
            raise ValueError(
                "MultiObjectSession needs a MultiModelRefiner (a single-model PoseRefiner "
                "tracks one object - use TrackingSession)")
        objects = list(objects)
        if not objects:
            raise ValueError("MultiObjectSession needs at least one object")
        self.model_ids = [_check_object_model(refiner, mid) for mid, _pose in objects]
        super().__init__(refiner, [PoseTracker(pose, init_cov=init_cov,
                                               process_noise=process_noise)
                                   for _mid, pose in objects],
                         motion, n_hypotheses, hypothesis_scale, min_quality, gate_chi2,
                         max_innovation, seed)

    @property
    def poses(self) -> np.ndarray:
        """(K, 4, 4) current fused estimates, translation in mm."""
        return np.stack([t.pose_mm for t in self.trackers])

    def _motions(self, motions_mm):
        k = len(self.trackers)
        if motions_mm is None:
            motions_mm = [None] * k
        if len(motions_mm) != k:
            raise ValueError(f"{len(motions_mm)} motions for {k} objects")
        return list(motions_mm)

    def step(self, frame_depth, motions_mm=None) -> list:
        """Consume one depth frame; returns one :class:`TrackStep` per
        object (``refined``/``results``/``best`` are that object's rows of
        the batch).

        motions_mm: optional per-object motion increments - K entries, each
        a (4, 4) LEFT-applied camera-frame increment or None (that object
        takes the session's motion model for this frame). A failed call
        leaves the session as it was."""
        return self._step(frame_depth, self._motions(motions_mm), self.model_ids)

    def step_async(self, frame_depth, motions_mm=None) -> Optional[list]:
        """Pipelined tracking: enqueue this frame, then wait for and fuse
        the PREVIOUS frame and return its per-object :class:`TrackStep`
        list (None on the first call). Call :meth:`flush` after the last
        frame to collect the final steps."""
        return self._step_async(frame_depth, self._motions(motions_mm), self.model_ids)

    def flush(self) -> Optional[list]:
        """Wait for and fuse the last step_async frame (None if nothing is
        in flight). Atomic: on a failed readback or filter update every
        tracker rolls back and the frame stays in flight for a retry."""
        return self._flush()

    def state_dict(self):
        """Exact loop state; ``from_state(refiner, state)`` resumes
        bit-exactly (see TrackingSession.state_dict)."""
        return {"model_ids": list(self.model_ids),
                "trackers": [t.state_dict() for t in self.trackers], **self._loop_state()}

    @classmethod
    def from_state(cls, refiner: MultiModelRefiner, state) -> "MultiObjectSession":
        """Inverse of :meth:`state_dict` given a freshly configured refiner."""
        if not isinstance(refiner, MultiModelRefiner):
            raise ValueError("MultiObjectSession.from_state needs a MultiModelRefiner")
        model_ids = [_check_object_model(refiner, mid, "state ") for mid in state["model_ids"]]
        trackers = [PoseTracker.from_state(s) for s in state["trackers"]]
        if len(trackers) != len(model_ids):
            raise ValueError(f"{len(trackers)} tracker states for {len(model_ids)} model ids")
        self = cls._resume(refiner, trackers, state)
        self.model_ids = model_ids
        return self


def _check_object_model(refiner: MultiModelRefiner, model_id, what: str = "") -> int:
    mid = int(model_id)
    if not 0 <= mid < len(refiner.models):
        raise ValueError(f"{what}model_id {mid} out of range [0, {len(refiner.models)})")
    return mid
