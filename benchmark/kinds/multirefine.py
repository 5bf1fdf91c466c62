"""Mix kind "multirefine": frames that each hold every model of the
configuration (``models``: stand-in meshes at their published diameters),
composed as the per-pixel nearest of the models rendered at their truths.
Each request hands a new frame to MultiModelRefiner.set_scene_depth
(cycling through the mix's frames), refines one batch of hypotheses of
every model - ``hypotheses_per_model`` of each, object by object, with
their model ids - through ``refine(model_ids, poses, criteria=)``, and
copies the poses, fitness and rmse to the host.

The answers are judged by ``reference/multimodel.py``, which renders each
hypothesis with its own model's triangles; the kind builds it from the
configuration itself (``run.py``'s one-mesh reference, which it is handed,
holds the first model only and is not used).

Mix keys: hypotheses_per_model, frames, hypothesis_batches (a multiple of
frames), z_mm (the truths' centres), rot_deg, trans_mm (the hypotheses
about their own object's truth), warmup_requests, profile_requests,
check_requests, check_hypotheses (the sample: that many answers of that
many requests).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np

from core import bounds, check, inputs, traffic
from core.trace import Spans
from reference.geometry import corner_gap, tf32
from reference.multimodel import MultiRefiner

# draws of one object's centre before the frame's placement starts again
TRIES = 1000


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


def diameter(vertices) -> float:
    """The largest vertex-to-vertex distance: only vertices at least the
    lower bound less the largest radius from the centroid can end the
    farthest pair, and those are compared exhaustively."""
    v = np.asarray(vertices, np.float64)
    r = np.linalg.norm(v - v.mean(0), axis=1)
    low = float(np.linalg.norm(v - v[r.argmax()], axis=1).max())
    keep = v[r >= low - r.max()]
    best = low
    for s in range(0, len(keep), 256):
        d = np.linalg.norm(keep[s:s + 256, None] - keep[None], axis=-1)
        best = max(best, float(d.max()))
    return best


def stand_in(spec: dict):
    """(vertices (V, 3) float32 mm, faces (F, 3) int32): the model's bumpy
    sphere scaled so that its largest vertex-to-vertex distance is the
    model's diameter."""
    if spec["shape"] != "bumpy_sphere":
        raise ValueError(f"unknown mesh shape {spec['shape']!r}")
    v, f = inputs.bumpy_sphere(1.0, spec["subdivisions"], spec["bump"])
    scale = float(spec["diameter_mm"]) / diameter(v)
    return (v.astype(np.float64) * scale).astype(np.float32), f


def _inside(c: np.ndarray, r: float, camera: dict) -> bool:
    """Whether a ball of radius r about c projects wholly inside the frame:
    each image coordinate bounded by the ball's extreme x (y) over its
    nearest or farthest z, whichever bounds the ratio."""
    if c[2] - r <= 0:
        return False
    K = camera["K"]
    for axis, size in ((0, camera["width"]), (1, camera["height"])):
        lo, hi = c[axis] - r, c[axis] + r
        lo_t = lo / (c[2] - r) if lo < 0 else lo / (c[2] + r)
        hi_t = hi / (c[2] - r) if hi > 0 else hi / (c[2] + r)
        f, p = K[axis][axis], K[axis][2]
        if p + f * lo_t < 0 or p + f * hi_t > size - 1:
            return False
    return True


def placements(rng, n: int, meshes, diameters, z_mm, camera: dict) -> np.ndarray:
    """(n, M, 4, 4) truths of every model in each of n frames: rotations
    uniform on SO(3), centres at z in z_mm and x, y uniform over the
    image at that depth, each model's bounding ball about its origin
    wholly inside the frame and no two balls of radius diameter / 2
    intersecting, drawn by rejection."""
    reach = [float(np.linalg.norm(v.astype(np.float64), axis=1).max()) for v, _ in meshes]
    half = [0.5 * float(d) for d in diameters]
    K = camera["K"]
    out = []
    for _ in range(n):
        R = inputs.uniform_rotations(rng, len(meshes))
        while True:
            centres = []
            for k in range(len(meshes)):
                for _ in range(TRIES):
                    z = rng.uniform(z_mm[0], z_mm[1])
                    c = np.array([(rng.uniform(0, camera["width"]) - K[0][2]) * z / K[0][0],
                                  (rng.uniform(0, camera["height"]) - K[1][2]) * z / K[1][1],
                                  z])
                    if _inside(c, reach[k], camera) and all(
                            np.linalg.norm(c - q) > half[k] + half[j]
                            for j, q in enumerate(centres)):
                        centres.append(c)
                        break
                else:
                    break
            if len(centres) == len(meshes):
                break
        out.append(inputs.poses(R, np.stack(centres)))
    return np.stack(out)


def compose(meshes, truths, camera: dict, device) -> np.ndarray:
    """(F, H, W) int32 mm frames: the per-pixel nearest of the models, each
    rendered at its truth ((F, M, 4, 4)) by the reference's renderer."""
    out = None
    for k, (v, f) in enumerate(meshes):
        d = inputs.render_frames(v, f, truths[:, k], camera, device)
        out = d if out is None else np.where((d > 0) & ((out == 0) | (d < out)), d, out)
    return out


def multi_refiner(ptt, cfg: dict, meshes, device):
    """The program under test: a MultiModelRefiner of the configuration's
    options on its card, each model written as a PLY and loaded by the
    program."""
    paths = [inputs.write_ply(v, f) for v, f in meshes]
    cam = cfg["camera"]
    try:
        return ptt.MultiModelRefiner(paths, K=np.asarray(cam["K"], np.float32),
                                     width=cam["width"], height=cam["height"],
                                     device=device, **cfg["refiner"])
    finally:
        for p in paths:
            os.unlink(p)


class Traffic(traffic.kind("refine")):
    """The refine kind's loop (warm-up, stretch, window, answers, sample)
    over this kind's inputs, requests and reference."""

    def __init__(self, ptt, cfg: dict, mix: dict, seed: int, devices: list):
        if len(devices) != 1:
            raise ValueError("multirefine runs on one card")
        self.ptt, self.cfg, self.mix, self.devices = ptt, cfg, mix, list(devices)
        self.meshes = [stand_in(m) for m in cfg["models"]]
        self.vertices, self.faces = self.meshes[0]
        self.calls = []
        self.refiner = multi_refiner(ptt, cfg, self.meshes, self.devices[0])
        per = int(mix["hypotheses_per_model"])
        self.ids = np.repeat(np.arange(len(self.meshes), dtype=np.int32), per)
        self.hypotheses = len(self.ids)
        self.halves = np.array([check.half_extent(v) for v, _ in self.meshes])
        self._ref = None
        self._inputs(traffic._rng(seed, 1))

    def _inputs(self, rng):
        m = self.mix
        n_frames, n_batches = int(m["frames"]), int(m["hypothesis_batches"])
        if n_batches % n_frames:
            raise ValueError("hypothesis_batches must be a multiple of frames")
        per = int(m["hypotheses_per_model"])
        self.truths = placements(rng, n_frames, self.meshes,
                                 [s["diameter_mm"] for s in self.cfg["models"]], m["z_mm"],
                                 self.cfg["camera"])
        self.frames = compose(self.meshes, self.truths, self.cfg["camera"], self.devices[0])
        self.batches = np.stack([np.concatenate([
            inputs.perturb(rng, t, per, m["rot_deg"], m["trans_mm"])
            for t in self.truths[b % n_frames]]) for b in range(n_batches)])
        self.crit = self.ptt.ICPConvergenceCriteria(**self.cfg["criteria"])
        self.iters = int(self.cfg["criteria"]["max_iteration"])
        self.n = 0

    def reference(self) -> MultiRefiner:
        if self._ref is None:
            self._ref = MultiRefiner(self.cfg, self.meshes, self.devices[0])
        return self._ref

    def request(self, spans: Spans) -> Request:
        i = self.n
        self.n += 1
        f, b = i % len(self.frames), i % len(self.batches)
        t0 = time.perf_counter()
        with spans.span("scene.set"):
            self.calls.append(("scene", f))
            self.refiner.set_scene_depth(self.frames[f])
        with spans.span("refine.call"):
            poses, res = self.refiner.refine(self.ids, self.batches[b], criteria=self.crit)
        self.calls.append(("refine", b))
        with spans.span("readback"):
            out = (poses.cpu().numpy(), res.fitness.cpu().numpy(), res.inlier_rmse.cpu().numpy())
        return Request(len(self.calls) - 1, f, b, time.perf_counter() - t0, *out)

    def _corner_gaps(self, a, b, ids) -> np.ndarray:
        """corner_gap of each answer with its own model's half extent."""
        return np.array([corner_gap(a[j], b[j], self.halves[k]) for j, k in enumerate(ids)])

    def gaps(self, ref, reqs, sample) -> dict:
        mref = self.reference()
        roi_of = check.rois(self, mref)
        scene = check.scenes(mref, self.frames)
        out = {"pose_gap_mm": [], "fitness_gap": [], "rmse_gap_um": []}
        for i, idx in sample:
            r = reqs[i]
            init, ids, roi = self.batches[r.batch][idx], self.ids[idx], roi_of[r.call]
            refined = mref.refine_models(scene(r.frame), init, ids, roi,
                                         self.iters)[0].cpu().numpy()
            out["pose_gap_mm"].append(self._corner_gaps(r.poses[idx], refined, ids))
            fit, rmse = mref.judge_models(scene(r.frame), init, ids, r.poses[idx], roi)
            f_gap, r_gap = check.rescore_gaps(r.fitness[idx], r.rmse[idx], fit.cpu().numpy(),
                                              rmse.cpu().numpy())
            out["fitness_gap"].append(f_gap)
            out["rmse_gap_um"].append(r_gap)
        return out

    def control(self, ref, reqs, sample) -> list:
        """The requests with the sampled answers computed by the reference in
        TF32."""
        mref = self.reference()
        roi_of = check.rois(self, mref)
        scene = check.scenes(mref, self.frames)
        out = list(reqs)
        for i, idx in sample:
            r = reqs[i]
            with tf32():
                refined, res, _, _ = mref.refine_models(
                    scene(r.frame), self.batches[r.batch][idx], self.ids[idx], roi_of[r.call],
                    self.iters)
            poses, fit, rmse = r.poses.copy(), r.fitness.copy(), r.rmse.copy()
            poses[idx] = refined.cpu().numpy()
            fit[idx], rmse[idx] = res.fitness.cpu().numpy(), res.rmse.cpu().numpy()
            out[i] = r._replace(poses=poses, fitness=fit, rmse=rmse)
        return out

    def work(self, ref, calls) -> dict:
        """The work of the refine calls ``calls``, each refined by the
        reference in its logged ROI. B1's is counted from each pose's own
        model: every model's triangles read once, the setup of a (pose,
        triangle) for its own model's triangles alone - the padding the
        program's table gives the smaller models is not work."""
        mref = self.reference()
        roi_of = check.rois(self, mref)
        scene = check.scenes(mref, self.frames)
        tris = np.array([t.shape[0] for t in mref.tables], np.int64)
        total, frame = {}, 0
        for i, (what, x) in enumerate(self.calls):
            if what == "scene":
                frame = x
            if what != "refine" or i not in calls:
                continue
            roi = roi_of[i]
            init = self.batches[x]
            _, res, valid, covered = mref.refine_models(scene(frame), init, self.ids, roi,
                                                        self.iters)
            out_w, out_h = (roi[2], roi[3]) if roi[2] > 0 else (mref.rw, mref.rh)
            w = check.refine_work(mref, 0, len(init), out_w, out_h, valid, covered, res, 0,
                                  self.iters)
            b, o = w["rasterize"]
            w["rasterize"] = (b + 36 * int(tris[np.unique(self.ids)].sum()),
                              o + bounds.RASTER_SETUP_OPS * int(tris[self.ids].sum()))
            check.add_work(total, w)
        return total
