"""The traffic of a cell: one class a mix kind, found by name as
``kinds/<kind>.py`` (the mix file's ``kind``), which reads the mix's
parameters, makes the cell's inputs from the seed, drives the program
under test in a closed loop with one caller and judges its answers by
the plain reference. A new kind is one new file there.

Every kind's class is a ``Traffic`` and keeps its interface:

  warmup()                   the cell's shapes, once each (set-up)
  stretch(spans) -> n        the profiled stretch: n requests
  window(seconds, spans)     -> (done, window seconds, poses completed);
                             ``done`` holds the window's answers
  answers(done)              -> (latencies in seconds, [arrays of an answer])
  release()                  drops the program's state before the check
  sample(done, seed)         the answers checked, drawn from the seed
  gaps(ref, done, sample)    -> {gap name: values}, each answer judged by the
                             reference (``check.numbers`` reads the limits
                             file's percentiles of them)
  control(ref, done, sample) -> ``done`` with the sampled answers computed by
                             the reference in TF32 (calibrate.py only)
  work(ref, calls)           -> {kernel family: (bytes, operations)} of the
                             requests whose render calls are ``calls``

Every call that plans a frame or renders hypotheses is logged in order
(``calls``), so the reference can work out again what the program derived
from them.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from core import inputs

KINDS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kinds")


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def refiner(ptt, cfg: dict, mesh_path: str, devices: list):
    """The program under test: a PoseRefiner of the configuration's options
    on its card, or split over ``devices`` when there are several."""
    cam = cfg["camera"]
    kw = dict(cfg["refiner"])
    if len(devices) > 1:
        kw["devices"] = list(devices)
    else:
        kw["device"] = devices[0]
    return ptt.PoseRefiner(mesh_path, K=np.asarray(cam["K"], np.float32),
                           width=cam["width"], height=cam["height"], **kw)


class Traffic:
    """The inputs and the program of one run of one cell."""

    def __init__(self, ptt, cfg: dict, mix: dict, seed: int, devices: list):
        self.ptt, self.cfg, self.mix, self.devices = ptt, cfg, mix, list(devices)
        self.vertices, self.faces = inputs.make_mesh(cfg["mesh"])
        self.calls = []
        path = inputs.write_ply(self.vertices, self.faces)
        try:
            self.refiner = refiner(ptt, cfg, path, self.devices)
        finally:
            os.unlink(path)
        self.hypotheses = int(mix["hypotheses"])
        self._inputs(_rng(seed, 1))

    def render(self, truths) -> np.ndarray:
        return inputs.render_frames(self.vertices, self.faces, truths, self.cfg["camera"],
                                    self.devices[0])

    def release(self):
        self.refiner = None


def kind(name: str):
    """The Traffic class of kinds/<name>.py."""
    path = os.path.join(KINDS, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_kind_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Traffic


def make(ptt, cfg: dict, mix: dict, seed: int, devices: list) -> Traffic:
    return kind(mix["kind"])(ptt, cfg, mix, seed, devices)
