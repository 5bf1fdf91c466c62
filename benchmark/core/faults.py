"""Faults planted in the program's timed path, each the way a cell can be
broken underneath: ``FAULTS[name](patch)`` replaces a function of the
program through ``patch(owner, name, value)`` (pytest's
``monkeypatch.setattr``, or ``Patches`` below). The benchmark's runs plant
none; ``tests/test_bench_faults.py`` drives a run on the CPU with each, and
``calibrate.py --faults`` reads the check's numbers with each at a cell's
own size on the card."""

from __future__ import annotations

import torch


def unchanged(patch):
    """The ICP step returns its state as it found it."""
    from pose_refine_tpu_torch import icp

    def step(cloud, valid, assoc, criteria, n_points=None, **kw):
        state, _valid, n_total = icp._icp_start(cloud, valid, n_points)
        return icp.RegistrationResult(state.T, state.fitness, state.rmse, n_total), state.cloud
    patch(icp, "_icp_run", step)


def half_batch(patch):
    """Half of the batch left out: the second half's answers are copies of
    the first half's."""
    from pose_refine_tpu_torch import icp
    real = icp._icp_run

    def step(cloud, valid, assoc, criteria, **kw):
        n = cloud.shape[0]
        h = (n + 1) // 2
        res, final = real(cloud[:h], valid[:h], assoc, criteria, **kw)
        idx = torch.arange(n, device=cloud.device) % h
        return icp.RegistrationResult(*(None if x is None else x[idx] for x in res)), final[idx]
    patch(icp, "_icp_run", step)


def _produced(patch, alter):
    from pose_refine_tpu_torch import pipeline
    real = pipeline._refine_clouds

    def produce(*a, **kw):
        refined, results, final, valids = real(*a, **kw)
        refined, results = alter(refined.clone(), results)
        return refined, results, final, valids
    patch(pipeline, "_refine_clouds", produce)


def altered(patch):
    """Every answer's pose altered where it is produced: 1 mm along x."""
    def alter(refined, results):
        refined[:, 0, 3] += 1.0
        return refined, results
    _produced(patch, alter)


def altered_fitness(patch):
    """Every answer's fitness altered where it is produced: 0.01 lower (about
    20 of a 2,048-point cloud's inliers)."""
    def alter(refined, results):
        return refined, results._replace(fitness=results.fitness - 0.01)
    _produced(patch, alter)


def no_exchange(patch):
    """The gather between cards left out: the first card's rows, zeros for
    the others'."""
    from pose_refine_tpu_torch.parallel import sharding

    def gather(outs, home):
        first = outs[0]
        if isinstance(first, tuple):
            return type(first)(*(None if f is None else gather([o[i] for o in outs], home)
                                 for i, f in enumerate(first)))
        return torch.cat([first.to(home)] + [torch.zeros_like(o).to(home) for o in outs[1:]])
    patch(sharding, "_gather", gather)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
          "altered_fitness": altered_fitness, "no_exchange": no_exchange}


def applies(fault: str, chips: int) -> bool:
    """Whether a cell on ``chips`` cards can have the fault."""
    return fault != "no_exchange" or chips > 1


class Patches:
    """``patch(owner, name, value)`` that ``undo()`` reverts."""

    def __init__(self):
        self._saved = []

    def __call__(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)
