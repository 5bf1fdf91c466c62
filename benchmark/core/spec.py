"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root, a configuration's file (named there), a traffic mix
(``mixes/<traffic>.json``), a cell's limits (``limits/<workload>.json``)
and a per-layer metric's reader (``metrics/<metric>.py``, a ``read(ctx)``
that returns a number, or None where it finds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of BENCHMARK.json with its configuration, mix, limits
    and the metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = _json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = _json(root / entry["file"])
        self.mix = _json(BENCH / "mixes" / f"{self.workload['traffic']}.json")
        self.limits = _json(BENCH / "limits" / f"{name}.json")

        def here(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        self.per_layer = [m for m in bench["per_layer"] if here(m)]
        self.run_seconds = int(bench["run_seconds"])


def reader(metric: str):
    """The ``read`` function of metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
