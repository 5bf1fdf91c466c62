"""The run, driven on the CPU at a size a test can hold (the look for a
card skipped), with the program sound and with the timed path broken
underneath in each way its cell can be (``core/faults.py``): ``correct``
must come out true and then false. The CPU runs the program's plain
versions of its kernels, the same functions the card's kernels compute,
and renders with its scatter raster (use_pallas=False), the same function
as its raster B1 and fast on a CPU. A request's answers are all checked:
32 of them (16 a tracked frame), so that the percentiles of the check
stand above the few answers that a projective association flip moves; 8
against a nearest-neighbour scene, whose association does not flip so and
whose plain kd walk is slow on a CPU. The same faults at the cells' own
sizes on the card: ``calibrate.py --faults``, PERF.md section 2."""

import json
import time

import pytest

import run
from core import faults, spec
from core.faults import FAULTS

SMALL = {"frames": 1, "hypothesis_batches": 1, "warmup_requests": 0, "check_requests": 1,
         "warmup_frames": 1, "check_frames": 1}


def small_cell(name: str) -> spec.Cell:
    cell = spec.Cell(name)
    for k, v in SMALL.items():
        if k in cell.mix:
            cell.mix[k] = v
    if cell.mix["kind"] == "refine":
        n = 8 if cell.config["refiner"]["scene"] == "nn" else 32
        cell.mix["hypotheses"] = cell.mix["check_hypotheses"] = n
    cell.config["refiner"]["use_pallas"] = False
    return cell


def drive(name: str, seed: int = 3_000_000_101) -> dict:
    cell = small_cell(name)
    seconds = 0.01 if cell.mix["kind"] == "refine" else 0.5
    return run.run_cell(cell, seed, seconds, False, ["cpu"] * cell.chips, time.perf_counter())


BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CASES = [(w["name"], f) for w in BENCH["workloads"] for f in FAULTS
         if faults.applies(f, w["chips"])]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = drive(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    out = drive(cell)
    assert not out["correct"], out["checks"]
