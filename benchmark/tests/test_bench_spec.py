"""The benchmark's data loads by name, and BENCHMARK.json keeps to the
shape its contract sets (names, units, keys, files under paths)."""

import json
import re
from pathlib import Path

import pytest

from core import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.Cell(cell)
    assert c.config["cards"] == c.chips
    assert (spec.BENCH / "kinds" / f"{c.mix['kind']}.py").exists()
    assert set(c.limits) >= {"pose_gap_mm_p50", "fitness_gap_p75", "rmse_gap_um_p75"}
    e2e = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "poses_per_s", "latency_ms_p95"} <= e2e
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(spec.reader(metric))


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == []
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (ROOT / BENCH["paths"][0] / "mixes" / f"{w['traffic']}.json").exists()
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
