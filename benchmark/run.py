#!/usr/bin/env python3
"""One run of one cell of the benchmark of pose_refine_tpu_torch.

    python3 benchmark/run.py --workload proj-frame256 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for. It makes the cell's inputs from the seed, builds the program's
refiner (the program builds its kernels inside the checkout on first
use), warms up, measures for --seconds in a closed loop, checks the
answers against the plain reference and prints one JSON line last on
standard output: the cell's end-to-end metrics (--trace 0) or its
per-layer metrics from one profiled stretch after the warm-up and spans
in the window (--trace 1). It exits non-zero without a result when there
is no CUDA card, fewer cards than the cell asks for, or a module of JAX or
of the JAX package loaded by the end.
"""

import os
import time

T_START = time.perf_counter()
# one process with one thread for the host's numerical libraries: the
# program's host work is small arrays, where thread pools add only jitter
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from core import check, readers, spec, trace, traffic  # noqa: E402
from reference.geometry import full_float32  # noqa: E402
from reference.refiner import Refiner  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pose_refine_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(devices):
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, devices: list,
             t_start: float) -> dict:
    """One run: set-up, (the profiled stretch,) the window, the check. The
    result's keys as printed; ``checks`` holds each compared number with
    its limit."""
    import pose_refine_tpu_torch as ptt

    cuda = torch.device(devices[0]).type == "cuda"
    full_float32()
    tr = traffic.make(ptt, cell.config, cell.mix, seed, devices)
    if cuda:
        for d in devices:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(d)
    tr.warmup()
    _sync(devices)
    setup_s = time.perf_counter() - t_start
    # the set-up's objects leave the collector's generations, so the
    # window's collections do not scan them again
    gc.collect()
    gc.freeze()
    stretch, profiled = None, {}

    def one_stretch() -> int:
        first = len(tr.calls)
        n = tr.stretch(trace.Spans(annotate=True))
        profiled["calls"] = range(first, len(tr.calls))
        return n

    if traced:
        stretch = trace.profile(one_stretch, devices)
    spans = trace.Spans(record=traced)
    done, window_s, poses = tr.window(seconds, spans)
    _sync(devices)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    latencies, answers = tr.answers(done)
    failed = sum(not all(np.isfinite(np.asarray(a, np.float64)).all() for a in ans)
                 for ans in answers)
    # the program's state is freed before the reference runs
    tr.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Refiner(cell.config, tr.vertices, tr.faces, devices[0])
    numbers = check.numbers(tr.gaps(ref, done, tr.sample(done, seed)), cell.limits)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(bool(c["value"] <= c["limit"]) for c in checks.values()) and failed == 0
    found = {"poses_per_s": poses / window_s,
             "latency_ms_p95": float(np.percentile(latencies, 95)) * 1e3,
             "setup_s": setup_s}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(done), "failed": int(failed)}
    if traced:
        work = tr.work(ref, profiled["calls"])
        ctx = readers.Context(spans.times, stretch, work)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device["busy_s"] = float(np.mean(list(stretch["busy_s"].values())))
        device["window_s"] = stretch["wall_s"]
        out.update(metrics=metrics, device=device, breakdown={
            "device_ops": sorted(([k[:160], v] for k, v in stretch["kernel_s"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[k[:160], v] for k, v in stretch["idle_gaps"][:10]]})
    else:
        out.update(metrics={m["name"]: {"value": found[m["name"]], "unit": m["unit"]}
                            for m in cell.end_to_end}, device=device)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
