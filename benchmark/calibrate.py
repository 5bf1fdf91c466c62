#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload proj-frame256 --seconds 2 \\
        --seeds 11 12 13 --control-seeds 21 22 23 [--faults 31 32 33] [--out FILE]

For each of --seeds: the cell's set-up and a short window of its traffic
through the program, then the check's numbers (the lower readings). For
each of --control-seeds: the same, with the sampled answers (a tracking
session's every frame) computed by the reference in TF32, the precision
below the configuration's float32 with TF32 off, in the program's place
(the upper readings). For each of --faults' seeds: the same with each
fault of ``core/faults.py`` that the cell can have planted in the program,
at the cell's own size. Prints one JSON line a reading, with the
percentiles of every gap and whether a number is over its limit, and the
smallest and largest of each number per side at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from core import check, faults, spec, trace, traffic  # noqa: E402
from reference.geometry import full_float32  # noqa: E402
from reference.refiner import Refiner  # noqa: E402


def readings(cell, seed: int, seconds: float, devices: list, control: bool = False,
             fault: str = "") -> dict:
    """The check's numbers for one seed: of the program's answers, of the
    reference's in TF32 (``control``), or of the program with ``fault``
    planted."""
    import pose_refine_tpu_torch as ptt

    full_float32()
    patches = faults.Patches()
    if fault:
        faults.FAULTS[fault](patches)
    try:
        tr = traffic.make(ptt, cell.config, cell.mix, seed, devices)
        tr.warmup()
        done, window_s, _ = tr.window(seconds, trace.Spans())
    finally:
        patches.undo()
    tr.release()
    gc.collect()
    torch.cuda.empty_cache()
    ref = Refiner(cell.config, tr.vertices, tr.faces, devices[0])
    t0 = time.perf_counter()
    sample = tr.sample(done, seed)
    if control:
        done = tr.control(ref, done, sample)
    gaps = tr.gaps(ref, done, sample)
    numbers = check.numbers(gaps, cell.limits)
    spread = {g: [float(np.percentile(np.concatenate([np.ravel(x) for x in v]), q))
                  for q in (50, 75, 90, 100)] for g, v in gaps.items()}
    return {"seed": seed, "control": control, "fault": fault, "requests": len(done),
            "window_s": window_s, "check_s": time.perf_counter() - t0, **numbers,
            "over": [k for k, v in numbers.items() if not v <= cell.limits[k]],
            "gaps_p50_p75_p90_max": spread}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", type=int, nargs="*", default=[],
                   help="seeds to read each fault the cell can have on")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    todo = [(s, False, "") for s in args.seeds] + [(s, True, "") for s in args.control_seeds]
    todo += [(s, False, f) for f in faults.FAULTS if faults.applies(f, cell.chips)
             for s in args.faults]
    rows = []
    for seed, control, fault in todo:
        try:
            row = readings(cell, seed, args.seconds, devices, control, fault)
        except Exception as e:  # a fault that crashes the run has failed it
            row = {"seed": seed, "control": control, "fault": fault, "raised": repr(e)[:300]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for side in ["program", "control"] + list(faults.FAULTS):
        got = [r for r in rows if (r["fault"] or ("control" if r["control"] else "program"))
               == side and "raised" not in r]
        if got:
            summary = {k: [min(r[k] for r in got), max(r[k] for r in got)] for k in cell.limits}
            print(json.dumps({"side": side, "seeds": len(got), "min_max": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            for r in rows:
                fh.write(json.dumps({"workload": args.workload, **r}) + "\n")
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
