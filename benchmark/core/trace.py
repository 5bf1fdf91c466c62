"""Host-clock spans, and one short profiled stretch of a cell's traffic.

torch.profiler stops recording the kernels a process launches with <<<>>>
after tens of seconds of launches, so the stretch runs right after the
warm-up, and the kernels it records of each counted family are held to the
program's launch counters for the same stretch: a stretch that misses one
is profiled again, and a run whose stretches all miss fails. Busy time,
idle share and kernel times come from that one stretch and its own wall.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

# kernel families: (name pattern, device kernels a counted launch)
FAMILIES = {
    "rasterize": (re.compile(r"\b(bin_kernel|raster_kernel)\b"), 2),
    "window_lift": (re.compile(r"\bwindow_lift_kernel\b"), 1),
    "icp_iterate": (re.compile(r"\bicp_iterate_kernel\b"), 1),
    "nn_kdtree": (re.compile(r"\bnn_kdtree_(staged|grid)\b"), 1),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def launch_counters() -> dict:
    """The program's launch counter of each family."""
    from pose_refine_tpu_torch.ops import icp_reduce, lift_cuda, rasterize_cuda
    from pose_refine_tpu_torch.scene import nn_kdtree
    return {"rasterize": rasterize_cuda.launches, "window_lift": lift_cuda.launches,
            "icp_iterate": icp_reduce.iterate_launches, "nn_kdtree": nn_kdtree.launches}


class Spans:
    """Named host-clock spans (seconds), recorded when ``record`` is set, and
    the same names as profiler annotations when ``annotate`` is set."""

    def __init__(self, record: bool = False, annotate: bool = False):
        self.record, self.annotate = record, annotate
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        ann = (torch.profiler.record_function(f"bench.{name}") if self.annotate
               else contextlib.nullcontext())
        with ann:
            t0 = time.perf_counter()
            yield
            if self.record:
                self.times[name].append(time.perf_counter() - t0)


class StretchError(RuntimeError):
    pass


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile(stretch, devices, tries: int = 3) -> dict:
    """Profile ``stretch()`` (which runs requests under Spans annotations and
    returns how many it ran) until its counted kernels match the launch
    counters. Returns the stretch's wall, requests, kernels, per-device
    busy seconds, kernel seconds by name, and the idle gaps of the first
    device by the host range active in them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(tries):
        for d in devices:
            torch.cuda.synchronize(d)
        before = launch_counters()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.stretch"):
                requests = stretch()
                for d in devices:
                    torch.cuda.synchronize(d)
        launched = {k: v - before[k] for k, v in launch_counters().items()}
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
        finally:
            os.unlink(path)
        out = _analyse(events, requests, devices)
        got = {k: sum(n for name, n in out["kernel_calls"].items() if pat.search(name)) // per
               for k, (pat, per) in FAMILIES.items()}
        seen.append((got, launched))
        if got == launched:
            out["launches"] = launched
            return out
    raise StretchError(f"the profiler's kernels fall short of the launch counters "
                       f"(profiled, counted): {seen}")


def _analyse(events, requests: int, devices) -> dict:
    win = [e for e in events if e.get("name") == "bench.stretch" and e.get("cat") in HOST_CATS]
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and t0 <= float(e["ts"]) <= t1]
    by_device = defaultdict(list)
    seconds, calls = defaultdict(float), defaultdict(int)
    for e in dev:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        by_device[int(e.get("args", {}).get("device", 0))].append((a, b))
        seconds[e["name"]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            calls[e["name"]] += 1
    ids = [torch.device(d).index or 0 for d in devices]
    busy = {i: _union(by_device.get(i, [])) * 1e-6 for i in ids}
    return {"requests": requests, "wall_s": (t1 - t0) * 1e-6, "busy_s": busy,
            "kernels": sum(calls.values()), "kernel_calls": dict(calls),
            "kernel_s": dict(seconds), "idle_gaps": _idle_gaps(events, by_device.get(ids[0], []),
                                                                t0, t1)}


def _innermost(ranges, starts, t: float, scan: int = 4096) -> str:
    """The name of the latest-starting of ``ranges`` (sorted by start) that
    spans t: host ranges nest, so that is the innermost one."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - scan, -1), -1):
        if ranges[j][1] >= t:
            return ranges[j][2]
    return ""


def _idle_gaps(events, intervals, t0: float, t1: float) -> list:
    """[label, seconds] of the first device's idle time in the stretch,
    summed by the innermost annotation and operator of the host that span
    each gap's midpoint, longest first."""
    def ranges(keep):
        out = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                     for e in events if e.get("cat") in HOST_CATS and keep(e["name"]))
        return out, [r[0] for r in out]

    ann = ranges(lambda n: n.startswith("bench.") and n != "bench.stretch")
    ops = ranges(lambda n: not n.startswith("bench."))
    gaps, end = [], t0
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    out = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "/".join(x for x in (_innermost(*ann, mid), _innermost(*ops, mid)) if x)
        out[label or "host"] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])
