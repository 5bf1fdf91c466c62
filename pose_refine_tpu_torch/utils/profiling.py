"""Profiling hooks (the PyTorch port of ``pose_refine_tpu/utils/profiling.py``):
``torch.profiler`` traces in place of ``jax.profiler`` (the reference ships
nv_prof.sh for nvprof/nvvp), the caching allocator's statistics, and a
rolling step timer."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, annotate: str = ""):
    """Capture a host and device trace around a block:

        with trace("traces/refine"):
            refiner.refine(poses)

    On exit the Chrome trace is written to ``logdir`` (default: a
    ``pose_refine_trace`` directory under the temporary directory) as
    ``trace_<pid>_<ns>.json``; open it in ui.perfetto.dev or
    chrome://tracing. The card's kernels are traced when one is present.
    ``annotate`` names a region around the whole block. Yields logdir."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "pose_refine_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        if annotate:
            with torch.profiler.record_function(annotate):
                yield logdir
        else:
            yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside an active trace."""
    with torch.profiler.record_function(name):
        yield


def device_memory_stats(device=None) -> Optional[dict]:
    """The caching allocator's statistics for one card under the JAX
    package's key names (the reference prints free/total device memory via
    cudaMemGetInfo, renderer.cu:52-69): ``bytes_in_use`` (allocated by
    tensors), ``peak_bytes_in_use`` (since the last
    ``torch.cuda.reset_peak_memory_stats``) and ``bytes_limit`` (the
    card's total memory). None for the CPU, or when no card is present (device=None: the current
    card)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def log_memory_usage(prefix: str = "device memory", device=None) -> str:
    """One-line human-readable memory summary (or an honest 'unavailable')."""
    stats = device_memory_stats(device)
    parts = []
    if stats:
        for key, label in (("bytes_in_use", "in_use"),
                           ("peak_bytes_in_use", "peak"),
                           ("bytes_limit", "limit")):
            val = stats.get(key)
            if val is not None:
                parts.append(f"{label} {val / 2**20:.1f} MiB")
    if parts:
        msg = f"{prefix}: " + ", ".join(parts)
    else:
        msg = f"{prefix}: allocator stats unavailable on this device"
    print(msg)
    return msg


class StepTimer:
    """Rolling wall-clock stats for production loops (observability beyond
    the reference's std::cout timers, helper.h:138-155). Host clock only:
    a step on the card is timed to its return, so end the step with a wait
    (``PendingResult.wait``, ``torch.cuda.synchronize``) to time the card."""

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.worst = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        self.total += dt
        self.worst = max(self.worst, dt)
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
