"""Profiling hooks (the PyTorch port of ``pose_refine_tpu/utils/profiling.py``):
the port's span recorder and counters, ``torch.profiler`` traces in place of
``jax.profiler`` (the reference ships nv_prof.sh for nvprof/nvvp), the
caching allocator's statistics, and a rolling step timer.

Spans. The port opens a named span at each boundary between its layers
(``prt.scene.set``, ``prt.plan``, ``prt.scene.build``, ``prt.refine``,
``prt.refine.render`` / ``.lift`` / ``.icp`` / ``.info``, ``prt.shard``,
``prt.refine.capture`` / ``.replay``, ``prt.refine.models``, ``prt.gather``, ``prt.track``,
``prt.track.pin``, ``prt.wait``, ``prt.step``, ``prt.step.sample``,
``prt.step.fuse``; README lists what each
covers). A closed span is one record (name, request id, parent's name,
thread id, start ns, end ns) on ``time.perf_counter_ns``'s clock, kept in a
ring of the last ``SPAN_CAPACITY`` records. A span opened with no open span
on its thread is a root and takes a new request id, which the spans opened
inside it inherit. While a ``torch.profiler`` records, each span is also a
``record_function`` range, so a trace's host timeline carries the spans,
nested as in the ring, on the trace's own clock. The recorder is on from
import; ``tracing(False)`` makes ``span`` return one shared no-op. It issues
no device work and synchronises nothing.

Counters. ``counters()`` reads every counter of the port where it lives:
the kernels' launch counters in ``ops/`` and ``scene/`` and the pipeline's
requests (``pipeline.scenes``, ``refines``, ``tracked_frames``, ``poses``),
the refines served by a CUDA graph (``graph_captures``,
``graph_replays``) and MultiModelRefiner's per-pose meshes
(``model_poses``, ``model_slots``, ``padded_slots``); ``advance`` adds a
replayed graph's launches.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import itertools
import os
import tempfile
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_CAPACITY = 65536

_ring: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_requests = itertools.count(1)
_enabled = True
_clock = time.perf_counter_ns


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the enclosing span's name (None for a
    root), ``request`` the root's id; times in ns of
    ``time.perf_counter_ns``."""
    name: str
    request: int
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int


class _Thread(threading.local):
    """A thread's stack of open spans and its id."""

    def __init__(self):
        self.stack = []
        self.ident = threading.get_ident()


_thread = _Thread()


class _Span:
    """An open span (span() with the recorder on)."""

    __slots__ = ("name", "request", "parent", "start", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _thread.stack
        if stack:
            top = stack[-1]
            self.request, self.parent = top.request, top.name
        else:
            self.request, self.parent = next(_requests), None
        stack.append(self)
        # the profiler's range lies inside the recorded span
        self.start = _clock()
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        end = _clock()
        local = _thread
        local.stack.pop()
        _ring.append((self.name, self.request, self.parent, local.ident, self.start, end))
        return False


class _NoSpan:
    """The shared span of a recorder that is off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager that records the block as the span ``name``:

        with span("prt.plan"):
            ...

    With the recorder off, the shared no-op."""
    return _Span(name) if _enabled else _NO_SPAN


def tracing(enabled: bool) -> bool:
    """Turn the span recorder on or off; returns whether it was on."""
    global _enabled
    was, _enabled = _enabled, bool(enabled)
    return was


def spans(name: Optional[str] = None) -> list:
    """A copy of the ring's records (of the span ``name`` only, if given),
    oldest first, as SpanRecords."""
    return [SpanRecord._make(r) for r in list(_ring) if name is None or r[0] == name]


def span_ms(name: str, self_only: bool = False) -> list:
    """The durations in ms of the ring's spans ``name``, oldest first.
    self_only=True subtracts the time each one's direct children cover
    (children close before their parent, on its thread)."""
    records = list(_ring)
    if not self_only:
        return [(r[5] - r[4]) * 1e-6 for r in records if r[0] == name]
    out, closed = [], collections.defaultdict(list)
    for r in records:
        # a thread's closed spans not yet claimed by a parent: the direct
        # children of r are the last of them that started inside r
        done = closed[r[3]]
        covered = 0
        while done and done[-1][0] >= r[4] and done[-1][2] == r[0]:
            start, end, _parent = done.pop()
            covered += end - start
        done.append((r[4], r[5], r[2]))
        if r[0] == name:
            out.append((r[5] - r[4] - covered) * 1e-6)
    return out


def clear_spans():
    """Empty the ring."""
    _ring.clear()


# every counter of the port: (module, its module-level int counters)
_COUNTERS = (
    ("pose_refine_tpu_torch.pipeline", ("scenes", "refines", "tracked_frames", "poses",
                                         "graph_captures", "graph_replays", "model_poses",
                                         "model_slots", "padded_slots")),
    ("pose_refine_tpu_torch.ops.rasterize_cuda", ("launches",)),
    ("pose_refine_tpu_torch.ops.lift_cuda", ("launches",)),
    ("pose_refine_tpu_torch.ops.scene_table", ("launches",)),
    ("pose_refine_tpu_torch.ops.icp_reduce", ("iterate_launches",)),
    ("pose_refine_tpu_torch.ops.gather", ("launches",)),
    ("pose_refine_tpu_torch.scene.nn_flash",
     ("packed_launches", "gated_launches", "stacked_launches")),
    ("pose_refine_tpu_torch.scene.nn_kdtree", ("launches",)),
    ("pose_refine_tpu_torch.scene.nn_mxu", ("launches",)),
)
_MODULES = {module.rsplit(".", 1)[1]: module for module, _names in _COUNTERS}


def counters() -> dict:
    """A snapshot of every counter of the port, keyed ``<module>.<name>``
    (``pipeline.poses``, ``rasterize_cuda.launches``, ...), each read from
    its module's globals."""
    out = {}
    for module, names in _COUNTERS:
        mod = importlib.import_module(module)
        short = module.rsplit(".", 1)[1]
        out.update((f"{short}.{n}", int(getattr(mod, n))) for n in names)
    return out


def advance(counts: dict) -> None:
    """Add ``counts`` (keyed as counters() keys them) to the counters: the
    launches of a replayed CUDA graph, which no wrapper counts."""
    for key, n in counts.items():
        short, name = key.rsplit(".", 1)
        mod = importlib.import_module(_MODULES[short])
        setattr(mod, name, getattr(mod, name) + n)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, annotate: str = ""):
    """Capture a host and device trace around a block:

        with trace("traces/refine"):
            refiner.refine(poses)

    On exit the Chrome trace is written to ``logdir`` (default: a
    ``pose_refine_trace`` directory under the temporary directory) as
    ``trace_<pid>_<ns>.json``; open it in ui.perfetto.dev or
    chrome://tracing. The card's kernels are traced when one is present,
    and the port's spans as ranges of the host's timeline. ``annotate``
    names a span around the whole block. Yields logdir."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "pose_refine_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with span(annotate) if annotate else contextlib.nullcontext():
            yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region inside an active trace: the span ``name``."""
    return span(name)


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
