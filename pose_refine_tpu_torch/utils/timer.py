"""Wall-clock timing utilities (helper::Timer analog, helper.h:138-155; the
PyTorch port of ``pose_refine_tpu/utils/timer.py``).

``time_jitted`` fences every call by ``torch.cuda.synchronize`` on the
device of the result's first CUDA tensor: PyTorch returns before a card
finishes, so a host clock without it would time the enqueue. A result with
no CUDA tensor is done on return.
"""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self):
        self.beg = time.perf_counter()

    def reset(self):
        self.beg = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.beg

    def out(self, message: str = "") -> float:
        t = self.elapsed()
        print(f"{message}\nelapsed time: {t:.6f}s\n")
        self.reset()
        return t


def _card_of(out):
    """The device of the first CUDA tensor in ``out`` (tensors, tuples,
    lists, dicts, NamedTuples), or None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.device.type == "cuda" else None
    if isinstance(out, dict):
        out = list(out.values())
    for item in out if isinstance(out, (tuple, list)) else ():
        dev = _card_of(item)
        if dev is not None:
            return dev
    return None


def _wait(out):
    """Wait until the card that holds ``out`` has finished; returns out."""
    dev = _card_of(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return out


def time_jitted(fn, *args, warmup: int = 2, iters: int = 10, **kwargs):
    """Median wall-clock seconds of fn(*args, **kwargs), each call fenced."""
    for _ in range(warmup):
        _wait(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
