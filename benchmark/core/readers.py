"""What a per-layer metric reads: the window's host-clock spans, the
profiled stretch and the work its requests need (check.stretch_work).
Each reader returns None where it finds nothing to read: a span that
was never opened, a kernel family that did not run."""

from __future__ import annotations

import numpy as np

from core import bounds
from core.trace import FAMILIES


class Context:
    def __init__(self, spans: dict, stretch: dict, work: dict):
        self.spans, self.stretch, self.work = spans, stretch, work

    def span_ms_p50(self, name: str):
        t = self.spans.get(name)
        return float(np.median(t)) * 1e3 if t else None

    def kernel_s(self, family: str) -> float:
        pat = FAMILIES[family][0]
        return sum(s for name, s in self.stretch["kernel_s"].items() if pat.search(name))

    def roofline(self, family: str):
        """The family's bound over its kernels' profiled time, in percent."""
        t = self.kernel_s(family)
        if t <= 0 or family not in self.work:
            return None
        return 100.0 * bounds.bound_s(*self.work[family]) / t

    def idle_share(self):
        """100 (1 - busy / wall) of the stretch, the mean over the cards."""
        wall = self.stretch["wall_s"]
        return 100.0 * float(np.mean([1.0 - b / wall for b in self.stretch["busy_s"].values()]))

    def kernels_per_request(self):
        return self.stretch["kernels"] / self.stretch["requests"]
