"""The program's own spans, read from its recorder
(``pose_refine_tpu_torch.utils.profiling``): the last ``SPAN_CAPACITY``
spans the process closed, the window's and, where the ring holds them,
the set-up's and the profiled stretch's. A program without the recorder
gives nothing to read."""

from __future__ import annotations

import numpy as np


def span_ms_p50(name: str, self_only: bool = False):
    """Median ms of the program's span ``name`` (self time with
    ``self_only``), or None where the ring holds none."""
    try:
        from pose_refine_tpu_torch.utils.profiling import span_ms
    except ImportError:
        return None
    t = span_ms(name, self_only=self_only)
    return float(np.median(t)) if t else None
