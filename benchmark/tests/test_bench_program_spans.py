"""The per-layer metrics that read the program's own spans: each reader
returns the median ms of its span in the program's ring (self time where
it reads self time), and None where the ring holds no such span."""

import collections

import pytest

from core import spec
from pose_refine_tpu_torch.utils import profiling

MS = 1_000_000  # ns

# metric -> (span, self time)
READERS = {
    "plan.ms_p50": ("prt.plan", False),
    "scene.build_ms_p50": ("prt.scene.build", False),
    "refine.icp_issue_ms_p50": ("prt.refine.icp", False),
    "track.sample_ms_p50": ("prt.step.sample", False),
    "track.wait_ms_p50": ("prt.wait", False),
    "track.fuse_ms_p50": ("prt.step.fuse", True),
}


def synthetic_ring(name: str, child: str = "prt.wait") -> collections.deque:
    """Five requests, each a root ``prt.step`` with the span ``name`` of
    (k + 1) ms inside it, which holds a ``child`` of k / 4 ms (none where
    the span is that child) and a ``prt.other`` grandchild under that
    child; a distractor span of 100 ms on another thread. Records close
    children first, as the recorder writes them."""
    out = []
    t = 0
    for k in range(5):
        rid = k + 1
        t0 = t
        a = t0 + MS
        if name != child:
            w0, w1 = a + MS // 10, a + MS // 10 + k * MS // 4
            out.append(("prt.other", rid, child, 1, w0, w0 + 10))
            out.append((child, rid, name, 1, w0, w1))
        out.append((name, rid, "prt.step", 1, a, a + (k + 1) * MS))
        out.append(("prt.step", rid, None, 1, t0, a + (k + 2) * MS))
        out.append(("prt.distractor", 100 + rid, None, 2, a, a + 100 * MS))
        t = a + (k + 3) * MS
    return collections.deque(out, maxlen=profiling.SPAN_CAPACITY)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_takes_the_median_of_its_span(metric, monkeypatch):
    name, self_only = READERS[metric]
    read = spec.reader(metric)
    monkeypatch.setattr(profiling, "_ring", synthetic_ring(name))
    # durations 1..5 ms, children 0, 0.25, ..., 1 ms
    want = 3.0 - (0.5 if self_only else 0.0)
    assert read(None) == pytest.approx(want, abs=1e-9)
    monkeypatch.setattr(profiling, "_ring", synthetic_ring("prt.elsewhere", "prt.elsewhere.in"))
    assert read(None) is None
    monkeypatch.setattr(profiling, "_ring", collections.deque())
    assert read(None) is None
