"""Median self ms of a tracking session's fuse (span ``prt.step.fuse``
less its ``prt.wait``: the buffer's unpack, the ranking, the gates and the
filter update), in the window."""

from core.program import span_ms_p50


def read(ctx):
    return span_ms_p50("prt.step.fuse", self_only=True)
