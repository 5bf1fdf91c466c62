"""Median ms the host blocks on the card for a tracked frame's results (span
``prt.wait``, PendingResult.wait inside the fuse), in the window."""

from core.program import span_ms_p50


def read(ctx):
    return span_ms_p50("prt.wait")
