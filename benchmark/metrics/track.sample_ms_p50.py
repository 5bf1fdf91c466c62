"""Median ms of a tracking session's hypothesis sampling (span
``prt.step.sample``: the filters' copies, prediction and sampling of a
step), in the window."""

from core.program import span_ms_p50


def read(ctx):
    return span_ms_p50("prt.step.sample")
