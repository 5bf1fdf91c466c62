"""Median ms of the program's host planning of a frame (span ``prt.plan``,
PoseRefiner._prepare_frame: the object's pixel statistics, the ROI and the
lift sizes), in the window."""

from core.program import span_ms_p50


def read(ctx):
    return span_ms_p50("prt.plan")
