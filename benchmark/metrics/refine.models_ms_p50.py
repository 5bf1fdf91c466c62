"""Median ms of MultiModelRefiner's per-pose meshes (span ``prt.refine.models``,
pipeline.MultiModelRefiner._per_pose_tris: the model ids' read and range
check on the host, and their upload), in the window."""

from core.program import span_ms_p50


def read(ctx):
    return span_ms_p50("prt.refine.models")
