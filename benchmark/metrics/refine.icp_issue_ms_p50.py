"""Median ms of the issue of a refine's or tracked frame's ICP loop (span
``prt.refine.icp``, pipeline._refine_clouds: the iteration kernel's
launches and, in an NN scene, K1's), in the window."""

from core.program import span_ms_p50


def read(ctx):
    return span_ms_p50("prt.refine.icp")
