"""Median ms of the program's scene build (span ``prt.scene.build``: the
projective table's copy to the card and the issue of its kernels, in
set_scene_depth and in each tracked frame), in the window."""

from core.program import span_ms_p50


def read(ctx):
    return span_ms_p50("prt.scene.build")
