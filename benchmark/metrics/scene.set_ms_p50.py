"""Median ms of a set_scene_depth call in the window (the benchmark's span):
the refiner's host planning and the scene build (pipeline.py,
scene/projective.py)."""


def read(ctx):
    return ctx.span_ms_p50("scene.set")
