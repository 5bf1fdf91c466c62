"""Median ms from a refine call to its return, before any readback (the
benchmark's span): the refiner's issue of the render, lift and ICP launches
(pipeline.py, icp.py, parallel/sharding.py)."""


def read(ctx):
    return ctx.span_ms_p50("refine.call")
