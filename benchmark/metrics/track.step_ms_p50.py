"""Median ms of a step_async call in the window (the benchmark's span around
it): the tracking session's host path (tracking.py), the frame's planning
and enqueue."""


def read(ctx):
    return ctx.span_ms_p50("track.step")
