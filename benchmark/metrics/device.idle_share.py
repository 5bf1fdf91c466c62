"""Percent of the profiled stretch's wall in which no operation ran on a card
(kernels, copies and sets, from the profiler's trace), the mean over the
cards used."""


def read(ctx):
    return ctx.idle_share()
