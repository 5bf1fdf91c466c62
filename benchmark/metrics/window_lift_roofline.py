"""L1 (ops/lift_cuda.py, window_lift_kernel): the bound of the stretch's lifts
(the framebuffer read once, the clouds written once) over L1's profiled
time, in percent."""


def read(ctx):
    return ctx.roofline("window_lift")
