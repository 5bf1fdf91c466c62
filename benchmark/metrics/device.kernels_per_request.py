"""Device kernels the profiled stretch launched, over its requests."""


def read(ctx):
    return ctx.kernels_per_request()
