"""The ICP iteration kernel (ops/icp_reduce.py, icp_iterate_kernel): the bound
of the stretch's ICP loops (the clouds read once a launch; the point-to-
plane body a point and 440 a pose-iteration at the iterations the
reference's latch counts, 18 a moved point) over the kernel's profiled time,
in percent."""


def read(ctx):
    return ctx.roofline("icp_iterate")
