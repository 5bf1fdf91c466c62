"""B1 (ops/rasterize_cuda.py, bin_kernel + raster_kernel): the bound of the
stretch's renders (core/bounds.py raster: the mesh, poses and projection
read once, the framebuffer written once; 136 operations a (pose, triangle),
8 a covered pixel) over B1's profiled time, in percent."""


def read(ctx):
    return ctx.roofline("rasterize")
