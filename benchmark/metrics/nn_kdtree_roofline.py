"""K1 (scene/nn_kdtree.py, nn_kdtree_staged / nn_kdtree_grid): the bound of the
stretch's nearest-neighbour passes, bytes only (the queries and the scene's
points read once, an index and a distance written a query, each pass) over
K1's profiled time, in percent."""


def read(ctx):
    return ctx.roofline("nn_kdtree")
