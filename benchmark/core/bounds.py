"""The card's published peaks and the work each kernel's function needs at
given inputs, counted from the inputs and never from a kernel's own tiles,
boxes or walk, so the same work is read whatever implements it. A bound is
the least time the card could take: the larger of the bytes over the HBM
bandwidth and the FP32 operations over the FP32 issue rate."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (700 W): 3.35 TB/s of HBM3, 67 TFLOP/s FP32,
# i.e. 33.5 T FP32 instructions a second with a fused multiply-add as one
HBM_BPS = 3.35e12
FP32_IPS = 67e12 / 2

# B1: the triangle setup a (pose, triangle) - per vertex 3 x 4 camera, 2 x 4
# projection, 2 x 3 screen operations (x 3), the area 7, its reciprocal 1,
# six barycentric coefficients 12, 1/z and its differences 5, the 1/z plane
# 10, the clamped box 16, the degenerate test 7 - and 8 (beta, gamma,
# alpha) for each pixel a triangle covers
RASTER_SETUP_OPS = 3 * 26 + 7 + 1 + 12 + 5 + 10 + 16 + 7
RASTER_PIXEL_OPS = 8
# L1: a compare a pixel of the render, and a kept valid point's z
# (convert, product) and x, y (convert, difference, quotient, product)
LIFT_POINT_OPS = 2 + 2 * 4
# the ICP iteration: the point-to-plane body a point with no fused
# multiply-add (3 differences, 5 residual, 9 cross, 7 weight products,
# 27 products and as many adds, 5 squared distance, 3 more: 86), with the
# projective front end (pcd2dep's 2 divisions, 2 products and 4 sums, the
# gate 3) or the indexed one (the gate 1); 440 a pose-iteration for the
# tail (scores, latch, damped solve, twist, T <- upd @ T); 18 a point for
# a move
BODY_OPS = 86
PROJECTIVE_FRONT_OPS = 11
INDEXED_FRONT_OPS = 1
TAIL_OPS = 440
MOVE_OPS = 18
# the iteration's state read and written a pose: T, fitness, rmse, done
# (and n_total read)
STATE_IN_BYTES, STATE_OUT_BYTES = 64 + 4 + 4 + 1 + 4, 64 + 4 + 4 + 1


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BPS, n_ops / FP32_IPS)


def raster(n_poses: int, n_tris: int, covered: int, out_w: int, out_h: int):
    """(bytes, operations) of one render: the mesh, the poses and the
    projection read once, the int32 framebuffer written once."""
    n_bytes = n_tris * 36 + n_poses * 64 + 64 + n_poses * out_w * out_h * 4
    return n_bytes, RASTER_SETUP_OPS * n_poses * n_tris + RASTER_PIXEL_OPS * covered


def lift(n_poses: int, out_w: int, out_h: int, slots: int, kept_valid: int):
    """(bytes, operations) of one lift: the framebuffer and K read once,
    each kept row (12 + 1 bytes) written once."""
    pixels = n_poses * out_w * out_h
    return pixels * 4 + 36 + n_poses * slots * 13, pixels + LIFT_POINT_OPS * kept_valid


def iterate(n_poses: int, slots: int, launches: int, point_bytes: int, front_ops: int,
            point_iterations: int, pose_iterations: int, point_moves: int):
    """(bytes, operations) of a refine's iteration launches: each launch
    reads the clouds and valid masks (and point_bytes more a point) and
    every pose's state once and writes the state once; the operations of
    the point-iterations and pose-iterations the latch lets run and of the
    points moved."""
    per_launch = n_poses * (slots * (13 + point_bytes) + STATE_IN_BYTES + STATE_OUT_BYTES)
    n_ops = (point_iterations * (front_ops + BODY_OPS) + pose_iterations * TAIL_OPS
             + point_moves * MOVE_OPS)
    return launches * per_launch, n_ops


def nearest(n_queries: int, scene_points: int, launches: int):
    """(bytes, 0) of the nearest-neighbour searches: each launch reads the
    queries and the scene's points once and writes an index and a squared
    distance a query (the normals are the iteration's to read). A
    nearest-neighbour search has no operation count that is independent
    of the method."""
    return launches * (n_queries * 12 + scene_points * 12 + n_queries * 8), 0
