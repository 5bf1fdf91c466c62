"""Edge inputs for the raster kernel (``csrc/rasterize.cu``): small meshes
whose triangles sit where the kernel's tiling, culling and per-triangle
setup change hands.

The kernel culls the union boxes of 256 and 32 consecutive triangles
against a 32x32 screen tile, then each triangle's own box; a warp walks the
pixels of its 32 triangles' boxes together, whatever their sizes.
``cases()`` gives, at 160x120 with the LINEMOD camera scaled by 1/4:

  * ``mixed``: a Morton-ordered icosphere plus a triangle wider than the
    frame, 1-pixel triangles on tile boundaries, boxes across the ROI's
    edges, zero-area padding rows (a repeated vertex, as MultiModelRefiner
    pads), a NaN vertex, an infinite vertex and a vertex behind the camera
    - 333 triangles, not a multiple of the 32-triangle block;
  * ``crowded``: 300 overlapping triangles of ~40 pixels a side, boxes
    that fill whole tiles next to small ones in the same warp;
  * ``empty``: every triangle off screen or degenerate.

Each case has one pose (N = 1) and three (N = 3); the meshes are in camera
coordinates, so the first pose is the identity. Everything is made with
numpy from fixed seeds.
"""

from __future__ import annotations

import numpy as np

WIDTH, HEIGHT = 160, 120
ROI = (40, 20, 64, 48)  # crosses tile and frame boundaries of the render
_LINEMOD_K = np.array([[572.4114, 0.0, 325.2611],
                       [0.0, 573.57043, 242.04899],
                       [0.0, 0.0, 1.0]], np.float32)


def camera_k() -> np.ndarray:
    """The LINEMOD intrinsics at 160x120."""
    k = _LINEMOD_K.copy()
    k[:2] *= 0.25
    return k


def _at(u, v, z):
    """The camera-space point that projects near pixel (u, v) at depth z."""
    k = camera_k()
    return [(u - k[0, 2]) * z / k[0, 0], (v - k[1, 2]) * z / k[1, 1], z]


def _icosphere(radius=40.0, subdivisions=2, z=300.0):
    from pose_refine_tpu_torch import mesh

    m = mesh.make_icosphere(radius=radius, subdivisions=subdivisions)
    tris = m.tris[mesh.morton_order(m.tris)] + np.float32([0, 0, z])
    return tris.astype(np.float32)


def _mixed():
    tris = [_icosphere()]
    extra = [
        # wider than the frame, near the camera plane
        [[-400.0, -300.0, 60.0], [400.0, -300.0, 60.0], [0.0, 400.0, 60.0]],
        # 1-pixel triangles at tile corners (x, y = 31 | 32, 63 | 64)
        [_at(31.6, 31.6, 250.0), _at(32.4, 31.6, 250.0), _at(32.0, 32.4, 250.0)],
        [_at(63.5, 64.2, 250.0), _at(64.5, 64.2, 250.0), _at(64.0, 63.4, 250.0)],
        [_at(95.9, 10.1, 250.0), _at(96.3, 10.1, 250.0), _at(96.1, 10.6, 250.0)],
        # boxes across the ROI's left / right / top / bottom edges
        [_at(35.0, 40.0, 280.0), _at(45.0, 42.0, 280.0), _at(38.0, 50.0, 280.0)],
        [_at(100.0, 30.0, 280.0), _at(110.0, 33.0, 280.0), _at(101.0, 39.0, 280.0)],
        [_at(60.0, 16.0, 280.0), _at(70.0, 24.0, 280.0), _at(64.0, 25.0, 280.0)],
        [_at(70.0, 64.0, 280.0), _at(80.0, 72.0, 280.0), _at(71.0, 73.0, 280.0)],
        # zero-area padding rows: the first vertex repeated
        [[0.0, 0.0, 300.0]] * 3,
        [[5.0, -3.0, 290.0]] * 3,
        # a NaN vertex, an infinite one, a vertex behind the camera
        [[np.nan, 0.0, 300.0], [10.0, 0.0, 300.0], [0.0, 10.0, 300.0]],
        [[np.inf, 0.0, 300.0], [10.0, 5.0, 300.0], [0.0, 10.0, 300.0]],
        [[-20.0, -10.0, 300.0], [20.0, -5.0, 300.0], [0.0, 15.0, -50.0]],
    ]
    return np.concatenate([tris[0], np.asarray(extra, np.float32)]).astype(np.float32)


def _crowded():
    rng = np.random.default_rng(5)
    centre = np.asarray(_at(80.0, 60.0, 300.0), np.float32)
    side = 40.0 * 300.0 / camera_k()[0, 0]  # ~40 pixels in camera units
    base = rng.uniform(-0.5, 0.5, (300, 3, 2)) * side
    z = rng.uniform(280.0, 320.0, (300, 1, 1)).repeat(3, 1)
    return np.concatenate([centre[:2] + base, z], -1).astype(np.float32)


def _empty():
    tris = _icosphere(radius=10.0, subdivisions=1, z=300.0) + np.float32([5000.0, 0, 0])
    flat = np.zeros((7, 3, 3), np.float32)  # zero-area rows
    return np.concatenate([tris, flat]).astype(np.float32)


def _poses(n: int) -> np.ndarray:
    """The identity, then small rotations and shifts (seed 3)."""
    from pose_refine_tpu_torch import geometry

    rng = np.random.default_rng(3)
    out = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        r = geometry.euler_to_rotation(rng.uniform(-0.05, 0.05, 3).astype(np.float32)).numpy()
        out.append(geometry.pose_from_Rt(r, rng.uniform(-5, 5, 3).astype(np.float32)).numpy())
    return np.stack(out).astype(np.float32)


def cases():
    """{name: (tris (T, 3, 3), poses (N, 4, 4))} for N = 1 and N = 3:
    names ``<case>-n1`` and ``<case>-n3``."""
    meshes = {"mixed": _mixed(), "crowded": _crowded(), "empty": _empty()}
    return {f"{name}-n{n}": (tris, _poses(n)) for name, tris in meshes.items() for n in (1, 3)}
