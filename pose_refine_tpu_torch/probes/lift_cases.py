"""Render batches and shapes for the window lift L1 (``csrc/lift.cu``) and
its plain version ``ops.depth_to_cloud.window_lift``.

``renders(h, w, seed)`` is an (8, h, w) int32 batch made with numpy: a blob
in the middle, an empty render (r0 = h, r1 = -1), a blob clipped by the
top-left corner, one clipped by the bottom-right corner, two blobs at
opposite corners with holes and negative pixels (a wide box with invalid
slots inside the window), a render covered everywhere (every slot valid),
one pixel, and a one-row stripe. Every valid pixel's depth is unique in its
render (200 + its flat index), so a lifted z names its pixel.

``SHAPES`` are the lift's regimes: a power-of-two P (the hash is a
bijection), P with colliding ranks, P <= max_points (no selection), a
window taller than the render, arrays in shared memory above 48 KB, and
arrays in the wrapper's scratch (P = 57,600, the auto window of a 640x480
render at stride 2; P = 65,536, window 256 at stride 1).
"""

from __future__ import annotations

import numpy as np

# name -> (h, w, window, stride, max_points, (tl_x, tl_y))
SHAPES = {
    "p4096": (160, 200, 128, 2, 2048, (8, 4)),
    "p2500": (120, 160, 100, 2, 700, (0, 0)),
    "p2304-k1000": (120, 160, 96, 2, 1000, (3, 0)),
    "p2304-all": (120, 160, 96, 2, 4096, (8, 4)),
    "narrow": (60, 160, 96, 2, 500, (8, 4)),
    "p10000": (240, 320, 200, 2, 3000, (4, 8)),
    "p57600": (480, 640, 480, 2, 8192, (0, 0)),
    "p65536": (256, 320, 256, 1, 32768, (0, 0)),
}


def _blob(out, yy, xx, cy, cx, ry, rx):
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    out[inside] = 1
    return out


def renders(h: int, w: int, seed: int = 0) -> np.ndarray:
    """The (8, h, w) int32 batch described in the module's note."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    mask = np.zeros((8, h, w), np.int32)
    _blob(mask[0], yy, xx, h * rng.uniform(0.4, 0.6), w * rng.uniform(0.4, 0.6), h / 4, w / 5)
    # mask[1] stays empty
    _blob(mask[2], yy, xx, h * 0.1, w * 0.05, h / 3, w / 4)
    _blob(mask[3], yy, xx, h * 0.95, w * 0.9, h / 3, w / 4)
    _blob(mask[4], yy, xx, h * 0.2, w * 0.2, h / 6, w / 6)
    _blob(mask[4], yy, xx, h * 0.8, w * 0.85, h / 6, w / 6)
    mask[4] &= (rng.uniform(size=(h, w)) > 0.3).astype(np.int32)
    mask[5] = 1
    mask[6, h // 3, w // 2] = 1
    mask[7, h // 2, w // 5: w - w // 5] = 1
    depth = np.where(mask > 0, 200 + np.arange(h * w, dtype=np.int32).reshape(h, w), 0)
    # pixels below zero are invalid, as pixels of zero are
    neg = (mask[4] == 0) & (rng.uniform(size=(h, w)) < 0.05)
    depth[4][neg] = -5
    return depth.astype(np.int32)
