"""Depth frames for the projective scene table: the kernel of
``csrc/scene_table.cu`` and its plain version
``scene/projective.py::_build_projective_table_plain``.

``frame(kind, h, w, seed)`` is an (h, w) int32 frame in mm made with numpy:

- ``mixed``: a bumpy surface at 300-1,500 mm with a few mm of noise, holes
  of zero depth and a few negative pixels;
- ``steps``: terraces 5 pixels wide whose neighbours at +-5 pixels differ
  by exactly +-49, +-50 or +-51 mm (the inlier gate's edge), in bands;
- ``far``: depths 1,990-2,010 mm (the centre gate at 2,000 and its
  neighbours) beside a block at 3,000-4,000 mm and one at 65,535 mm;
- ``edges``: a tilted plane over the whole frame, so that the border, the
  interior's last rows and columns (dim - 7) and the pixels past them all
  hold depth;
- ``random``: uniform depths in [0, 2,600) mm: every gate both ways.

``SHAPES`` are the frame sizes: the camera's 640 x 480, odd sizes that
leave a ragged tile on both axes, a frame whose interior is one row, one
with no interior, and a sliver thinner than the stencil.
"""

from __future__ import annotations

import numpy as np

KINDS = ("mixed", "steps", "far", "edges", "random")

# name -> (h, w)
SHAPES = {
    "vga": (480, 640),
    "odd": (479, 641),
    "small": (29, 45),
    "one-row": (12, 40),
    "no-interior": (11, 11),
    "sliver": (3, 70),
}

_STEPS = (49, 50, 51, -49, -50)


def frame(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """An (h, w) int32 frame of ``kind`` (module docstring)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "mixed":
        surf = (900 + 400 * np.sin(xx / 37.0 + seed) * np.cos(yy / 29.0)
                + rng.integers(-3, 4, size=(h, w)))
        out = surf.astype(np.int32)
        out[rng.random((h, w)) < 0.05] = 0
        out[rng.random((h, w)) < 0.002] = -300
    elif kind == "steps":
        sx = np.take(_STEPS, (yy // 40 + seed) % len(_STEPS))
        sy = np.take(_STEPS, (xx // 40) % len(_STEPS))
        out = (600 + sx * ((xx // 5) % 6) + sy * ((yy // 5) % 6)).astype(np.int32)
    elif kind == "far":
        out = (1990 + (xx + 3 * yy + seed) % 21).astype(np.int32)
        out[h // 3: h // 2, w // 4: w // 2] = 3000 + rng.integers(0, 1000)
        out[h // 2:, w // 2:][rng.random(out[h // 2:, w // 2:].shape) < 0.5] = 65535
    elif kind == "edges":
        out = (800 + 2 * xx + 3 * yy + seed).astype(np.int32)
    elif kind == "random":
        out = rng.integers(0, 2600, size=(h, w)).astype(np.int32)
    else:
        raise ValueError(f"unknown frame kind {kind!r}; kinds: {KINDS}")
    return np.ascontiguousarray(out, dtype=np.int32)


def stack(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A (len(KINDS), h, w) int32 stack: one frame of each kind."""
    return np.stack([frame(kind, h, w, seed + i) for i, kind in enumerate(KINDS)])
