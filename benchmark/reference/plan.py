"""What a refiner derives before it renders, worked out again: the
decimated hypothesis mesh and the per-frame render ROI. Frozen copies of
the program's stated rules (vertex clustering on a grid keyed by the
vertex normal's octant; the auto ROI: the observed object's box in render
pixels, a margin of 0.35 x its extent + 16, the width a multiple of 128
and the height of 8, kept while the object stays a guard margin inside)."""

from __future__ import annotations

import numpy as np


def decimate(vertices: np.ndarray, faces: np.ndarray, cell: float) -> np.ndarray:
    """(F', 3, 3) float32 triangles of the mesh clustered on a ``cell`` mm
    grid: each cluster's vertices (same cell, same normal octant) merged to
    their centroid, collapsed faces dropped."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    c = np.maximum(np.floor((v - v.min(0)) / float(cell)).astype(np.int64), 0)
    key = (c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for corner in range(3):
        np.add.at(vn, f[:, corner], fn)
    octant = ((vn[:, 0] >= 0).astype(np.int64) | ((vn[:, 1] >= 0).astype(np.int64) << 1)
              | ((vn[:, 2] >= 0).astype(np.int64) << 2))
    uniq, inverse = np.unique((key << 3) | octant, return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inverse, v)
    verts = (sums / np.bincount(inverse, minlength=len(uniq))[:, None]).astype(np.float32)
    g = inverse[f]
    keep = (g[:, 0] != g[:, 1]) & (g[:, 1] != g[:, 2]) & (g[:, 0] != g[:, 2])
    return verts[g[keep]]


class RoiPlanner:
    """The ROI a refiner renders its hypotheses in, frame after frame
    (render pixels, (x, y, w, h)), with its hysteresis."""

    def __init__(self, width: int, height: int, scale: int, margin: float = 0.35):
        self.rw, self.rh, self.s, self.margin = width // scale, height // scale, scale, margin
        self.roi = (0, 0, 0, 0)

    def _fits(self, ys, xs) -> bool:
        if self.roi == (0, 0, 0, 0):
            return False
        if len(xs) == 0:
            return True
        s = self.s
        x0, y0, w, h = self.roi
        extent = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        guard = max(12, (int(self.margin * extent) + 16) // 2)
        return (int(xs.min()) // s - guard >= x0 and int(ys.min()) // s - guard >= y0
                and int(xs.max()) // s + guard <= x0 + w and int(ys.max()) // s + guard <= y0 + h)

    def _compute(self, ys, xs):
        if len(xs) == 0:
            return (0, 0, 0, 0)
        s = self.s
        extent = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        mx = int(self.margin * extent) + 16
        x0, y0 = max(int(xs.min()) // s - mx, 0), max(int(ys.min()) // s - mx, 0)
        x1, y1 = min(int(xs.max()) // s + mx, self.rw), min(int(ys.max()) // s + mx, self.rh)
        w = min(-(-(x1 - x0) // 128) * 128, self.rw)
        h = min(-(-(y1 - y0) // 8) * 8, self.rh)
        return (min(x0, self.rw - w), min(y0, self.rh - h), w, h)

    def observe(self, frame: np.ndarray):
        """Plan for an (H, W) mm frame; returns the ROI its refine renders in."""
        ys, xs = np.nonzero(np.asarray(frame) > 0)
        if not self._fits(ys, xs):
            self.roi = self._compute(ys, xs)
        return self.roi
