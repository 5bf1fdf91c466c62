"""The scene a frame makes, and the association of source points with it:
the projective scene (the frame's points and LINEMOD normals looked up at
the projected pixel, depth_scene.h:29-48) and the nearest-neighbour scene
(the frame's valid points with their normals, averaged per voxel, searched
exhaustively; pcd_scene.h:61-136). The normals are a frozen copy of the
reference's get_normal (common.cpp:17-107) with its quirks."""

from __future__ import annotations

import numpy as np
import torch

from reference.lift import depth_points

_OFFSETS = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def linemod_normals(depth, K, radius: int = 5, diff: int = 50, far: int = 2000):
    """(H, W) int mm depth -> (H, W, 3) float32 normals, 0 where invalid:
    the 8 neighbours at radius 5 within 50 mm, a 2x2 least-squares plane,
    normal = normalize(fx ddx, fy ddy, -det d); the center gate d < 2000
    (zero depths not excluded) and the interior rows/cols [r, dim - r - 2]."""
    d = torch.as_tensor(depth).to(torch.int32)
    h, w = d.shape
    K = torch.as_tensor(K, dtype=torch.float32, device=d.device)
    pad = torch.nn.functional.pad(d, (radius,) * 4)
    a0 = a1 = a3 = b0 = b1 = torch.zeros_like(d)
    for ox, oy in _OFFSETS:
        dx, dy = ox * radius, oy * radius
        delta = pad[radius + dy:radius + dy + h, radius + dx:radius + dx + w] - d
        f = (delta.abs() < diff).to(torch.int32)
        a0, a1, a3 = a0 + f * dx * dx, a1 + f * dx * dy, a3 + f * dy * dy
        b0, b1 = b0 + f * dx * delta, b1 + f * dy * delta
    det = a0 * a3 - a1 * a1
    nx = K[0, 0] * (a3 * b0 - a1 * b1).to(torch.float32)
    ny = K[1, 1] * (-a1 * b0 + a0 * b1).to(torch.float32)
    nz = -det.to(torch.float32) * d.to(torch.float32)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    row = torch.arange(h, device=d.device)[:, None]
    col = torch.arange(w, device=d.device)[None, :]
    ok = ((d < far) & (norm > 0) & (row >= radius) & (row < h - radius - 1)
          & (col >= radius) & (col < w - radius - 1))
    inv = torch.where(ok, 1.0 / torch.where(norm > 0, norm, torch.ones_like(norm)),
                      torch.zeros_like(norm))
    return torch.stack([nx * inv, ny * inv, nz * inv], -1)


class ProjectiveScene:
    """The frame's point and normal images; ``query`` projects a point with
    pcd2dep's trunc(v + 0.5), bounds-checks the pixel and gates on scene z
    > 0 and |src.z - dst.z| <= max_dist."""

    def __init__(self, depth, K, max_dist: float):
        depth = torch.as_tensor(depth)
        self.h, self.w = depth.shape
        pts, _ = depth_points(depth, K)
        self.table = torch.cat([pts.reshape(-1, 3), linemod_normals(depth, K).reshape(-1, 3)], 1)
        self.K = torch.as_tensor(K, dtype=torch.float32, device=depth.device)
        self.max_dist = max_dist

    def query(self, src):
        K = self.K
        x = torch.trunc(src[..., 0] / src[..., 2] * K[0, 0] + K[0, 2] + 0.5)
        y = torch.trunc(src[..., 1] / src[..., 2] * K[1, 1] + K[1, 2] + 0.5)
        x = torch.nan_to_num(x, nan=-1.0, posinf=-1.0, neginf=-1.0)
        y = torch.nan_to_num(y, nan=-1.0, posinf=-1.0, neginf=-1.0)
        inb = (x >= 0) & (x < self.w) & (y >= 0) & (y < self.h)
        lin = (y.clamp(0, self.h - 1).to(torch.int64) * self.w
               + x.clamp(0, self.w - 1).to(torch.int64))
        rows = self.table[lin]
        dst, nrm = rows[..., 0:3], rows[..., 3:6]
        ok = inb & (dst[..., 2] > 0) & ((src[..., 2] - dst[..., 2]).abs() <= self.max_dist)
        return dst, nrm, ok


def voxel_average(points: np.ndarray, normals: np.ndarray, voxel_m: float):
    """Centroid point and renormalised mean normal per voxel of edge
    voxel_m, voxels from the cloud's minimum corner (float64 sums)."""
    p, n = np.asarray(points, np.float64), np.asarray(normals, np.float64)
    cell = np.floor((p - p.min(0)) / voxel_m).astype(np.int64)
    key = (cell[:, 0] << 42) | (cell[:, 1] << 21) | cell[:, 2]
    _, inverse = np.unique(key, return_inverse=True)
    m = inverse.max() + 1
    cnt = np.bincount(inverse, minlength=m).astype(np.float64)
    ps = np.stack([np.bincount(inverse, p[:, i], m) for i in range(3)], 1) / cnt[:, None]
    ns = np.stack([np.bincount(inverse, n[:, i], m) for i in range(3)], 1)
    norm = np.linalg.norm(ns, axis=1, keepdims=True)
    ns = np.where(norm > 1e-12, ns / np.maximum(norm, 1e-12), ns)
    return ps.astype(np.float32), ns.astype(np.float32)


class NearestScene:
    """The frame's valid points and normals (voxel-averaged when voxel_mm >
    0); ``query`` finds each source point's exact nearest scene point (the
    squared distances in float64, ties to the lower index) and gates on
    its float32 squared distance < max_dist^2."""

    def __init__(self, depth, K, max_dist: float, voxel_mm: float = 0.0,
                 chunk: int = 1 << 14):
        depth = torch.as_tensor(depth)
        # built on the host in IEEE float32, as the scene's statement has
        # it: a CUDA tensor divided by a number is multiplied by its
        # reciprocal, a last-bit change that moves points across voxel
        # edges
        host = depth.cpu()
        pts, mask = depth_points(host, K)
        nrm = linemod_normals(host, K)
        p, n = pts[mask].numpy(), nrm[mask].numpy()
        if voxel_mm > 0:
            p, n = voxel_average(p, n, voxel_mm / 1000.0)
        self.points = torch.as_tensor(p, device=depth.device)
        self.normals = torch.as_tensor(n, device=depth.device)
        self._p64 = self.points.double()
        self._sq = (self._p64 ** 2).sum(1)
        g = np.float32(max_dist)
        self.gate_sq = float(g * g)
        self.chunk = chunk

    def nearest(self, src):
        flat = src.reshape(-1, 3)
        idx = torch.empty(flat.shape[0], dtype=torch.int64, device=flat.device)
        for s in range(0, flat.shape[0], self.chunk):
            q = flat[s:s + self.chunk].double()
            d2 = (q ** 2).sum(1, keepdim=True) - 2.0 * q @ self._p64.T + self._sq[None]
            idx[s:s + self.chunk] = d2.argmin(1)
        return idx.reshape(src.shape[:-1])

    def query(self, src):
        idx = self.nearest(src)
        dst, nrm = self.points[idx], self.normals[idx]
        e = dst - src
        ok = (e * e).sum(-1) < self.gate_sq
        return dst, nrm, ok
