"""The inputs a cell hands to the program and to the reference alike, all
made from ``--seed``: the mesh (written as a PLY for the program's loader),
the truth poses, the depth frames rendered by the reference's renderer,
the hypotheses, and a tracked object's closed trajectory."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from reference.geometry import compute_proj, euler_np
from reference.render import render


def _icosphere(subdivisions: int):
    """(unit vertices (V, 3) float64, faces (F, 3) int64): the icosahedron,
    each face split in four ``subdivisions`` times, midpoints on the sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        key = np.sort(edges, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(3, -1)  # midpoint of edges ab, bc, ca of each face
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = m[0], m[1], m[2]
        f = np.concatenate([np.stack(x, 1) for x in
                            ((a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca))])
        v = np.concatenate([v, mid])
    return v, f


def bumpy_sphere(radius: float, subdivisions: int, bump: float):
    """An icosphere with an asymmetric radial modulation (no rotational
    symmetry, so a pose's rotation is observable): (vertices (V, 3)
    float32 mm, faces (F, 3) int32)."""
    v, f = _icosphere(subdivisions)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    mod = 1.0 + bump * (0.6 * np.sin(3.0 * x + 0.7) * np.cos(2.0 * y)
                        + 0.4 * np.sin(4.0 * z + 1.3) * np.cos(1.0 * x))
    return (v * (radius * mod)[:, None]).astype(np.float32), f.astype(np.int32)


def make_mesh(spec: dict):
    if spec["shape"] != "bumpy_sphere":
        raise ValueError(f"unknown mesh shape {spec['shape']!r}")
    return bumpy_sphere(spec["radius_mm"], spec["subdivisions"], spec["bump"])


def write_ply(vertices: np.ndarray, faces: np.ndarray) -> str:
    """The mesh as a binary little-endian PLY in the temporary directory
    (TMPDIR); returns its path. The caller deletes it."""
    fd, path = tempfile.mkstemp(suffix=".ply")
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\nproperty float x\nproperty float y\n"
            f"property float z\nelement face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n").encode()
    rec = np.zeros(len(faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    rec["n"], rec["i"] = 3, faces
    with os.fdopen(fd, "wb") as fh:
        fh.write(head)
        fh.write(np.ascontiguousarray(vertices, "<f4").tobytes())
        fh.write(rec.tobytes())
    return path


def uniform_rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3, 3) rotations uniform on SO(3) (unit quaternions from normals)."""
    q = rng.standard_normal((n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)], 1)


def poses(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = np.zeros(R.shape[:-2] + (4, 4), np.float32)
    out[..., :3, :3], out[..., :3, 3], out[..., 3, 3] = R, t, 1.0
    return out


def truth_poses(rng, n: int, z_mm, xy_mm: float) -> np.ndarray:
    """(n, 4, 4) object poses: rotation uniform, z in z_mm, x and y within
    +-xy_mm."""
    t = np.stack([rng.uniform(-xy_mm, xy_mm, n), rng.uniform(-xy_mm, xy_mm, n),
                  rng.uniform(z_mm[0], z_mm[1], n)], 1)
    return poses(uniform_rotations(rng, n), t)


def perturb(rng, truth: np.ndarray, n: int, rot_deg: float, trans_mm: float) -> np.ndarray:
    """(n, 4, 4) hypotheses around ``truth``: Euler angles uniform within
    +-rot_deg an axis applied on the left, translation +-trans_mm an axis
    (the upstream test's perturbation, test.cpp:29-44)."""
    a = np.radians(rot_deg)
    d_rot = euler_np(rng.uniform(-a, a, (n, 3)))
    d_t = rng.uniform(-trans_mm, trans_mm, (n, 3))
    return poses(d_rot @ truth[:3, :3].astype(np.float64), truth[:3, 3] + d_t)


def trajectory(rng, n: int, z_mm, xy_mm: float, step_rad: float, step_mm: float) -> np.ndarray:
    """(n, 4, 4) truths on a smooth closed loop of n frames: a seeded base
    pose (rotation uniform, centre mid-range), moved by Euler angles and a
    translation that are sinusoids of period n with seeded phases and
    amplitudes, at most step_rad an axis and step_mm an axis per frame, so
    the sequence repeats without a jump."""
    base = uniform_rotations(rng, 1)[0]
    centre = np.array([0.0, 0.0, 0.5 * (z_mm[0] + z_mm[1])])
    w = 2.0 * np.pi / n
    reach = np.array([xy_mm, xy_mm, 0.5 * (z_mm[1] - z_mm[0])])
    amp_r = rng.uniform(0.5, 1.0, 3) * step_rad / w
    amp_t = np.minimum(rng.uniform(0.5, 1.0, 3) * step_mm / w, 0.8 * reach)
    ph_r, ph_t = rng.uniform(0, 2 * np.pi, 3), rng.uniform(0, 2 * np.pi, 3)
    k = np.arange(n)[:, None]
    R = euler_np(amp_r * np.sin(w * k + ph_r)) @ base
    return poses(R, centre + amp_t * np.sin(w * k + ph_t))


def render_frames(vertices, faces, truths, camera: dict, device) -> np.ndarray:
    """(F, H, W) int32 mm frames of the mesh at ``truths``, rendered by the
    reference's renderer on ``device``."""
    tris = torch.as_tensor(vertices[faces], device=device)
    proj = compute_proj(camera["K"], camera["width"], camera["height"])
    out = []
    for p in truths:
        d, _ = render(tris, torch.as_tensor(p[None], device=device), camera["width"],
                      camera["height"], proj)
        out.append(d[0].cpu().numpy())
    return np.stack(out)
