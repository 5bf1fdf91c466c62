"""Tie-stress inputs for the flash-NN kernels (``csrc/nn_flash.cu``): small
scene tables and queries whose minimal score is reached by several columns,
placed where the kernel's scan changes hands.

The kernel scores a chunk of 128 columns in four warp parts of 32, each in
groups of 16, keeps a running minimum per group and finds the index
afterwards; of equal scores it must return the smallest column, as the
plain versions (``scene.nn_flash``) do. ``cases()`` puts equal columns on
both sides of a group boundary (columns 15 | 16), a warp part's boundary
(31 | 32), a chunk boundary (127 | 128) and in distant chunks, and adds
queries equidistant from several lattice points, scores of +0 and -0, a
scene of one chunk that is mostly pad columns, and query counts that leave
a partial last tile. Everything is made with numpy from fixed seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from pose_refine_tpu_torch.scene import nn_flash as NF

GATE_M = 10.0  # a gate that holds every query of every case


def _random():
    rng = np.random.default_rng(0)
    s = (rng.normal(size=(1000, 3)) * 0.1 + [0, 0, 0.3]).astype(np.float32)
    q = (rng.normal(size=(1100, 3)) * 0.1 + [0, 0, 0.3]).astype(np.float32)
    return NF.pack_scene(s), q


def _duplicates():
    rng = np.random.default_rng(1)
    s = (rng.normal(size=(700, 3)) * 0.05 + [0, 0, 0.3]).astype(np.float32)
    # (copy, original): across a group, a warp part and a chunk boundary,
    # in another warp part of a distant chunk, in the same part of another
    # chunk, and three of a kind
    pairs = [(16, 15), (32, 31), (128, 127), (300, 5), (643, 3), (71, 7), (500, 7)]
    for dup, src in pairs:
        s[dup] = s[src]
    at = s[[i for pair in pairs for i in pair]]
    q = np.concatenate([at, at + rng.normal(0, 1e-4, at.shape),
                        rng.normal(size=(333 - 2 * len(at), 3)) * 0.05 + [0, 0, 0.3]])
    return NF.pack_scene(s), q.astype(np.float32)


def _equidistant():
    """A shuffled lattice of spacing 2^-6 (coordinates and products exact in
    float32) with queries at edge midpoints and cell centres: 2- and 8-way
    ties of the true distance, most of them ties of the rounded score."""
    rng = np.random.default_rng(2)
    g = np.stack(np.meshgrid(np.arange(10), np.arange(10), np.arange(7), indexing="ij"), -1)
    lattice = g.reshape(-1, 3).astype(np.float32) / 64.0
    s = lattice[rng.permutation(len(lattice))]
    mids = lattice[rng.integers(0, len(lattice), 300)] + np.float32([1 / 128.0, 0, 0])
    centres = lattice[rng.integers(0, len(lattice), 301)] + np.float32(1 / 128.0)
    return NF.pack_scene(s), np.concatenate([mids, centres]).astype(np.float32)


def _zeros():
    """Far columns (scores > 0 for every query) and, at the boundaries,
    columns at the origin with signed zeros in x, y, z and |s|^2: their
    scores are +0 or -0 by the signs, equal as numbers, so the smallest
    such column must win whatever its sign."""
    rng = np.random.default_rng(3)
    tab = np.zeros((8, 256), np.float32)
    tab[:3] = rng.uniform(1.0, 2.0, (3, 256))
    tab[3] = (tab[:3] ** 2).sum(0)
    for col in (15, 16, 31, 32, 127, 128, 200):
        tab[:4, col] = np.where(rng.random(4) < 0.5, -0.0, 0.0)
    q = rng.uniform(-0.1, 0.1, (200, 3))
    q[:50] = np.abs(q[:50])
    q[50:100] = -np.abs(q[50:100])
    return torch.as_tensor(tab), q.astype(np.float32)


def _one_chunk():
    rng = np.random.default_rng(4)
    s = (rng.normal(size=(50, 3)) * 0.05).astype(np.float32)
    s[40] = s[2]
    q = np.concatenate([s[[2, 40]], rng.normal(size=(128, 3)) * 0.05])
    return NF.pack_scene(s), q.astype(np.float32)


def cases():
    """{name: (scene table (8, S_pad) float32 CPU tensor, queries (Q, 3)
    float32 CPU tensor)}; every Q is even (two poses for a stacked launch)
    and leaves a partial last 128-query tile."""
    made = {"random": _random(), "duplicates": _duplicates(), "equidistant": _equidistant(),
            "zeros": _zeros(), "one_chunk_pads": _one_chunk()}
    return {name: (tab.contiguous(), torch.as_tensor(q[: len(q) // 2 * 2]))
            for name, (tab, q) in made.items()}


def stacked(table: torch.Tensor) -> torch.Tensor:
    """A two-frame stack of a case's table: the table, then its columns in
    reverse order, so that a tie resolves to another column in frame 1."""
    return torch.cat([table, table.flip(1)], dim=1).contiguous()
