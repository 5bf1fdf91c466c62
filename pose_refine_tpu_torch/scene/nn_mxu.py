"""Exact nearest-neighbour search with a tensor-core screen ("P1"): the
hand-written CUDA kernel ``csrc/nn_mxu.cu``, its wrapper, and its plain
PyTorch version (PyTorch port of ``scripts/probe_mxu_nn.py``'s
``pack_scene_mxu`` and ``nn_flash_mxu``).

The function is B2's (``scene/nn_flash.py``, ``nn_flash_packed``): for each
query the smallest column among those whose B2 score |s|^2 - 2 q.s (rounded
as B2 rounds it) is minimal, and dist^2 = max(score + |q|^2, 0), bit for
bit. The kernel takes the score as the product of [1, qx, qy, qz] with the
table rows [|s|^2, -2x, -2y, -2z] on the tensor cores (3xTF32), but only as
a screen: every pair whose screened score lies within ``eps_q`` of the
running minimum is scored again with B2's own arithmetic, and the argmin is
taken over those exact scores (the argument is in the .cu source).
``EPS_C`` is the constant of eps_q = EPS_C * (Smax^2 + 2 |q| Smax). The
plain version is B2's plain version on the table's rows 0-3, which are
``pack_scene``'s. It is measured against B2 by ``probes/mxu_nn.py``; the
association keeps B2/B3, as the JAX package does.

The JAX probe's kernel rounds its HIGHEST-precision product otherwise than
B2, so against it P1 agrees up to near-ties: ``near_ties`` checks that every
disagreement of two NN results is two candidates within ``near_tie_band``.

Dispatch: ``nn_flash_mxu`` uses the plain version for CPU tensors and the
kernel for CUDA tensors. There is no fallback from the kernel to the plain
version; a kernel that does not build or launch raises.
"""

from __future__ import annotations

import torch

from pose_refine_tpu_torch._build import launch, load_kernels
from pose_refine_tpu_torch.scene.nn_flash import (BIG, S_CHUNK, _flat, _sum_sq,
                                                   nn_flash_packed_plain, pack_scene)

# kernel launches by nn_flash_mxu_cuda, each the prologue and the scan
# (chip_smoke.py resets and reads it to show the probe went through the
# kernel)
launches = 0
EPS_C = 2.0 ** -16  # csrc/nn_mxu.cu's kC: the screen's margin over M_q
NEAR_TIE_ULPS = 16  # of |q|^2: the disagreement band against the JAX probe


def pack_scene_mxu(scene_pts) -> torch.Tensor:
    """(S, 3) points -> (8, S_pad) table: rows 0-2 x, y, z; row 3 |s|^2;
    rows 4-6 -2x, -2y, -2z; row 7 zero (probe_mxu_nn.py:21-25): pack_scene
    with its zero rows filled, so pad columns keep |s|^2 = BIG."""
    t = pack_scene(scene_pts).clone()
    t[4:7] = -2.0 * t[0:3]
    return t


def nn_flash_mxu_plain(queries, scene_table):
    """Plain PyTorch version on any device: queries (..., 3) -> (idx (...,)
    int32, dist_sq (...,) float32), B2's function (nn_flash_packed_plain)
    on the table's rows 0-3."""
    return nn_flash_packed_plain(queries, scene_table)


def _check_table(scene_table, dev):
    if scene_table.device != dev or scene_table.dtype != torch.float32 \
            or not scene_table.is_contiguous():
        raise ValueError(f"scene_table must be a contiguous float32 tensor on {dev}, "
                         f"got {scene_table.dtype} on {scene_table.device}")
    if scene_table.dim() != 2 or scene_table.shape[0] != 8 or scene_table.shape[1] % S_CHUNK \
            or scene_table.shape[1] == 0:
        raise ValueError(f"scene_table must be (8, S_pad) from pack_scene_mxu, got "
                         f"{tuple(scene_table.shape)}")
    if scene_table.data_ptr() % 16:
        raise ValueError("scene_table must be 16-byte aligned (the kernel copies it 16 bytes "
                         "at a time)")
    if 8 * scene_table.shape[1] >= 2 ** 31:
        raise ValueError(f"too large for int32 sizes: {scene_table.shape[1]} scene columns")


def split_scene_cuda(scene_table):
    """Launch the kernel's prologue on the current stream: the table's
    [|s|^2, -2x, -2y, -2z] split into TF32 (hi, lo) pairs, (S_pad / 128, 4,
    128, 2) int32, and Smax^2 (1,) float32. nn_flash_mxu_cuda runs it
    first; chip_smoke.py times it alone."""
    dev = scene_table.device
    if dev.type != "cuda":
        raise ValueError(f"the nn_mxu kernel needs CUDA tensors, got {dev}")
    _check_table(scene_table, dev)
    s_pad = scene_table.shape[1]
    split = torch.empty((s_pad // S_CHUNK, 4, S_CHUNK, 2), dtype=torch.int32, device=dev)
    smax2 = torch.empty(1, dtype=torch.float32, device=dev)
    launch(load_kernels()[0], "prt_nn_mxu_split", dev,
           (scene_table.data_ptr(), s_pad, split.data_ptr(), smax2.data_ptr()),
           "nn_mxu prologue")
    return split, smax2


def nn_flash_mxu_cuda(flat, scene_table, stats: bool = False):
    """Launch csrc/nn_mxu.cu (the prologue, then the scan) on (Q, 3) CUDA
    queries on the current stream, without synchronising; raises for
    anything it cannot launch. Returns (idx (Q,) int32, dist_sq (Q,)
    float32), and with ``stats`` also each query's re-scored pairs (Q,)
    int32 and the largest |screen - B2 score| / eps_q of its re-scores (Q,)
    float32 (the kernel's instrumented instantiation)."""
    global launches
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError(f"the nn_mxu kernel needs CUDA tensors, got {dev}")
    if scene_table.device != dev or flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError(f"queries must be a contiguous float32 tensor on "
                         f"{scene_table.device}, got {flat.dtype} on {dev}")
    _check_table(scene_table, dev)
    nq, s_pad = flat.shape[0], scene_table.shape[1]
    if nq >= 2 ** 31:
        raise ValueError(f"too large for int32 sizes: {nq} queries")
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    dist = torch.empty(nq, dtype=torch.float32, device=dev)
    rescored = torch.empty(nq, dtype=torch.int32, device=dev) if stats else None
    ratio = torch.empty(nq, dtype=torch.float32, device=dev) if stats else None
    if nq == 0:
        return (idx, dist, rescored, ratio) if stats else (idx, dist)
    split, smax2 = split_scene_cuda(scene_table)
    launch(load_kernels()[0], "prt_nn_mxu", dev,
           (flat.data_ptr(), nq, scene_table.data_ptr(), s_pad, split.data_ptr(),
            smax2.data_ptr(), idx.data_ptr(), dist.data_ptr(),
            None if rescored is None else rescored.data_ptr(),
            None if ratio is None else ratio.data_ptr()), "nn_mxu")
    launches += 1
    return (idx, dist, rescored, ratio) if stats else (idx, dist)


def nn_flash_mxu(queries, scene_table):
    """Exact NN against a pack_scene_mxu table, B2's bits through a
    tensor-core screen: queries (..., 3) -> (idx (...,) int32, dist_sq
    (...,) float32). CUDA: the kernel; CPU: the plain version."""
    flat, shape = _flat(queries)
    if flat.device.type == "cpu":
        return nn_flash_mxu_plain(queries, scene_table)
    idx, dist = nn_flash_mxu_cuda(flat.contiguous(), scene_table)
    return idx.reshape(shape), dist.reshape(shape)


def near_tie_band(queries) -> torch.Tensor:
    """NEAR_TIE_ULPS float32 ULPs of |q|^2 per query (~1e-7 m^2 at 0.3 m):
    the bound on a score's rounding, within which two candidates are a
    near-tie (P1 and B2 against the JAX probe's HIGHEST product)."""
    qq = _sum_sq(_flat(queries)[0])
    return NEAR_TIE_ULPS * (torch.nextafter(qq, torch.full_like(qq, BIG)) - qq)


def near_ties(queries, points, idx_a, dist_a, idx_b, dist_b):
    """Compare two NN results (idx, dist_sq) of the same (Q, 3) queries
    against (S, 3) points: (number of idx disagreements, whether every one
    of them is a near-tie - the two candidates' float64 squared distances
    within near_tie_band - and whether every |dist_sq difference| is within
    the band). Indices index ``points`` (pack columns of real points)."""
    flat = _flat(queries)[0]
    band = near_tie_band(flat).double()
    diff = (idx_a.reshape(-1) != idx_b.reshape(-1)).nonzero()[:, 0]
    pts = torch.as_tensor(points, device=flat.device).double()
    q = flat[diff].double()
    da = ((pts[idx_a.reshape(-1)[diff].long()] - q) ** 2).sum(-1)
    db = ((pts[idx_b.reshape(-1)[diff].long()] - q) ** 2).sum(-1)
    ties_ok = bool(((da - db).abs() <= band[diff]).all())
    dist_ok = bool(((dist_a.reshape(-1).double() - dist_b.reshape(-1).double()).abs()
                    <= band).all())
    return int(diff.numel()), ties_ok, dist_ok
