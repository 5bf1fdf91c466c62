"""Exact nearest-neighbour search with the score as a matrix product ("P1"):
the hand-written CUDA kernel ``csrc/nn_mxu.cu``, its wrapper, and its plain
PyTorch version (PyTorch port of ``scripts/probe_mxu_nn.py``'s
``pack_scene_mxu`` and ``nn_flash_mxu``).

The score |s|^2 - 2 q.s of B2 (``scene/nn_flash.py``) is the product of
[1, qx, qy, qz] with the table rows [|s|^2, -2x, -2y, -2z]; the kernel takes
it on the tensor cores (3xTF32, see the note in the .cu source), keeps the
smallest score per query and, of equal scores, the smallest index. It is
measured against B2 by ``probes/mxu_nn.py``; the association keeps B2/B3,
as the JAX package does.

Its scores round otherwise than any fixed float32 expression, so it meets
its plain version (the product in float64, rounded once to float32) and B2
up to near-ties: where two scene points' squared distances to a query lie
within ``near_tie_band`` of each other, either may win, and the reported
dist^2 may differ by as much. ``near_ties`` checks that every disagreement
is one.

Dispatch: ``nn_flash_mxu`` uses the plain version for CPU tensors and the
kernel for CUDA tensors. There is no fallback from the kernel to the plain
version; a kernel that does not build or launch raises.
"""

from __future__ import annotations

import torch

from pose_refine_tpu_torch.scene.nn_flash import BIG, _flat, _sum_sq, pack_scene

# kernel launches by nn_flash_mxu_cuda (chip_smoke.py resets and reads it to
# show the probe went through the kernel)
launches = 0
NEAR_TIE_ULPS = 16  # of |q|^2: the disagreement band of kernel, plain and B2


def pack_scene_mxu(scene_pts) -> torch.Tensor:
    """(S, 3) points -> (8, S_pad) table: rows 0-2 x, y, z; row 3 |s|^2;
    rows 4-6 -2x, -2y, -2z; row 7 zero (probe_mxu_nn.py:21-25): pack_scene
    with its zero rows filled, so pad columns keep |s|^2 = BIG."""
    t = pack_scene(scene_pts).clone()
    t[4:7] = -2.0 * t[0:3]
    return t


def nn_flash_mxu_plain(queries, scene_table):
    """Plain PyTorch version on any device: queries (..., 3) -> (idx (...,)
    int32, dist_sq (...,) float32). The score [1, q] . table[3:7] is taken
    in float64 and rounded once to float32; the first index among equal
    scores wins; dist_sq = max(score + |q|^2, 0)."""
    flat, shape = _flat(queries)
    n_s = scene_table.shape[1]
    budget = 1 << 27 if flat.device.type == "cuda" else 1 << 20
    step = max(1, budget // max(n_s, 1))
    b = scene_table[3:7].double()
    best = torch.empty(flat.shape[0], dtype=torch.float32, device=flat.device)
    idx = torch.empty(flat.shape[0], dtype=torch.int64, device=flat.device)
    for a in range(0, flat.shape[0], step):
        q = flat[a:a + step].double()
        lhs = torch.cat([torch.ones_like(q[:, :1]), q], dim=1)
        best[a:a + step], idx[a:a + step] = (lhs @ b).float().min(dim=1)
    dist = torch.clamp(best + _sum_sq(flat), min=0.0)
    return idx.to(torch.int32).reshape(shape), dist.reshape(shape)


def nn_flash_mxu_cuda(flat, scene_table):
    """Launch csrc/nn_mxu.cu on (Q, 3) CUDA queries on the current stream,
    without synchronising; raises for anything it cannot launch."""
    global launches
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError(f"the nn_mxu kernel needs CUDA tensors, got {dev}")
    for name, t in (("queries", flat), ("scene_table", scene_table)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if scene_table.dim() != 2 or scene_table.shape[0] != 8 or scene_table.shape[1] % 128 \
            or scene_table.shape[1] == 0:
        raise ValueError(f"scene_table must be (8, S_pad) from pack_scene_mxu, got "
                         f"{tuple(scene_table.shape)}")
    nq, s_pad = flat.shape[0], scene_table.shape[1]
    if nq >= 2 ** 31 or 8 * s_pad >= 2 ** 31:
        raise ValueError(f"too large for int32 sizes: {nq} queries, {s_pad} scene columns")
    from pose_refine_tpu_torch._build import load_kernels

    lib, _info = load_kernels()
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    dist = torch.empty(nq, dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, dist
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prt_nn_mxu(flat.data_ptr(), nq, scene_table.data_ptr(), s_pad,
                             idx.data_ptr(), dist.data_ptr(), stream)
    if err != 0:
        msg = lib.prt_error_string(err).decode()
        raise RuntimeError(f"nn_mxu kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return idx, dist


def nn_flash_mxu(queries, scene_table):
    """Exact NN against a pack_scene_mxu table, the score as a matrix
    product: queries (..., 3) -> (idx (...,) int32, dist_sq (...,)
    float32). CUDA: the kernel; CPU: the plain version."""
    flat, shape = _flat(queries)
    if flat.device.type == "cpu":
        return nn_flash_mxu_plain(queries, scene_table)
    idx, dist = nn_flash_mxu_cuda(flat.contiguous(), scene_table)
    return idx.reshape(shape), dist.reshape(shape)


def near_tie_band(queries) -> torch.Tensor:
    """NEAR_TIE_ULPS float32 ULPs of |q|^2 per query (~1e-7 m^2 at 0.3 m):
    the bound on the score's rounding, within which two candidates are a
    near-tie."""
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
