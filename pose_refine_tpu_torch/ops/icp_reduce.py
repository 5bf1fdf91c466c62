"""One ICP pass in one launch: the association lookup and the reduction to
the 29 packed normal-equation sums of every pose - the hand-written CUDA
kernel ``csrc/icp_reduce.cu``, its wrappers, and its plain PyTorch version.

The port's own kernel: the counterpart of the reference's transform_reduce
over thrust__pcd2Ab (icp.h:125-209) and of the JAX package's
``_normal_equations_packed`` (icp.py:215-238) with the scene query inlined.
Per pose, over its P points, with ``v = q_valid & valid``, ``diff = dst -
p``, ``b = diff . n`` and ``a = [p x n, n] * v``:

    sums = sum_p [a_i a_j (21, upper triangle, row-major) | a (b v) (6)
                  | |diff|^2 v | v]                                -> (29,)

in the JAX order (AtA 0..20, Atb 21..26, mse 27, count 28). Two front ends
find ``dst``, ``n`` and ``q_valid``: the projective one projects the point
to a pixel of the scene table (scene/projective.py), the indexed one takes
the flash-NN kernels' index and dist^2 (scene/nn.py).

The association, and so the count, equals the plain version's exactly. The
other 28 sums are float32 in the kernel's own fixed order (thread, warp
butterfly, warps, the pose's CTAs), which is neither a matrix product's nor
``torch.sum``'s, so they differ from those in their last bits. The plain
version (``assoc_reduce_plain``) rounds every term and takes every add in
that same order: kernel and plain version agree bit for bit, as do two
launches on equal inputs, and a refine through the plain versions is the
same refine.

The ``_cuda`` entry points launch the kernel and raise for CPU tensors;
there is no fallback from the kernel to the plain version, and a kernel that
does not build or launch raises. The ICP loop (icp.py) takes the plain
formulations for CPU tensors itself.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from pose_refine_tpu_torch.ops.gather import ROW

PACKED = 29  # floats per pose: 21 AtA + 6 Atb + mse + count
# jnp.triu_indices(6): the upper triangle of AtA, row-major
_IU, _JU = (list(t) for t in zip(*((i, j) for i in range(6) for j in range(i, 6))))
KERNEL_THREADS = 256  # csrc/icp_reduce.cu kThreads
MAX_SLABS = 8         # csrc/icp_reduce.cu kMaxSlabs, the portable cluster size
FILL_CTAS = 132       # the H100's SMs: poses are split until as many CTAs run

# kernel launches by the _cuda entry points (chip_smoke.py resets and reads
# it to show the main path went through the kernel)
launches = 0


def packed_terms(cloud, valid, dst, nrm, q_valid) -> torch.Tensor:
    """The 29-float vector of every point from a given association, on any
    device and in the clouds' dtype: (..., P, 3) clouds, (..., P) valid, the
    query's (dst, normal, valid) -> (..., P, 29). Every term is multiplied
    by ``q_valid & valid``. One rounded operation a torch call, in the order
    the kernel's body writes them (no fused multiply-add in either), so the
    float32 terms equal the kernel's bit for bit."""
    v = (q_valid & valid).to(cloud.dtype)
    px, py, pz = cloud.unbind(dim=-1)
    nx, ny, nz = nrm.unbind(dim=-1)
    dx, dy, dz = (dst - cloud).unbind(dim=-1)
    bv = ((dx * nx + dy * ny) + dz * nz) * v
    row = [(py * nz - pz * ny) * v, (pz * nx - px * nz) * v, (px * ny - py * nx) * v,
           nx * v, ny * v, nz * v]
    return torch.stack(
        [row[i] * row[j] for i, j in zip(_IU, _JU)] + [r * bv for r in row]
        + [((dx * dx + dy * dy) + dz * dz) * v, v], dim=-1)


def ordered_sum(terms: torch.Tensor) -> torch.Tensor:
    """(..., P, 29) terms -> (..., 29) sums in the kernel's order, one
    float add a step: a pose's points split into slabs_for(poses, P) slabs;
    in a slab, thread t of 256 adds points t, t + 256, ... in rising order;
    a warp's 32 sums merge by halving (what lane 0 of the kernel's xor
    butterfly holds); the 8 warps are added in warp order; the slabs in slab
    order. Float32 terms give the kernel's float32 sums bit for bit."""
    lead, (p, k) = terms.shape[:-2], terms.shape[-2:]
    terms = terms.reshape(-1, p, k)
    n = terms.shape[0]
    slabs = slabs_for(n, p)
    per_slab = -(-p // slabs)
    total = None
    for s in range(slabs):
        seg = terms[:, s * per_slab:min((s + 1) * per_slab, p)]
        seg = torch.nn.functional.pad(seg, (0, 0, 0, (-seg.shape[1]) % KERNEL_THREADS))
        seg = seg.reshape(n, -1, KERNEL_THREADS // 32, 32, k)
        acc = torch.zeros_like(seg[:, 0])
        for step in range(seg.shape[1]):
            acc = acc + seg[:, step]
        for half in (16, 8, 4, 2, 1):
            acc = acc[:, :, :half] + acc[:, :, half:2 * half]
        cta = torch.zeros_like(acc[:, 0, 0])
        for w in range(acc.shape[1]):
            cta = cta + acc[:, w, 0]
        total = cta if total is None else total + cta
    return total.reshape(lead + (k,))


def packed_sums_plain(cloud, valid, dst, nrm, q_valid) -> torch.Tensor:
    """The packed formulation from a given association: (..., 29) sums of
    packed_terms over the points, in the kernel's order (ordered_sum)."""
    return ordered_sum(packed_terms(cloud, valid, dst, nrm, q_valid))


def sums_error(sums, cloud, valid, dst, nrm, q_valid):
    """How far float32 (..., 29) ``sums`` lie from the float64 sums of the
    same association: (count_equal, worst |sum - sum64| / (sum64 of |terms|)
    over the 28 float sums). A sum that is not finite in float64 (a masked
    point with a non-finite coordinate) must be non-finite in ``sums`` too,
    else the error is inf. The yardstick chip_smoke.py and the tests hold
    the kernel and the plain version to."""
    terms = packed_terms(cloud.double(), valid, dst.double(), nrm.double(), q_valid)
    want, scale = terms.sum(dim=-2), terms.abs().sum(dim=-2)
    count_equal = torch.equal(sums[..., 28].double(), want[..., 28])
    finite = torch.isfinite(want)
    err = (sums.double() - want).abs() / scale.clamp(min=1e-300)
    err = torch.where(finite, err, torch.where(torch.isfinite(sums), torch.inf, 0.0))
    return count_equal, float(err[..., :28].nan_to_num(nan=torch.inf).max())


def assoc_reduce_plain(cloud, valid, query: Callable) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: the scene query's
    plain version (``query``: src -> (dst, normal, valid), e.g.
    ``functools.partial(scene.query, plain=True)``) followed by the packed
    formulation, term by term and add by add in the kernel's order: equal
    to the kernel bit for bit. (..., P, 3) clouds -> (..., 29)."""
    return packed_sums_plain(cloud, valid, *query(cloud))


@functools.lru_cache(maxsize=None)
def _ata_index(device: torch.device) -> torch.Tensor:
    """(36,) int64 on ``device``: where entry (i, j) of the symmetric AtA
    lies among the 21 packed upper-triangle sums. Cached per device: built
    inside the ICP loop it would cost a host-to-device copy a pass."""
    at = {ij: k for k, ij in enumerate(zip(_IU, _JU))}
    return torch.tensor([at[min(i, j), max(i, j)] for i in range(6) for j in range(6)],
                        device=device)


def unpack_sums(sums: torch.Tensor):
    """(..., 29) packed sums -> (AtA (..., 6, 6) symmetric, Atb (..., 6),
    count (...), mse_sum (...)), as JAX icp.py:236-238 unpacks them: one
    gather, the rest are views."""
    AtA = sums.index_select(-1, _ata_index(sums.device)).reshape(sums.shape[:-1] + (6, 6))
    return AtA, sums[..., 21:27], sums[..., 28], sums[..., 27]


def pack_sums(AtA, Atb, count, mse_sum) -> torch.Tensor:
    """The inverse of unpack_sums: (..., 29) from (AtA, Atb, count, mse_sum)."""
    return torch.cat([AtA[..., _IU, _JU], Atb, mse_sum[..., None], count[..., None]], dim=-1)


def slabs_for(n_poses: int, points: int) -> int:
    """CTAs the kernel gives a pose (its thread block cluster): 1 when the
    poses alone fill the card, else doubled, up to 8, while the CTAs are
    fewer than the SMs and a slab keeps at least one point a thread. A
    function of the shapes alone, so the summation order is too."""
    slabs = 1
    while (slabs < MAX_SLABS and n_poses * slabs < FILL_CTAS
           and points >= 2 * slabs * KERNEL_THREADS):
        slabs *= 2
    return slabs


def _launch(cloud, valid, table, *, K=None, gate=None, base=None, height=0, width=0,
            idx=None, dist_sq=None, gate_sq=0.0) -> torch.Tensor:
    """Launch csrc/icp_reduce.cu on the current stream, without
    synchronising: (..., P, 3) clouds -> (..., 29). ``idx`` None selects the
    projective front end."""
    global launches
    dev = cloud.device
    if dev.type != "cuda":
        raise ValueError(f"the assoc_reduce kernel needs CUDA tensors, got {dev}")
    if cloud.dim() < 2 or cloud.shape[-1] != 3 or cloud.shape[-2] == 0:
        raise ValueError(f"cloud must be (..., P, 3) with P > 0, got {tuple(cloud.shape)}")
    lead, points = cloud.shape[:-2], cloud.shape[-2]
    if valid.shape != cloud.shape[:-1]:
        raise ValueError(f"valid must be {tuple(cloud.shape[:-1])}, got {tuple(valid.shape)}")
    if table.dim() != 2 or table.shape[1] != ROW or table.shape[0] == 0:
        raise ValueError(f"table must be (R, {ROW}) with R > 0, got {tuple(table.shape)}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be contiguous and 16-byte aligned")
    n_poses = cloud.numel() // (3 * points)
    if idx is None:
        if tuple(K.shape) != (3, 3) or gate.dim() != 0 or height <= 0 or width <= 0:
            raise ValueError(f"the projective front end wants K (3, 3), a 0-d gate and a frame "
                             f"size, got {tuple(K.shape)}, {tuple(gate.shape)}, "
                             f"{height}x{width}")
        inputs = {"K": (K, torch.float32), "gate": (gate, torch.float32)}
        if base is not None:
            if base.numel() != n_poses:
                raise ValueError(f"base must hold one row offset per pose ({n_poses}), got "
                                 f"{tuple(base.shape)}")
            inputs["base"] = (base, torch.int64)
    else:
        if idx.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"idx must be int32 or int64, got {idx.dtype}")
        if idx.shape != cloud.shape[:-1] or dist_sq.shape != cloud.shape[:-1]:
            raise ValueError(f"idx and dist_sq must be {tuple(cloud.shape[:-1])}, got "
                             f"{tuple(idx.shape)} and {tuple(dist_sq.shape)}")
        inputs = {"idx": (idx, idx.dtype), "dist_sq": (dist_sq, torch.float32)}
    for name, (t, dtype) in {"cloud": (cloud, torch.float32), "valid": (valid, torch.bool),
                             "table": (table, torch.float32), **inputs}.items():
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} on {t.device}")
    if n_poses * MAX_SLABS >= 2 ** 31 or points >= 2 ** 31:
        raise ValueError(f"too large for one launch: {n_poses} poses of {points} points")
    from pose_refine_tpu_torch._build import load_kernels

    lib, _info = load_kernels()
    # contiguous() copies nothing for the tensors the ICP loop hands in
    cloud, valid = cloud.contiguous(), valid.contiguous()
    if idx is None:
        K, gate = K.contiguous(), gate.contiguous()
        base = None if base is None else base.contiguous()
    else:
        idx, dist_sq = idx.contiguous(), dist_sq.contiguous()
    out = torch.empty(lead + (PACKED,), dtype=torch.float32, device=dev)
    if n_poses == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prt_assoc_reduce(
            cloud.data_ptr(), valid.data_ptr(), n_poses, points, table.data_ptr(),
            table.shape[0], slabs_for(n_poses, points),
            None if idx is not None else K.data_ptr(),
            None if idx is not None else gate.data_ptr(),
            None if base is None else base.data_ptr(), height, width,
            None if idx is None else idx.data_ptr(),
            0 if idx is None else idx.element_size(),
            None if idx is None else dist_sq.data_ptr(), gate_sq, out.data_ptr(), stream)
    if err != 0:
        msg = lib.prt_error_string(err).decode()
        raise RuntimeError(f"assoc_reduce kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


def assoc_reduce_projective_cuda(cloud, valid, table, K, max_dist_diff, height: int,
                                 width: int, base=None) -> torch.Tensor:
    """The kernel with the projective front end: (..., P, 3) CUDA clouds
    against the (R, 8) scene table of ``height`` x ``width`` frames, K (3, 3)
    and the 0-d gate ``max_dist_diff`` on the device (the kernel reads them
    there), ``base`` an int64 row offset per pose for stacked frames ->
    (..., 29). Raises for CPU tensors."""
    return _launch(cloud, valid, table, K=K, gate=max_dist_diff, base=base, height=int(height),
                   width=int(width))


def assoc_reduce_indexed_cuda(cloud, valid, table, idx, dist_sq, gate_sq: float) -> torch.Tensor:
    """The kernel with the indexed front end: the (..., P) ``idx`` (int32
    or int64, clamped into the table) and ``dist_sq`` of the flash-NN
    kernels, valid where dist_sq < gate_sq -> (..., 29). Raises for CPU
    tensors."""
    return _launch(cloud, valid, table, idx=idx, dist_sq=dist_sq, gate_sq=float(gate_sq))
