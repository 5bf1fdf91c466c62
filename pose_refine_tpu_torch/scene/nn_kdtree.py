"""Exact nearest neighbour by the stackless kd traversal: the hand-written
CUDA kernel ``csrc/nn_kdtree.cu``, its wrapper, and its plain PyTorch
version (PyTorch port of ``pose_refine_tpu/scene/nn.py::_nn_kdtree``, the
reference's device search, pcd_scene.h:61-136).

The walk needs no recursion and no stack: from the root it descends to the
near child by ``p[split_dim] - split_v < 0``; at a leaf it scans the
leaf's points; it backtracks by parent pointers, and at an interior node
reached back from its near child it enters the far child iff the far
child's own box lies no farther than the best distance so far (the JAX
package's ``prune="far"``). The state is (cur, last, back, best index, best
dist^2, steps), from (0, -1, False, 0, FLT_MAX, 0); the walk ends at the
root's parent or at ``max_steps``.

Both versions round as XLA's CPU backend does for the JAX function, which
contracts the three-term sums of squares into fused multiply-adds:
dist^2 = fma(dz, dz, fma(dy, dy, dx * dx)) with d = point - query, and the
box distance likewise. The plain version equals JAX's ``_nn_kdtree`` bit for
bit in idx, dist^2 and steps on the CPU (tests/test_torch_kdtree.py), and
the kernel equals the plain version on the card.

Output: int32 idx and float32 dist^2 of every query, as the flash-NN
kernels return them, so ``scene.nn._rows_in_gate`` and the ICP iteration
kernel take them unchanged. A query with no point at a finite distance (NaN, or
so far that every dist^2 overflows) keeps the initial state: idx 0,
dist^2 FLT_MAX, which every gate rejects.

Dispatch: ``nn_kdtree`` uses the plain version for CPU tensors and the
kernel for CUDA tensors; a kernel that does not build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pose_refine_tpu_torch._build import launch, load_kernels
from pose_refine_tpu_torch.scene.kdtree import KDTreeDevice
from pose_refine_tpu_torch.scene.nn_flash import _flat, _fma

FLT_MAX = float(np.finfo(np.float32).max)
# the largest table (bytes) the kernel stages whole in shared memory and
# walks with persistent CTAs, one an SM: an H100 SM's 228 KB less the 1 KB
# the runtime keeps a CTA; a larger one is walked through L1, where staging
# a part of it measured slower (PERF.md)
STAGE_CAP_BYTES = 233472 - 1024

# kernel launches by nn_kdtree_cuda (chip_smoke.py resets and reads it to
# show the main path went through the kernel)
launches = 0


def _sq3(a, b, c):
    """a^2 + b^2 + c^2 of float32 tensors as XLA contracts jnp.sum(x * x)
    over three terms: fma(c, c, fma(b, b, a * a))."""
    return _fma(c, c, _fma(b, b, a * a))


def nn_kdtree_plain(src, tree: KDTreeDevice, return_steps: bool = False,
                    return_work: bool = False):
    """Plain PyTorch version of the traversal on any device: (..., 3)
    queries -> (idx (...) int32, dist_sq (...) float32[, steps (...)
    int32][, leaf points scanned (...) int32, far children tested (...)
    int32, far-child boxes read (...) int32]). JAX
    ``_nn_kdtree(prune="far")`` step for step: one loop iteration is one
    step of every query still walking, masked over the batch, until every
    query is done. The work counts give a walk's bound (chip_smoke.py): the
    kernel settles a far-child test by the split plane alone where
    (p[split_dim] - split_v)^2 exceeds the best, and reads the box for the
    rest; both decide alike (csrc/nn_kdtree.cu), so only the counts see
    it."""
    flat, shape = _flat(src)
    dev = flat.device
    nq = flat.shape[0]
    rec = tree.records
    parent, c0_all, leaf_all = rec[:, 0], rec[:, 1], rec[:, 1] < 0
    split_dim, split_v = tree.split_dim, tree.split_v
    boxes = tree.boxes
    pts = tree.points[:, :3]
    n_pts = pts.shape[0]
    offs = torch.arange(tree.leaf_cap, device=dev)
    cur = torch.zeros(nq, dtype=torch.int64, device=dev)
    last = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    back = torch.zeros(nq, dtype=torch.bool, device=dev)
    bi = torch.zeros(nq, dtype=torch.int64, device=dev)
    bd = torch.full((nq,), FLT_MAX, dtype=torch.float32, device=dev)
    steps = torch.zeros(nq, dtype=torch.int32, device=dev)
    scanned = torch.zeros(nq, dtype=torch.int32, device=dev)
    tested = torch.zeros(nq, dtype=torch.int32, device=dev)
    box_reads = torch.zeros(nq, dtype=torch.int32, device=dev)
    act = torch.arange(nq, device=dev)
    while act.numel():
        c, p, bk = cur[act], flat[act], back[act]
        b_d, b_i = bd[act], bi[act]
        leaf = leaf_all[c]
        c1 = c0_all[c].long()
        c2 = torch.where(leaf, c1, c1 + 1)
        par = parent[c].long()
        pc = p.gather(1, split_dim[c].long()[:, None])[:, 0]
        off = pc - split_v[c]
        near = off < 0
        best = torch.where(near, c1, c2)
        other = torch.where(near, c2, c1)
        # a leaf entered descending: its first nearest point, taken only if
        # strictly nearer than the best so far
        s = (leaf & ~bk).nonzero()[:, 0]
        if s.numel():
            left, right = rec[c[s], 2].long(), rec[c[s], 3].long()
            lidx = left[:, None] + offs
            d = pts[lidx.clamp(0, n_pts - 1)] - p[s][:, None, :]
            d2 = _sq3(d[..., 0], d[..., 1], d[..., 2])
            d2 = torch.where(lidx < right[:, None], d2, FLT_MAX)
            leaf_bd, j = d2.min(dim=1)
            upd = leaf_bd < b_d[s]
            b_d[s] = torch.where(upd, leaf_bd, b_d[s])
            b_i[s] = torch.where(upd, lidx.gather(1, j[:, None])[:, 0], b_i[s])
            scanned[act[s]] += (right - left).to(torch.int32)
        # back at an interior node from its near child: the far child's box
        go_far = torch.zeros_like(bk)
        g = (bk & (last[act] == best)).nonzero()[:, 0]
        if g.numel():
            box, pg = boxes[other[g]], p[g]
            delta = (box[:, 0:3] - pg).clamp(min=0.0) + (pg - box[:, 4:7]).clamp(min=0.0)
            min_poss = _sq3(delta[:, 0], delta[:, 1], delta[:, 2])
            go_far[g] = min_poss <= b_d[g]
            tested[act[g]] += 1
            box_reads[act[g]] += (~(off[g] * off[g] > b_d[g])).to(torch.int32)
        nxt = torch.where(bk, torch.where(go_far, other, par), torch.where(leaf, par, best))
        back[act] = torch.where(bk, ~go_far, leaf)
        last[act] = c
        cur[act] = nxt
        bd[act], bi[act] = b_d, b_i
        steps[act] += 1
        act = act[(nxt >= 0) & (steps[act] < tree.max_steps)]
    out = (bi.to(torch.int32).reshape(shape), bd.reshape(shape))
    if return_steps:
        out += (steps.reshape(shape),)
    if return_work:
        out += (scanned.reshape(shape), tested.reshape(shape), box_reads.reshape(shape))
    return out


class KDLaunch:
    """The kernel bound to one tree and one batch of queries: the argument
    checks, ``load_kernels()``, the idx / dist^2 buffers and the kernel's
    tile counters once; then a launch a call, one ctypes call into the same
    buffers (an NN refine's ICP loop calls it once a pass, on the moved
    cloud; ops/icp_reduce.py's iteration kernel reads the buffers before
    the next launch overwrites them, on the same stream).

    ``shape``: the batch shape of the queries, (...,) of (..., 3).
    ``whole``: the kernel stages the whole tree in shared memory (a table of
    at most STAGE_CAP_BYTES); otherwise it walks the tree through L1."""

    def __init__(self, tree: KDTreeDevice, shape, device):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the nn_kdtree kernel needs CUDA tensors, got {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        t = tree.table
        m = tree.n_nodes
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the tree table must be a contiguous float32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if m < 1 or t.dim() != 2 or t.shape[1] != 4 or t.shape[0] <= 3 * m:
            raise ValueError(f"the tree table must be (3 M + P, 4) with M >= 1, P >= 1, got "
                             f"{tuple(t.shape)} for M = {m}")
        if t.data_ptr() % 16:
            raise ValueError("the tree table must be 16-byte aligned (the kernel reads 16 bytes "
                             "at a time)")
        self.shape = tuple(shape)
        nq = int(np.prod(self.shape, dtype=np.int64))
        if nq >= 2 ** 31:
            raise ValueError(f"too many queries for int32 sizes: {nq}")
        self.lib, _info = load_kernels()
        self.tree, self.dev, self.nq = tree, dev, nq
        self.whole = 16 * t.shape[0] <= STAGE_CAP_BYTES
        self.idx = torch.empty(self.shape, dtype=torch.int32, device=dev)
        self.dist = torch.empty(self.shape, dtype=torch.float32, device=dev)
        self.counters = torch.zeros(2, dtype=torch.int32, device=dev)
        # the C interface's arguments but the stream; [0] the queries and
        # [10] steps change from launch to launch
        self.args = [None, nq, t.data_ptr(), m, t.shape[0] - 3 * m, tree.max_steps,
                     int(self.whole), self.counters.data_ptr(), self.idx.data_ptr(),
                     self.dist.data_ptr(), None]

    def __call__(self, queries, steps=None):
        """idx and dist^2 of ``queries`` ((..., 3) contiguous float32 of the
        bound shape, on the card) on the current stream, without
        synchronising; ``steps``, if given, an int32 tensor of the batch
        shape, receives each query's step count. The same two buffers every
        call. Raises on a failed launch."""
        global launches
        if queries.device != self.dev or queries.dtype != torch.float32 \
                or tuple(queries.shape) != self.shape + (3,) or not queries.is_contiguous():
            raise ValueError(f"queries must be a contiguous float32 {self.shape + (3,)} tensor "
                             f"on {self.dev}, got {queries.dtype} {tuple(queries.shape)} on "
                             f"{queries.device}")
        if steps is not None and (steps.device != self.dev or steps.dtype != torch.int32
                                  or tuple(steps.shape) != self.shape
                                  or not steps.is_contiguous()):
            raise ValueError(f"steps must be a contiguous int32 {self.shape} tensor on "
                             f"{self.dev}")
        if self.nq == 0:
            return self.idx, self.dist
        args = self.args
        args[0] = queries.data_ptr()
        args[10] = None if steps is None else steps.data_ptr()
        launch(self.lib, "prt_nn_kdtree", self.dev, args, "nn_kdtree")
        launches += 1
        return self.idx, self.dist


def nn_kdtree_cuda(flat, tree: KDTreeDevice, steps=None):
    """The kernel on (Q, 3) contiguous float32 CUDA queries, on the current
    stream, without synchronising: (idx (Q,) int32, dist_sq (Q,) float32),
    fresh buffers (a KDLaunch built for the one call). ``steps``, if given,
    a (Q,) int32 tensor, receives each query's step count. Raises for CPU
    tensors and on a failed launch."""
    if flat.device.type != "cuda":
        raise ValueError(f"the nn_kdtree kernel needs CUDA tensors, got {flat.device}")
    if flat.dim() != 2 or flat.shape[1] != 3:
        raise ValueError(f"queries must be (Q, 3), got {tuple(flat.shape)}")
    return KDLaunch(tree, flat.shape[:1], flat.device)(flat, steps)


def nn_kdtree(src, tree: KDTreeDevice):
    """Exact NN by the kd traversal: (..., 3) queries -> (idx (...) int32,
    dist_sq (...) float32). CUDA: the kernel; CPU: the plain version."""
    flat, shape = _flat(src)
    if flat.device.type == "cpu":
        return nn_kdtree_plain(src, tree)
    idx, dist = nn_kdtree_cuda(flat.contiguous(), tree)
    return idx.reshape(shape), dist.reshape(shape)
