"""Exact nearest-neighbour search ("flash-NN"): the hand-written CUDA kernels
``csrc/nn_flash.cu``, their wrappers, and their plain PyTorch versions
(PyTorch port of ``pose_refine_tpu/scene/nn_pallas.py``).

* ``nn_flash_packed`` replaces the Pallas kernel of the same name: exact
  NN of every query over the whole scene.
* ``nn_flash_gated`` replaces ``nn_flash_gated``: the same argmin, exact
  for every query whose NN lies inside the gate; the kernel skips 128-point
  chunks that cannot hold an in-gate neighbour of any query of its tile.
  It prunes by true distance and reports the rounded score, so a query
  whose NN lies within float32 rounding of the gate (about 16 ULPs of
  |q|^2) may come out invalid where the full scan finds it valid - the
  Pallas kernel's behaviour too. Over a stacked table of ``frames``
  equal-width frames (``scene.nn.SceneNNStack``) it windows every loop to
  one frame, chosen per pose by ``frame_id``, and returns stacked-table
  indices.

Both score a pair as |s|^2 - 2 q.s over the field-major ``pack_scene``
table and keep the smallest index among equal scores. The arithmetic is
that of the JAX kernels as XLA compiles them on the CPU, which contracts
the three-term sums into fused multiply-adds (see ``_fma``): the plain
versions here equal the JAX kernels in interpret mode bit for bit, and the
CUDA kernels equal the plain versions.

Dispatch: the wrappers use the plain version for CPU tensors and the kernel
for CUDA tensors. There is no fallback from the kernel to the plain
version; a kernel that does not build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

S_CHUNK = 128   # scene points per chunk (the kernels' shared-memory stage)
BIG = 3.0e38    # score / dist^2 sentinel
IBIG = 2 ** 30
UB_BALL = 32    # scene points per bounding ball of the gated kernel's pass 1
Q_TILE = 128    # queries per CTA of the CUDA kernels (one per thread)

# kernel launches by the _cuda entry points (chip_smoke.py resets and reads
# them to show the main path went through the kernels)
packed_launches = 0
gated_launches = 0
stacked_launches = 0  # the gated launches over a stacked table (frames > 1)


def pack_scene(scene_pts, rows=None) -> torch.Tensor:
    """(S, 3) points -> (8, S_pad) field-major [x, y, z, |s|^2, 0, 0, 0, 0]
    table. Pad columns repeat the last real point with |s|^2 = BIG, so they
    never win and chunk boxes stay tight. |s|^2 is ((x*x + y*y) + z*z),
    each step rounded, as the JAX pack_scene and its numpy twin compute it.
    ``rows`` pads to that column count instead of the next S_CHUNK multiple
    (a stacked scene pads every frame to its widest frame)."""
    s = torch.as_tensor(scene_pts, dtype=torch.float32)
    ns = s.shape[0]
    spad = (-ns) % S_CHUNK if rows is None else rows - ns
    ssq = s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1] + s[:, 2] * s[:, 2]
    tab = torch.zeros((8, ns + spad), dtype=torch.float32, device=s.device)
    tab[:3, :ns] = s.T
    tab[3, :ns] = ssq
    if spad:
        tab[:3, ns:] = s[-1][:, None]
        tab[3, ns:] = BIG
    return tab


def chunk_boxes(scene_table: torch.Tensor) -> torch.Tensor:
    """Per-S_CHUNK bounding boxes of a pack_scene table: (8, S_pad) ->
    (S_pad/128, 8) [xlo, ylo, zlo, 0, xhi, yhi, zhi, 0]."""
    pts = scene_table[:3].reshape(3, -1, S_CHUNK)
    lo = pts.amin(dim=2).T
    hi = pts.amax(dim=2).T
    z = torch.zeros((lo.shape[0], 1), dtype=torch.float32, device=lo.device)
    return torch.cat([lo, z, hi, z], dim=1).contiguous()


def ball_table(scene_table: torch.Tensor) -> torch.Tensor:
    """Bounding balls of UB_BALL-point runs of a pack_scene table, for the
    gated kernel's first pass: (8, S_pad) -> (4, S_pad/UB_BALL) [cx; cy; cz;
    r], centre = the run's box centre, r = half its diagonal. The JAX
    wrapper derives the same table inside every call (nn_pallas.py:400-404)
    and pads it with far balls; the CUDA kernel needs no padding, and a
    scene builds it once."""
    sub = scene_table[:3].reshape(3, -1, UB_BALL)
    blo = sub.amin(dim=2)
    bhi = sub.amax(dim=2)
    ctr = 0.5 * (blo + bhi)
    ext = bhi - blo
    # jnp.linalg.norm as XLA contracts its sum of squares
    rad = 0.5 * torch.sqrt(_fma(ext[2], ext[2], _fma(ext[1], ext[1], ext[0] * ext[0])))
    return torch.cat([ctr, rad[None]], dim=0).contiguous()


def _fma_exact(a, b, c):
    """a*b + c rounded once to float32 (broadcasting float32 tensors), for
    any device: the float64 product is exact, the float64 sum is made
    round-to-odd from its exact error (TwoSum), and rounding that to
    float32 is then the correctly rounded fused result."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _fma(a, b, c):
    """Fused multiply-add of float32 tensors, rounded once, as XLA's CPU
    backend emits for ``a*b + c``. On the CPU ``torch.addcmul`` is such an
    FMA (tests hold it against ``_fma_exact``); on a card the plain version
    takes the exact emulation, since a library's elementwise kernels
    promise no contraction."""
    if c.device.type == "cpu":
        return torch.addcmul(c, a, b)
    return _fma_exact(a, b, c)


def _sum_sq(flat):
    """|q|^2 of (Q, 3) points as XLA contracts jnp.sum(q * q, -1):
    fma(z, z, fma(y, y, x*x))."""
    x, y, z = flat[:, 0], flat[:, 1], flat[:, 2]
    return _fma(z, z, _fma(y, y, x * x))


def _score(q, sx, sy, sz, ss):
    """|s|^2 - 2 q.s of a (C, 3) query chunk against (1, S) scene rows,
    contracted as XLA does: fma(qz, sz, fma(qx, sx, qy*sy)). On the CPU
    the FMAs are addcmul_ in place (the loop is memory-bound)."""
    qx, qy, qz = q[:, 0:1], q[:, 1:2], q[:, 2:3]
    dot = qy * sy
    if dot.device.type == "cpu":
        dot.addcmul_(qx, sx).addcmul_(qz, sz)
    else:
        dot = _fma_exact(qz, sz, _fma_exact(qx, sx, dot))
    return dot.mul_(-2.0).add_(ss)  # -2 q.s is exact: one rounding, as ss - 2 q.s


def _scan_plain(flat, scene_table):
    """Dense exact argmin of |s|^2 - 2 q.s over every (query, scene column)
    pair, chunked over queries (about 2**27 pairs a chunk on a card, 2**20
    on the CPU). Returns (best score (Q,), idx (Q,) int32): the first index
    among equal scores (``torch.min``), and (BIG, 0) where no score is below
    BIG, as the kernels' strict running minimum from BIG leaves it."""
    nq = flat.shape[0]
    n_s = scene_table.shape[1]
    dev = flat.device
    budget = 1 << 27 if dev.type == "cuda" else 1 << 20
    step = max(1, budget // max(n_s, 1))
    sx, sy, sz, ss = (scene_table[k][None, :] for k in range(4))
    best = torch.empty(nq, dtype=torch.float32, device=dev)
    idx = torch.empty(nq, dtype=torch.int64, device=dev)
    for a in range(0, nq, step):
        best[a:a + step], idx[a:a + step] = _score(flat[a:a + step], sx, sy, sz, ss).min(dim=1)
    hit = best < BIG
    return torch.where(hit, best, BIG), torch.where(hit, idx, 0).to(torch.int32)


def gate_sq(max_dist) -> float:
    """The squared gate as the JAX wrapper forms it (float32 product)."""
    g = np.float32(float(max_dist))
    return float(g * g)


def _flat(queries):
    q = torch.as_tensor(queries, dtype=torch.float32)
    if q.shape[-1] != 3:
        raise ValueError(f"queries must be (..., 3), got {tuple(q.shape)}")
    return q.reshape(-1, 3), q.shape[:-1]


def _frame_ids(frame_id, shape, frames: int, device):
    """The per-pose frame ids of queries of batch ``shape`` (without the
    trailing 3) as an (N,) int32 tensor on ``device``, clamped to [0,
    frames), and the queries per pose: a scalar id takes every query as one
    pose, an (N,) id the leading axis as the poses (the JAX package's vmap
    over poses, written out). None is frame 0, the JAX kernel's default."""
    if frames < 1:
        raise ValueError(f"frames must be >= 1, got {frames}")
    nq = int(np.prod(shape, dtype=np.int64))
    fid = torch.as_tensor(0 if frame_id is None else frame_id, device=device)
    if fid.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"frame_id must be integer, got {fid.dtype}")
    if fid.dim() == 0:
        fid = fid.reshape(1)
    elif fid.dim() != 1 or len(shape) < 2 or shape[0] != fid.shape[0]:
        raise ValueError(f"frame_id {tuple(fid.shape)} must be a scalar or one id per pose "
                         f"of (N, ..., 3) queries, got queries {tuple(shape)} + (3,)")
    per_pose = nq // fid.shape[0] if fid.shape[0] else 0
    return fid.clamp(0, frames - 1).to(torch.int32), per_pose


def nn_flash_packed_plain(queries, scene_table):
    """Plain PyTorch version of the exact-NN kernel on any device:
    queries (..., 3) -> (idx (...,) int32, dist_sq (...,) float32)."""
    flat, shape = _flat(queries)
    best, idx = _scan_plain(flat, scene_table)
    dist = torch.clamp(best + _sum_sq(flat), min=0.0)
    return idx.reshape(shape), dist.reshape(shape)


def nn_flash_gated_plain(queries, scene_table, max_dist, frame_id=None, frames: int = 1):
    """Plain PyTorch version of the gated kernel on any device: the exact NN
    of every query (no pruning, so it needs no boxes or balls), with
    dist_sq = BIG where the NN lies outside the gate - the kernel's
    contract, under which a query is valid iff dist_sq < max_dist^2. The
    kernel agrees with it on every in-gate idx and dist_sq and on validity,
    except within float32 rounding of the gate (see the module note).

    Stacked tables (``frames`` > 1): each pose's queries are scanned
    against its frame's columns alone (``frame_id``, see nn_flash_gated),
    never the whole stack, where another frame's or a pad column could win;
    the index is the stacked column."""
    flat, shape = _flat(queries)
    fid, per_pose = _frame_ids(frame_id, shape, frames, flat.device)
    rows = scene_table.shape[1] // frames
    best = torch.full((flat.shape[0],), BIG, dtype=torch.float32, device=flat.device)
    idx = torch.zeros((flat.shape[0],), dtype=torch.int32, device=flat.device)
    pose_of = torch.arange(flat.shape[0], device=flat.device) // max(per_pose, 1)
    for k in range(frames):
        sel = (fid[pose_of] == k).nonzero()[:, 0] if frames > 1 else None
        q = flat if sel is None else flat[sel]
        b, i = _scan_plain(q, scene_table[:, k * rows:(k + 1) * rows])
        i = torch.where(b < BIG, i + k * rows, 0)  # no hit: index 0, as the kernels leave it
        if sel is None:
            best, idx = b, i
        else:
            best[sel], idx[sel] = b, i
    dist = torch.clamp(best + _sum_sq(flat), min=0.0)
    dist = torch.where((best < BIG) & (dist < gate_sq(max_dist)), dist, BIG)
    return idx.reshape(shape), dist.reshape(shape)


def _launch(flat, scene_table, boxes, balls, gate2: float, prune: bool, scanned=None,
            frame_id=None, frames: int = 1, per_pose: int = 0):
    """Launch csrc/nn_flash.cu on the current stream, without
    synchronising. Returns (idx (Q,) int32, dist_sq (Q,) float32)."""
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError(f"the nn_flash kernels need CUDA tensors, got {dev}")
    tensors = {"queries": flat, "scene_table": scene_table}
    if prune:
        tensors.update(boxes=boxes, balls=balls)
    if frame_id is not None and (frame_id.device != dev or frame_id.dtype != torch.int32
                                 or frame_id.dim() != 1 or not frame_id.is_contiguous()):
        raise ValueError(f"frame_id must be a contiguous (N,) int32 tensor on {dev}")
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 tensor on {dev}, "
                f"got {t.dtype} on {t.device}")
    if scene_table.dim() != 2 or scene_table.shape[0] != 8 or scene_table.shape[1] % S_CHUNK \
            or scene_table.shape[1] == 0:
        raise ValueError(f"scene_table must be (8, S_pad) from pack_scene, got "
                         f"{tuple(scene_table.shape)}")
    s_pad = scene_table.shape[1]
    n_balls = 0
    if prune:
        if tuple(boxes.shape) != (s_pad // S_CHUNK, 8):
            # a stale box table would skip or misjudge chunks silently
            raise ValueError(f"boxes {tuple(boxes.shape)} do not cover the scene table "
                             f"({s_pad // S_CHUNK} chunks of {S_CHUNK})")
        if balls.dim() != 2 or balls.shape[0] != 4 or balls.shape[1] == 0:
            raise ValueError(f"balls must be (4, Nb) from ball_table, got {tuple(balls.shape)}")
        n_balls = balls.shape[1]
        if s_pad % (frames * S_CHUNK) or n_balls % frames:
            raise ValueError(f"a table of {s_pad} columns and {n_balls} balls is not {frames} "
                             f"equal frames of S_CHUNK={S_CHUNK} multiples")
    nq = flat.shape[0]
    if nq >= 2 ** 31 or 8 * s_pad >= 2 ** 31:
        raise ValueError(f"too large for int32 sizes: {nq} queries, {s_pad} scene columns")
    if frame_id is not None and (frame_id.shape[0] * per_pose != nq
                                 or frame_id.shape[0] > 65535):
        raise ValueError(f"{frame_id.shape[0]} poses of {per_pose} queries do not cover "
                         f"{nq} queries in at most 65535 poses")
    from pose_refine_tpu_torch._build import load_kernels

    lib, _info = load_kernels()
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    dist = torch.empty(nq, dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, dist
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prt_nn_flash(
            flat.data_ptr(), nq, scene_table.data_ptr(), s_pad,
            boxes.data_ptr() if prune else None, balls.data_ptr() if prune else None,
            n_balls, gate2, int(prune), None if frame_id is None else frame_id.data_ptr(),
            frames, per_pose, idx.data_ptr(), dist.data_ptr(),
            None if scanned is None else scanned.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.prt_error_string(err).decode()
        raise RuntimeError(f"nn_flash kernel launch failed: CUDA error {err} ({msg})")
    return idx, dist


def nn_flash_packed_cuda(flat, scene_table):
    """The exact-NN kernel on (Q, 3) CUDA queries; raises for CPU tensors."""
    global packed_launches
    out = _launch(flat, scene_table, None, None, 0.0, prune=False)
    packed_launches += 1
    return out


def nn_flash_gated_cuda(flat, scene_table, boxes, balls, max_dist, scanned=None,
                        frame_id=None, frames: int = 1, per_pose: int = 0):
    """The gated kernel on (Q, 3) CUDA queries; raises for CPU tensors.
    ``scanned`` (one int32 per tile: ceil(Q/128), or N * ceil(per_pose/128)
    with frame ids), if given, receives the number of chunks each query tile
    scanned. ``frame_id`` (N,) int32 in [0, frames), if given, is the frame
    of each pose's ``per_pose`` consecutive queries (a stacked table);
    launches of a stacked table are also counted in ``stacked_launches``."""
    global gated_launches, stacked_launches
    out = _launch(flat, scene_table, boxes, balls, gate_sq(max_dist), prune=True,
                  scanned=scanned, frame_id=frame_id, frames=frames, per_pose=per_pose)
    gated_launches += 1
    stacked_launches += frames > 1
    return out


def nn_flash_packed(queries, scene_table):
    """Exact NN against a pack_scene table: queries (..., 3) -> (idx (...,)
    int32, dist_sq (...,) float32). CUDA: the kernel; CPU: the plain
    version."""
    flat, shape = _flat(queries)
    if flat.device.type == "cpu":
        return nn_flash_packed_plain(queries, scene_table)
    idx, dist = nn_flash_packed_cuda(flat.contiguous(), scene_table)
    return idx.reshape(shape), dist.reshape(shape)


def nn_flash_gated(queries, scene_table, boxes, balls, max_dist, frame_id=None,
                   frames: int = 1):
    """Gate-exact NN: equal to nn_flash_packed for every query whose NN lies
    within max_dist (meters, a Python float: the gate never costs a host
    synchronisation); queries with no scene point inside the gate are
    invalid (dist_sq >= max_dist^2). boxes from chunk_boxes and balls from
    ball_table, both built once per scene. CUDA: the kernel; CPU: the plain
    version.

    Stacked scenes: ``frames`` = K equal-width per-frame tables side by
    side (boxes and balls frame-major), and ``frame_id`` the frame each
    query associates against - a scalar for all queries, or an (N,) tensor
    of one id per pose of (N, ..., 3) queries (ids are clamped to [0, K);
    on a card they never leave it). None is frame 0. Indices come back as
    stacked-table columns (frame-local + fid * S_pad / K)."""
    flat, shape = _flat(queries)
    if flat.device.type == "cpu":
        return nn_flash_gated_plain(queries, scene_table, max_dist, frame_id, frames)
    fid, per_pose = (None, 0) if frame_id is None else \
        _frame_ids(frame_id, shape, frames, flat.device)
    idx, dist = nn_flash_gated_cuda(flat.contiguous(), scene_table, boxes, balls, max_dist,
                                    frame_id=fid, frames=frames, per_pose=per_pose)
    return idx.reshape(shape), dist.reshape(shape)

