"""Data parallelism over the pose batch (the PyTorch port of
``pose_refine_tpu/parallel/sharding.py``).

The workload's one parallel axis is the hypothesis batch: every pose is
refined on its own (SURVEY.md section 2). The batch is padded to a multiple
of the device count (the first row replicated), cut into equal shards, and
each device refines its shard against its own replica of the scene and the
mesh on a CUDA stream of its own; the results are gathered on the first
device and the padding dropped. A device list may name one device more than
once: each entry is one shard (the CPU tests, and a one-card run of the
split).

Every per-pose computation is independent of the others, but two orders of
summation depend on the batch's size: the ICP kernel's (``geometry``), so
each shard's iteration is handed the whole batch's size (``order_batch``),
and on a card the information pass's torch reductions, so the covariance is
computed once on the gathered clouds (``pipeline.refine_poses_split``). The
split refine equals the single-device refine bit for bit. The cost of the
first: a shard's launch takes the slabs and threads of the whole batch, so
on several cards a pose is split over fewer CTAs than its shard alone would
give it.

The scene, the mesh and the camera go to each card once: ``run_sharded``
keeps their replicas in the caller's ``replicas`` memo (a PoseRefiner's)
while they are the same objects.

The JAX package's names keep their signatures: its ``Mesh`` is the list of
devices here (``make_mesh``), and its ``axis`` names the one data-parallel
axis, so it is checked to be a string and has no other effect.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional, Sequence

import torch

from pose_refine_tpu_torch import icp
from pose_refine_tpu_torch.ops.rasterize_cuda import IndexedTris
from pose_refine_tpu_torch.utils.profiling import span


def canonical(device) -> torch.device:
    """``device`` as a torch.device with its card's index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_axis(axis) -> None:
    """JAX's mesh axis name: a string; the port has one data-parallel axis,
    so the name selects nothing."""
    if not isinstance(axis, str):
        raise TypeError(f"axis must be a str naming the data-parallel axis, got {axis!r}")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> list:
    """The devices of the pose batch's data-parallel axis ``axis`` (the
    JAX package's 1-D mesh): every card, or the first ``n_devices`` of
    them."""
    _check_axis(axis)
    n = torch.cuda.device_count()
    if n_devices is not None:
        if n_devices > n:
            raise ValueError(f"{n_devices} devices requested, {n} CUDA cards present")
        n = int(n_devices)
    return [torch.device("cuda", i) for i in range(n)]


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))]) if pad else x


def pad_to_devices(n_devices: int, init_poses, tris=None):
    """Pad an (N, 4, 4) pose batch (and a per-pose (N, T, 3, 3) triangle
    table, or an IndexedTris's per-pose ids) to a multiple of n_devices.

    Padding replicates the FIRST row: a renderable pose (identity padding
    would put the mesh at the camera origin), whose results the caller
    drops (unpad_results). Returns (poses_padded, tris_padded, n_orig)."""
    poses = torch.as_tensor(init_poses, dtype=torch.float32)
    n = poses.shape[0]
    pad = (-n) % n_devices
    poses = _pad_rows(poses, pad)
    if isinstance(tris, IndexedTris):
        tris = IndexedTris(tris.table, _pad_rows(tris.ids, pad))
    elif tris is not None and tris.dim() == 4:
        tris = _pad_rows(tris, pad)
    return poses, tris, n


def _rows(x, rows: slice):
    """Rows of a tensor or of each tensor field of a NamedTuple (None
    fields stay None)."""
    if isinstance(x, tuple):
        return type(x)(*(None if f is None else f[rows] for f in x))
    return x[rows]


def unpad_results(n: int, refined, *rest):
    """Drop padded rows appended by pad_to_devices (no-op when unpadded).
    Accepts any number of batched results (RegistrationResult,
    PoseUncertainty, ...) after the refined poses."""
    if refined.shape[0] == n:
        return (refined,) + rest
    return (refined[:n],) + tuple(_rows(r, slice(0, n)) for r in rest)


def shard_pose_batch(mesh: Sequence, init_poses, axis: str = "dp") -> list:
    """Cut (N, 4, 4) poses into len(mesh) equal shards, each on its device
    of ``mesh`` (a device list, make_mesh). N must be a multiple of the
    device count - pad_to_devices first for arbitrary batch sizes
    (PoseRefiner does this itself)."""
    _check_axis(axis)
    poses = torch.as_tensor(init_poses, dtype=torch.float32)
    if poses.shape[0] % len(mesh):
        raise ValueError(f"{poses.shape[0]} poses do not split over {len(mesh)} devices; "
                         "pad_to_devices first")
    return [p.to(canonical(d)) for p, d in zip(poses.chunk(len(mesh)), mesh)]


def replicate(obj, device: torch.device):
    """``obj`` (a tensor, an IndexedTris or a scene) on ``device``; a
    tensor already there is returned as it is."""
    if isinstance(obj, IndexedTris):
        return IndexedTris(obj.table.to(device), obj.ids.to(device))
    return obj.to(device)


def _replica(memo: Optional[dict], slot, obj, device: torch.device):
    """replicate(obj, device), kept in ``memo`` under (slot, device) and
    handed out again while the slot holds the same object; a new object
    in the slot replaces the old one's replica (one a slot and device)."""
    if memo is None:
        return replicate(obj, device)
    hit = memo.get((slot, device))
    if hit is None or hit[0] is not obj:
        hit = memo[(slot, device)] = (obj, replicate(obj, device))
    return hit[1]


def _gather(outs: list, home: torch.device):
    """Concatenate the shards' outputs (tensors or NamedTuples of tensors,
    None fields kept) on ``home``."""
    first = outs[0]
    if isinstance(first, tuple):
        return type(first)(*(None if f is None else _gather([o[i] for o in outs], home)
                             for i, f in enumerate(first)))
    return torch.cat([o.to(home) for o in outs])


@functools.lru_cache(maxsize=None)
def _shard_stream(device: torch.device, shard: int) -> "torch.cuda.Stream":
    """The CUDA stream of the shard-th entry of a device list, made once:
    a shard keeps its stream from call to call, and so the caching
    allocator's pool of blocks for that stream (a new stream each call
    would find its pool empty and allocate afresh)."""
    return torch.cuda.Stream(device)


def run_sharded(devices: Sequence, fn: Callable, tris, init_poses, shared: Sequence = (),
                per_pose: Optional[dict] = None, replicas: Optional[dict] = None, **kwargs):
    """fn(tris, poses, *shared, **per_pose, **kwargs) with the pose batch
    split over ``devices``: the batch (and per-pose tris, and each
    ``per_pose`` value, None or an (N, ...) tensor) padded to a multiple of
    the device count and cut into shards; a shard's tris and ``shared``
    arguments replicated to its device (kept in ``replicas``, a dict the
    caller keeps from call to call, see _replica); each shard run on a
    stream of its own; the outputs (a tensor or a tuple of tensors /
    NamedTuples) gathered on devices[0] behind every shard's stream, with
    the padding dropped."""
    devices = [canonical(d) for d in devices]
    home = devices[0]
    poses, tris, n = pad_to_devices(len(devices), init_poses, tris)
    pad = poses.shape[0] - n
    per_pose = {name: None if x is None else _pad_rows(x, pad)
                for name, x in (per_pose or {}).items()}
    size = poses.shape[0] // len(devices)
    outs, streams = [], []
    for i, dev in enumerate(devices):
        with span("prt.shard"):
            rows = slice(i * size, (i + 1) * size)
            if isinstance(tris, IndexedTris):
                t = IndexedTris(_replica(replicas, "tris", tris.table, dev), tris.ids[rows].to(dev))
            elif tris.dim() == 4:
                t = tris[rows].to(dev)
            else:
                t = _replica(replicas, "tris", tris, dev)
            args = [t, poses[rows].to(dev),
                    *(_replica(replicas, k, s, dev) for k, s in enumerate(shared))]
            named = {name: None if x is None else x[rows].to(dev) for name, x in per_pose.items()}
            stream = None
            if dev.type == "cuda":
                # the shard's stream starts behind what the caller enqueued
                stream = _shard_stream(dev, i)
                stream.wait_stream(torch.cuda.current_stream(dev))
            on_stream = (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext())
            with on_stream:
                out = fn(*args, **named, **kwargs)
            for a in (*args, *named.values()):  # made on the caller's stream, read on the shard's
                _record(a, stream)
            outs.append(out if isinstance(out, tuple) else (out,))
            streams.append((dev, stream))
    with span("prt.gather"):
        for dev, stream in streams:
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
        for out, (dev, _s) in zip(outs, streams):
            if dev.type == "cuda":  # outputs made on the shard's stream, read on dev's current
                _record(out, torch.cuda.current_stream(dev))
        gathered = tuple(_gather([o[j] for o in outs], home) for j in range(len(outs[0])))
        gathered = unpad_results(n, *gathered)
    return gathered if len(gathered) > 1 else gathered[0]


def _record(x, stream):
    """record_stream on every CUDA tensor in x (a tensor, or a tuple or a
    scene of them, a replica that a later call may replace among them):
    the caching allocator then keeps x's memory until ``stream``'s work
    queued so far is done."""
    if stream is None:
        return
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            x.record_stream(stream)
    elif isinstance(x, tuple):
        for f in x:
            _record(f, stream)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _record(getattr(x, f.name), stream)


def refine_poses_sharded(tris, init_poses, scene, proj, K, width: int, height: int,
                         max_points: int = 16384,
                         criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
                         mesh: Optional[Sequence] = None, axis: str = "dp",
                         use_pallas: Optional[bool] = None, **pipeline_kwargs):
    """Data-parallel refine: pipeline.refine_poses_jit with the pose batch
    (and per-pose tris and a ``scene_ids`` keyword) split over the devices
    of ``mesh`` (default: make_mesh(), every card;
    pipeline.refine_poses_split). Returns (refined poses, results[,
    uncertainty]) on mesh[0], equal to the one-device refine bit for bit.

    use_pallas picks the raster as in refine_poses_jit (pipeline._raster);
    pipeline_kwargs (window, stride, roi, lift, chunk_iters,
    with_information, ...) pass through with refine_poses_jit's defaults,
    so the sharded refine runs the same configuration as the single-device
    one."""
    from pose_refine_tpu_torch.pipeline import _raster, refine_poses_split

    _check_axis(axis)
    devices = make_mesh(axis=axis) if mesh is None else list(mesh)
    pipeline_kwargs.setdefault("chunk_iters", 8)
    return refine_poses_split(devices, tris, init_poses, scene, proj, K, width=width,
                              height=height, max_points=max_points, criteria=criteria,
                              raster=_raster(use_pallas), **pipeline_kwargs)
