"""The refine's window lift on the card: the hand-written CUDA kernel L1
(``csrc/lift.cu``) and its wrapper.

Replaces the JAX package's XLA code of the lift (pipeline.py:111-146:
``ops/depth_to_cloud.py::window_cloud_batched``, ``compact_topk`` and
``morton_key``), which the port's plain version,
``ops/depth_to_cloud.py::window_lift``, computes in plain PyTorch. One
launch lifts every render of a batch: the object box, the strided crop, the
points, the top-k selection and the Morton order (NN scenes). The kernel
rounds each operation as the plain version does on the card, so the two
agree bit for bit.

Dispatch (``pipeline._window_lift``): CPU renders take the plain version,
CUDA renders this wrapper. There is no fallback from the kernel to the
plain version; a shape the kernel cannot take, or a launch that fails,
raises.
"""

from __future__ import annotations

import torch

from pose_refine_tpu_torch._build import launch, load_kernels
from pose_refine_tpu_torch.ops.depth_to_cloud import window_grid

# a CTA keeps its two P-entry int arrays (rank buckets and lists) in shared
# memory up to this many bytes, else in a scratch buffer allocated here;
# mirrors kSharedCapBytes in csrc/lift.cu
SHARED_CAP_BYTES = 224 * 1024
MORTON_CAP = 1 << 14  # morton_key's 14-bit grid
_INT_MAX = 2 ** 31 - 1

# kernel launches by window_lift_cuda (chip_smoke.py resets and reads it to
# show the main path went through the kernel)
launches = 0


def scratch_ints(p: int, max_points: int) -> int:
    """int32 entries of device scratch a pose needs at P slots: 2P when the
    selection's arrays do not fit shared memory, else 0."""
    if max_points >= p or 8 * p <= SHARED_CAP_BYTES:
        return 0
    return 2 * p


def window_lift_cuda(depth: torch.Tensor, K, *, window: int, stride: int, max_points: int,
                     morton: bool, tl_x: int = 0, tl_y: int = 0):
    """Launch L1 on the current stream, without synchronising:
    ``ops.depth_to_cloud.window_lift``'s function of a contiguous (N, H,
    W) int32 CUDA framebuffer. Returns (clouds (N, P', 3) float32, valid
    (N, P') bool), P' = min(max_points, P). Raises for anything else, and
    for the Morton order of a window wider than 2^14 slots (as morton_key
    does)."""
    global launches
    if not isinstance(depth, torch.Tensor) or depth.device.type != "cuda":
        raise ValueError("window_lift_cuda needs the renders as CUDA tensors, got "
                         f"{type(depth).__name__} on "
                         f"{getattr(depth, 'device', 'the host')}")
    if depth.dtype != torch.int32 or depth.dim() != 3 or not depth.is_contiguous():
        raise ValueError(f"depth must be a contiguous (N, H, W) int32 tensor, got "
                         f"{depth.dtype} {tuple(depth.shape)}")
    n, h, w = depth.shape
    if h < 1 or w < 1 or h * w > _INT_MAX:
        raise ValueError(f"renders of {h} x {w} pixels cannot be lifted by one CTA")
    if min(window, stride, max_points) < 1 or max(window, stride) > _INT_MAX:
        raise ValueError(f"window ({window}) and stride ({stride}) must lie in [1, 2^31), "
                         f"max_points ({max_points}) must be >= 1")
    for name, v in (("tl_x", tl_x), ("tl_y", tl_y)):
        if abs(int(v)) > 2 ** 30:
            raise ValueError(f"{name} = {v} is outside the kernel's int32 range")
    sh, sw = window_grid(h, w, window, stride)
    p = sh * sw
    if morton and max(sh, sw) > MORTON_CAP:
        raise ValueError(f"grid ({sh}, {sw}) exceeds 14-bit morton key range")
    dev = depth.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    if K.shape != (3, 3):
        raise ValueError(f"K must be 3 x 3, got {tuple(K.shape)}")
    K = K.contiguous()
    rows = min(max_points, p)
    clouds = torch.empty((n, rows, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((n, rows), dtype=torch.bool, device=dev)
    if n == 0:
        return clouds, valid
    extra = scratch_ints(p, max_points)
    scratch = torch.empty((n, extra), dtype=torch.int32, device=dev) if extra else None
    launch(load_kernels()[0], "prt_window_lift", dev,
           (depth.data_ptr(), n, h, w, K.data_ptr(), window, stride, rows, int(bool(morton)),
            int(tl_x), int(tl_y), clouds.data_ptr(), valid.data_ptr(),
            None if scratch is None else scratch.data_ptr()), "window lift")
    launches += 1
    return clouds, valid
