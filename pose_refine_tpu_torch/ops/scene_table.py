"""The projective scene table on the card: the hand-written CUDA kernel of
``csrc/scene_table.cu`` and its wrapper.

Replaces the JAX package's XLA code of the table
(``pose_refine_tpu/scene/projective.py::_build_projective_table``:
dep2pcd, the LINEMOD normals and the zero pad), which the port's plain
version, ``scene/projective.py::_build_projective_table_plain``, computes
in eager PyTorch as some 200 small kernels. One launch writes the whole
(H*W, 8) table of a frame, or the (K*H*W, 8) table of a stack of frames;
the kernel rounds each operation as the plain version does on the card, so
the two agree bit for bit.

Dispatch (``scene/projective.py::_build_projective_table``): CPU frames
take the plain version, CUDA frames this wrapper. There is no fallback
from the kernel to the plain version; a frame the kernel cannot take, or a
launch that fails, raises.
"""

from __future__ import annotations

import torch

from pose_refine_tpu_torch._build import launch, load_kernels

# the kernel's grid: frames on its z axis, 16-row tiles on its y axis
MAX_FRAMES = 65535
MAX_ROWS = 16 * 65535
_INT_MAX = 2 ** 31 - 1

# kernel launches by scene_table_cuda (chip_smoke.py resets and reads it to
# show the main path went through the kernel)
launches = 0


def check_frames(depth, K) -> None:
    """Raise ValueError unless ``depth`` is an (H, W) frame or a (K, H, W)
    stack and ``K`` a 3 x 3 camera matrix."""
    if len(depth.shape) not in (2, 3):
        raise ValueError(f"the scene table wants an (H, W) frame or (K, H, W) frames, got "
                         f"{tuple(depth.shape)}")
    if tuple(torch.as_tensor(K).shape) != (3, 3):
        raise ValueError(f"K must be 3 x 3, got {tuple(torch.as_tensor(K).shape)}")


def scene_table_cuda(depth: torch.Tensor, K) -> torch.Tensor:
    """Launch the kernel on the current stream, without synchronising:
    ``_build_projective_table_plain``'s function of a contiguous (H, W) or
    (K, H, W) int32 CUDA frame (mm) and K on the same card. Returns the
    (H*W, 8) or (K*H*W, 8) float32 table of [x y z | nx ny nz | 0 0] rows.
    Raises for anything else."""
    global launches
    check_frames(depth, K)
    if not isinstance(depth, torch.Tensor) or depth.device.type != "cuda":
        raise ValueError("scene_table_cuda needs the frames as CUDA tensors, got "
                         f"{type(depth).__name__} on {getattr(depth, 'device', 'the host')}")
    if depth.dtype != torch.int32 or not depth.is_contiguous():
        raise ValueError(f"depth must be a contiguous int32 tensor, got {depth.dtype} "
                         f"{tuple(depth.shape)}")
    frames = depth if depth.dim() == 3 else depth[None]
    k, h, w = frames.shape
    if k > MAX_FRAMES or h > MAX_ROWS or h * w > _INT_MAX:
        raise ValueError(f"{k} frames of {h} x {w} pixels exceed the kernel's grid")
    dev = depth.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev).contiguous()
    table = torch.empty((k * h * w, 8), dtype=torch.float32, device=dev)
    if table.shape[0] == 0:
        return table
    launch(load_kernels()[0], "prt_scene_table", dev,
           (frames.data_ptr(), k, h, w, K.data_ptr(), table.data_ptr()), "scene table")
    launches += 1
    return table
