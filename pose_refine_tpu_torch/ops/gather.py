"""Row gather of an (R, 8) float32 table: the hand-written CUDA kernel
``csrc/gather.cu``, its wrapper, and its plain PyTorch version.

Replaces ``scripts/probe_pallas_gather.py::gather_pallas``. It is the
association lookup of every ICP pass: the projective query gathers the scene
table at the projected pixel (scene/projective.py), the NN query at the
flash kernels' index (scene/nn.py). Both clamp the index into the table
first, so ``gather_rows`` computes ``table[clamp(idx, 0, R - 1)]``.

Dispatch: ``gather_rows`` uses the plain version for CPU tensors and the
kernel for CUDA tensors. There is no fallback from the kernel to the plain
version; a kernel that does not build or launch raises.
"""

from __future__ import annotations

import torch

from pose_refine_tpu_torch._build import launch, load_kernels

ROW = 8  # floats per table row: [xyz | normal xyz | 0 0]

# kernel launches by gather_rows_cuda (chip_smoke.py resets and reads it to
# show the main path went through the kernel)
launches = 0


def _check(table: torch.Tensor, idx: torch.Tensor):
    if table.dim() != 2 or table.shape[1] != ROW or table.shape[0] == 0:
        raise ValueError(f"table must be (R, {ROW}) with R > 0, got {tuple(table.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32 or int64, got {idx.dtype}")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device: (R, 8) table, (...) indices ->
    (..., 8) rows, each index clamped into [0, R) first."""
    _check(table, idx)
    flat = idx.reshape(-1).clamp(0, table.shape[0] - 1)
    return torch.index_select(table, 0, flat).reshape(*idx.shape, ROW)


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch csrc/gather.cu on the current stream, without synchronising;
    raises for anything but a contiguous, 16-byte aligned float32 table and
    integer indices on one CUDA device."""
    global launches
    _check(table, idx)
    dev = table.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"gather_rows_cuda needs CUDA tensors on one device, got table on "
                         f"{dev} and idx on {idx.device}")
    if table.dtype != torch.float32 or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be a contiguous, 16-byte aligned float32 tensor")
    flat = idx.reshape(-1).contiguous()
    n = flat.numel()
    if n >= 2 ** 31:
        raise ValueError(f"too many indices for one launch: {n}")
    if flat.data_ptr() % flat.element_size():
        raise ValueError("idx must be aligned to its element size")
    out = torch.empty((n, ROW), dtype=torch.float32, device=dev)
    launch(load_kernels()[0], "prt_gather_rows", dev,
           (table.data_ptr(), table.shape[0], flat.data_ptr(), flat.element_size(), n,
            out.data_ptr()), "gather_rows")
    launches += 1
    return out.reshape(*idx.shape, ROW)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[clamp(idx, 0, R - 1)]: (R, 8) float32 table, (...) int32 or
    int64 indices -> (..., 8). CUDA: the kernel; CPU: the plain version."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    return gather_rows_cuda(table, idx)
