"""Raw framebuffer -> depth / mask conversions (PyTorch port of
``pose_refine_tpu/ops/convert.py``): the reference's raw2depth_uint16 /
raw2mask_uint8 / raw2depth_mask output converters (renderer.cpp:300-366,
renderer.cu:338-439), batched. Elementwise PyTorch on the tensor's device,
as the JAX package leaves them to XLA."""

from __future__ import annotations

import torch


def raw_to_depth_u16(raw: torch.Tensor) -> torch.Tensor:
    """(N, H, W) int32 mm -> uint16 depth (renderer.cu:354-376), wrapping
    modulo 2^16 as the integer conversion of both packages does."""
    return torch.as_tensor(raw).to(torch.uint16)


def raw_to_mask_u8(raw: torch.Tensor) -> torch.Tensor:
    """(N, H, W) int32 mm -> uint8 mask, 255 where rendered
    (renderer.cu:378-400)."""
    raw = torch.as_tensor(raw)
    return torch.where(raw > 0, 255, 0).to(torch.uint8)


def raw_to_depth_mask(raw: torch.Tensor):
    """Both conversions of one framebuffer (raw2depth_mask_kernel,
    renderer.cu:402-407): (uint16 depth, uint8 mask)."""
    return raw_to_depth_u16(raw), raw_to_mask_u8(raw)
