"""Device selection for the PyTorch port.

The JAX package picks its raster backend from the default JAX backend
(pipeline.py:455-456: the Pallas kernel off the CPU, the XLA scatter path
on it). The port makes the device an explicit argument of every public
entry point instead, and resolves it here:

  * ``None``    - the CUDA card (the counterpart of JAX's default backend
                  on an accelerator), or ``RuntimeError`` when there is
                  none: the entry points run on the card unless the caller
                  asks for the CPU;
  * ``"cuda"``  - the same. A CUDA request never runs on the CPU.
  * ``"cpu"``   - the CPU, where every kernel wrapper uses its plain
                  PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def to_device(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (a tensor, a numpy array or a nested sequence) as a tensor on
    ``device``. Host data bound for a card is staged through pinned memory
    and copied without blocking: a copy from pageable memory synchronises
    the stream, which would hold an enqueue back until the card has
    finished its earlier work."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        t = torch.from_numpy(a if a.flags.writeable and a.flags.c_contiguous else a.copy())
    if dtype is not None and t.device.type == "cpu":
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Turn a device argument into a ``torch.device``: None is the card;
    a CUDA device the machine does not have raises."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False: no CUDA card on this machine"
            )
        # the JAX package contracts every matmul at Precision.HIGHEST; keep
        # TF32 out of the port's matmuls and convolutions the same way
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: expected 'cuda' or 'cpu'")
    return dev
