"""Device selection for the PyTorch port.

The JAX package picks its raster backend from the default JAX backend
(pipeline.py:455-456: the Pallas kernel off the CPU, the XLA scatter path
on it). The port makes the device an explicit argument of every public
entry point instead, and resolves it here:

  * ``None``    - the CUDA card when one is present, else the CPU (the
                  counterpart of JAX's default backend);
  * ``"cuda"``  - the card, or ``RuntimeError`` when there is none. A CUDA
                  request never runs on the CPU.
  * ``"cpu"``   - the CPU, where every kernel wrapper uses its plain
                  PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Turn a device argument into a ``torch.device``, refusing a CUDA
    device the machine does not have."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
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
