"""State carried between the JAX package and the port as numpy arrays.

The port never imports jax: callers convert the JAX package's arrays with
``np.asarray`` and build the port's state from them here, so both packages
compute on identical inputs (the CPU tests do exactly that).
"""

from __future__ import annotations

import numpy as np
import torch

from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.icp import RegistrationResult
from pose_refine_tpu_torch.scene.projective import SceneProjective


def scene_from_numpy(table, K, max_dist_diff, height: int, width: int,
                     device: DeviceLike = None) -> SceneProjective:
    """A SceneProjective from a packed (H*W, 8) table (e.g.
    ``np.asarray(jax_scene.table)``), K and the gate."""
    dev = resolve_device(device)
    table = torch.as_tensor(np.asarray(table, np.float32), device=dev)
    if tuple(table.shape) != (height * width, 8):
        raise ValueError(f"table shape {tuple(table.shape)} != ({height * width}, 8)")
    return SceneProjective(
        table=table,
        K=torch.as_tensor(np.asarray(K, np.float32), device=dev),
        max_dist_diff=torch.tensor(float(np.asarray(max_dist_diff)), dtype=torch.float32,
                                   device=dev),
        height=int(height),
        width=int(width),
    )


def tris_from_numpy(tris, device: DeviceLike = None) -> torch.Tensor:
    """(T, 3, 3) or (N, T, 3, 3) float32 triangle table on ``device``."""
    return torch.as_tensor(np.asarray(tris, np.float32), device=resolve_device(device))


def proj_from_numpy(proj, device: DeviceLike = None) -> torch.Tensor:
    """(4, 4) float32 projection on ``device``."""
    return torch.as_tensor(np.asarray(proj, np.float32), device=resolve_device(device))


def results_to_numpy(results: RegistrationResult) -> RegistrationResult:
    """The same result with every field a host numpy array."""
    return RegistrationResult(
        *(None if f is None else f.detach().cpu().numpy() for f in results)
    )
