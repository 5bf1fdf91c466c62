"""Checkpoint / resume: persist scenes, kd-trees, results, filters and
tracking sessions in one ``.npz`` (the PyTorch port of
``pose_refine_tpu/utils/serialization.py``).

The file format is the JAX package's, so a file written by either package
loads in the other: a ``__meta__`` JSON string with the ``kind`` and the
``static`` (non-array) fields, and the arrays under the JAX classes' field
names; sessions flatten their filters' states as ``tracker.`` /
``tracker{i}.`` keys. The port's ``SceneNN`` differs from JAX's in layout
only: it keeps its kd tree as one packed ``KDTreeDevice`` table (``kd``,
None for a device-built scene), its gated kernel's ball table
(``flash_balls``, derived from ``flash_table``) and its gate as a host
float. ``save`` writes JAX's fields (the tree's flat arrays, or for a
device-built scene the one-leaf stub JAX's ``from_depth_device`` writes,
nn.py:239-253); ``load`` derives the port's tables from them.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pose_refine_tpu_torch import tracking
from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.icp import RegistrationResult
from pose_refine_tpu_torch.scene import nn_flash
from pose_refine_tpu_torch.scene.kdtree import KDTree, KDTreeDevice, ensure_leaf_bboxes
from pose_refine_tpu_torch.scene.nn import SceneNN, SceneNNStack
from pose_refine_tpu_torch.scene.projective import SceneProjective, SceneProjectiveStack
from pose_refine_tpu_torch.utils.fusion import PoseTracker

_KINDS = ("SceneProjective", "SceneProjectiveStack", "SceneNN", "SceneNNStack", "KDTree",
          "RegistrationResult", "PoseTracker", "TrackingSession", "MultiObjectSession")

# session state_dict values that are plain arrays (everything else - floats,
# strings, None, tuples - rides in the JSON meta)
_TRACKER_ARRAY_KEYS = ("T_m", "P", "Q", "T_prev")
# JAX SceneNN's kd fields (nn.py:49-54), in the port the views of SceneNN.kd
_TREE_FIELDS = ("parent", "child", "split_dim", "split_v", "bbox", "bounds")
_TREE_ARRAYS = ("points", "normals") + _TREE_FIELDS


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten_tracker(state: dict, prefix: str, arrays: dict, static: dict):
    for k, v in state.items():
        if k in _TRACKER_ARRAY_KEYS:
            arrays[f"{prefix}{k}"] = np.asarray(v)
        else:
            static[f"{prefix}{k}"] = v


def _unflatten_tracker(prefix: str, arrays: dict, static: dict) -> dict:
    state = {k: arrays[f"{prefix}{k}"] for k in _TRACKER_ARRAY_KEYS if f"{prefix}{k}" in arrays}
    for k, v in static.items():
        if k.startswith(prefix) and "." not in k[len(prefix):]:
            state[k[len(prefix):]] = v
    return state


def _scene_nn_fields(obj: SceneNN):
    """(arrays, static) of a port SceneNN under the JAX SceneNN's fields."""
    arrays = {f: _host(getattr(obj, f))
              for f in ("points", "normals", "table", "flash_table", "flash_boxes")}
    if obj.kd is None:
        # device-built: no tree - JAX's stub, one leaf over every row
        rows = arrays["points"].shape[0]
        arrays.update(parent=np.full(1, -1, np.int32), child=np.full((1, 2), -1, np.int32),
                      split_dim=np.zeros(1, np.int32), split_v=np.zeros(1, np.float32),
                      bbox=np.zeros((1, 6), np.float32),
                      bounds=np.array([[0, rows]], np.int32))
        static = {"leaf_cap": 1, "max_steps": 1}
    else:
        arrays.update({f: _host(getattr(obj.kd, f)) for f in _TREE_FIELDS})
        static = {"leaf_cap": obj.kd.leaf_cap, "max_steps": obj.kd.max_steps}
    arrays["max_dist_diff"] = np.float32(obj.max_dist_diff)
    static["backend"] = obj.backend
    return arrays, static


def save(path: str, obj) -> None:
    """Save a scene / kd-tree / result / tracker / tracking session to
    ``path`` (.npz). Tensors are read back from their device. Sessions
    store their full loop state (filters, rng stream, gate config); reload
    them with ``load(path, refiner=...)``, since refiners are rebuilt, not
    serialized."""
    kind = type(obj).__name__
    if kind not in _KINDS:
        raise TypeError(f"don't know how to serialize {kind}")
    arrays, static = {}, {}
    if kind == "PoseTracker":  # filter state: exact resume of a track
        arrays = obj.state_dict()
        static["n_rejected"] = arrays.pop("n_rejected")
    elif kind == "TrackingSession":
        state = obj.state_dict()
        _flatten_tracker(state.pop("tracker"), "tracker.", arrays, static)
        static.update(state)
    elif kind == "MultiObjectSession":
        state = obj.state_dict()
        for i, ts in enumerate(state.pop("trackers")):
            _flatten_tracker(ts, f"tracker{i}.", arrays, static)
        static.update(state)
    elif kind == "RegistrationResult":
        arrays = {name: _host(v) for name, v in obj._asdict().items() if v is not None}
    elif kind == "SceneNN":
        arrays, static = _scene_nn_fields(obj)
    else:  # the other scene dataclasses and KDTree: ints and strings static
        for name, v in vars(obj).items():
            if name == "max_dist_diff":  # JAX keeps the gate as a float32 array
                arrays[name] = np.float32(_host(v))
            elif isinstance(v, (int, str, bool)):
                static[name] = v
            elif name != "flash_balls":  # derived from flash_table on load
                arrays[name] = _host(v)
    meta = {"kind": kind, "static": static}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load(path: str, refiner=None, device: DeviceLike = None):
    """Load an object stored by :func:`save` (or by the JAX package's
    ``save``). Scenes and results come back as tensors on ``device`` (the
    card unless asked, as every entry point of the port); a KDTree and a
    PoseTracker are host numpy, as they were saved. A kd tree (KDTree, or a
    SceneNN's) gets its missing leaf boxes back from its points
    (ensure_leaf_bboxes): files from before the JAX package's round 3 carry
    none, and the kd traversal prunes with them.

    Tracking sessions need ``refiner=`` (a freshly configured PoseRefiner /
    MultiModelRefiner matching the one the session was built with)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {n: z[n] for n in z.files if n != "__meta__"}
    kind, static = meta["kind"], meta["static"]
    if kind not in _KINDS:
        raise TypeError(f"don't know how to load {kind}")
    if kind in ("TrackingSession", "MultiObjectSession"):
        if refiner is None:
            raise ValueError(f"{kind} needs load(path, refiner=...) - refiners are rebuilt, "
                             "not serialized")
        state = {k: (tuple(v) if k == "max_innovation" and isinstance(v, list) else v)
                 for k, v in static.items() if "." not in k}
        if kind == "TrackingSession":
            state["tracker"] = _unflatten_tracker("tracker.", arrays, static)
            return tracking.TrackingSession.from_state(refiner, state)
        state["trackers"] = [_unflatten_tracker(f"tracker{i}.", arrays, static)
                             for i in range(len(state["model_ids"]))]
        return tracking.MultiObjectSession.from_state(refiner, state)
    if kind == "PoseTracker":
        return PoseTracker.from_state({**arrays, **static})
    if "bbox" in arrays:  # KDTree, SceneNN
        arrays["bbox"] = ensure_leaf_bboxes(arrays["points"], arrays["child"],
                                            arrays["bounds"], arrays["bbox"])
    if kind == "KDTree":
        return KDTree(**{f: arrays[f] for f in _TREE_ARRAYS})
    dev = resolve_device(device)
    t = {name: torch.as_tensor(a, device=dev) for name, a in arrays.items()}
    if kind == "RegistrationResult":
        return RegistrationResult(**t)
    if kind in ("SceneProjective", "SceneProjectiveStack"):
        cls = SceneProjective if kind == "SceneProjective" else SceneProjectiveStack
        return cls(**t, **static)
    gate = float(arrays["max_dist_diff"])
    balls = nn_flash.ball_table(t["flash_table"])
    if kind == "SceneNNStack":
        return SceneNNStack(table=t["table"], points=t["points"], flash_table=t["flash_table"],
                            flash_boxes=t["flash_boxes"], flash_balls=balls, max_dist_diff=gate,
                            **static)
    kd = None
    if int(static["max_steps"]) != 1:  # 1 = the device-built scene's stub (no tree)
        kd = KDTreeDevice.from_tree(KDTree(**{f: arrays[f] for f in _TREE_ARRAYS}), dev)
    return SceneNN(points=t["points"], normals=t["normals"], table=t["table"],
                   flash_table=t["flash_table"], flash_boxes=t["flash_boxes"],
                   flash_balls=balls, max_dist_diff=gate, backend=static["backend"], kd=kd)
