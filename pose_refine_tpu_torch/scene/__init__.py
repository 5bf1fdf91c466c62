"""The scenes (the JAX package's ``pose_refine_tpu.scene`` exports).

The names load on first use (PEP 562): ``ops/icp_reduce.py`` imports
``scene.nn_flash``, and both scene modules import ``ops.icp_reduce``, so
importing them here at once would close that cycle.
"""

import importlib

_EXPORTS = {
    "SceneProjective": "projective",
    "SceneProjectiveStack": "projective",
    "SceneNN": "nn",
    "SceneNNStack": "nn",
    "KDTree": "kdtree",
    "build_kdtree": "kdtree",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
