"""pose_refine_tpu_torch: the PyTorch + CUDA port of pose_refine_tpu.

Batch depth rasterization of pose hypotheses (a hand-written CUDA kernel,
``csrc/rasterize.cu``) plus batched point-to-plane ICP against a projective
scene, on an NVIDIA GPU or, with the kernels' plain PyTorch versions, on the
CPU. Every public entry point takes an explicit ``device=``. The package
imports torch and never jax.
"""

from pose_refine_tpu_torch import geometry  # noqa: F401
from pose_refine_tpu_torch.device import resolve_device  # noqa: F401
from pose_refine_tpu_torch.geometry import LINEMOD_K, compute_proj  # noqa: F401
from pose_refine_tpu_torch.icp import (  # noqa: F401
    ICPConvergenceCriteria,
    RegistrationResult,
    icp_point_to_plane,
)
from pose_refine_tpu_torch.mesh import (  # noqa: F401
    Model,
    load_benchmark_model,
    make_bumpy_sphere,
    make_icosphere,
    simplify_vertex_clustering,
)
from pose_refine_tpu_torch.ops.rasterize import rasterize_dense  # noqa: F401
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize, rasterize_plain  # noqa: F401
from pose_refine_tpu_torch.pipeline import PoseRefiner, refine_poses  # noqa: F401
from pose_refine_tpu_torch.scene.projective import SceneProjective  # noqa: F401

__version__ = "0.1.0"
