"""pose_refine_tpu_torch: the PyTorch + CUDA port of pose_refine_tpu.

Batch depth rasterization of pose hypotheses (a hand-written CUDA kernel,
``csrc/rasterize.cu``) plus batched point-to-plane ICP against a projective
scene or a nearest-neighbour scene (exact NN by the flash-NN kernels,
``csrc/nn_flash.cu``; the association's row gather, ``csrc/gather.cu``;
every ICP pass's association and 29-float reduction in one kernel,
``csrc/icp_reduce.cu``), with its pose uncertainty, stacked scenes (``set_scene_depths``), several
meshes in one batch (``MultiModelRefiner``), per-frame tracking
(``PoseRefiner.track``), the filtered ``TrackingSession`` and
``MultiObjectSession``, on an NVIDIA GPU or, with the kernels' plain
PyTorch versions, on the CPU. Every public entry point takes an
explicit ``device=``. The package imports torch and never jax.
"""

from pose_refine_tpu_torch import geometry  # noqa: F401
from pose_refine_tpu_torch.device import resolve_device  # noqa: F401
from pose_refine_tpu_torch.geometry import LINEMOD_K, compute_proj  # noqa: F401
from pose_refine_tpu_torch.icp import (  # noqa: F401
    DEPTH_QUANT_SIGMA_M,
    LATERAL_QUANT_COEFF,
    RENDER_COV_INFLATION,
    ICPConvergenceCriteria,
    PoseUncertainty,
    RegistrationResult,
    icp_point_to_plane,
    pose_covariance,
    pose_information,
)
from pose_refine_tpu_torch.mesh import (  # noqa: F401
    Model,
    load_benchmark_model,
    make_bumpy_sphere,
    make_icosphere,
    simplify_vertex_clustering,
)
from pose_refine_tpu_torch.ops.gather import gather_rows  # noqa: F401
from pose_refine_tpu_torch.ops.rasterize import rasterize_dense  # noqa: F401
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize, rasterize_plain  # noqa: F401
from pose_refine_tpu_torch.pipeline import (  # noqa: F401
    MultiModelRefiner,
    PendingResult,
    PoseRefiner,
    refine_poses,
    track_poses,
    track_poses_nn,
)
from pose_refine_tpu_torch.scene.nn import SceneNN, SceneNNStack  # noqa: F401
from pose_refine_tpu_torch.scene.projective import (  # noqa: F401
    SceneProjective,
    SceneProjectiveStack,
)
from pose_refine_tpu_torch.tracking import (  # noqa: F401
    MultiObjectSession,
    TrackingSession,
    TrackStep,
)
from pose_refine_tpu_torch.utils.fusion import CHI2_6_99, PoseTracker  # noqa: F401

__version__ = "0.1.0"
