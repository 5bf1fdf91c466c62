"""pose_refine_tpu_torch: the PyTorch + CUDA port of pose_refine_tpu.

Batch depth rasterization of pose hypotheses (a hand-written CUDA kernel,
``csrc/rasterize.cu``) plus batched point-to-plane or point-to-point ICP,
optionally Huber-weighted, against a projective scene or a
nearest-neighbour scene (exact NN by the stackless kd traversal,
``csrc/nn_kdtree.cu``, or the flash-NN kernels, ``csrc/nn_flash.cu``; the
association's row gather, ``csrc/gather.cu``; every ICP iteration's
association, 29-float reduction and update in one kernel,
``csrc/icp_reduce.cu``), with its pose
uncertainty, stacked scenes (``set_scene_depths``), several
meshes in one batch (``MultiModelRefiner``), per-frame tracking
(``PoseRefiner.track``), the filtered ``TrackingSession`` and
``MultiObjectSession``, the coarse-to-fine point and gate schedules
(``coarse_iters``, ``refine(schedule=)``), and the reference's renderer
API (``PoseRenderer``), on an NVIDIA GPU or, with the kernels' plain
PyTorch versions, on the CPU; ``devices=`` splits the pose batch over
several devices (``parallel/``), ``utils.serialization`` saves and loads
scenes, trees, results and sessions in the JAX package's ``.npz`` format,
and ``native/`` holds the C++ kd-tree builder and the reference-algorithm
CPU baseline. Every public entry point takes an explicit ``device=``. The
JAX package's names, keywords and positional orders are accepted with its
meaning (``refine_poses_jit``, ``track_poses_jit``, ``track_poses_nn_jit``,
``use_pallas=``, ``chunk_iters=``, the sub-packages' exports). The
package imports torch and never jax.
"""

from pose_refine_tpu_torch import geometry  # noqa: F401
from pose_refine_tpu_torch.api import PoseRenderer, get_bbox  # noqa: F401
from pose_refine_tpu_torch.device import resolve_device  # noqa: F401
from pose_refine_tpu_torch.geometry import LINEMOD_K, compute_proj, sample_hypotheses  # noqa: F401
from pose_refine_tpu_torch.icp import (  # noqa: F401
    DEPTH_QUANT_SIGMA_M,
    LATERAL_QUANT_COEFF,
    RENDER_COV_INFLATION,
    ICPConvergenceCriteria,
    PoseUncertainty,
    RegistrationResult,
    icp_point_to_plane,
    icp_point_to_plane_batch,
    icp_point_to_point,
    pose_covariance,
    pose_information,
)
from pose_refine_tpu_torch.mesh import (  # noqa: F401
    Model,
    load_benchmark_model,
    load_gltf,
    load_obj,
    load_ply,
    load_stl,
    make_bumpy_sphere,
    make_icosphere,
    simplify_vertex_clustering,
)
from pose_refine_tpu_torch.ops.convert import (  # noqa: F401
    raw_to_depth_mask,
    raw_to_depth_u16,
    raw_to_mask_u8,
)
from pose_refine_tpu_torch.ops.depth_to_cloud import depth_to_cloud  # noqa: F401
from pose_refine_tpu_torch.ops.gather import gather_rows  # noqa: F401
from pose_refine_tpu_torch.ops.rasterize import (  # noqa: F401
    rasterize_dense,
    rasterize_scatter,
    render,
)
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize, rasterize_plain  # noqa: F401
from pose_refine_tpu_torch.pipeline import (  # noqa: F401
    MultiModelRefiner,
    PendingResult,
    PoseRefiner,
    fence,
    refine_poses,
    refine_poses_jit,
    track_poses,
    track_poses_nn,
)
from pose_refine_tpu_torch.scene.kdtree import KDTree, build_kdtree  # noqa: F401
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
