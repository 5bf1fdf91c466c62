"""Model assets: mesh loading and procedural fixtures.

In this domain a "model" is a rigid-object triangle mesh (the reference's
cuda_renderer::Model); the implementation lives in
pose_refine_tpu_torch.mesh and is re-exported here as the canonical import
point (as ``pose_refine_tpu.models`` re-exports the JAX package's).
"""

from pose_refine_tpu_torch.mesh import (  # noqa: F401
    Model,
    find_reference_ply,
    load_benchmark_model,
    load_ply,
    make_bumpy_sphere,
    make_icosphere,
    morton_order,
    save_ply_ascii,
    simplify_vertex_clustering,
)
