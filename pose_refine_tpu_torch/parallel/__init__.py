from pose_refine_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    pad_to_devices,
    refine_poses_sharded,
    shard_pose_batch,
    unpad_results,
)
