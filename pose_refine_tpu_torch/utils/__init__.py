from pose_refine_tpu_torch.utils.timer import Timer, time_jitted  # noqa: F401
