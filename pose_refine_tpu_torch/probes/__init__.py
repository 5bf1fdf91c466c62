"""Measurement probes of the port: each a ``main()`` runnable as
``python -m pose_refine_tpu_torch.probes.<name>``."""
