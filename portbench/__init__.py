"""The benchmark of ``azplugins_tpu_torch``, the PyTorch and CUDA port:
timesteps per second of its configurations on one H100, per-layer metrics
from a profiled stretch, and a plain reference that judges every run."""
