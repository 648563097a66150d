from . import aniso_kernel, dense, dpd_kernel, evaluators, pair_kernel, rng_kernel  # noqa: F401
from .pair_force import ForceResult  # noqa: F401
