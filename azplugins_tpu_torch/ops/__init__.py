from . import dense, evaluators, pair_kernel  # noqa: F401
from .pair_force import ForceResult  # noqa: F401
