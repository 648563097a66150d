from . import bond, filter, methods, nlist, pair, rotation  # noqa: A004
from .integrate import Integrator

__all__ = ["Integrator", "bond", "filter", "methods", "nlist", "pair", "rotation"]
