from . import bond, filter, methods, nlist, pair, rotation, trigger  # noqa: A004
from .integrate import Integrator

__all__ = ["Integrator", "bond", "filter", "methods", "nlist", "pair", "rotation", "trigger"]
