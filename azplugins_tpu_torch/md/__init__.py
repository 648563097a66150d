from . import filter, methods, nlist, pair  # noqa: A004
from .integrate import Integrator

__all__ = ["Integrator", "filter", "methods", "nlist", "pair"]
