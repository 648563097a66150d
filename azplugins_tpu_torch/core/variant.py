"""Time-dependent scalar parameters ("variants").

Port of ``azplugins_tpu/core/variant.py`` (``Constant`` and ``as_variant``;
the other schedules come with the slices that use them). A variant is
evaluated on the host once per step from the integer timestep and returns
a Python float that is an exact float32 value, so device arithmetic with it
rounds like the reference's ``jnp.float32`` scalar.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Variant", "Constant", "as_variant"]


class Variant:
    """Base class: a scalar function of the integer timestep."""

    def __call__(self, timestep: int) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class Constant(Variant):
    def __init__(self, value: float):
        self.value = float(value)

    def __call__(self, timestep: int) -> float:
        return float(np.float32(self.value))


def as_variant(value) -> Variant:
    """Coerce a float or Variant to a Variant (HOOMD-style preprocessing)."""
    if isinstance(value, Variant):
        return value
    if isinstance(value, (int, float)):
        return Constant(float(value))
    raise TypeError(f"cannot interpret {value!r} as a variant")
