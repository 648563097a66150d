"""Small helpers shared across the port.

Counterpart of ``azplugins_tpu/utils/jaxtools.py``. The reference keeps
its state in frozen pytree dataclasses; the port keeps the frozen
dataclasses (so a timestep builds new tensors instead of mutating the ones
a transactional replay may roll back to) and only needs their ``replace``.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

T = TypeVar("T")

__all__ = ["frozen_dataclass"]


def frozen_dataclass(cls: type[T]) -> type[T]:
    """Decorator: frozen dataclass with a ``replace(**updates)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls
