"""Small helpers shared across the port.

Counterpart of ``azplugins_tpu/utils/jaxtools.py``. The reference keeps
its state in frozen pytree dataclasses; the port keeps the frozen
dataclasses (so a timestep builds new tensors instead of mutating the ones
a transactional replay may roll back to) and only needs their ``replace``.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import torch

T = TypeVar("T")

__all__ = ["as_blocks", "frozen_dataclass", "sqrt"]


def frozen_dataclass(cls: type[T]) -> type[T]:
    """Decorator: frozen dataclass with a ``replace(**updates)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls


def as_blocks(x) -> tuple:
    """A layout held whole or as shards (a State, a GridMeta, a tensor) as a
    tuple of blocks: a tuple is kept, anything else is one block."""
    return x if isinstance(x, tuple) else (x,)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x``, as the reference's
    ``jnp.sqrt`` gives it on every host.

    PyTorch's CPU ``torch.sqrt`` on float32 is not correctly rounded on every
    host (a vectorised kernel can land 1 ulp off), so a float32 tensor on the
    CPU takes its root in float64 and rounds once to float32: a double has
    53 >= 2 * 24 + 2 bits, so the double rounding is innocuous for a square
    root. Every other tensor, and every CUDA tensor (whose ``torch.sqrt`` is
    IEEE, as the kernels' ``sqrtf`` is), takes ``torch.sqrt`` as it is.
    """
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
