"""Time-dependent scalar parameters ("variants").

Port of ``azplugins_tpu/core/variant.py``. A variant is evaluated on the
host once per step from the integer timestep and returns a Python float
that is an exact float32 value, so device arithmetic with it rounds like
the reference's ``jnp.float32`` scalar. Each schedule computes in
``numpy.float32`` in the reference's operation order, so the value is the
reference's bit for bit (``Power``'s ``frac ** power`` goes through the C
library's ``powf`` and may differ from XLA's by an ulp).

Subclass ``Variant`` and override ``__call__`` for a custom schedule; it
must return a float for a Python int timestep.

A run reads a variant's values for a stretch of steps at once
(:meth:`Variant.values`, the bits ``__call__`` gives, as float32), so that
the device holds them: inside :func:`scheduled` the step loop's operations
take a variant's value at a step through :func:`value_at`, a 0-d float32
tensor on their device, which a CUDA graph reads anew at every replay; a
kernel's by-value argument (K8's and K9's kT) takes the host float on the
eager loop and the tensor only inside a graph. A ``Constant`` is a host
float everywhere, as is every variant outside a run (the reference's
traced scalar at ``t`` either way).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

__all__ = ["Variant", "Constant", "Ramp", "Cycle", "Power", "SphereArea", "as_variant",
           "scheduled", "value_at"]

_F32 = np.float32


def _clip01(x):
    return min(max(x, _F32(0.0)), _F32(1.0))


def _ramp_fraction(timestep: int, t_start: int, t_ramp: int):
    """The reference's ``clip((f32(t) - t_start) / t_ramp, 0, 1)``, in float32."""
    return _clip01((_F32(timestep) - _F32(t_start)) / _F32(t_ramp))


class Variant:
    """Base class: a scalar function of the integer timestep."""

    def __call__(self, timestep: int) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def values(self, t0: int, n: int) -> np.ndarray:
        """float32 ``[n]``: the value at each of timesteps ``t0 .. t0 + n -
        1``, the bits ``__call__`` gives."""
        return np.array([self(t) for t in range(int(t0), int(t0) + int(n))], dtype=np.float32)

    def range(self):
        """(min, max) bounds if known, for host-side validation."""
        return (-math.inf, math.inf)


class Constant(Variant):
    def __init__(self, value: float):
        self.value = float(value)

    def __call__(self, timestep: int) -> float:
        return float(_F32(self.value))

    def values(self, t0: int, n: int) -> np.ndarray:
        return np.full(int(n), _F32(self.value), dtype=np.float32)

    def range(self):
        return (self.value, self.value)

    def __eq__(self, other):
        return isinstance(other, Constant) and self.value == other.value


class Ramp(Variant):
    """Linear ramp from A to B over t_ramp steps starting at t_start."""

    def __init__(self, A: float, B: float, t_start: int, t_ramp: int):
        self.A = float(A)
        self.B = float(B)
        self.t_start = int(t_start)
        self.t_ramp = int(t_ramp)

    def __call__(self, timestep: int) -> float:
        frac = _ramp_fraction(timestep, self.t_start, self.t_ramp)
        return float(_F32(self.A) + frac * _F32(self.B - self.A))

    def range(self):
        return (min(self.A, self.B), max(self.A, self.B))


class Cycle(Variant):
    """Periodic triangle wave between A and B."""

    def __init__(self, A: float, B: float, t_start: int, t_A: int, t_AB: int, t_B: int, t_BA: int):
        self.A, self.B = float(A), float(B)
        self.t_start = int(t_start)
        self.t_A, self.t_AB, self.t_B, self.t_BA = int(t_A), int(t_AB), int(t_B), int(t_BA)

    def __call__(self, timestep: int) -> float:
        period = self.t_A + self.t_AB + self.t_B + self.t_BA
        # integer modulo first, then float32, as the reference's int32 ops
        t = _F32(max(int(timestep) - self.t_start, 0) % period)
        a, b = _F32(self.A), _F32(self.B)
        # piecewise: hold A, ramp A->B, hold B, ramp B->A
        e0 = _F32(self.t_A)
        e1 = e0 + _F32(self.t_AB)
        e2 = e1 + _F32(self.t_B)
        if t < e1:
            return float(a + (b - a) * _clip01((t - e0) / _F32(max(self.t_AB, 1))))
        if t < e2:
            return float(b)
        return float(b + (a - b) * _clip01((t - e2) / _F32(max(self.t_BA, 1))))

    def range(self):
        return (min(self.A, self.B), max(self.A, self.B))


class Power(Variant):
    """Power-law interpolation from A to B over t_ramp steps."""

    def __init__(self, A: float, B: float, power: float, t_start: int, t_ramp: int):
        self.A, self.B = float(A), float(B)
        self.power = float(power)
        self.t_start = int(t_start)
        self.t_ramp = int(t_ramp)

    def __call__(self, timestep: int) -> float:
        frac = _ramp_fraction(timestep, self.t_start, self.t_ramp)
        return float(_F32(self.A) + (frac ** _F32(self.power)) * _F32(self.B - self.A))

    def range(self):
        return (min(self.A, self.B), max(self.A, self.B))


class SphereArea(Variant):
    """Radius of a sphere whose *area* changes at constant rate alpha.

    R(t) = sqrt(max(R0^2 - (alpha / 4 pi) t, 0)) (the droplet-evaporation
    schedule of the reference).
    """

    def __init__(self, R0: float, alpha: float):
        if R0 < 0:
            raise ValueError("R0 must be non-negative")
        self.R0 = float(R0)
        self.alpha = float(alpha)

    def __call__(self, timestep: int) -> float:
        R0_sq = _F32(self.R0 * self.R0)
        k = _F32(self.alpha / (4.0 * 3.141592653589793))
        drsq = k * _F32(timestep)
        return float(np.sqrt(max(R0_sq - drsq, _F32(0.0))))

    def range(self):
        return (0.0, self.R0) if self.alpha >= 0 else (self.R0, math.inf)


def as_variant(value) -> Variant:
    """Coerce a float or Variant to a Variant (HOOMD-style preprocessing)."""
    if isinstance(value, Variant):
        return value
    if isinstance(value, (int, float)):
        return Constant(float(value))
    raise TypeError(f"cannot interpret {value!r} as a variant")


# the values in force inside scheduled(): (id -> row, the rows, their first
# timestep, {device: a copy of the rows there}, whether a host float may
# stand in), or None
_schedule: tuple | None = None


@contextlib.contextmanager
def scheduled(variants, rows: torch.Tensor | None, t0: int, host_form: bool = False):
    """Inside, :func:`value_at` gives ``variants[k]``'s value at timestep
    ``t`` as the 0-d float32 ``rows[k, t - t0]`` (``rows``: ``[len(variants),
    n]`` on a device, a view, no copy and no launch; on another device from a
    copy of the rows made once). ``rows`` None schedules nothing.
    ``host_form``: the steps run eagerly, so a caller that asks for it
    (``value_at(..., host_form=True)``) gets the host float instead."""
    global _schedule
    prev = _schedule
    if rows is not None:
        if rows.dtype != torch.float32 or tuple(rows.shape[:1]) != (len(variants),):
            raise ValueError(f"rows [{len(variants)}, n] of float32 expected, got "
                             f"{rows.dtype} {tuple(rows.shape)}")
        _schedule = ({id(v): k for k, v in enumerate(variants)}, rows, int(t0), {},
                     bool(host_form))
    try:
        yield
    finally:
        _schedule = prev


def value_at(variant: Variant, timestep: int, device=None, host_form: bool = False):
    """``variant``'s value at ``timestep`` as a step reads it: a
    ``Constant``'s, and any variant's outside :func:`scheduled`, as the host
    float ``variant(timestep)``; inside, the scheduled 0-d float32 tensor on
    ``device`` (default: the rows' own), the same bits. With ``host_form``
    (a kernel's by-value argument) the host float where the schedule allows
    it (the eager loop), the tensor inside a CUDA graph. A variant that is
    not scheduled, or a timestep outside the rows, raises: a value baked
    into a CUDA graph would be replayed at every timestep."""
    if _schedule is None or isinstance(variant, Constant):
        return variant(timestep)
    index, rows, t0, copies, host_ok = _schedule
    if host_form and host_ok:
        return variant(timestep)
    k = index.get(id(variant))
    j = int(timestep) - t0
    if k is None or not 0 <= j < rows.shape[1]:
        raise ValueError(f"{type(variant).__name__} has no scheduled value at timestep "
                         f"{timestep} (rows from {t0}, {rows.shape[1]} steps)")
    if device is not None and torch.device(device) != rows.device:
        dev = torch.device(device)
        if dev not in copies:
            copies[dev] = rows.to(dev, non_blocking=True)
        rows = copies[dev]
    return rows[k, j]
