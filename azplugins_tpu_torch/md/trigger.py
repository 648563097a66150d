"""Triggers: schedules for updaters.

Port of ``azplugins_tpu/md/trigger.py``. A trigger is evaluated on the
host from the integer timestep and returns a bool; the step loop decides
on the host whether an updater fires, so a firing costs no device read.
:meth:`Trigger.mask` gives the bools of a stretch of steps at once: the
CUDA graphs carry them to the card, where the updaters run as the
reference's masked selects.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Trigger", "Periodic", "After", "Before", "On", "as_trigger"]


class Trigger:
    def __call__(self, timestep: int) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def mask(self, t0: int, n: int) -> np.ndarray:
        """bool ``[n]``: whether the trigger holds at each of timesteps
        ``t0 .. t0 + n - 1``, as ``__call__`` says."""
        return np.array([bool(self(t)) for t in range(int(t0), int(t0) + int(n))], dtype=bool)


def _steps(t0: int, n: int) -> np.ndarray:
    return np.arange(int(t0), int(t0) + int(n), dtype=np.int64)


class Periodic(Trigger):
    def __init__(self, period: int, phase: int = 0):
        if period <= 0:
            raise ValueError("period must be positive")
        self.period = int(period)
        self.phase = int(phase)

    def __call__(self, timestep: int) -> bool:
        return (int(timestep) - self.phase) % self.period == 0

    def mask(self, t0: int, n: int) -> np.ndarray:
        return (_steps(t0, n) - self.phase) % self.period == 0


class After(Trigger):
    def __init__(self, timestep: int):
        self.timestep = int(timestep)

    def __call__(self, timestep: int) -> bool:
        return int(timestep) > self.timestep

    def mask(self, t0: int, n: int) -> np.ndarray:
        return _steps(t0, n) > self.timestep


class Before(Trigger):
    def __init__(self, timestep: int):
        self.timestep = int(timestep)

    def __call__(self, timestep: int) -> bool:
        return int(timestep) < self.timestep

    def mask(self, t0: int, n: int) -> np.ndarray:
        return _steps(t0, n) < self.timestep


class On(Trigger):
    def __init__(self, timestep: int):
        self.timestep = int(timestep)

    def __call__(self, timestep: int) -> bool:
        return int(timestep) == self.timestep

    def mask(self, t0: int, n: int) -> np.ndarray:
        return _steps(t0, n) == self.timestep


def as_trigger(value) -> Trigger:
    if isinstance(value, Trigger):
        return value
    if isinstance(value, int):
        return Periodic(value)
    raise TypeError(f"cannot interpret {value!r} as a trigger")
