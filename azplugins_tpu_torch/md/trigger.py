"""Triggers: schedules for updaters.

Port of ``azplugins_tpu/md/trigger.py``. A trigger is evaluated on the
host from the integer timestep and returns a bool; the step loop decides
on the host whether an updater fires, so a firing costs no device read.
"""

from __future__ import annotations

__all__ = ["Trigger", "Periodic", "After", "Before", "On", "as_trigger"]


class Trigger:
    def __call__(self, timestep: int) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


class Periodic(Trigger):
    def __init__(self, period: int, phase: int = 0):
        if period <= 0:
            raise ValueError("period must be positive")
        self.period = int(period)
        self.phase = int(phase)

    def __call__(self, timestep: int) -> bool:
        return (int(timestep) - self.phase) % self.period == 0


class After(Trigger):
    def __init__(self, timestep: int):
        self.timestep = int(timestep)

    def __call__(self, timestep: int) -> bool:
        return int(timestep) > self.timestep


class Before(Trigger):
    def __init__(self, timestep: int):
        self.timestep = int(timestep)

    def __call__(self, timestep: int) -> bool:
        return int(timestep) < self.timestep


class On(Trigger):
    def __init__(self, timestep: int):
        self.timestep = int(timestep)

    def __call__(self, timestep: int) -> bool:
        return int(timestep) == self.timestep


def as_trigger(value) -> Trigger:
    if isinstance(value, Trigger):
        return value
    if isinstance(value, int):
        return Periodic(value)
    raise TypeError(f"cannot interpret {value!r} as a trigger")
