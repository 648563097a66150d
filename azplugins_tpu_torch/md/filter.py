"""Particle filters (group selection).

Port of ``azplugins_tpu/md/filter.py`` (``All``; the other filters come
with the slices that use them). A filter resolves to a host mask for
group-wide observables and binds to a selector ``state -> bool tensor``
for the step loop, evaluated per step because the dense engine permutes
particles into cell slots (empty slots have tag < 0).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ParticleFilter", "All"]


class ParticleFilter:
    def mask(self, typeids: np.ndarray, types: list[str]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def bind(self, types: list[str]):
        """Return a selector ``state -> bool[N]`` for the step loop."""
        raise NotImplementedError  # pragma: no cover


class All(ParticleFilter):
    def mask(self, typeids, types):
        return np.ones(typeids.shape[0], dtype=bool)

    def bind(self, types):
        return lambda state: state.tag >= 0

    def __repr__(self):
        return "All()"
