"""Particle filters (group selection).

Port of ``azplugins_tpu/md/filter.py``. A filter resolves to a host mask
for group-wide observables and binds to a selector ``state -> bool
tensor`` for the step loop, evaluated per step because the dense engine
permutes particles into cell slots (empty slots have tag < 0). Filters
compare and hash by their repr.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ParticleFilter", "All", "Null", "Type", "Tags", "Intersection", "Union"]


class ParticleFilter:
    def mask(self, typeids: np.ndarray, types: list[str]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def bind(self, types: list[str]):
        """Return a selector ``state -> bool[N]`` for the step loop."""
        raise NotImplementedError  # pragma: no cover

    def __hash__(self):
        return hash(repr(self))

    def __eq__(self, other):
        return repr(self) == repr(other)


class All(ParticleFilter):
    def mask(self, typeids, types):
        return np.ones(typeids.shape[0], dtype=bool)

    def bind(self, types):
        return lambda state: state.tag >= 0

    def __repr__(self):
        return "All()"


class Null(ParticleFilter):
    def mask(self, typeids, types):
        return np.zeros(typeids.shape[0], dtype=bool)

    def bind(self, types):
        return lambda state: torch.zeros_like(state.tag, dtype=torch.bool)

    def __repr__(self):
        return "Null()"


def _type_ids(names, types) -> list[int]:
    ids = []
    for t in names:
        if t not in types:
            raise ValueError(f"unknown particle type {t!r}")
        ids.append(types.index(t))
    return ids


class Type(ParticleFilter):
    def __init__(self, types):
        if isinstance(types, str):
            types = [types]
        self.types = tuple(sorted(types))

    def mask(self, typeids, types):
        return np.isin(typeids, _type_ids(self.types, types))

    def bind(self, types):
        ids = _type_ids(self.types, types)

        def select(state):
            sel = state.tag < 0  # all False, of the right shape
            for i in ids:
                sel = sel | (state.typeid == i)
            return sel & (state.tag >= 0)

        return select

    def __repr__(self):
        return f"Type({self.types})"


class Tags(ParticleFilter):
    def __init__(self, tags):
        self.tags = tuple(int(t) for t in tags)

    def mask(self, typeids, types):
        sel = np.zeros(typeids.shape[0], dtype=bool)
        sel[list(self.tags)] = True
        return sel

    def bind(self, types):
        tags = self.tags

        def select(state):
            sel = state.tag < 0
            for t in tags:
                sel = sel | (state.tag == t)
            return sel

        return select

    def __repr__(self):
        return f"Tags({self.tags})"


class Intersection(ParticleFilter):
    def __init__(self, f, g):
        self.f, self.g = f, g

    def mask(self, typeids, types):
        return self.f.mask(typeids, types) & self.g.mask(typeids, types)

    def bind(self, types):
        f, g = self.f.bind(types), self.g.bind(types)
        return lambda state: f(state) & g(state)

    def __repr__(self):
        return f"Intersection({self.f!r}, {self.g!r})"


class Union(ParticleFilter):
    def __init__(self, f, g):
        self.f, self.g = f, g

    def mask(self, typeids, types):
        return self.f.mask(typeids, types) | self.g.mask(typeids, types)

    def bind(self, types):
        f, g = self.f.bind(types), self.g.bind(types)
        return lambda state: f(state) | g(state)

    def __repr__(self):
        return f"Union({self.f!r}, {self.g!r})"
