"""Updaters: TypeUpdater and ParticleEvaporator.

Port of ``azplugins_tpu/update.py``:

  * ``TypeUpdater`` flips particle types by z-slab membership: particles
    of ``inside_type``/``outside_type`` become ``inside_type`` when their
    wrapped z is in [lo, hi), else ``outside_type``.
  * ``ParticleEvaporator`` retypes up to ``N_evap_max`` "solvent"
    particles found in the slab to an inert type per firing. The pick is a
    top-k over per-candidate counter-based random priorities (a uniform
    subset without replacement), bitwise the reference's: the priority is
    the particle's Threefry word, and the k smallest are kept in exact
    integer space, ties to the lower slot as in XLA's ``top_k``.

An updater's ``_update(state, timestep, seed)`` is a pure device function:
it reads nothing back to the host. The step loop fires it after the step
with index ``timestep`` when its trigger says so on the host
(Simulation._run_chunk), through ``_update_shards``, which takes the
layout as a tuple of shards (one for a whole layout): by default
``_update`` once a shard, which is right for any elementwise updater. The
evaporator ranks every slot of the system, keyed on the global slot (the
reference's top-k over its sharded slot axis): on the card its pick is two
kernels over every shard of one device (K4 at the pick,
``ops/pick_kernel.py::evaporator_pick``; the plain version on the CPU), on
shards over distinct devices each shard's candidates merged on the first
one's. Retyping is a masked select, never a resize.

Inside the CUDA graphs (``graph.py``) an updater runs as the reference's
``apply_inline_updaters`` does: ``_update_masked_shards(shards, fire,
timestep, seed)`` runs the update after every step on every shard and
keeps its result where the 0-d device bool ``fire`` (the trigger, read
from the chunk's schedule) is set, the old bits elsewhere: by default
``_update_masked`` once a shard, a select on each field ``_update``
replaced (``typeid`` for the TypeUpdater); the evaporator flips each
shard's ``typeid`` in place, its kernels reading ``fire`` on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import rng as _rng
from .md.trigger import as_trigger
from .ops import pick_kernel
from .utils import as_blocks

__all__ = ["Updater", "TypeUpdater", "ParticleEvaporator"]


def _f32(x: float) -> float:
    """A bound as the float32 value the reference compares against."""
    return float(np.float32(x))


def _z_bounds(sim) -> tuple[float, float]:
    Lz = sim._synced_state().box.L[2]
    return float(-0.5 * Lz), float(0.5 * Lz)


class Updater:
    def __init__(self, trigger):
        self.trigger = as_trigger(trigger)
        self._attached = False

    def _attach(self, sim):
        self._attached = True

    def _update(self, state, timestep, seed):  # pragma: no cover - interface
        raise NotImplementedError

    def _update_shards(self, shards: tuple, timestep, seed) -> tuple:
        """The update on a layout held as shards (a tuple of States, one
        for a whole layout): ``_update`` once a shard by default."""
        return tuple(self._update(s, timestep, seed) for s in shards)

    def _update_masked_shards(self, shards: tuple, fire: torch.Tensor, timestep, seed) -> tuple:
        """The masked update of a layout held as shards (one for a whole
        layout), all on ``fire``'s device: :meth:`_update_masked` once a
        shard by default."""
        return tuple(self._update_masked(s, fire, timestep, seed) for s in shards)

    def _update_masked(self, state, fire: torch.Tensor, timestep, seed):
        """The update of a layout (or a shard) kept where ``fire`` (a 0-d
        bool on the state's device) is set: ``_update``, then
        ``torch.where(fire, new, old)`` on each tensor field it replaced (a
        field it returned as it was keeps its object). Unfired, every field
        keeps its bits."""
        new = self._update(state, timestep, seed)
        return state.replace(**{
            f.name: torch.where(fire, getattr(new, f.name), getattr(state, f.name))
            for f in dataclasses.fields(state)
            if isinstance(getattr(new, f.name), torch.Tensor)
            and getattr(new, f.name) is not getattr(state, f.name)
        })


class TypeUpdater(Updater):
    def __init__(self, trigger, inside_type: str, outside_type: str, lo: float, hi: float):
        super().__init__(trigger)
        self.inside_type = inside_type
        self.outside_type = outside_type
        self.lo = float(lo)
        self.hi = float(hi)
        if self.lo >= self.hi:
            raise ValueError("region lo must be below hi")

    def _attach(self, sim):
        types = sim._particle_types
        if self.inside_type not in types or self.outside_type not in types:
            raise ValueError("inside/outside types must exist")
        if self.inside_type == self.outside_type:
            raise ValueError("inside and outside types must differ")
        self._inside_id = types.index(self.inside_type)
        self._outside_id = types.index(self.outside_type)
        box_lo, box_hi = _z_bounds(sim)
        if self.lo < box_lo or self.hi > box_hi:
            raise ValueError("region must lie inside the global box")
        super()._attach(sim)

    def _update(self, state, timestep, seed):
        pos, _ = state.box.wrap(state.position, state.image)
        z = pos[:, 2]
        in_region = (z >= _f32(self.lo)) & (z < _f32(self.hi))
        affected = (state.typeid == self._inside_id) | (state.typeid == self._outside_id)
        new_typeid = torch.where(
            affected,
            torch.where(in_region, self._inside_id, self._outside_id),
            state.typeid,
        ).to(torch.int32)
        return state.replace(typeid=new_typeid)


class ParticleEvaporator(Updater):
    """Evaporate (retype) solvent particles out of a z-slab region."""

    def __init__(
        self,
        trigger,
        solvent_type: str,
        evaporated_type: str,
        lo: float,
        hi: float,
        N_evap_max: int = 0xFFFFFFF,
        seed: int | None = None,
    ):
        super().__init__(trigger)
        self.solvent_type = solvent_type
        self.evaporated_type = evaporated_type
        self.lo = float(lo)
        self.hi = float(hi)
        self.N_evap_max = int(N_evap_max)
        self.seed = seed  # falls back to the simulation seed
        if self.lo >= self.hi:
            raise ValueError("region lo must be below hi")

    def _attach(self, sim):
        types = sim._particle_types
        if self.solvent_type not in types or self.evaporated_type not in types:
            raise ValueError("solvent/evaporated types must exist")
        if self.solvent_type == self.evaporated_type:
            raise ValueError("solvent and evaporated types must differ")
        self._solvent_id = types.index(self.solvent_type)
        self._evaporated_id = types.index(self.evaporated_type)
        box_lo, box_hi = _z_bounds(sim)
        if self.lo < box_lo or self.hi > box_hi:
            raise ValueError("region must lie inside the global box")
        self._k = min(self.N_evap_max, int(sim._state.N))
        super()._attach(sim)

    def _candidates(self, state):
        pos, _ = state.box.wrap(state.position, state.image)
        z = pos[:, 2]
        return (state.typeid == self._solvent_id) & (z >= _f32(self.lo)) & (z < _f32(self.hi))

    def _keys(self, state, candidate, timestep, seed, first: int = 0):
        """Each slot's unique pick key ``(priority << 31) | global slot``,
        non-candidates last. An int64 key is exact, so ties go to the lower
        slot; an f32 cast would collide mantissas. ``first``: the state's
        first global slot (a shard's offset)."""
        (bits,) = _rng.particle_bits(
            _rng.Stream.PARTICLE_EVAPORATOR, seed, timestep, state.tag, n_words=1
        )
        priority = torch.where(candidate, bits, 0xFFFFFFFF)
        slot = first + torch.arange(state.N, dtype=torch.int64, device=state.device)
        return (priority << 31) | slot

    def _flips(self, shards: tuple, timestep, seed) -> list:
        """Each shard's flips (the plain pick): its candidates whose key is
        among the k smallest over every shard. Each shard's k smallest keys
        (on its global slots) join in shard order on the first shard's
        device, the k-th smallest of them is the whole layout's, and each
        shard flips its own candidates at or below it; every candidate
        when there are at most k. Keys are unique, so the pick is the same
        for any number of shards, bit for bit; nothing is read back to the
        host."""
        dev0 = shards[0].device
        cands = [self._candidates(s) for s in shards]
        if self._k >= sum(s.N for s in shards):
            return cands
        if self._k == 0:  # top_k of nothing: no candidate flips
            return [torch.zeros_like(c) for c in cands]
        keys, first = [], 0
        for s, c in zip(shards, cands):
            keys.append(self._keys(s, c, timestep, seed, first=first))
            first += s.N
        tops = [torch.topk(k, min(self._k, k.numel()), largest=False, sorted=False).values
                for k in keys]
        kth = torch.topk(torch.cat([t.to(dev0) for t in tops]), self._k, largest=False,
                         sorted=False).values.max()
        n_marked = torch.stack([c.to(torch.int32).sum().to(dev0) for c in cands]).sum()
        few = n_marked <= self._k
        return [torch.where(few.to(c.device), c, (k <= kth.to(c.device)) & c)
                for c, k in zip(cands, keys)]

    def _pick(self, typeids, shards, fire, timestep, seed) -> None:
        """The pick over a layout held as ``shards`` (a tuple of States, or
        a whole layout's State): flip, in ``typeids`` (each shard's int32
        [N], written in place; a tensor with a State), the candidates it
        keeps, where ``fire`` (a 0-d bool on the shards' device; None:
        fired) is set. On the card with every shard
        on one device K4 at the pick (``ops/pick_kernel.py::
        evaporator_pick``, two launches over every shard that read ``fire``
        there and return at once where it is unset); on the CPU, and on
        shards over distinct devices (the eager loop), :meth:`_pick_plain`
        (its keys K4's words on the card)."""
        from .parallel.mesh import _key

        typeids, shards = as_blocks(typeids), as_blocks(shards)
        if self.seed is not None:
            seed = self.seed
        if (_rng._on_card(typeids[0].device)
                and len({_key(t.device) for t in typeids}) == 1):
            s0 = shards[0]
            pick_kernel.evaporator_pick(
                typeids, tuple(s.position for s in shards), tuple(s.tag for s in shards),
                self._k, self._solvent_id, self._evaporated_id, _f32(self.lo), _f32(self.hi),
                s0.box.Lz, _rng.Stream.PARTICLE_EVAPORATOR, seed, timestep, fire)
        else:
            self._pick_plain(typeids, shards, fire, timestep, seed)

    def _pick_plain(self, typeids, shards, fire, timestep, seed) -> None:
        """The plain version of :meth:`_pick`: the candidates, their keys
        with ``particle_bits`` and the ``torch.topk`` of :meth:`_flips`,
        each shard's flips ANDed with ``fire``."""
        typeids, shards = as_blocks(typeids), as_blocks(shards)
        for typeid, flip in zip(typeids, self._flips(shards, timestep, seed), strict=True):
            typeid.masked_fill_(flip if fire is None else flip & fire.to(flip.device),
                                self._evaporated_id)

    def _update(self, state, timestep, seed):
        return self._update_shards((state,), timestep, seed)[0]

    def _update_shards(self, shards: tuple, timestep, seed) -> tuple:
        """The pick on a layout held as shards (one for a whole layout),
        fired: :meth:`_pick` into copies of the shards' ``typeid``."""
        typeids = tuple(s.typeid.clone() for s in shards)
        self._pick(typeids, shards, None, timestep, seed)
        return tuple(s.replace(typeid=t) for s, t in zip(shards, typeids, strict=True))

    def _update_masked_shards(self, shards: tuple, fire: torch.Tensor, timestep, seed) -> tuple:
        """The masked update (the graphs' form) in place, one pick over
        every shard: the flips go into each shard's ``typeid`` where
        ``fire`` is set, so the caller passes a layout it owns (a
        segment's buffers or a rebuild's output). Unfired, ``typeid`` keeps
        its bits; no ``torch.where`` is needed, and on the card the pick's
        launches return at once."""
        self._pick(tuple(s.typeid for s in shards), shards, fire, timestep, seed)
        return shards

    def _update_masked(self, state, fire: torch.Tensor, timestep, seed):
        """:meth:`_update_masked_shards` on a whole layout."""
        return self._update_masked_shards((state,), fire, timestep, seed)[0]
