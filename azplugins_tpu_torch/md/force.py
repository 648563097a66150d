"""Force base classes and attach machinery.

Port of ``azplugins_tpu/md/force.py``. Users configure parameters by type
name; at attach they are validated and precomputed into host float32
tables, which each run copies to the simulation's device once
(:meth:`Force._device_tables`); the step loop calls ``_compute_dense``.
Pair, DPD, anisotropic and bond forces override it; per-particle forces
(barriers, walls) take the base version, which hands the dense state to
their ``_compute``: they are layout-agnostic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.typeparam import TypeParameter
from ..logging import log
from ..ops.pair_force import ForceResult

__all__ = ["Force", "ForceResult", "SimContext", "build_pair_tables"]


class SimContext:
    """Static per-run context handed to force computes."""

    def __init__(self, dt: float, seed: int):
        self.dt = float(dt)
        self.seed = int(seed)


class Force:
    """Base class for all force computes."""

    _needs_nlist = False
    # an anisotropic force returns torques (ForceResult.torque) and reads the
    # orientations of both members of a pair
    _produces_torque = False
    _needs_quat_j = False
    # a pair force that reads the velocities of both members (DPD's drag):
    # a shard's halo window then carries them
    _needs_velocity_j = False
    # the force reads the particle diameters (the diameter column then rides
    # the rebuild even when every diameter has its default)
    _needs_diameter = False
    # a force that reads particles of any shard (bonds): on a sharded mesh
    # ``_compute_dense`` takes ``partners=`` (every slot's position and the
    # shard's first global slot)
    _reads_partners = False
    # an isotropic pair potential of K1 (ops/pair_kernel.py): inside a rebuild
    # segment on the card ``_compute_dense`` takes ``pair_list=``, a Verlet
    # list built at the segment's start, for its force-only calls
    _takes_pair_list = False

    def __init__(self):
        self._attached = False
        self._sim = None

    # -- attach lifecycle ----------------------------------------------------
    def _attach(self, sim):
        self._sim = sim
        self._build_tables(sim)
        self._attached = True

    def _device_tables(self, device) -> dict:
        """The tables handed to ``_compute_dense``, as tensors on ``device``."""
        raise NotImplementedError  # pragma: no cover

    def _build_tables(self, sim):  # pragma: no cover - interface
        """(Re)build the host tables from the params; run at every run()."""
        raise NotImplementedError

    def _compute_dense(self, dense, spec, slot_of, timestep, ctx, tbl,
                       want="all") -> ForceResult:
        """Force in the dense (slot) layout; ``slot_of`` maps tag -> slot.
        A stencil force (``_needs_nlist``) also takes ``window=``: on a
        sharded mesh, the shard's halo window, for whose own slots it
        computes; a force that ``_reads_partners`` takes ``partners=``; one
        that ``_takes_pair_list`` takes ``pair_list=``.

        Default: a per-particle force, the same in any layout (``_compute``).
        """
        return self._compute(dense, timestep, tbl)

    def _compute(self, state, timestep, tbl) -> ForceResult:  # pragma: no cover - interface
        """Per-particle force on ``state``; empty slots (tag < 0) get zeros."""
        raise NotImplementedError

    def _max_r_cut(self) -> float:
        return 0.0

    # -- observables (computed on access, like the reference's pull path) -----
    def _result(self) -> ForceResult:
        if not self._attached:
            raise RuntimeError(
                f"{type(self).__name__} is not attached to a simulation; run sim.run(0) first"
            )
        return self._sim._compute_single_force(self)

    @log(category="particle", requires_run=True)
    def forces(self) -> np.ndarray:
        """Per-particle forces (tag order)."""
        return self._result().force.cpu().numpy()

    @log(category="particle", requires_run=True)
    def energies(self) -> np.ndarray:
        """Per-particle potential energies (tag order)."""
        return self._result().energy.cpu().numpy()

    @log(requires_run=True)
    def energy(self) -> float:
        """Total potential energy of this force."""
        return float(torch.sum(self._result().energy))

    @log(category="particle", requires_run=True, default=False)
    def virials(self) -> np.ndarray:
        """Per-particle virial tensor components (tag order; None when the
        force computes none)."""
        v = self._result().virial
        return None if v is None else v.cpu().numpy()

    @log(category="particle", requires_run=True, default=False)
    def torques(self) -> np.ndarray:
        """Per-particle torques (zero for isotropic forces)."""
        r = self._result()
        if r.torque is None:
            return np.zeros((r.force.shape[0], 3), dtype=np.float32)
        return r.torque.cpu().numpy()


def build_pair_tables(def_, params: TypeParameter, types: list[str]) -> dict:
    """Validate and precompute per-type-pair parameter tables (float32, host)."""
    pre = def_.precompute(params.to_dict_tables(types))
    return {k: np.asarray(v, dtype=np.float32) for k, v in pre.items()}
