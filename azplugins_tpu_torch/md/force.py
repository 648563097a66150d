"""Force base classes and attach machinery.

Port of ``azplugins_tpu/md/force.py``. Users configure parameters by type
name; at attach they are validated and precomputed into host float32
tables, which each run copies to the simulation's device once
(:meth:`Force._device_tables`); the step loop calls ``_compute_dense``.
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

    def _compute_dense(self, dense, spec, timestep, ctx, tbl, want="all") -> ForceResult:
        """Force in the dense (slot) layout."""
        raise NotImplementedError  # pragma: no cover

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
        """Per-particle virial tensor components (tag order)."""
        return self._result().virial.cpu().numpy()


def build_pair_tables(def_, params: TypeParameter, types: list[str]) -> dict:
    """Validate and precompute per-type-pair parameter tables (float32, host)."""
    pre = def_.precompute(params.to_dict_tables(types))
    return {k: np.asarray(v, dtype=np.float32) for k, v in pre.items()}
