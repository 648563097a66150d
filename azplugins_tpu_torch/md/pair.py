"""Pair potentials (user API).

Port of ``azplugins_tpu/md/pair.py`` (the ``Pair`` base and
PerturbedLennardJones; the other potentials follow with ROADMAP slice 3).
Parameters are set per unordered type pair::

    lj = PerturbedLennardJones(nlist=Cell(buffer=0.4), default_r_cut=3.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)

Shift modes follow HOOMD semantics (``none``/``shift``/``xplor``). On a
CUDA device the force runs through the hand-written kernel
(ops/pair_kernel.py), which covers modes none and shift.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.typeparam import TypeParameter
from ..ops.evaluators import PAIR_POTENTIALS
from ..ops.pair_kernel import pair_force, plj_kernel_tables
from .force import Force, build_pair_tables
from .nlist import Cell

__all__ = ["Pair", "PerturbedLennardJones"]


class Pair(Force):
    """Base for isotropic pair potentials riding a shared neighbour grid."""

    _needs_nlist = True
    _evaluator_name: str = ""
    _accepted_modes = ("none", "shift", "xplor")

    def __init__(self, nlist: Cell, default_r_cut=None, default_r_on=0.0, mode="none"):
        super().__init__()
        if mode not in self._accepted_modes:
            raise ValueError(f"mode must be one of {self._accepted_modes}")
        if not isinstance(nlist, Cell):
            raise TypeError("nlist must be an azplugins_tpu_torch.md.nlist.Cell")
        self.nlist = nlist
        self.mode = mode
        self._def = PAIR_POTENTIALS[self._evaluator_name]
        self.params = TypeParameter("params", 2, self._def.spec)
        self.r_cut = TypeParameter(
            "r_cut", 2, None, float, default=None if default_r_cut is None else float(default_r_cut)
        )
        self.r_on = TypeParameter("r_on", 2, None, float, default=float(default_r_on))

    def _build_tables(self, sim):
        types = sim._particle_types
        self._tbl = {
            "params": build_pair_tables(self._def, self.params, types),
            "r_cut": np.asarray(self.r_cut.to_scalar_table(types), dtype=np.float32),
            "r_on": np.asarray(self.r_on.to_scalar_table(types), dtype=np.float32),
        }

    def _device_tables(self, device) -> dict:
        def dev(a):
            return torch.as_tensor(a, device=device)

        tbl = {
            "params": {k: dev(v) for k, v in self._tbl["params"].items()},
            "r_cut": dev(self._tbl["r_cut"]),
            "r_on": dev(self._tbl["r_on"]),
        }
        if torch.device(device).type == "cuda" and self._evaluator_name == "PerturbedLennardJones":
            tbl["kernel"] = plj_kernel_tables(tbl["params"], tbl["r_cut"])
        return tbl

    def _max_r_cut(self) -> float:
        if not hasattr(self, "_tbl"):
            raise RuntimeError("not attached")
        return float(self._tbl["r_cut"].max())

    def _compute_dense(self, dense, spec, timestep, ctx, tbl, want="all"):
        return pair_force(self._def.energy_force, dense, spec, tbl, self.mode, want)


class PerturbedLennardJones(Pair):
    """WCA core + attraction_scale_factor-scaled LJ tail.

    Parity: reference plugin ``src/pair.py:354-427`` and
    ``src/PairEvaluatorPerturbedLennardJones.h:117-155``.
    """

    _evaluator_name = "PerturbedLennardJones"
