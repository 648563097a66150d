"""Pair potentials (user API).

Port of ``azplugins_tpu/md/pair.py``: the ``Pair`` base, every isotropic
potential, and DPDGeneralWeight. Parameters are set per unordered type
pair::

    lj = PerturbedLennardJones(nlist=Cell(buffer=0.4), default_r_cut=3.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)

Shift modes follow HOOMD semantics (``none``/``shift``/``xplor``). On a
CUDA device the isotropic potentials run through the hand-written kernel
of ops/pair_kernel.py, DPD through that of ops/dpd_kernel.py and the
anisotropic TwoPatchMorse (force and torques) through that of
ops/aniso_kernel.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.typeparam import TypeParameter
from ..core.variant import as_variant, value_at
from ..ops.aniso_kernel import aniso_force, aniso_kernel_tables
from ..ops.dpd_kernel import dpd_force
from ..ops.evaluators import ANISO_PAIR_POTENTIALS, PAIR_POTENTIALS
from ..ops.pair_kernel import kernel_tables, pair_force
from .force import Force, build_pair_tables
from .nlist import Cell

__all__ = [
    "Pair",
    "Colloid",
    "DPDGeneralWeight",
    "ExpandedYukawa",
    "Gaussian",
    "Hertz",
    "LJ",
    "Morse",
    "PerturbedLennardJones",
    "TwoPatchMorse",
    "Yukawa",
]


class Pair(Force):
    """Base for isotropic pair potentials riding a shared neighbour grid."""

    _needs_nlist = True
    _takes_pair_list = True
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
        if torch.device(device).type == "cuda":
            tbl["kernel"] = kernel_tables(self._evaluator_name, tbl["params"], tbl["r_cut"],
                                          tbl["r_on"], self.mode)
        return tbl

    def _max_r_cut(self) -> float:
        if not hasattr(self, "_tbl"):
            raise RuntimeError("not attached")
        return float(self._tbl["r_cut"].max())

    def _compute_dense(self, dense, spec, slot_of, timestep, ctx, tbl, want="all", window=None,
                       pair_list=None):
        return pair_force(self._def.energy_force, dense, spec, tbl, self.mode, want,
                          window=window, pair_list=pair_list)


class Colloid(Pair):
    """Integrated Lennard-Jones (Hamaker/Everaers-Ejtehadi) colloid potential.

    Parity: reference plugin ``src/pair.py:14-118`` and
    ``src/PairEvaluatorColloid.h:101-269``. Params per pair: ``A`` (Hamaker
    energy), ``a_1``/``a_2`` (radii; 0 selects the solvent-solvent /
    colloid-solvent branches), ``sigma``.
    """

    _evaluator_name = "Colloid"


class ExpandedYukawa(Pair):
    """U = eps exp(-kappa (r - delta)) / (r - delta).

    Parity: reference plugin ``src/pair.py:242-298``,
    ``src/PairEvaluatorExpandedYukawa.h:92-115``.
    """

    _evaluator_name = "ExpandedYukawa"


class Hertz(Pair):
    """U = eps (1 - r/r_cut)^{5/2}.

    Parity: reference plugin ``src/pair.py:300-352``,
    ``src/PairEvaluatorHertz.h:93-110``.
    """

    _evaluator_name = "Hertz"


class PerturbedLennardJones(Pair):
    """WCA core + attraction_scale_factor-scaled LJ tail.

    Parity: reference plugin ``src/pair.py:354-427`` and
    ``src/PairEvaluatorPerturbedLennardJones.h:117-155``.
    """

    _evaluator_name = "PerturbedLennardJones"


class LJ(Pair):
    """Standard 12-6 Lennard-Jones, U = 4 eps ((sigma/r)^12 - (sigma/r)^6)
    (HOOMD's md.pair.LJ, which azplugins scripts mix with the plugin's
    potentials)."""

    _evaluator_name = "LJ"


class Morse(Pair):
    """Isotropic Morse, U = D0 (exp(-2 alpha (r - r0)) - 2 exp(-alpha (r - r0)))."""

    _evaluator_name = "Morse"


class Gaussian(Pair):
    """Gaussian core, U = eps exp(-r^2 / (2 sigma^2))."""

    _evaluator_name = "Gaussian"


class Yukawa(Pair):
    """Screened Coulomb, U = eps exp(-kappa r) / r (HOOMD's md.pair.Yukawa)."""

    _evaluator_name = "Yukawa"


class DPDGeneralWeight(Pair):
    """DPD with generalized weight function w_D = (1-r/rcut)^s.

    Parity: reference plugin ``src/pair.py:121-240``,
    ``src/DPDPairEvaluatorGeneralWeight.h:198-255``. The drag reads the
    half-step velocities the step loop holds at force time; the random force
    uses pair-symmetric counter RNG keyed on the step's timestep and the
    simulation seed, so trajectories are bitwise independent of how runs are
    chunked. ``kT`` is a variant, evaluated at each step's timestep
    (``core/variant.py::value_at``: in a run, the schedule's 0-d tensor).
    """

    _evaluator_name = "DPDGeneralWeight"
    _accepted_modes = ("none",)
    _needs_velocity_j = True
    _takes_pair_list = False

    def __init__(self, nlist: Cell, kT, default_r_cut=None, mode="none"):
        super().__init__(nlist, default_r_cut=default_r_cut, mode=mode)
        self.kT = as_variant(kT)

    def _device_tables(self, device) -> dict:
        def dev(a):
            return torch.as_tensor(a, device=device)

        return {"params": {k: dev(v) for k, v in self._tbl["params"].items()},
                "r_cut": dev(self._tbl["r_cut"])}

    def _compute_dense(self, dense, spec, slot_of, timestep, ctx, tbl, want="all", window=None):
        kT = value_at(self.kT, timestep, dense.device)
        return dpd_force(dense, spec, tbl, kT, ctx.dt, ctx.seed, timestep, want, window=window)


class TwoPatchMorse(Force):
    """Anisotropic two-patch Morse potential (forces and torques).

    Parity: reference plugin ``src/pair.py:429-525`` and
    ``src/AnisoPairEvaluatorTwoPatchMorse.h:127-216``. Params per pair:
    ``M_d``, ``M_r``, ``r_eq``, ``omega``, ``alpha``, ``repulsion``; modes
    none/shift, ``r_cut`` per type pair. The shift subtracts the raw Morse
    energy at the cutoff scaled by both patch alignments (the torques do
    not see it, as in the reference plugin).
    """

    _needs_nlist = True
    _produces_torque = True
    _needs_quat_j = True
    _accepted_modes = ("none", "shift")

    def __init__(self, nlist: Cell, default_r_cut=None, mode="none"):
        super().__init__()
        if mode not in self._accepted_modes:
            raise ValueError(f"mode must be one of {self._accepted_modes}")
        if not isinstance(nlist, Cell):
            raise TypeError("nlist must be an azplugins_tpu_torch.md.nlist.Cell")
        self.nlist = nlist
        self.mode = mode
        self._def = ANISO_PAIR_POTENTIALS["TwoPatchMorse"]
        self.params = TypeParameter("params", 2, self._def.spec)
        self.r_cut = TypeParameter(
            "r_cut", 2, None, float, default=None if default_r_cut is None else float(default_r_cut)
        )

    def _build_tables(self, sim):
        types = sim._particle_types
        self._tbl = {
            "params": build_pair_tables(self._def, self.params, types),
            "r_cut": np.asarray(self.r_cut.to_scalar_table(types), dtype=np.float32),
        }

    def _device_tables(self, device) -> dict:
        def dev(a):
            return torch.as_tensor(a, device=device)

        tbl = {"params": {k: dev(v) for k, v in self._tbl["params"].items()},
               "r_cut": dev(self._tbl["r_cut"])}
        if torch.device(device).type == "cuda":
            tbl["kernel"] = aniso_kernel_tables(tbl["params"], tbl["r_cut"], self.mode)
            tbl["kernel_mode"] = self.mode
        return tbl

    def _max_r_cut(self) -> float:
        if not hasattr(self, "_tbl"):
            raise RuntimeError("not attached")
        return float(self._tbl["r_cut"].max())

    def _compute_dense(self, dense, spec, slot_of, timestep, ctx, tbl, want="all", window=None):
        return aniso_force(self._def.energy_force_torque, dense, spec, tbl, self.mode, want,
                           window=window)
