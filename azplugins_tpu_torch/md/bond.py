"""Bond potentials (user API).

Port of ``azplugins_tpu/md/bond.py``: DoubleWell and Quartic (the plugin's)
and Harmonic and FENEWCA (HOOMD's, which azplugins polymer scripts use for
backbones). Parameters are per bond type name::

    dw = DoubleWell()
    dw.params["A-A"] = dict(r_0=0.5, r_1=1.0, U_1=5.0, U_tilt=0.0)

The force is PyTorch ops on every device (ops/dense.py::dense_bond_force),
as the reference's is XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..core.typeparam import TypeParameter
from ..ops.dense import dense_bond_force
from ..ops.evaluators import BOND_POTENTIALS
from .force import Force

__all__ = ["Bond", "DoubleWell", "FENEWCA", "Harmonic", "Quartic"]


class Bond(Force):
    _evaluator_name = ""
    # a partner may lie in any shard: on a sharded mesh the force reads
    # every slot's position
    _reads_partners = True

    def __init__(self):
        super().__init__()
        self._def = BOND_POTENTIALS[self._evaluator_name]
        self.params = TypeParameter("params", 1, self._def.spec)

    def _build_tables(self, sim):
        host = self.params.to_dict_tables(sim._bond_types)
        self._tbl = {k: torch.as_tensor(v, dtype=torch.float32)
                     for k, v in self._def.precompute(host).items()}

    def _device_tables(self, device) -> dict:
        """Each parameter gathered per bond, once per run (bond types are
        static), and the bond table, on ``device``."""
        state = self._sim._state
        typeid = state.bond_typeid.to(device=device, dtype=torch.int64)
        return {
            "params": {k: v.to(device)[typeid] for k, v in self._tbl.items()},
            "group": state.bond_group.to(device),
        }

    def _compute_dense(self, dense, spec, slot_of, timestep, ctx, tbl, want="all",
                       partners=None):
        """``partners``: on a shard, ``(positions of every slot, the shard's
        first global slot)`` (ops/dense.py::dense_bond_force)."""
        positions, first = partners if partners is not None else (None, 0)
        return dense_bond_force(self._def.energy_force, dense, slot_of, tbl["group"],
                                tbl["params"], want, positions, first)


class DoubleWell(Bond):
    """Double-well bond with tunable barrier and tilt.

    Parity: reference plugin ``src/bond.py:13-66``,
    ``src/BondEvaluatorDoubleWell.h:96-113``.
    """

    _evaluator_name = "DoubleWell"


class Quartic(Bond):
    """Scissile quartic bond + WCA core; plateaus at U_0 beyond r_0.

    Parity: reference plugin ``src/bond.py:68-157``,
    ``src/BondEvaluatorQuartic.h:129-200``. ``delta`` defaults to 0 as in
    the reference (``src/bond.py:153``).
    """

    _evaluator_name = "Quartic"


class Harmonic(Bond):
    """Harmonic spring U = k/2 (r - r0)^2 (HOOMD's md.bond.Harmonic)."""

    _evaluator_name = "Harmonic"


class FENEWCA(Bond):
    """Kremer-Grest FENE spring + WCA core on the delta-shifted distance.

    U = -k/2 R0^2 ln(1 - ((r - delta)/R0)^2) + WCA(eps, sigma; r - delta).
    """

    _evaluator_name = "FENEWCA"
