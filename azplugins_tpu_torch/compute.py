"""Computes: thermodynamic quantities of a particle group.

Port of ``ThermodynamicQuantities`` from ``azplugins_tpu/compute.py``
(translational and rotational quantities; the velocity computes come with
ROADMAP slice 12). Quantities are pull-path observables: each access
reduces the current state on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .logging import log
from .md import rotation as R
from .md.filter import All, ParticleFilter

__all__ = ["Compute", "ThermodynamicQuantities"]


class Compute:
    def __init__(self):
        self._sim = None
        self._attached = False

    def _attach(self, sim):
        self._sim = sim
        self._attached = True

    def _require_attached(self, what: str):
        if not self._attached:
            raise RuntimeError(f"{what} is not available before attaching (run sim.run(0))")


class ThermodynamicQuantities(Compute):
    """Kinetic temperature, energies and pressure of a group.

    Pressure is assembled from the per-particle virials the pair force
    computes.
    """

    def __init__(self, filter: ParticleFilter | None = None):
        super().__init__()
        self.filter = filter if filter is not None else All()
        self._mask = None

    def _attach(self, sim):
        super()._attach(sim)
        typeids = sim._synced_state().typeid.cpu().numpy()
        self._mask = torch.as_tensor(
            self.filter.mask(typeids, sim._particle_types), device=sim.device
        )

    @log(requires_run=True)
    def kinetic_energy(self) -> float:
        """Translational kinetic energy of the group."""
        self._require_attached("kinetic_energy")
        state = self._sim._synced_state()
        m = torch.where(self._mask, state.mass, 0.0)
        return float(0.5 * torch.sum(m * torch.sum(state.velocity**2, dim=-1)))

    @log(requires_run=True)
    def translational_degrees_of_freedom(self) -> float:
        """3N, minus 3 when every method conserves the whole system's
        momentum (NVE); thermostats break momentum conservation."""
        self._require_attached("translational_degrees_of_freedom")
        n = int(self._mask.sum())
        integ = self._sim.operations.integrator
        conserves = True
        if integ is not None:
            conserves = all(m._conserves_momentum for m in integ.methods)
        whole_system = isinstance(self.filter, All)
        return 3.0 * n - (3.0 if (conserves and whole_system and n > 0) else 0.0)

    @log(requires_run=True)
    def rotational_degrees_of_freedom(self) -> float:
        """One per non-zero principal moment of inertia of the group's
        particles, when the integrator integrates rotational DOF (else 0)."""
        self._require_attached("rotational_degrees_of_freedom")
        if not self._sim._rotational():
            return 0.0
        active = self._sim._synced_state().moment_inertia > 1e-12
        return float(active[self._mask].sum())

    @log(requires_run=True)
    def rotational_kinetic_energy(self) -> float:
        """Sum of L_body^2 / (2 I) over the group's rotating particles."""
        self._require_attached("rotational_kinetic_energy")
        if not self._sim._rotational():
            return 0.0
        state = self._sim._synced_state()
        L = R.body_angular_momentum(state.orientation, state.angmom)
        inertia = state.moment_inertia
        active = (inertia > 1e-12) & self._mask[:, None]
        return float(0.5 * torch.sum(torch.where(active, L * L / torch.clamp_min(inertia, 1e-12),
                                                 0.0)))

    @log(requires_run=True)
    def kinetic_temperature(self) -> float:
        """2 KE / DOF over the translational and rotational modes."""
        dof = self.translational_degrees_of_freedom
        ke = self.kinetic_energy
        rdof = self.rotational_degrees_of_freedom
        if rdof > 0:
            ke += self.rotational_kinetic_energy
            dof += rdof
        return 2.0 * ke / dof

    @log(requires_run=True)
    def potential_energy(self) -> float:
        """Sum of the attached forces' potential energies."""
        self._require_attached("potential_energy")
        integ = self._sim.operations.integrator
        return sum(f.energy for f in integ.forces) if integ is not None else 0.0

    @log(requires_run=True)
    def volume(self) -> float:
        """Volume of the simulation box."""
        self._require_attached("volume")
        return self._sim._synced_state().box.volume()

    def _virial_sum(self) -> np.ndarray:
        """Total virial tensor components (xx, xy, xz, yy, yz, zz)."""
        total = np.zeros(6)
        integ = self._sim.operations.integrator
        if integ is not None:
            for f in integ.forces:
                v = f.virials
                if v is not None:
                    total += v.sum(axis=0)
        return total

    @log(requires_run=True)
    def pressure(self) -> float:
        """Isotropic pressure P = (2 KE + W) / (3 V), W the virial trace."""
        self._require_attached("pressure")
        w = self._virial_sum()
        return float((2.0 * self.kinetic_energy + w[0] + w[3] + w[5]) / (3.0 * self.volume))

    @log(category="sequence", requires_run=True)
    def pressure_tensor(self) -> np.ndarray:
        """Pressure tensor (P_xx, P_xy, P_xz, P_yy, P_yz, P_zz)."""
        self._require_attached("pressure_tensor")
        state = self._sim._synced_state()
        m = np.where(self._mask.cpu().numpy(), state.mass.cpu().numpy(), 0.0)
        v = state.velocity.cpu().numpy()
        kin = np.stack(
            [
                (m * v[:, a] * v[:, b]).sum()
                for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
            ]
        )
        return (kin + self._virial_sum()) / self.volume
