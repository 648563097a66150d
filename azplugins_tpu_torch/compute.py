"""Computes: centre-of-mass velocity, binned velocity fields, thermo.

Port of ``azplugins_tpu/compute.py``. Quantities are pull-path
observables: each access reduces the current state on its device. With
``include_mpcd_particles`` the velocity computes add the MPCD solvent
stream (``sim._mpcd``) to the group's sums.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .logging import log
from .md import rotation as R
from .md.filter import All, ParticleFilter
from .ops.binning import bin_particles, cartesian_coords, cylindrical_coords

__all__ = [
    "Compute",
    "VelocityCompute",
    "VelocityFieldCompute",
    "CartesianVelocityFieldCompute",
    "CylindricalVelocityFieldCompute",
    "ThermodynamicQuantities",
]


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


class _GroupCompute(Compute):
    """A compute over a filtered group, optionally with the MPCD stream.

    ``filter=None`` selects no MD particle: with ``include_mpcd_particles``
    that is the solvent alone.
    """

    def __init__(self, filter: ParticleFilter | None = None, include_mpcd_particles=False):
        super().__init__()
        self.filter = filter
        self.include_mpcd_particles = bool(include_mpcd_particles)
        self._mask = None

    def _attach(self, sim):
        super()._attach(sim)
        if self.include_mpcd_particles and sim._mpcd is None:
            raise ValueError(
                "include_mpcd_particles=True but the snapshot carried no "
                "MPCD particles (snapshot.mpcd)"
            )
        typeids = sim._synced_state().typeid.cpu().numpy()
        if self.filter is None:
            self._mask = torch.zeros(typeids.shape[0], dtype=torch.bool, device=sim.device)
        else:
            self._mask = torch.as_tensor(
                self.filter.mask(typeids, sim._particle_types), device=sim.device
            )


class VelocityCompute(_GroupCompute):
    """Centre-of-mass velocity of a particle group."""

    @log(category="sequence", requires_run=True)
    def velocity(self):
        """Centre-of-mass velocity of the group; with
        ``include_mpcd_particles`` the MPCD solvent joins the momentum and
        mass sums."""
        self._require_attached("velocity")
        state = self._sim._synced_state()
        m = torch.where(self._mask, state.mass, 0.0)
        mom = torch.sum(state.velocity * m[:, None], dim=0)
        mtot = torch.sum(m)
        if self.include_mpcd_particles:
            mpcd = self._sim._whole_mpcd()
            mom = mom + mpcd["mass"] * torch.sum(mpcd["velocity"], dim=0)
            mtot = mtot + mpcd["mass"] * mpcd["velocity"].shape[0]
        return (mom / torch.clamp_min(mtot, 1e-38)).cpu().numpy()


class VelocityFieldCompute(_GroupCompute):
    """Mass-averaged velocity field on a grid of up to three axes; use a
    derived type."""

    _coord_fn = None

    def __init__(self, num_bins, lower_bounds, upper_bounds, filter=None,
                 include_mpcd_particles=False):
        if type(self)._coord_fn is None:
            raise TypeError(
                "VelocityFieldCompute is abstract; use "
                "CartesianVelocityFieldCompute or "
                "CylindricalVelocityFieldCompute"
            )
        super().__init__(filter, include_mpcd_particles)
        self.num_bins = tuple(int(b) for b in num_bins)
        self.lower_bounds = tuple(float(b) for b in lower_bounds)
        self.upper_bounds = tuple(float(b) for b in upper_bounds)
        if len(self.num_bins) != 3:
            raise ValueError("num_bins must have 3 entries")

    @property
    def coordinates(self):
        """Bin centre coordinates (compact shape, as the reference's)."""
        coords = []
        shape = []
        for num, lo, hi in zip(self.num_bins, self.lower_bounds, self.upper_bounds):
            if num > 0:
                x, dx = np.linspace(lo, hi, num, endpoint=False, retstep=True)
                coords.append(x + 0.5 * dx)
                shape.append(num)
        if len(shape) == 0:
            return None
        if len(shape) > 1:
            shape.append(len(shape))
        return np.reshape(list(itertools.product(*coords)), shape)

    def _compact_shape(self):
        return tuple(b for b in self.num_bins if b > 0)

    def _grids(self, position, velocity, mass, select, box):
        pos, _ = box.wrap(position)
        coords, vel = type(self)._coord_fn(pos, velocity)
        return bin_particles(coords, vel, mass, select, self.num_bins, self.lower_bounds,
                             self.upper_bounds)

    @log(category="object", requires_run=True)
    def velocities(self):
        """Mass-averaged velocity per bin (compact shape + vector axis)."""
        self._require_attached("velocities")
        state = self._sim._synced_state()
        mass_grid, mom_grid = self._grids(state.position, state.velocity, state.mass,
                                          self._mask, state.box)
        if self.include_mpcd_particles:
            mpcd = self._sim._whole_mpcd()
            pos = mpcd["position"]
            n = pos.shape[0]
            mg, pg = self._grids(pos, mpcd["velocity"],
                                 torch.full((n,), mpcd["mass"], device=pos.device),
                                 torch.ones(n, dtype=torch.bool, device=pos.device), state.box)
            mass_grid = mass_grid + mg
            mom_grid = mom_grid + pg
        filled = mass_grid > 0
        m_safe = torch.where(filled, mass_grid, 1.0)
        v = torch.where(filled[:, None], mom_grid / m_safe[:, None], 0.0)
        return v.cpu().numpy().reshape((*self._compact_shape(), 3))


class CartesianVelocityFieldCompute(VelocityFieldCompute):
    """Velocity field binned in (x, y, z)."""

    _coord_fn = staticmethod(cartesian_coords)


class CylindricalVelocityFieldCompute(VelocityFieldCompute):
    """Velocity field binned in (r, theta, z), the velocity in the
    (r, theta, z) basis."""

    _coord_fn = staticmethod(cylindrical_coords)


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
