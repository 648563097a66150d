"""Integration methods: NVE and Langevin (with an optional flow field).

Port of the translational part of ``azplugins_tpu/md/methods.py``.
ConstantVolume is velocity Verlet; LangevinFlow takes the drag relative to
a flow velocity u(r) and draws a uniform random force with coefficient
sqrt(6 gamma kT / dt) per particle from Threefry (bitwise the reference's
noise); Langevin is LangevinFlow with u = 0. Rotational integration is
ROADMAP slice 10: attaching with ``integrate_rotational_dof=True`` raises.

Protocol, driven by the Simulation's step loop:
    step1(state, dt, timestep, seed): drift half of the update
    step2(state, dt, timestep, seed): kick half; ``state.net_force`` holds
        the forces at the *new* positions when step2 runs.

Each method returns a new State; nothing is updated in place, so a chunk
that must be replayed can roll back to the State it started from.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as _rng
from ..core.typeparam import TypeParameter
from ..core.variant import as_variant
from .filter import All, ParticleFilter

__all__ = ["Method", "ConstantVolume", "Langevin", "LangevinFlow"]


class Method:
    # True when the method conserves total momentum (plain NVE): read by
    # ThermodynamicQuantities' DOF accounting (3N-3 vs 3N)
    _conserves_momentum = False

    def __init__(self, filter: ParticleFilter | None = None):
        self.filter = filter if filter is not None else All()
        self._select = None  # selector, bound at attach

    def _attach(self, sim):
        integ = sim.operations.integrator
        if integ is not None and integ.integrate_rotational_dof:
            raise NotImplementedError("rotational integration is ROADMAP slice 10")
        self._select = self.filter.bind(sim._particle_types)

    def _where(self, state, new, old):
        # empty slots (tag < 0, dense layout) must never move: their far
        # sentinel positions keep them out of every pair
        m = self._select(state) & (state.tag >= 0)
        if new.ndim > m.ndim:
            m = m[(...,) + (None,) * (new.ndim - m.ndim)]
        return torch.where(m, new, old)

    # Velocity Verlet. step1 drifts with the *stored* acceleration (which for
    # Langevin includes last step's thermostat forces). Positions are NOT
    # wrapped here: they drift unwrapped until the next rebuild, which wraps
    # them and updates images (ops/dense._bin_to_slots).
    def step1(self, state, dt, timestep, seed):
        vel_half = state.velocity + (0.5 * dt) * state.acceleration
        pos = state.position + dt * vel_half
        return state.replace(
            position=self._where(state, pos, state.position),
            velocity=self._where(state, vel_half, state.velocity),
        )

    def step2(self, state, dt, timestep, seed):
        accel = state.net_force / state.mass[:, None]
        vel = state.velocity + (0.5 * dt) * accel
        return state.replace(
            velocity=self._where(state, vel, state.velocity),
            acceleration=self._where(state, accel, state.acceleration),
        )


class ConstantVolume(Method):
    """NVE velocity Verlet."""

    _conserves_momentum = True


class LangevinFlow(Method):
    """Velocity-Verlet Langevin with drag relative to a flow field.

    step2 adds F_BD = F_random - gamma (v - u(r)) to the net force before
    the second half kick (reference plugin: TwoStepLangevinFlow.h:159-249).
    ``flow_field`` is any callable mapping wrapped positions ``[N, 3]`` to
    flow velocities ``[N, 3]``.
    """

    _rng_stream = _rng.Stream.LANGEVIN_FLOW

    def __init__(self, kT, flow_field=None, filter=None, default_gamma: float = 1.0,
                 noiseless: bool = False):
        super().__init__(filter)
        self.kT = as_variant(kT)
        self.flow_field = flow_field
        self.noiseless = bool(noiseless)
        self.gamma = TypeParameter("gamma", 1, None, float, default=float(default_gamma))

    def _attach(self, sim):
        super()._attach(sim)
        table = np.asarray(self.gamma.to_scalar_table(sim._particle_types), dtype=np.float32)
        self._gamma_table = torch.as_tensor(table, device=sim.device)

    def _gamma_of(self, state):
        # typeid is permuted (and -1 on empty slots) in the dense layout
        return self._gamma_table[torch.clamp_min(state.typeid, 0).to(torch.int64)]

    def step2(self, state, dt, timestep, seed):
        gp = self._gamma_of(state)
        kT = self.kT(timestep)
        if self.noiseless or dt <= 0:
            random_force = torch.zeros_like(state.velocity)
        else:
            u = _rng.particle_uniform3(self._rng_stream, seed, timestep, state.tag)
            random_force = torch.sqrt(6.0 * gp * kT / dt)[:, None] * u
        rel_vel = state.velocity
        if self.flow_field is not None:
            # flow fields are defined on in-box coordinates; positions drift
            # unwrapped between rebuilds, so wrap locally
            rel_vel = rel_vel - self.flow_field(state.box.wrap(state.position)[0])
        bd_force = random_force - gp[:, None] * rel_vel
        accel = (state.net_force + bd_force) / state.mass[:, None]
        vel = state.velocity + (0.5 * dt) * accel
        return state.replace(
            velocity=self._where(state, vel, state.velocity),
            acceleration=self._where(state, accel, state.acceleration),
        )


class Langevin(LangevinFlow):
    """Standard Langevin thermostat (flow field = 0)."""

    _rng_stream = _rng.Stream.LANGEVIN

    def __init__(self, kT, filter=None, default_gamma: float = 1.0, noiseless: bool = False):
        super().__init__(kT, flow_field=None, filter=filter,
                         default_gamma=default_gamma, noiseless=noiseless)
