"""Integration methods: NVE and Langevin (with an optional flow field).

Port of ``azplugins_tpu/md/methods.py``. ConstantVolume is velocity
Verlet; LangevinFlow takes the drag relative to a flow velocity u(r) and
draws a uniform random force with coefficient sqrt(6 gamma kT / dt) per
particle from Threefry (bitwise the reference's noise); Langevin is
LangevinFlow with u = 0. BrownianFlow is overdamped dynamics advected by
u(r), with the same kind of noise from its own stream; Brownian is
BrownianFlow with u = 0. With ``integrate_rotational_dof=True`` on the
integrator, every method also integrates orientations and angular momenta
(NO_SQUISH, md/rotation.py), and Langevin thermostats them with body-frame
friction gamma_r and noise from its own Threefry stream.

Protocol, driven by the Simulation's step loop:
    step1(state, dt, timestep, seed): drift half of the update
    step1(state, dt, timestep, seed, drift): the same and the Verlet drift
        check of the new positions (a :class:`DriftCheck`), as
        ``(state, result)``: the last method's step1 on a grid path
    step2(state, dt, timestep, seed): kick half; ``state.net_force`` holds
        the forces at the *new* positions when step2 runs.

Each method returns a new State; nothing is updated in place, so a chunk
that must be replayed can roll back to the State it started from.

Dispatch: on CUDA tensors ``step1`` and ``step2`` launch the kernels of
:mod:`azplugins_tpu_torch.ops.integrate_kernel` (K7 the drift half, or
with a drift check K7 and K6 in one launch; K8 the kick half with the
Langevin force and its draw inside; K9 the NO_SQUISH rotation after
either; BrownianFlow's step1 K11, its draw inside, alone or with the drift
check in one launch, and its step2 K8's acceleration-only instance); on
CPU tensors they run their plain versions (``_step1_plain``, then the plain
drift check of ``ops/dense.py``; ``_step2_plain``; BrownianFlow's
``_step1_brownian``), which the kernels are held to bitwise on the card;
any other device raises. Nothing falls back.

kT is a variant read at the step (``core/variant.py::value_at``, its host
form): a host float on the eager loop and outside a run (K8's and K9's
host-kT form, a launch argument); inside a CUDA graph a 0-d float32
tensor on the card from the chunk's schedule, which K8 and K9 read
through a pointer (their device-kT form, bitwise the host form), K11 too,
and the plain versions multiply by as a tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rng as _rng
from ..core.typeparam import TypeParameter
from ..core.variant import as_variant, value_at
from ..ops import dense as D
from . import rotation as R
from .filter import All, ParticleFilter
from ..utils import sqrt

__all__ = ["Method", "DriftCheck", "ConstantVolume", "Langevin", "LangevinFlow", "Brownian",
           "BrownianFlow"]


def _kernels():
    from ..ops import integrate_kernel  # imported here, on first use

    return integrate_kernel


class DriftCheck(NamedTuple):
    """The Verlet drift check a step1 carries: the grid's ``meta`` (its
    ``ref_position``) and ``spec`` (its ``buffer``), and ``viol``, the
    chunk's violation flag the verdict ORs in, or None for a shard's two
    largest squared drifts."""

    meta: object
    spec: object
    viol: torch.Tensor | None

    def of(self, state):
        """The check on ``state`` by ``ops/dense.py``: ``needs_rebin``'s
        verdict, or ``drift_top_two`` with no ``viol``."""
        if self.viol is None:
            return D.drift_top_two(state, self.meta)
        return D.needs_rebin(state, self.meta, self.spec, self.viol)


class Method:
    # True when the method conserves total momentum (plain NVE): read by
    # ThermodynamicQuantities' DOF accounting (3N-3 vs 3N)
    _conserves_momentum = False

    def __init__(self, filter: ParticleFilter | None = None):
        self.filter = filter if filter is not None else All()
        self._select = None  # selector, bound at attach
        self._rotational = False  # set at attach from the integrator flag

    def _attach(self, sim):
        self._select = self.filter.bind(sim._particle_types)
        integ = sim.operations.integrator
        self._rotational = bool(integ is not None and integ.integrate_rotational_dof)

    def _selection(self, state):
        """The filter's bool for a kernel: None for ``All()`` (the kernels
        test ``tag >= 0`` themselves), else the selector's tensor."""
        return None if type(self.filter) is All else self._select(state)

    def _where(self, state, **new):
        """``state`` with the fields in ``new`` taken where the method acts
        and kept elsewhere, under one mask: empty slots (tag < 0, dense
        layout) must never move, their far sentinel positions keep them out
        of every pair."""
        m = self._select(state) & (state.tag >= 0)
        return state.replace(**{
            name: torch.where(m[(...,) + (None,) * (value.ndim - m.ndim)], value,
                              getattr(state, name))
            for name, value in new.items()
        })

    # Velocity Verlet. step1 drifts with the *stored* acceleration (which for
    # Langevin includes last step's thermostat forces). Positions are NOT
    # wrapped here: they drift unwrapped until the next rebuild, which wraps
    # them and updates images (ops/dense._bin_to_slots). With ``drift`` (a
    # DriftCheck) step1 returns ``(state, drift.of(state))``: on the card
    # one launch of K7 and K6 (K9 touches no position), on the CPU the
    # plain step then the plain check.
    def step1(self, state, dt, timestep, seed, drift: DriftCheck | None = None):
        if not _rng._on_card(state.device):
            state = self._step1_plain(state, dt, timestep, seed)
            return state if drift is None else (state, drift.of(state))
        K = _kernels()
        sel = self._selection(state)
        if drift is None:
            x, v = K.step1(state.tag, sel, state.position, state.velocity, state.acceleration,
                           dt)
        else:
            x, v, found = K.step1_drift(state.tag, sel, state.position, state.velocity,
                                        state.acceleration, dt, drift.meta.ref_position,
                                        drift.spec.buffer, drift.viol)
        state = state.replace(position=x, velocity=v)
        if self._rotational:
            q, p = K.no_squish(0, state.tag, sel, state.typeid, state.orientation, state.angmom,
                               state.moment_inertia, state.net_torque, dt)
            state = state.replace(orientation=q, angmom=p)
        return state if drift is None else (state, found)

    def step2(self, state, dt, timestep, seed):
        if not _rng._on_card(state.device):
            return self._step2_plain(state, dt, timestep, seed)
        K = _kernels()
        sel = self._selection(state)
        v, a = K.step2(state.tag, sel, state.typeid, state.velocity, state.acceleration,
                       state.net_force, state.mass, dt)
        state = state.replace(velocity=v, acceleration=a)
        if self._rotational:
            (p,) = K.no_squish(1, state.tag, sel, state.typeid, state.orientation, state.angmom,
                               state.moment_inertia, state.net_torque, dt)
            state = state.replace(angmom=p)
        return state

    def _step1_plain(self, state, dt, timestep, seed):
        vel_half = state.velocity + (0.5 * dt) * state.acceleration
        pos = state.position + dt * vel_half
        state = self._where(state, position=pos, velocity=vel_half)
        if self._rotational:
            state = self._rot_step1(state, dt)
        return state

    def _step2_plain(self, state, dt, timestep, seed):
        accel = state.net_force / state.mass[:, None]
        vel = state.velocity + (0.5 * dt) * accel
        state = self._where(state, velocity=vel, acceleration=accel)
        if self._rotational:
            state = self._rot_step2(state, dt)
        return state

    # Rotational velocity Verlet (NO_SQUISH). step1 kicks the angular
    # momentum by dt/2 with the STORED torques (from the previous step, like
    # the stored acceleration), then rotates freely for dt; step2 kicks with
    # the fresh torques in state.net_torque.
    def _rot_step1(self, state, dt):
        q, p, inertia = state.orientation, state.angmom, state.moment_inertia
        p = R.angmom_kick(q, p, state.net_torque, inertia, dt)
        q, p = R.free_rotation(q, p, inertia, dt)
        return self._where(state, orientation=q, angmom=p)

    def _rot_step2(self, state, dt):
        p = R.angmom_kick(state.orientation, state.angmom, state.net_torque,
                          state.moment_inertia, dt)
        return self._where(state, angmom=p)


class ConstantVolume(Method):
    """NVE velocity Verlet."""

    _conserves_momentum = True


class _GammaMixin:
    """Per-type drag coefficients: gamma, and gamma_r for rotation."""

    def _init_gamma(self, default_gamma):
        self.gamma = TypeParameter("gamma", 1, None, float, default=float(default_gamma))
        self.gamma_r = TypeParameter("gamma_r", 1, None, float, default=1.0)

    def _attach(self, sim):
        super()._attach(sim)

        def table(param):
            t = np.asarray(param.to_scalar_table(sim._particle_types), dtype=np.float32)
            return torch.as_tensor(t, device=sim.device)

        self._gamma_table = table(self.gamma)
        self._gamma_r_table = table(self.gamma_r)
        self._tables_on = {}

    def _table_on(self, name, device):
        """The ``[T]`` table ``name`` on ``device``: a shard may lie on
        another device than the simulation (copied once a device)."""
        table = getattr(self, name)
        if table.device != device:
            if (name, device) not in self._tables_on:
                self._tables_on[(name, device)] = table.to(device)
            table = self._tables_on[(name, device)]
        return table

    def _gamma_of(self, state):
        # typeid is permuted (and -1 on empty slots) in the dense layout
        table = self._table_on("_gamma_table", state.device)
        return table[torch.clamp_min(state.typeid, 0).to(torch.int64)]

    def _gamma_r_of(self, state):
        table = self._table_on("_gamma_r_table", state.device)
        return table[torch.clamp_min(state.typeid, 0).to(torch.int64)]


class LangevinFlow(_GammaMixin, Method):
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
        self._init_gamma(default_gamma)

    def step2(self, state, dt, timestep, seed):
        if not _rng._on_card(state.device):
            return self._step2_plain(state, dt, timestep, seed)
        K = _kernels()
        kT = value_at(self.kT, timestep, state.device, host_form=True)
        noisy = not (self.noiseless or dt <= 0)
        sel = self._selection(state)
        flow = None
        if self.flow_field is not None:
            flow = self.flow_field(state.box.wrap(state.position)[0])
        noise = K.Noise(self._table_on("_gamma_table", state.device), self._rng_stream, seed,
                        timestep, kT, noisy)
        v, a = K.step2(state.tag, sel, state.typeid, state.velocity, state.acceleration,
                       state.net_force, state.mass, dt, noise, flow)
        state = state.replace(velocity=v, acceleration=a)
        if self._rotational:
            noise = K.Noise(self._table_on("_gamma_r_table", state.device),
                            _rng.Stream.LANGEVIN_ANGULAR, seed, timestep, kT, noisy)
            p, torque = K.no_squish(2, state.tag, sel, state.typeid, state.orientation,
                                    state.angmom, state.moment_inertia, state.net_torque, dt,
                                    noise)
            state = state.replace(angmom=p, net_torque=torque)
        return state

    def _step2_plain(self, state, dt, timestep, seed):
        gp = self._gamma_of(state)
        kT = value_at(self.kT, timestep, state.device, host_form=True)
        if self.noiseless or dt <= 0:
            random_force = torch.zeros_like(state.velocity)
        else:
            u = _rng.particle_uniform3(self._rng_stream, seed, timestep, state.tag)
            random_force = sqrt(6.0 * gp * kT / dt)[:, None] * u
        rel_vel = state.velocity
        if self.flow_field is not None:
            # flow fields are defined on in-box coordinates; positions drift
            # unwrapped between rebuilds, so wrap locally
            rel_vel = rel_vel - self.flow_field(state.box.wrap(state.position)[0])
        bd_force = random_force - gp[:, None] * rel_vel
        accel = (state.net_force + bd_force) / state.mass[:, None]
        vel = state.velocity + (0.5 * dt) * accel
        state = self._where(state, velocity=vel, acceleration=accel)
        if self._rotational:
            state = self._rot_step2_langevin(state, dt, timestep, seed, kT)
        return state

    def _rot_step2_langevin(self, state, dt, timestep, seed, kT):
        """Second rotational half-kick with body-frame friction and noise.

        The BD torque (body frame) is sqrt(6 gamma_r kT / dt) U(-1, 1) per
        axis minus gamma_r omega_body, rotated to the lab frame and added to
        the conservative torque for the dt/2 kick. The EFFECTIVE torque
        (conservative + BD) is stored in net_torque so the next step1
        half-kick reuses it, as the stored acceleration carries F_BD;
        without it the noise acts over dt/2 only and the rotational
        temperature settles at kT/2.
        """
        q, p, inertia = state.orientation, state.angmom, state.moment_inertia
        active = inertia > 1e-12
        L_body = R.body_angular_momentum(q, p)
        omega = torch.where(active, L_body / torch.clamp_min(inertia, 1e-12), 0.0)
        gr = self._gamma_r_of(state)[:, None]
        if self.noiseless or dt <= 0:
            rand = torch.zeros_like(omega)
        else:
            u = _rng.particle_uniform3(_rng.Stream.LANGEVIN_ANGULAR, seed, timestep, state.tag)
            rand = sqrt(6.0 * gr * kT / dt) * u
        bd_body = torch.where(active, rand - gr * omega, 0.0)
        torque = state.net_torque + R.rotate(q, bd_body)
        p = R.angmom_kick(q, p, torque, inertia, dt)
        return self._where(state, angmom=p, net_torque=torque)


class Langevin(LangevinFlow):
    """Standard Langevin thermostat (flow field = 0)."""

    _rng_stream = _rng.Stream.LANGEVIN

    def __init__(self, kT, filter=None, default_gamma: float = 1.0, noiseless: bool = False):
        super().__init__(kT, flow_field=None, filter=filter,
                         default_gamma=default_gamma, noiseless=noiseless)


class BrownianFlow(_GammaMixin, Method):
    """Overdamped (Brownian) dynamics advected by a flow field.

    Single-step update r += (u(r) + (F + F_rand) / gamma) dt in step1
    (reference plugin: TwoStepBrownianFlow.h:103-182); step2 only mirrors
    the net force into the acceleration, which the rebuild carries. On the
    card step1 is K11 (with a drift check, K11 and K6 in one launch) and
    step2 K8's acceleration-only instance; on the CPU their plain versions.
    """

    _rng_stream = _rng.Stream.BROWNIAN_FLOW

    def __init__(self, kT, flow_field=None, filter=None, default_gamma: float = 1.0,
                 noiseless: bool = False):
        super().__init__(filter)
        self.kT = as_variant(kT)
        self.flow_field = flow_field
        self.noiseless = bool(noiseless)
        self._init_gamma(default_gamma)

    def step1(self, state, dt, timestep, seed, drift: DriftCheck | None = None):
        if not _rng._on_card(state.device):
            state = self._step1_brownian(state, dt, timestep, seed)
            return state if drift is None else (state, drift.of(state))
        K = _kernels()
        kT = value_at(self.kT, timestep, state.device, host_form=True)
        noise = K.Noise(self._table_on("_gamma_table", state.device), self._rng_stream, seed,
                        timestep, kT, not (self.noiseless or dt <= 0))
        flow = None
        if self.flow_field is not None:
            flow = self.flow_field(state.box.wrap(state.position)[0])
        args = (state.tag, self._selection(state), state.typeid, state.position,
                state.net_force, dt, noise, flow)
        if drift is None:
            return state.replace(position=K.brownian_step(*args))
        x, found = K.brownian_step_drift(*args, drift.meta.ref_position, drift.spec.buffer,
                                         drift.viol)
        return state.replace(position=x), found

    def _step1_brownian(self, state, dt, timestep, seed):
        gp = self._gamma_of(state)
        kT = value_at(self.kT, timestep, state.device, host_form=True)
        if self.noiseless or dt <= 0:
            coeff = torch.zeros((state.N, 1), dtype=torch.float32, device=state.device)
        else:
            coeff = sqrt(6.0 * gp * kT / dt)[:, None]
        u = _rng.particle_uniform3(self._rng_stream, seed, timestep, state.tag)
        random_force = coeff * u
        if self.flow_field is None:
            flow_vel = torch.zeros_like(state.position)
        else:
            flow_vel = self.flow_field(state.box.wrap(state.position)[0])
        pos = state.position + (flow_vel + (state.net_force + random_force) / gp[:, None]) * dt
        return self._where(state, position=pos)

    def step2(self, state, dt, timestep, seed):
        if not _rng._on_card(state.device):
            return self._step2_plain(state, dt, timestep, seed)
        a = _kernels().step2_accel(state.tag, self._selection(state), state.acceleration,
                                   state.net_force, state.mass)
        return state.replace(acceleration=a)

    def _step2_plain(self, state, dt, timestep, seed):
        accel = state.net_force / state.mass[:, None]
        return self._where(state, acceleration=accel)


class Brownian(BrownianFlow):
    """Standard Brownian dynamics (flow field = 0)."""

    _rng_stream = _rng.Stream.BROWNIAN

    def __init__(self, kT, filter=None, default_gamma: float = 1.0, noiseless: bool = False):
        super().__init__(kT, flow_field=None, filter=filter,
                         default_gamma=default_gamma, noiseless=noiseless)
