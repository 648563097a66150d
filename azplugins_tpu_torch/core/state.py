"""Simulation state as a frozen dataclass of tensors.

Port of ``azplugins_tpu/core/state.py``. The user-facing State is in tag
order (index == tag); the hot loop runs the same dataclass in the dense
cell-slot order of ops/dense.py, where ``tag`` maps slots back to user
order and negative tags mark empty slots. Every tensor lives on the
simulation's device; the box is a host constant (core/box.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import frozen_dataclass
from .box import Box
from .rng import Stream, particle_bits, uniform_from_bits
from .snapshot import Snapshot

__all__ = ["State", "state_from_snapshot", "state_to_snapshot", "thermalize_momenta"]


@frozen_dataclass
class State:
    """All per-particle and topology arrays plus the box.

    Shapes: N particles (or S slots), NB bonds. Floats are float32, ids int32.
    """

    position: torch.Tensor  # [N, 3]
    tag: torch.Tensor  # [N] int32; negative marks an empty slot
    velocity: torch.Tensor  # [N, 3]
    typeid: torch.Tensor  # [N] int32
    image: torch.Tensor  # [N, 3] int32
    orientation: torch.Tensor  # [N, 4] quaternion (w, x, y, z)
    mass: torch.Tensor  # [N]
    diameter: torch.Tensor  # [N]
    charge: torch.Tensor  # [N]
    net_force: torch.Tensor  # [N, 3] conservative forces at current positions
    acceleration: torch.Tensor  # [N, 3] effective accel incl. thermostat forces
    angmom: torch.Tensor  # [N, 4]
    moment_inertia: torch.Tensor  # [N, 3]
    net_torque: torch.Tensor  # [N, 3]
    bond_typeid: torch.Tensor  # [NB] int32
    bond_group: torch.Tensor  # [NB, 2] int32
    box: Box

    @property
    def N(self) -> int:
        return self.position.shape[0]

    @property
    def n_bonds(self) -> int:
        return self.bond_typeid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.position.device


def state_from_snapshot(snapshot: Snapshot, device) -> tuple[State, list[str], list[str]]:
    """Build a State on ``device``. Returns (state, particle_types, bond_types)."""
    snapshot.validate()
    p = snapshot.particles
    b = snapshot.bonds
    box_arr = list(snapshot.configuration.box)
    if len(box_arr) == 3:
        box_arr = box_arr + [0.0, 0.0, 0.0]

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    zeros3 = torch.zeros((p.N, 3), dtype=torch.float32, device=device)
    state = State(
        position=f32(p.position),
        tag=torch.arange(p.N, dtype=torch.int32, device=device),
        velocity=f32(p.velocity),
        typeid=i32(p.typeid),
        image=i32(p.image),
        orientation=f32(p.orientation),
        mass=f32(p.mass),
        diameter=f32(p.diameter),
        charge=f32(p.charge),
        net_force=zeros3,
        acceleration=zeros3.clone(),
        angmom=f32(p.angmom),
        moment_inertia=f32(p.moment_inertia),
        net_torque=zeros3.clone(),
        bond_typeid=i32(b.typeid),
        bond_group=i32(b.group).reshape(-1, 2),
        box=Box.from_lengths(*box_arr),
    )
    return state, list(p.types), list(b.types)


def state_to_snapshot(state: State, particle_types, bond_types) -> Snapshot:
    snap = Snapshot(N=state.N, bond_N=state.n_bonds)
    snap.particles.types = list(particle_types)
    snap.bonds.types = list(bond_types)
    p = snap.particles

    def host(a, dtype=np.float64):
        return a.detach().cpu().numpy().astype(dtype)

    # positions may carry unwrapped drift (integrators defer wrapping to
    # the neighbor rebuild); the user-facing snapshot is always wrapped
    pos_w, image_w = state.box.wrap(state.position, state.image)
    p.position[:] = host(pos_w)
    p.velocity[:] = host(state.velocity)
    p.typeid[:] = host(state.typeid, np.int32)
    p.image[:] = host(image_w, np.int32)
    p.orientation[:] = host(state.orientation)
    p.mass[:] = host(state.mass)
    p.diameter[:] = host(state.diameter)
    p.charge[:] = host(state.charge)
    p.angmom[:] = host(state.angmom)
    p.moment_inertia[:] = host(state.moment_inertia)
    L = state.box.L.astype(np.float64)
    tilt = state.box.tilt.astype(np.float64)
    snap.configuration.box = [L[0], L[1], L[2], tilt[0], tilt[1], tilt[2]]
    snap.bonds.typeid[:] = host(state.bond_typeid, np.int32)
    snap.bonds.group[:] = host(state.bond_group, np.int32)
    return snap


def thermalize_momenta(state: State, kT: float, seed: int, mask=None) -> State:
    """Draw Maxwell-Boltzmann velocities and remove the group's net momentum.

    Box-Muller over Threefry words of stream THERMALIZE at timestep 0, as
    the reference. Rotational momenta belong to a later slice: a state
    with non-zero moments of inertia is refused.
    """
    if bool((state.moment_inertia > 0).any()):
        raise NotImplementedError(
            "thermalizing angular momenta is not ported yet (ROADMAP slice 10)"
        )
    n = state.N
    words = particle_bits(Stream.THERMALIZE, seed, 0, state.tag, n_words=8)
    eps = float(np.float32(1.1754944e-38))
    gauss = []
    for k in range(3):
        u1 = torch.clamp_min(uniform_from_bits(words[2 * k], 0.0, 1.0), eps)
        u2 = uniform_from_bits(words[2 * k + 1], 0.0, 1.0)
        gauss.append(torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2))
    gauss = torch.stack(gauss, dim=-1)
    sigma = torch.sqrt(float(np.float32(kT)) / state.mass)[:, None]
    vel = gauss * sigma
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=state.device)
    mask_f = mask.to(torch.float32)[:, None]
    mom = torch.sum(vel * state.mass[:, None] * mask_f, dim=0)
    mtot = torch.sum(state.mass * mask_f[:, 0])
    vel = vel - (mom / mtot)[None, :]
    return state.replace(velocity=torch.where(mask[:, None], vel, state.velocity))
