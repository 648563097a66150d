"""The initial state a configuration's builder makes from the seed."""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from the run's ``--seed`` (any
    whole number: reduced modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def simulation_seed(seed: int) -> int:
    """The simulation's own 16-bit seed (its counter-based draws), from
    ``--seed``."""
    return (int(seed) * 0x9E3779B1 >> 7) & 0xFFFF


def momenta(n: int, kT: float, mass: float, gen: torch.Generator) -> torch.Tensor:
    """Maxwell-Boltzmann velocities ``[n, 3]`` (float32) with the net momentum
    removed, drawn in one call on the generator's device."""
    v = torch.randn((n, 3), generator=gen, device=gen.device, dtype=torch.float64)
    v = v * math.sqrt(kT / mass)
    return (v - v.mean(dim=0)).to(torch.float32)


def cubic_lattice(n_side: int, L: float) -> np.ndarray:
    """A simple cubic lattice of ``n_side**3`` sites filling the box [-L/2, L/2)^3."""
    a = L / n_side
    x = (np.arange(n_side) + 0.5) * a - L / 2
    return np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)


def snapshot(az, init: dict):
    """The program's Snapshot of an initial state."""
    x = init["x"]
    snap = az.Snapshot(N=len(x))
    snap.configuration.box = [*init["L"], 0, 0, 0]
    snap.particles.types = list(init["types"])
    snap.particles.position[:] = x
    snap.particles.velocity[:] = init["v"].cpu().numpy()
    snap.particles.typeid[:] = init["type"]
    return snap
