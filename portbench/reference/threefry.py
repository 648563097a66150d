"""Threefry-2x32-20 and the per-particle draws that the MD methods key on.

A plain copy of the counter-based draws of azplugins (HOOMD's
``RandomGenerator`` keyed by an ``RNGIdentifier``): the key is
``((stream << 16) ^ seed, timestep)``, the counter ``(tag, lane)``, and a
uniform in [-1, 1) fills the 23 mantissa bits of a word. Words are int64
tensors holding values in [0, 2**32).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA

# azplugins' stream identifiers of the draws these configurations make
LANGEVIN = 210
LANGEVIN_FLOW = 202
PARTICLE_EVAPORATOR = 203


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor, rounds: int = 20):
    """Threefry-2x32 (Salmon et al., SC'11): a key injection after every
    fourth round. Returns the two output words."""
    k0, k1 = int(k0) & M32, int(k1) & M32
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    for i in range(rounds):
        x0 = (x0 + x1) & M32
        x1 = _rotl(x1, ROTATIONS[i % 8]) ^ x0
        if i % 4 == 3:
            n = i // 4 + 1
            x0 = (x0 + ks[n % 3]) & M32
            x1 = (x1 + ((ks[(n + 1) % 3] + n) & M32)) & M32
    return x0, x1


def particle_words(stream: int, seed: int, timestep: int, tag: torch.Tensor, n_words: int):
    """``n_words`` words a particle: lane ``l`` gives words ``2l`` and ``2l + 1``."""
    k0 = ((int(stream) << 16) & M32) ^ (int(seed) & M32)
    k1 = int(timestep) & M32
    c0 = tag.to(torch.int64) & M32
    words = []
    for lane in range((n_words + 1) // 2):
        x0, x1 = threefry2x32(k0, k1, c0, torch.full_like(c0, lane))
        words += [x0, x1]
    return words[:n_words]


def uniform3(stream: int, seed: int, timestep: int, tag: torch.Tensor,
             dtype=torch.float64) -> torch.Tensor:
    """Three uniforms in [-1, 1) a particle, ``[N, 3]`` in ``dtype``."""
    w = particle_words(stream, seed, timestep, tag, 3)
    u = torch.stack([(x >> 9).to(torch.float64) * 2.0**-23 for x in w], dim=-1)
    return (2.0 * u - 1.0).to(dtype)
