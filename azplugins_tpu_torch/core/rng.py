"""Counter-based random numbers for reproducible stochastic physics.

Port of ``azplugins_tpu/core/rng.py``: a vectorised Threefry-2x32 keyed on
(stream id, seed, timestep) with per-particle or per-pair counters, bitwise
equal to the reference on every device.

PyTorch has no usable unsigned 32-bit arithmetic (``torch.uint32`` lacks
add, shifts and ``minimum`` on the CPU), so the words travel as int64
tensors holding values in [0, 2**32) and every add is masked back to 32
bits. Keys and the timestep are Python ints, formed on the host.
"""

from __future__ import annotations

import torch

__all__ = [
    "Stream",
    "FAST_ROUNDS",
    "threefry2x32",
    "uniform_from_bits",
    "pair_uniform",
    "particle_uniform3",
    "particle_bits",
]

_M32 = 0xFFFFFFFF


class Stream:
    """RNG stream identifiers (the reference's ``Stream``)."""

    DPD_GENERAL_WEIGHT = 200
    BROWNIAN_FLOW = 201
    LANGEVIN_FLOW = 202
    PARTICLE_EVAPORATOR = 203
    LANGEVIN = 210
    BROWNIAN = 211
    THERMALIZE = 212
    LANGEVIN_ANGULAR = 213
    THERMALIZE_ANGULAR = 214


# Threefry-2x32 rotation schedule (Salmon et al., SC'11).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
# Round count of the hot per-pair noise paths (DPD). 13 is the minimum
# Salmon et al. (SC'11, Table 2) measured to pass BigCrush: it carries no
# safety margin. The default of 20 rounds (jax.random's count) carries 7.
FAST_ROUNDS = 13


def _u32(x, like: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """A word tensor (int64 holding [0, 2**32)) from an int, array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    dev = like.device if like is not None else device
    return torch.as_tensor(int(x) & _M32, dtype=torch.int64, device=dev)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 block cipher (random123 round and injection schedule).

    The key words ``k0``/``k1`` are Python ints; the counters are tensors of
    any integer dtype (or ints), read modulo 2**32 and broadcast together.
    Returns two int64 tensors holding uint32 values. A key injection follows
    every 4th round, never a trailing partial group.
    """
    k0 = int(k0) & _M32
    k1 = int(k1) & _M32
    like = c0 if isinstance(c0, torch.Tensor) else c1
    x0 = (_u32(c0, like) + k0) & _M32
    x1 = (_u32(c1, like) + k1) & _M32
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    for i in range(rounds):
        x0 = (x0 + x1) & _M32
        x1 = _rotl32(x1, _ROTATIONS[i % 8]) ^ x0
        if i % 4 == 3:
            inject = i // 4 + 1
            x0 = (x0 + ks[inject % 3]) & _M32
            x1 = (x1 + ((ks[(inject + 1) % 3] + inject) & _M32)) & _M32
    return x0, x1


def uniform_from_bits(bits: torch.Tensor, low=-1.0, high=1.0) -> torch.Tensor:
    """Map uint32 words to a float32 uniform in [low, high).

    Mantissa fill: 23 random mantissa bits under exponent 0 give [1, 2); the
    word ``0x3F800000 | (bits >> 9)`` is below 2**31, so it bitcasts through
    int32 to float32 exactly as the reference bitcasts uint32.
    """
    word = (bits >> 9) | 0x3F800000
    f = word.to(torch.int32).view(torch.float32) - 1.0
    return f * (high - low) + low


def _key_words(stream: int, seed: int, timestep: int) -> tuple[int, int]:
    """The two key words from (stream id, user seed, timestep)."""
    k0 = ((int(stream) << 16) & _M32) ^ (int(seed) & _M32)
    return k0, int(timestep) & _M32


def pair_uniform(stream: int, seed, timestep, tag_a, tag_b, low=-1.0, high=1.0,
                 rounds: int = 20) -> torch.Tensor:
    """One uniform per pair, symmetric in (tag_a, tag_b)."""
    a = _u32(tag_a)
    b = _u32(tag_b)
    k0, k1 = _key_words(stream, seed, timestep)
    x0, _ = threefry2x32(k0, k1, torch.minimum(a, b), torch.maximum(a, b), rounds=rounds)
    return uniform_from_bits(x0, low, high)


def particle_bits(stream: int, seed, timestep, tag, n_words: int = 4):
    """``n_words`` uint32 streams keyed per particle tag. Returns a tuple.

    Word pairs come from counter lanes 0, 1, ... as in the reference; the
    lanes are evaluated together as one leading batch axis.
    """
    tag = _u32(tag)
    k0, k1 = _key_words(stream, seed, timestep)
    n_lanes = (n_words + 1) // 2
    lanes = torch.arange(n_lanes, dtype=torch.int64, device=tag.device)
    lanes = lanes.reshape((n_lanes,) + (1,) * tag.ndim)
    x0, x1 = threefry2x32(k0, k1, tag.unsqueeze(0), lanes)
    words = []
    for lane in range(n_lanes):
        words.extend([x0[lane], x1[lane]])
    return tuple(words[:n_words])


def particle_uniform3(stream: int, seed, timestep, tag, low=-1.0, high=1.0) -> torch.Tensor:
    """Three i.i.d. uniforms per particle, shape ``tag.shape + (3,)``."""
    w0, w1, w2, _ = particle_bits(stream, seed, timestep, tag, n_words=4)
    return torch.stack(
        [
            uniform_from_bits(w0, low, high),
            uniform_from_bits(w1, low, high),
            uniform_from_bits(w2, low, high),
        ],
        dim=-1,
    )
