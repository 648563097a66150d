"""Counter-based random numbers for reproducible stochastic physics.

Port of ``azplugins_tpu/core/rng.py``: a vectorised Threefry-2x32 keyed on
(stream id, seed, timestep) with per-particle or per-pair counters, bitwise
equal to the reference on every device.

The MPCD collision (``mpcd.SRD``) draws through ``jax.random`` in the
reference, not through these streams; ``jax_key``, ``jax_fold_in``,
``jax_split``, ``jax_uniform_host`` and ``jax_normal`` rebuild those draws
from the same Threefry, as ``jax.random`` derives them with
``jax_threefry_partitionable`` on (JAX's default since 0.5): ``fold_in(k,
d)`` hashes the counter pair ``(0, d)`` under ``k``; ``split`` and the
random bits hash the pairs ``(i >> 32, i & 0xFFFFFFFF)`` over the row-major
index ``i`` of the shape, a 32-bit word being ``x0 ^ x1``; ``uniform`` fills
the mantissa, and ``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
``(-1, 1)`` and XLA's float32 ``ErfInv`` polynomial.

PyTorch has no usable unsigned 32-bit arithmetic (``torch.uint32`` lacks
add, shifts and ``minimum`` on the CPU), so the words travel as int64
tensors holding values in [0, 2**32) and every add is masked back to 32
bits. Keys and the timestep are Python ints, formed on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Stream",
    "FAST_ROUNDS",
    "threefry2x32",
    "uniform_from_bits",
    "pair_uniform",
    "particle_uniform3",
    "particle_bits",
    "jax_key",
    "jax_fold_in",
    "jax_split",
    "jax_uniform_host",
    "jax_normal",
    "xla_erfinv",
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


def _word(x):
    """A counter read modulo 2**32: an int stays an int (no device scalar)."""
    return _u32(x) if isinstance(x, torch.Tensor) else int(x) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 block cipher (random123 round and injection schedule).

    The key words ``k0``/``k1`` are Python ints; the counters are tensors of
    any integer dtype, or ints, read modulo 2**32 and broadcast together.
    Returns two int64 tensors holding uint32 values (two ints when both
    counters are ints). A key injection follows every 4th round, never a
    trailing partial group.
    """
    k0 = int(k0) & _M32
    k1 = int(k1) & _M32
    x0 = (_word(c0) + k0) & _M32
    x1 = (_word(c1) + k1) & _M32
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


# -- jax.random's derivation (partitionable Threefry) ------------------------
# XLA's float32 ErfInv (Giles' approximation), coefficients from the highest
# degree down, for w = -log1p(-x^2) below 5 and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
# normal's uniform interval: (nextafter(-1, 0), 1), and its width in float32
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_NORMAL_WIDTH = np.float32(1.0) - _NORMAL_LO


def jax_key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for a 32-bit seed: the words (0, seed)."""
    return 0, int(seed) & _M32


def jax_fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: the counter pair (0, data) hashed."""
    return threefry2x32(key[0], key[1], 0, data)


def jax_split(key: tuple[int, int], n: int) -> list[tuple[int, int]]:
    """``jax.random.split(key, n)``: key i hashes the counter pair (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(n)]


def jax_uniform_host(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,), float32)`` in [0, 1), on the host:
    numpy float32, for the few draws the host needs (a grid shift)."""
    words = []
    for i in range(n):
        x0, x1 = threefry2x32(key[0], key[1], 0, i)
        words.append(x0 ^ x1)
    bits = (np.asarray(words, dtype=np.uint32) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))


def xla_erfinv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function in XLA's float32 form (its ``ErfInv``), on
    the tensor's device: ``torch.erfinv`` is another approximation."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1.0, x * float(np.finfo(np.float32).max), p * x)


def jax_normal(key: tuple[int, int], shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device``: the words
    and the uniforms bitwise; the erfinv within a few ulp of XLA's (the
    log1p and the polynomial's rounding are the device's own)."""
    n = int(np.prod(shape))
    if n >= 2**32:
        raise ValueError("jax_normal: more than 2**32 draws need the high counter word")
    x0, x1 = threefry2x32(key[0], key[1], 0, torch.arange(n, dtype=torch.int64, device=device))
    word = ((x0 ^ x1) >> 9) | 0x3F800000
    f = word.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * float(_NORMAL_WIDTH) + float(_NORMAL_LO), float(_NORMAL_LO))
    return (_SQRT2_F32 * xla_erfinv(u)).reshape(shape)
