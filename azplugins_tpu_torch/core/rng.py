"""Counter-based random numbers for reproducible stochastic physics.

Port of ``azplugins_tpu/core/rng.py``: a vectorised Threefry-2x32 keyed on
(stream id, seed, timestep) with per-particle or per-pair counters, bitwise
equal to the reference on every device.

The MPCD collision (``mpcd.SRD``) draws through ``jax.random`` in the
reference, not through these streams; ``jax_key``, ``jax_fold_in``,
``jax_split``, ``jax_uniform_host`` and ``jax_normal_axis`` rebuild those draws
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
bits. Keys and the timestep are Python ints, formed on the host, except
inside :func:`device_clock`: there a draw takes its key's timestep word
from a clock on the card (a 0-d int64 tensor), so that a CUDA graph
captured inside replays at whatever timestep the clock holds then. The
kernels read the clock themselves (a pointer and an offset,
:func:`_clock_args`); the plain versions add the offset to it as a tensor
(:func:`_step_word`). Both give the host int's bits, past 2**32 too.

The MPCD collision's keys and grid shift derive from its timestep. On the
host (the eager loop) :func:`jax_fold_in`, :func:`jax_split` and
:func:`jax_uniform_host` form them; :func:`collision_draws` forms them on
the device from the timestep word, the clock's under :func:`device_clock`,
with the draws of :func:`jax_normal_axis` in the same call, so a CUDA graph
of a collision replays at the clock's timestep.

Dispatch: ``particle_bits``, ``particle_uniform3``, ``jax_normal_axis``
and ``collision_draws`` take their plain PyTorch versions
(``_particle_bits_plain``, ``_particle_uniform3_plain``,
``_jax_normal_axis_plain``, itself on ``_jax_normal_plain``, the plain
``jax.random.normal``, and ``_collision_draws_plain``) for CPU tensors and
the CUDA kernels of :mod:`azplugins_tpu_torch.ops.rng_kernel` for CUDA
tensors, or raise; any other device raises. Nothing falls back.
``threefry2x32`` and ``pair_uniform`` stay plain (the CPU DPD path; the
card's DPD kernel draws its own).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = [
    "Stream",
    "FAST_ROUNDS",
    "device_clock",
    "threefry2x32",
    "uniform_from_bits",
    "pair_uniform",
    "particle_uniform3",
    "particle_bits",
    "jax_key",
    "jax_fold_in",
    "jax_split",
    "jax_uniform_host",
    "jax_normal_axis",
    "collision_draws",
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

    The key words ``k0``/``k1`` and the counters are ints or tensors of
    any integer dtype (a key word a tensor where it derives from the card's
    clock), read modulo 2**32 and broadcast together.
    Returns two int64 tensors holding uint32 values (two ints when every
    input is an int). A key injection follows every 4th round, never a
    trailing partial group.
    """
    k0 = _word(k0)
    k1 = _word(k1)
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


def _key_words(stream: int, seed: int, timestep: int, device=None) -> tuple:
    """The two key words from (stream id, user seed, timestep). The second
    is :func:`_step_word` on ``device``: an int, or under
    :func:`device_clock` on that device a 0-d word tensor there."""
    k0 = ((int(stream) << 16) & _M32) ^ (int(seed) & _M32)
    return k0, _step_word(timestep, device)


# the clock of device_clock(): (0-d int64 tensor, the timestep it holds at
# capture), or None outside it
_clock: tuple | None = None


@contextlib.contextmanager
def device_clock(clock: torch.Tensor, base: int):
    """Key the draws on ``clock``'s device on the card's clock while inside.

    ``clock`` is a 0-d int64 tensor that holds the timestep ``base`` when
    the work inside runs; a draw at timestep ``t`` then takes the key word
    ``(clock + t - base) mod 2**32``, read on the card by the kernels and
    added as a tensor by the plain versions, never read on the host. Work
    captured inside as a CUDA graph thus draws at the timestep the clock
    holds when it is replayed (``Simulation``'s segment graphs).
    """
    global _clock
    if clock.dtype != torch.int64 or clock.dim() != 0:
        raise ValueError("the device clock is a 0-d int64 tensor")
    prev, _clock = _clock, (clock, int(base))
    try:
        yield
    finally:
        _clock = prev


def _clock_on(device) -> tuple | None:
    """The active device clock when it lies on ``device`` (``"cuda"``
    naming the current CUDA device), else None."""
    if _clock is None or device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _clock if _clock[0].device == dev else None


def _offset(timestep: int, base: int) -> int:
    off = int(timestep) - base
    if not -(2**31) <= off < 2**31:
        raise ValueError(f"timestep {timestep} lies {off} steps from the device clock's")
    return off


def _step_word(timestep: int, device=None):
    """The key's timestep word: ``timestep mod 2**32`` as an int, or under
    :func:`device_clock` on ``device`` the clock's word as a 0-d int64
    tensor there (no host read)."""
    c = _clock_on(device)
    if c is None:
        return int(timestep) & _M32
    clock, base = c
    return (clock + _offset(timestep, base)) & _M32


def _clock_args(timestep: int, device) -> tuple:
    """A kernel's clock arguments: ``(pointer to the clock, offset)`` under
    :func:`device_clock` on ``device`` (the kernel keys on ``(uint32)(clock
    + offset)``), else ``(None, 0)`` (it keys on the host's word)."""
    c = _clock_on(device)
    if c is None:
        return None, 0
    clock, base = c
    return clock.data_ptr(), _offset(timestep, base)


def pair_uniform(stream: int, seed, timestep, tag_a, tag_b, low=-1.0, high=1.0,
                 rounds: int = 20) -> torch.Tensor:
    """One uniform per pair, symmetric in (tag_a, tag_b)."""
    a = _u32(tag_a)
    b = _u32(tag_b)
    k0, k1 = _key_words(stream, seed, timestep, a.device)
    x0, _ = threefry2x32(k0, k1, torch.minimum(a, b), torch.maximum(a, b), rounds=rounds)
    return uniform_from_bits(x0, low, high)


def _on_card(device) -> bool:
    """Whether work on ``device`` takes its kernel (CUDA) or its plain
    version (the CPU); any other device raises. The draws, the integrator
    and the drift check dispatch through it."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain version for device {dev}")
    return dev.type == "cuda"


def _kernels():
    from ..ops import rng_kernel  # imported here: ops imports core

    return rng_kernel


def particle_bits(stream: int, seed, timestep, tag, n_words: int = 4):
    """``n_words`` uint32 streams keyed per particle tag. Returns a tuple.

    Word pairs come from counter lanes 0, 1, ... as in the reference. A
    CUDA ``tag`` takes the kernel (K4), bitwise the plain version.
    """
    if isinstance(tag, torch.Tensor) and _on_card(tag.device):
        return _kernels().particle_bits(stream, seed, timestep, tag, n_words)
    return _particle_bits_plain(stream, seed, timestep, tag, n_words)


def particle_uniform3(stream: int, seed, timestep, tag, low=-1.0, high=1.0) -> torch.Tensor:
    """Three i.i.d. uniforms per particle, shape ``tag.shape + (3,)``. A
    CUDA ``tag`` takes the kernel (K4), bitwise the plain version."""
    if isinstance(tag, torch.Tensor) and _on_card(tag.device):
        return _kernels().particle_uniform3(stream, seed, timestep, tag, low, high)
    return _particle_uniform3_plain(stream, seed, timestep, tag, low, high)


def _particle_bits_plain(stream: int, seed, timestep, tag, n_words: int = 4):
    """The plain version of :func:`particle_bits`: the lanes are evaluated
    together as one leading batch axis."""
    tag = _u32(tag)
    k0, k1 = _key_words(stream, seed, timestep, tag.device)
    n_lanes = (n_words + 1) // 2
    lanes = torch.arange(n_lanes, dtype=torch.int64, device=tag.device)
    lanes = lanes.reshape((n_lanes,) + (1,) * tag.ndim)
    x0, x1 = threefry2x32(k0, k1, tag.unsqueeze(0), lanes)
    words = []
    for lane in range(n_lanes):
        words.extend([x0[lane], x1[lane]])
    return tuple(words[:n_words])


def _particle_uniform3_plain(stream: int, seed, timestep, tag, low=-1.0,
                             high=1.0) -> torch.Tensor:
    """The plain version of :func:`particle_uniform3`."""
    w0, w1, w2, _ = _particle_bits_plain(stream, seed, timestep, tag, n_words=4)
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


def _jax_normal_plain(key: tuple[int, int], shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device``, as PyTorch
    operations: the words and the uniforms bitwise; the erfinv within a few
    ulp of XLA's (the log1p is the device's own). K5 draws these normals
    inside :func:`jax_normal_axis`."""
    n = int(np.prod(shape))
    if n >= 2**32:
        raise ValueError("jax_normal: more than 2**32 draws need the high counter word")
    x0, x1 = threefry2x32(key[0], key[1], 0, torch.arange(n, dtype=torch.int64, device=device))
    word = ((x0 ^ x1) >> 9) | 0x3F800000
    f = word.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * float(_NORMAL_WIDTH) + float(_NORMAL_LO), float(_NORMAL_LO))
    return (_SQRT2_F32 * xla_erfinv(u)).reshape(shape)


def jax_normal_axis(key: tuple[int, int], rows: int, device, second=None) -> tuple:
    """The MPCD collision's draws: ``(axis, normals)``, ``axis`` the unit
    rows of ``jax.random.normal(key, (rows, 3), float32)``, each divided by
    its norm clamped at 1e-12 (``azplugins_tpu/mpcd.py:323-326``), and
    ``normals`` ``jax.random.normal(second, (rows, 3), float32)``, or None
    without ``second`` (the virtual-particle fill between plates, ``:314``).
    A CUDA ``device`` takes K5's axis form: both in one launch."""
    if _on_card(device):
        return _kernels().jax_normal_axis(key, rows, device, second)
    return _jax_normal_axis_plain(key, rows, device, second)


def _jax_normal_axis_plain(key: tuple[int, int], rows: int, device, second=None) -> tuple:
    """The plain version of :func:`jax_normal_axis`: two plain draws and
    the normalisation as PyTorch operations."""
    axis = _jax_normal_plain(key, (rows, 3), device)
    axis = axis / torch.clamp_min(torch.sqrt(torch.sum(axis * axis, dim=1, keepdim=True)), 1e-12)
    return axis, None if second is None else _jax_normal_plain(second, (rows, 3), device)


def collision_draws(inner: tuple[int, int], timestep: int, rows: int, device, cell_size: float,
                    shift: bool = True, second: bool = False) -> tuple:
    """The MPCD collision's draws at ``timestep`` from its inner key ``inner``
    (``fold_in(key(seed), stream)``, host words), every step on the device:
    the collision key ``fold_in(inner, timestep)`` split in three,
    ``(kshift, kaxis, kvirt)``, the timestep word the clock's under
    :func:`device_clock`. Returns ``(axis, normals, shift, scaled)``: what
    :func:`jax_normal_axis` draws under ``kaxis`` (and ``kvirt`` with
    ``second``), the grid shift ``jax.random.uniform(kshift, (3,)) *
    cell_size`` (zeros without ``shift``) and ``shift / cell_size``, both
    float32 [3] formed as the host forms them (an IEEE product and
    quotient), so every value is bitwise the host-key form's. A CUDA
    ``device`` takes K5's clock form: one launch."""
    if _on_card(device):
        return _kernels().collision_draws(inner, timestep, rows, device, cell_size, shift, second)
    return _collision_draws_plain(inner, timestep, rows, device, cell_size, shift, second)


def _collision_draws_plain(inner: tuple[int, int], timestep: int, rows: int, device,
                           cell_size: float, shift: bool = True, second: bool = False) -> tuple:
    """The plain version of :func:`collision_draws`: the keys hashed as
    tensors where the timestep word is the clock's, the shift's uniforms as
    :func:`jax_uniform_host` forms them, the quotient by a tensor (PyTorch
    divides by a Python scalar as a product with its reciprocal)."""
    key = jax_fold_in(inner, _step_word(timestep, device))
    kshift, kaxis, kvirt = jax_split(key, 3)
    axis, normals = _jax_normal_axis_plain(kaxis, rows, device, kvirt if second else None)
    a = float(np.float32(cell_size))
    if shift:
        x0, x1 = threefry2x32(kshift[0], kshift[1], 0,
                              torch.arange(3, dtype=torch.int64, device=device))
        word = ((x0 ^ x1) >> 9) | 0x3F800000
        offset = torch.clamp_min(word.to(torch.int32).view(torch.float32) - 1.0, 0.0) * a
    else:
        offset = torch.zeros(3, dtype=torch.float32, device=device)
    return axis, normals, offset, offset / torch.full((3,), a, dtype=torch.float32, device=device)
