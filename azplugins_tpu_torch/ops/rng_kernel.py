"""Counter-based random draws on the card: the CUDA kernels and their wrappers.

``csrc/threefry.cu`` holds the kernels, on the Threefry rounds of
``csrc/threefry.cuh``. None replaces a ``pallas_call``: they compute what
the reference leaves to XLA, which fuses it into its step.

- K4 ``az_particle_bits`` / ``az_particle_uniform3``: what
  :func:`~azplugins_tpu_torch.core.rng.particle_bits` and
  :func:`~azplugins_tpu_torch.core.rng.particle_uniform3` compute
  (reference ``azplugins_tpu/core/rng.py::particle_bits``,
  ``particle_uniform3``): the per-particle draws of Brownian, the
  evaporator's pick on shards and thermalize (Langevin draws the same
  uniforms inside its integrator kernels, ``ops/integrate_kernel.py``).
  Bitwise the plain version.
- K5 ``az_jax_normal_axis``: what
  :func:`~azplugins_tpu_torch.core.rng.jax_normal_axis` computes, the
  MPCD collision's unit axes, ``jax.random.normal`` over its row's norm
  (reference ``azplugins_tpu/mpcd.py:323-326``), with the virtual-particle
  normals under a second key (``:314``) in the same launch. Bitwise the
  plain version but for ``log1pf`` against PyTorch's CUDA ``log1p``.
- K5's clock form ``az_collision_draws``: what
  :func:`~azplugins_tpu_torch.core.rng.collision_draws` computes, the
  collision's keys derived on the card from its inner key and the timestep
  word (the clock's under ``device_clock``: a CUDA graph of a collision
  replays at the clock's timestep), K5's draws under them and the grid
  shift with its quotient by the cell size (reference
  ``azplugins_tpu/mpcd.py:238-248``), in one launch; bitwise K5's
  host-key form and the host's shift.

The evaporator's pick on K4's words is ``ops/pick_kernel.py``. The plain
PyTorch versions are ``core/rng.py``'s ``_particle_bits_plain``,
``_particle_uniform3_plain`` and ``_jax_normal_axis_plain``. The public
functions dispatch here for CUDA tensors; a launch runs on the current
stream, with no synchronisation and no host-to-device copy (the keys and
constants are kernel arguments). Under
:func:`~azplugins_tpu_torch.core.rng.device_clock` K4 reads its key's
timestep word from the clock on the card (a CUDA graph's replays draw at
the clock's timestep), bitwise the host word's. An empty draw launches
nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng as _rng
from .cuda_build import load_library
from .pair_kernel import check_tensor, launch_error

__all__ = ["launches", "launches_by_kernel", "particle_bits", "particle_uniform3",
           "jax_normal_axis", "collision_draws"]

# kernel launches since import (or since a caller last reset them to 0):
# in all, and by kernel ("particle_bits" for K4, "jax_normal_axis" for K5,
# "jax_normal_axis_clock" for its clock form)
launches = 0
launches_by_kernel: dict[str, int] = {}

_SOURCE = "threefry.cu"


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    if lib.az_particle_bits.argtypes is None:
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        lib.az_particle_bits.argtypes = [p, i, i, u, u, p, i, p, p]
        lib.az_particle_uniform3.argtypes = [p, i, u, u, p, i, f, f, p, p]
        lib.az_jax_normal_axis.argtypes = [ctypes.c_int64, u, u, u, u, i, f, f, f, p, p, p, p]
        lib.az_collision_draws.argtypes = [ctypes.c_int64, u, u, u, p, i, i, i, f, f, f, f, p,
                                           p, p, p, p, p]
        for fn in (lib.az_particle_bits, lib.az_particle_uniform3, lib.az_jax_normal_axis,
                   lib.az_collision_draws):
            fn.restype = ctypes.c_int
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, entry: str, dev: torch.device, *args) -> None:
    """Call the C entry point ``entry`` on ``dev``'s current stream, with
    ``dev`` current (a shard may lie on another card); raise on its CUDA
    error, else count one launch of ``kernel``."""
    global launches
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, entry, err)
    launches += 1
    launches_by_kernel[kernel] = launches_by_kernel.get(kernel, 0) + 1


def _tags(tag: torch.Tensor) -> tuple[torch.Tensor, torch.device]:
    """The tags as one contiguous int32 row on their CUDA device."""
    dev = tag.device
    if dev.type != "cuda":
        raise ValueError(f"the random-draw kernels need CUDA tensors, got {dev}")
    flat = tag.reshape(-1).contiguous()
    check_tensor(flat, "tag", torch.int32, (flat.numel(),), dev)
    if flat.numel() >= 2**31:
        raise ValueError(f"{flat.numel()} tags exceed the kernel's int32 index")
    return flat, dev


def uniform_args(low, high) -> tuple[float, float]:
    """The float32 scale and offset of ``uniform_from_bits(bits, low,
    high)``: PyTorch rounds the Python scalars ``high - low`` (formed in
    double) and ``low`` to float32 when it multiplies and adds."""
    return float(np.float32(high - low)), float(np.float32(low))


def normal_args() -> tuple[float, float, float, np.ndarray]:
    """The float32 constants of K5's normals: the uniform's width and low
    end, sqrt(2), and XLA's ErfInv coefficients (w < 5, then w >= 5), each
    the float32 of the plain version's Python float."""
    coeffs = np.asarray(_rng._ERFINV_LT5 + _rng._ERFINV_GE5, dtype=np.float32)
    return (float(np.float32(_rng._NORMAL_WIDTH)), float(np.float32(_rng._NORMAL_LO)),
            float(np.float32(_rng._SQRT2_F32)), coeffs)


# formed once: the coefficients' host array must outlive each launch call
_NORMAL_ARGS = normal_args()


def particle_bits(stream: int, seed, timestep, tag: torch.Tensor, n_words: int = 4) -> tuple:
    """K4 in words mode: ``n_words`` int64 tensors shaped like ``tag``,
    holding the uint32 words of counter lanes 0, 1, ... (a tuple)."""
    flat, dev = _tags(tag)
    if n_words < 1:
        raise ValueError(f"n_words must be at least 1, got {n_words}")
    n = flat.numel()
    words = torch.empty((n_words, n), dtype=torch.int64, device=dev)
    if n:
        k0, k1 = _rng._key_words(stream, seed, timestep)
        _launch("particle_bits", "az_particle_bits", dev, flat.data_ptr(), n, n_words, k0, k1,
                *_rng._clock_args(timestep, dev), words.data_ptr())
    return tuple(words.reshape((n_words,) + tuple(tag.shape)).unbind(0))


def particle_uniform3(stream: int, seed, timestep, tag: torch.Tensor, low=-1.0,
                      high=1.0) -> torch.Tensor:
    """K4 in uniform3 mode: float32 ``tag.shape + (3,)`` in [low, high)."""
    flat, dev = _tags(tag)
    n = flat.numel()
    out = torch.empty(tuple(tag.shape) + (3,), dtype=torch.float32, device=dev)
    if n:
        k0, k1 = _rng._key_words(stream, seed, timestep)
        width, low32 = uniform_args(low, high)
        _launch("particle_bits", "az_particle_uniform3", dev, flat.data_ptr(), n, k0, k1,
                *_rng._clock_args(timestep, dev), width, low32, out.data_ptr())
    return out


def jax_normal_axis(key: tuple[int, int], rows: int, device, second=None) -> tuple:
    """K5's axis form: ``(axis, normals)``, ``axis`` the unit rows of
    ``jax.random.normal(key, (rows, 3), float32)`` (each row over its norm
    clamped at 1e-12) and ``normals`` ``jax.random.normal(second, (rows,
    3))`` (None without ``second``), in one launch on the CUDA ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the random-draw kernels need a CUDA device, got {dev}")
    if 3 * rows >= 2**32:
        raise ValueError("jax_normal_axis: more than 2**32 draws need the high counter word")
    axis = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    normals = None if second is None else torch.empty((rows, 3), dtype=torch.float32, device=dev)
    if rows:
        width, lo, sqrt2, coeffs = _NORMAL_ARGS
        k2 = (0, 0) if second is None else second
        _launch("jax_normal_axis", "az_jax_normal_axis", dev, rows, int(key[0]) & 0xFFFFFFFF,
                int(key[1]) & 0xFFFFFFFF, int(k2[0]) & 0xFFFFFFFF, int(k2[1]) & 0xFFFFFFFF,
                int(second is not None), width, lo, sqrt2, coeffs.ctypes.data, axis.data_ptr(),
                None if normals is None else normals.data_ptr())
    return axis, normals


def collision_draws(inner: tuple[int, int], timestep: int, rows: int, device, cell_size: float,
                    shift: bool = True, second: bool = False) -> tuple:
    """K5's clock form: ``(axis, normals, shift, scaled)`` as
    :func:`~azplugins_tpu_torch.core.rng.collision_draws` defines them, the
    keys derived on the CUDA ``device`` from ``inner`` and the timestep word
    (read from the clock there under ``device_clock``), in one launch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the random-draw kernels need a CUDA device, got {dev}")
    if not (0 < rows and 3 * rows < 2**32):
        raise ValueError(f"collision_draws: {rows} rows (one or more, 3 rows under 2**32)")
    axis = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    normals = torch.empty((rows, 3), dtype=torch.float32, device=dev) if second else None
    out = torch.empty((2, 3), dtype=torch.float32, device=dev)  # the shift, its quotient
    width, lo, sqrt2, coeffs = _NORMAL_ARGS
    _launch("jax_normal_axis_clock", "az_collision_draws", dev, rows, int(inner[0]) & 0xFFFFFFFF,
            int(inner[1]) & 0xFFFFFFFF, _rng._step_word(timestep), *_rng._clock_args(timestep, dev),
            int(second), int(shift), float(np.float32(cell_size)), width, lo, sqrt2,
            coeffs.ctypes.data, axis.data_ptr(), None if normals is None else normals.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr())
    return axis, normals, out[0], out[1]
