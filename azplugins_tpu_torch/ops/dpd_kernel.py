"""DPD force on the dense cell grid: the CUDA kernel, its wrapper, dispatch.

The kernel, ``csrc/cell_dpd_force.cu``, replaces the TPU kernel
``azplugins_tpu/ops/pallas_pair.py::stencil_pair_force_kernel`` as reached
through ``azplugins_tpu/ops/dense.py::_pallas_half_dpd_force``: the full
DPD triple (conservative, drag, pair-symmetric random force) with the
Threefry-13 noise drawn inside the kernel, bitwise the plain version's
``core/rng.py::pair_uniform``. Where the reference took its XLA path
(``want="all"``, the observables), the kernel computes the energy and the
conservative virial too, so CUDA tensors never take the plain version. Its
plain PyTorch version is :func:`azplugins_tpu_torch.ops.dense.dense_dpd_force`.
The kernel runs the packed schedule of ``csrc/cell_stencil.cuh`` (see
:mod:`azplugins_tpu_torch.ops.pair_kernel`); what bounds it and what its
design does about it is in the source.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import rng as _rng
from ..core.state import State
from .cuda_build import load_library
from .dense import GridSpec, Window, dense_dpd_force, dpd_sigma_table, make_jblocks
from .pair_force import ForceResult
from .pair_kernel import box_args, check_cell_args, check_tensor, launch_error, launch_window

__all__ = ["launches", "dpd_kernel_tables", "cell_dpd_force", "dpd_force"]

# kernel launches since import (or since a caller last reset it to 0)
launches = 0

_SOURCE = "cell_dpd_force.cu"
_N_TABLES = 5  # A, gamma, s, r_cut, sigma (csrc enum Tab)


def dpd_kernel_tables(params: dict, r_cut: torch.Tensor, kT, dt: float) -> torch.Tensor:
    """Stack the DPD tables for the kernel: ``[5, T, T]`` float32.

    The last row is the random-force coefficient ``sqrt(6 gamma kT / dt)``,
    formed by the same torch expression the plain version uses
    (:func:`~azplugins_tpu_torch.ops.dense.dpd_sigma_table`); ``kT`` a float
    or, in a run with a variant kT, the schedule's 0-d float32 tensor on the
    card, so the kernel reads each step's row from the device.
    """
    sigma = dpd_sigma_table(params["gamma"], kT, dt)
    return torch.stack([params["A"], params["gamma"], params["s"], r_cut, sigma]).contiguous()


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    fn = lib.az_cell_dpd_force
    if fn.argtypes is None:
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        fn.argtypes = ([p, p, p, p, p, i, i, i, i, i, i, i, i, i] + [f] * 9
                       + [u, u, p, i, i, i, p, p, p, p])
        fn.restype = ctypes.c_int
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cell_dpd_force(dense: State, spec: GridSpec, tables: torch.Tensor, seed: int,
                   timestep: int, want: str = "force", window: Window | None = None) -> ForceResult:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    ``tables`` comes from :func:`dpd_kernel_tables`. ``dense.velocity`` is
    read as it stands: on the step path, the half-step velocity after
    step1, as the reference's force evaluation reads it. Under
    :func:`~azplugins_tpu_torch.core.rng.device_clock` the draw's timestep
    word is read from the clock on the card. Returns per-slot
    force ``[S, 3]``, plus energy ``[S]`` and virial ``[S, 6]`` when
    ``want="all"``; with a ``window``, read from ``window.state``, for its
    own slots.
    """
    global launches
    dense, geom, S_in, S = launch_window(dense, spec, window)
    dev = check_cell_args("cell_dpd_force", dense, spec, want, S_in)
    T = tables.shape[-1]
    check_tensor(dense.velocity, "velocity", torch.float32, (S_in, 3), dev)
    check_tensor(tables, "tables", torch.float32, (_N_TABLES, T, T), dev)
    k0, k1 = _rng._key_words(_rng.Stream.DPD_GENERAL_WEIGHT, seed, timestep)

    lib = _library()
    force = torch.empty((S, 3), dtype=torch.float32, device=dev)
    want_all = want == "all"
    energy = torch.empty((S,), dtype=torch.float32, device=dev) if want_all else None
    virial = torch.empty((S, 6), dtype=torch.float32, device=dev) if want_all else None
    # launched with the tensors' device current (a shard may lie on another card)
    with torch.cuda.device(dev):
        err = lib.az_cell_dpd_force(
            dense.position.data_ptr(), dense.velocity.data_ptr(), dense.typeid.data_ptr(),
            dense.tag.data_ptr(), tables.data_ptr(), T, *spec.dims, spec.cap, *geom,
            *box_args(dense), k0, k1, *_rng._clock_args(timestep, dev),
            int(not spec.newton_ok), int(want_all),
            force.data_ptr(),
            energy.data_ptr() if want_all else None,
            virial.data_ptr() if want_all else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise launch_error(lib, "cell_dpd_force", err)
    launches += 1
    return ForceResult(force=force, energy=energy, virial=virial)


def dpd_force(dense: State, spec: GridSpec, tbl: dict, kT, dt: float, seed: int,
              timestep: int, want: str = "all", window: Window | None = None) -> ForceResult:
    """DPD force on the dense grid, by the tensors' device.

    ``tbl`` holds the device tables of
    :class:`azplugins_tpu_torch.md.pair.DPDGeneralWeight` (``params``,
    ``r_cut``). CPU tensors take the plain version; CUDA tensors take the
    kernel. With a ``window`` (a shard's), the force of its own slots, read
    from ``window.state``.
    """
    src = dense if window is None else window.state
    dev = src.position.device
    if dev.type == "cpu":
        jb = make_jblocks(src, spec, half=spec.newton_ok, need_velocity=True, need_tag=True,
                          window=window)
        return dense_dpd_force(src, jb, spec, tbl["params"], tbl["r_cut"], kT, dt, seed,
                               timestep, want, window=window)
    if dev.type != "cuda":
        raise ValueError(f"no DPD force for device {dev}")
    tables = dpd_kernel_tables(tbl["params"], tbl["r_cut"], kT, dt)
    return cell_dpd_force(dense, spec, tables, seed, timestep, want, window=window)
