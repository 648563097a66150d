"""Anisotropic force on the dense cell grid: the CUDA kernel, its wrapper, dispatch.

The kernel, ``csrc/cell_aniso_force.cu``, replaces the TPU kernel
``azplugins_tpu/ops/pallas_pair.py::stencil_pair_force_kernel`` as reached
through ``azplugins_tpu/ops/dense.py::_pallas_half_aniso_force``: the
TwoPatchMorse force with each side's own torque, in modes none/shift.
Where the reference took its XLA path (``want="all"``, the observables),
the kernel computes the energy and the virial too, so CUDA tensors never
take the plain version. Its plain PyTorch version is
:func:`azplugins_tpu_torch.ops.dense.dense_aniso_force`. What bounds the
kernel and what its design does about it is in the source. Like the pair
and DPD kernels it runs the packed schedule of ``csrc/cell_stencil.cuh``
and takes the slot layout :func:`~azplugins_tpu_torch.ops.dense.densify`
builds, each cell's occupied slots first; a cell whose stencil holds
another layout gets NaN outputs (the torque too), never a silently
dropped pair.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.state import State
from .cuda_build import load_library
from .dense import GridSpec, Window, dense_aniso_force, make_jblocks
from .evaluators.aniso import morse_cut, two_patch_morse
from .pair_force import ForceResult
from .pair_kernel import box_args, check_cell_args, check_tensor, launch_error, launch_window

__all__ = ["launches", "KERNEL_TABLES", "aniso_kernel_tables", "cell_aniso_force", "aniso_force"]

# kernel launches since import (or since a caller last reset it to 0)
launches = 0

_SOURCE = "cell_aniso_force.cu"
# the kernel's [T, T] tables in the order it reads them (csrc enum Tab)
KERNEL_TABLES = ("M_d", "M_rinv", "r_eq", "omega", "alpha", "repulsion", "rcutsq", "U_cut")


def aniso_kernel_tables(params: dict, r_cut: torch.Tensor, mode: str) -> torch.Tensor:
    """Stack the TwoPatchMorse tables for the kernel: ``[8, T, T]`` float32.

    ``params`` holds the precomputed tables (M_d, M_rinv, r_eq, omega,
    alpha, repulsion). The last two rows are ``r_cut**2`` and ``U_cut``,
    the raw Morse energy at the cutoff (evaluated by the plain
    :func:`~azplugins_tpu_torch.ops.evaluators.aniso.morse_cut`, as the
    plain version does) for mode "shift", 0 for mode "none".
    """
    if mode not in ("none", "shift"):
        raise ValueError(f"unknown shift mode {mode!r} for an anisotropic potential")
    rcutsq = r_cut * r_cut
    if mode == "shift":
        u_cut = morse_cut(torch.where(r_cut > 0, rcutsq, 4.0), params)
    else:
        u_cut = torch.zeros_like(rcutsq)
    rows = [params[k] for k in KERNEL_TABLES[:6]] + [rcutsq, u_cut]
    return torch.stack(rows).to(torch.float32).contiguous()


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    fn = lib.az_cell_aniso_force
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i] + [f] * 9 + [i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cell_aniso_force(dense: State, spec: GridSpec, tables: torch.Tensor,
                     want: str = "force", window: Window | None = None) -> ForceResult:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    ``tables`` comes from :func:`aniso_kernel_tables` (it carries the mode).
    Returns per-slot force ``[S, 3]`` and torque ``[S, 3]``, plus energy
    ``[S]`` and virial ``[S, 6]`` when ``want="all"``; with a ``window``,
    read from ``window.state``, for its own slots.
    """
    global launches
    dense, geom, S_in, S = launch_window(dense, spec, window)
    dev = check_cell_args("cell_aniso_force", dense, spec, want, S_in)
    T = tables.shape[-1]
    check_tensor(dense.orientation, "orientation", torch.float32, (S_in, 4), dev)
    check_tensor(tables, "tables", torch.float32, (len(KERNEL_TABLES), T, T), dev)

    lib = _library()
    force = torch.empty((S, 3), dtype=torch.float32, device=dev)
    torque = torch.empty((S, 3), dtype=torch.float32, device=dev)
    want_all = want == "all"
    energy = torch.empty((S,), dtype=torch.float32, device=dev) if want_all else None
    virial = torch.empty((S, 6), dtype=torch.float32, device=dev) if want_all else None
    # launched with the tensors' device current (a shard may lie on another card)
    with torch.cuda.device(dev):
        err = lib.az_cell_aniso_force(
            dense.position.data_ptr(), dense.orientation.data_ptr(), dense.typeid.data_ptr(),
            dense.tag.data_ptr(), tables.data_ptr(), T, *spec.dims, spec.cap, *geom,
            *box_args(dense), int(not spec.newton_ok), int(want_all),
            force.data_ptr(), torque.data_ptr(),
            energy.data_ptr() if want_all else None,
            virial.data_ptr() if want_all else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise launch_error(lib, "cell_aniso_force", err)
    launches += 1
    return ForceResult(force=force, energy=energy, virial=virial, torque=torque)


def aniso_force(energy_force_torque_fn, dense: State, spec: GridSpec, tbl: dict,
                mode: str = "none", want: str = "all", window: Window | None = None) -> ForceResult:
    """TwoPatchMorse force and torque on the dense grid, by the tensors' device.

    ``tbl`` holds the device tables of
    :class:`azplugins_tpu_torch.md.pair.TwoPatchMorse`: ``params``,
    ``r_cut`` and, on CUDA, the stacked ``kernel`` tables with the
    ``kernel_mode`` they were built for, which must be ``mode`` (the kernel
    reads the shift from its tables). CPU tensors take the plain version;
    CUDA tensors take the kernel. With a ``window`` (a shard's), the force
    and torque of its own slots, read from ``window.state``.
    """
    src = dense if window is None else window.state
    dev = src.position.device
    if dev.type == "cpu":
        jb = make_jblocks(src, spec, half=spec.newton_ok, need_quat=True, window=window)
        return dense_aniso_force(energy_force_torque_fn, src, jb, spec, tbl["params"],
                                 tbl["r_cut"], mode, want, window=window)
    if dev.type != "cuda":
        raise ValueError(f"no anisotropic force for device {dev}")
    if energy_force_torque_fn is not two_patch_morse:
        raise NotImplementedError("the CUDA anisotropic kernel evaluates TwoPatchMorse only")
    if "kernel" not in tbl:
        raise ValueError("CUDA anisotropic force needs tbl['kernel'] from aniso_kernel_tables()")
    if tbl.get("kernel_mode") != mode:
        raise ValueError(f"tbl['kernel'] was built for mode {tbl.get('kernel_mode')!r}, "
                         f"not {mode!r}")
    return cell_aniso_force(dense, spec, tbl["kernel"], want, window=window)
