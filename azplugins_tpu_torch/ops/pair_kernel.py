"""Pair force on the dense cell grid: the CUDA kernel, its wrapper, dispatch.

The kernel, ``csrc/cell_pair_force.cu``, replaces the TPU kernel
``azplugins_tpu/ops/pallas_pair.py::stencil_pair_force_kernel`` as reached
through ``azplugins_tpu/ops/dense.py::_pallas_half_pair_force`` for the
perturbed Lennard-Jones potential: force only on the step path, and force
with per-slot energy and virial (modes none and shift) for observables.
Its plain PyTorch version is :func:`azplugins_tpu_torch.ops.dense.dense_pair_force`.

What bounds it on an H100. At the 64k headline (cap 48, ~37 particles per
cell, r_cut 3.0 in cells 3.5 wide) each slot tests ~1,000 occupied
candidates in its 27 neighbour cells, of which ~100 fall inside the cutoff.
The cutoff test costs ~10 float32 operations and four shared-memory reads
per candidate, the full evaluation ~30 float32 operations per pair inside
the cutoff, and every pair is evaluated from both of its sides (twice the
half stencil's work). That is ~1 GFLOP per call, ~15 us at the card's
67 TFLOP/s float32 peak; the instruction stream of the candidate loop
(instruction slots and shared-memory reads, not FLOPs) is what binds, estimated
at ~0.1 ms. Occupancy: one 64-thread block per cell, so a quarter of the
lanes idle at cap 48, and the 1,728 cells give ~26 resident warps per SM.
Measured on an H100 80GB HBM3 at 700 W: 0.39-0.40 ms per call at the
headline with the untuned cap 72, where each thread also walks ~35 empty
slots per neighbour cell (PERF.md).

What the design does about it: positions and typeids of each neighbour cell
are staged once in shared memory and read as broadcasts; empty slots and
pairs beyond the cutoff leave the loop before any evaluator work; the
accumulation stays in registers with no atomics. Work skipping by cell
occupancy, Newton halving with a j-side scatter and a faster reciprocal are
later measurements.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.state import State
from .cuda_build import load_library
from .dense import GridSpec, dense_pair_force, make_jblocks
from .evaluators.pair import perturbed_lennard_jones
from .pair_force import ForceResult

__all__ = ["launches", "plj_kernel_tables", "cell_pair_force", "pair_force"]

# kernel launches since import (or since a caller last reset it to 0)
launches = 0

_SOURCE = "cell_pair_force.cu"
# order of the stacked [T, T] tables the kernel reads (csrc enum Tab)
_PARAM_KEYS = ("lj1", "lj2", "lam", "rwcasq", "wca_shift")
_N_TABLES = len(_PARAM_KEYS) + 2  # + rcutsq, ecut
_MODES = {"none": 0, "shift": 1}
_ROADMAP_B2 = (
    "the CUDA pair kernel covers PerturbedLennardJones in modes none and shift; "
    "other potentials and xplor on the GPU are ROADMAP queue B item B2"
)


def plj_kernel_tables(params: dict, r_cut: torch.Tensor) -> torch.Tensor:
    """Stack the PLJ tables for the kernel: ``[7, T, T]`` float32.

    ``ecut`` is the pair energy at the cutoff (the shift-mode offset),
    evaluated by the plain evaluator, as the reference's kernel path does.
    """
    rcutsq = r_cut * r_cut
    ecut, _ = perturbed_lennard_jones(torch.where(rcutsq > 0, rcutsq, 4.0), rcutsq, params)
    return torch.stack([params[k] for k in _PARAM_KEYS] + [rcutsq, ecut]).contiguous()


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    fn = lib.az_cell_pair_force
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i] + [f] * 9 + [i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cell_pair_force(dense: State, spec: GridSpec, tables: torch.Tensor,
                    mode: str = "none", want: str = "force") -> ForceResult:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    ``tables`` comes from :func:`plj_kernel_tables`. Returns per-slot force
    ``[S, 3]``, plus energy ``[S]`` and virial ``[S, 6]`` when ``want="all"``.
    """
    global launches
    dev = dense.position.device
    if dev.type != "cuda":
        raise ValueError(f"cell_pair_force needs CUDA tensors, got {dev}")
    if mode not in _MODES:
        raise NotImplementedError(_ROADMAP_B2)
    if want not in ("force", "all"):
        raise ValueError(f"want must be 'force' or 'all', got {want!r}")
    S, T = spec.S, tables.shape[-1]
    if spec.cap > 1024:
        raise ValueError(f"cell capacity {spec.cap} exceeds the kernel's 1024 threads per cell")
    _check(dense.position, "position", torch.float32, (S, 3), dev)
    _check(dense.typeid, "typeid", torch.int32, (S,), dev)
    _check(dense.tag, "tag", torch.int32, (S,), dev)
    _check(tables, "tables", torch.float32, (_N_TABLES, T, T), dev)

    lib = _library()
    force = torch.empty((S, 3), dtype=torch.float32, device=dev)
    want_all = want == "all"
    energy = torch.empty((S,), dtype=torch.float32, device=dev) if want_all else None
    virial = torch.empty((S, 6), dtype=torch.float32, device=dev) if want_all else None
    box = dense.box
    xyLy, xzLz, yzLz = box.lattice_products()
    err = lib.az_cell_pair_force(
        dense.position.data_ptr(), dense.typeid.data_ptr(), dense.tag.data_ptr(),
        tables.data_ptr(), T, *spec.dims, spec.cap,
        box.Lx, box.Ly, box.Lz, box.xy, box.xz, box.yz, xyLy, xzLz, yzLz,
        int(not spec.newton_ok), _MODES[mode], int(want_all),
        force.data_ptr(),
        energy.data_ptr() if want_all else None,
        virial.data_ptr() if want_all else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.az_cuda_error_string(err).decode()
        raise RuntimeError(f"cell_pair_force launch failed: CUDA error {err} ({msg})")
    launches += 1
    return ForceResult(force=force, energy=energy, virial=virial)


def pair_force(energy_force_fn, dense: State, spec: GridSpec, tbl: dict,
               mode: str = "none", want: str = "all") -> ForceResult:
    """Pair force of one potential on the dense grid, by the tensors' device.

    ``tbl`` holds the device tables of :class:`azplugins_tpu_torch.md.pair.Pair`:
    ``params``, ``r_cut``, ``r_on`` and, on CUDA, the stacked ``kernel``
    tables. CPU tensors take the plain version; CUDA tensors take the
    kernel, and a potential or mode the kernel does not cover raises.
    """
    dev = dense.position.device
    if dev.type == "cpu":
        jb = make_jblocks(dense, spec, half=spec.newton_ok)
        return dense_pair_force(
            energy_force_fn, dense, jb, spec, tbl["params"], tbl["r_cut"], tbl["r_on"],
            mode, want,
        )
    if dev.type != "cuda":
        raise ValueError(f"no pair force for device {dev}")
    if energy_force_fn is not perturbed_lennard_jones or "kernel" not in tbl:
        raise NotImplementedError(_ROADMAP_B2)
    return cell_pair_force(dense, spec, tbl["kernel"], mode, want)
