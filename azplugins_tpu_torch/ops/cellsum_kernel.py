"""The MPCD collision's cell sums on the card, deterministic: the CUDA kernel and its wrapper.

``csrc/cell_sums.cu`` holds K10, ``az_cell_sums``: what
:func:`azplugins_tpu_torch.mpcd._cell_sums` computes for CUDA tensors, every
cell's (count, mass, momentum, m v^2) with each cell's rows added in
ascending row order from +0.0, the order of the CPU's ``index_add_``
(reference ``azplugins_tpu/mpcd.py:267-273``, a scatter-add that XLA
compiles: no ``pallas_call`` is replaced). CUDA's ``index_add_`` adds with
atomics in an order that varies; this kernel makes a collision bitwise
reproducible on the card. Bitwise the plain version
(``mpcd.py::_cell_sums_plain`` on ``mpcd.py::_payload``).

A call runs on the current stream, with no synchronisation and no host
read, and counts one launch (its six steps are one entry point).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load_library
from .pair_kernel import check_tensor, launch_error

__all__ = ["launches", "cell_sums"]

# calls since import (or since a caller last reset it to 0): one a collision
# block
launches = 0

_SOURCE = "cell_sums.cu"


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    if lib.az_cell_sums.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.az_cell_sums.argtypes = [p, p, p, i, i, p, p, p]
        lib.az_cell_sums.restype = ctypes.c_int
        lib.az_cell_sums_work.argtypes = [i, i]
        lib.az_cell_sums_work.restype = ctypes.c_longlong
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cell_sums(cid: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor | None,
              cells: int) -> torch.Tensor:
    """K10: float32 ``[cells, 6]``, cell c's (count, mass, momentum xyz, m
    v^2) over the rows with ``cid == c`` (int64 ``[n]``; ``vel`` float32
    ``[n, 3]``; ``mass`` float32 ``[n]`` or None, 1 a row), each cell's rows
    added in ascending row order from +0.0. Rows whose id lies outside
    ``[0, cells)`` (the trash cell) are left out."""
    global launches
    dev = vel.device
    if dev.type != "cuda":
        raise ValueError(f"the cell-sum kernel needs CUDA tensors, got {dev}")
    n = cid.numel()
    check_tensor(cid, "cid", torch.int64, (n,), dev)
    check_tensor(vel, "vel", torch.float32, (n, 3), dev)
    if mass is not None:
        check_tensor(mass, "mass", torch.float32, (n,), dev)
    if n >= 2**31 or not 0 < cells < 2**31 - 1:
        raise ValueError(f"{n} rows into {cells} cells exceed the kernel's int32 indices")
    lib = _library()
    work = torch.empty(int(lib.az_cell_sums_work(n, cells)), dtype=torch.int32, device=dev)
    sums = torch.empty((cells, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.az_cell_sums(cid.data_ptr(), vel.data_ptr(),
                               None if mass is None else mass.data_ptr(), n, cells,
                               work.data_ptr(), sums.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "az_cell_sums", err)
    launches += 1
    return sums
