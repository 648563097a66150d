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
read: a memset and two kernels (three nodes in a CUDA graph), which bucket
the rows by cell and add each cell's. It counts one launch. The wrapper
picks, from the rows a cell, the lanes that add a cell
(:func:`group_width`) and the slots a bucket (:func:`bucket_cap`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import load_library
from .pair_kernel import check_tensor, launch_error

__all__ = ["launches", "GROUPS", "group_width", "bucket_cap", "cell_sums"]

# calls since import (or since a caller last reset it to 0): one a collision
# block
launches = 0

_SOURCE = "cell_sums.cu"

# the lane groups the kernel is built for (lanes a cell); a lone lane takes
# a cell of up to 4 rows, a group one of up to its width
GROUPS = (1, 8, 16, 32)


def group_width(n: int, cells: int) -> int:
    """The lanes a cell for ``n`` rows into ``cells`` cells: the least of
    :data:`GROUPS` that takes at least twice the mean rows a cell (a lone
    lane at pure SRD's one row a cell, a warp from 16 rows a cell on). A
    deeper cell is taken by its warp, or past 32 rows by its block."""
    return next((g for g in GROUPS if max(g, 4) >= 2 * n / cells), GROUPS[-1])


def bucket_cap(n: int, cells: int) -> int:
    """The slots a cell's bucket holds: a power of two at least twice the
    mean rows a cell, from 8 (one 32-byte sector) to 4,096. Rows past it go
    to an overflow list that only a cell deeper than its bucket reads."""
    return min(4096, max(8, 1 << max(0, math.ceil(2 * n / cells) - 1).bit_length()))


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    if lib.az_cell_sums.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.az_cell_sums.argtypes = [p, p, p, i, i, i, i, p, p, p]
        lib.az_cell_sums.restype = ctypes.c_int
        lib.az_cell_sums_work.argtypes = [i, i, i]
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
    ``[0, cells)`` (the trash cell) are left out. :func:`group_width`
    gives the lanes a cell (every width the same bits); the workspace holds
    :func:`bucket_cap` int32 a cell and two a row."""
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
    group, cap = group_width(n, cells), bucket_cap(n, cells)
    lib = _library()
    work = torch.empty(int(lib.az_cell_sums_work(n, cells, cap)), dtype=torch.int32, device=dev)
    sums = torch.empty((cells, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.az_cell_sums(cid.data_ptr(), vel.data_ptr(),
                               None if mass is None else mass.data_ptr(), n, cells, group,
                               cap, work.data_ptr(), sums.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "az_cell_sums", err)
    launches += 1
    return sums
