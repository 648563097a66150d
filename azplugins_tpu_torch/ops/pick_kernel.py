"""The evaporator's pick on the card (K4 at the pick): the CUDA kernels and their wrapper.

``csrc/pick.cu`` holds the two kernels, on the Threefry rounds of
``csrc/threefry.cuh``. They compute ``ParticleEvaporator``'s pick on a whole
layout or over every shard of a mesh on one device (``update.py``,
``ParticleEvaporator._pick``; reference
``azplugins_tpu/update.py::ParticleEvaporator._update``, which XLA
compiles: no ``pallas_call`` is replaced): the candidates (solvent slots
whose wrapped z lies in the slab), each candidate's priority (K4's first
word of its tag, ``core/rng.py::particle_bits``), the ``k`` smallest keys
``(priority << 31) | slot`` over all slots, global ones on shards (shard d's
local slot i is ``d * n_loc + i``, as ``ParticleEvaporator._keys`` numbers
them), and the flips written into each shard's ``typeid`` in place; the
shards' arrays reach the kernels as tables of pointers passed by value.
Both kernels read the trigger's flag on the card and return at once where
it is unset, so the graphs' masked form needs no select. Bitwise the plain
pick (``ParticleEvaporator._pick_plain``).

A launch runs on the current stream, with no synchronisation and no host
read. Under :func:`~azplugins_tpu_torch.core.rng.device_clock` the scan
reads its key's timestep word from the clock on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng as _rng
from ..utils import as_blocks
from .cuda_build import load_library
from .pair_kernel import check_tensor, launch_error

__all__ = ["launches", "evaporator_pick"]

# kernel launches since import (or since a caller last reset it to 0): two a
# pick, the scan and the select
launches = 0

_SOURCE = "pick.cu"


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    if lib.az_pick_scan.argtypes is None:
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        lib.az_pick_scan.argtypes = [p, p, p, i, i, i, f, f, f, f, u, u, p, i, p, p, p, p]
        lib.az_pick_select.argtypes = [p, i, i, i, i, p, p, p, p]
        for fn in (lib.az_pick_scan, lib.az_pick_select):
            fn.restype = ctypes.c_int
        lib.az_pick_layout.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.az_pick_layout.restype = None
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(entry: str, dev: torch.device, *args) -> None:
    """Call the C entry point ``entry`` on ``dev``'s current stream, with
    ``dev`` current; raise on its CUDA error, else count one launch."""
    global launches
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, entry, err)
    launches += 1


# the pointer tables' size in csrc/pick.cu (kMaxShards)
MAX_SHARDS = 64

# (slots a shard, shards) -> (regions a shard, keys a region) of the pick's
# scratch (az_pick_layout)
_layouts: dict[tuple[int, int], tuple[int, int]] = {}


def _layout(n_loc: int, n_shards: int) -> tuple[int, int]:
    if (n_loc, n_shards) not in _layouts:
        blocks, span = ctypes.c_int(), ctypes.c_int()
        _library().az_pick_layout(n_loc, n_shards, ctypes.byref(blocks), ctypes.byref(span))
        _layouts[n_loc, n_shards] = (blocks.value, span.value)
    return _layouts[n_loc, n_shards]


def _pointers(tensors: tuple):
    """A host array of the tensors' device pointers (what the C entry
    points copy into a kernel's pointer table)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def evaporator_pick(typeid, position, tag, k: int, solvent: int, evaporated: int, lo: float,
                    hi: float, Lz: float, stream: int, seed, timestep,
                    fire: torch.Tensor | None = None) -> None:
    """Flip, in ``typeid`` (int32 [N] on the card, written in place; on
    shards a tuple, one a shard, with ``position`` and ``tag`` tuples
    alike, every shard of N slots on one device), the candidates
    ``ParticleEvaporator``'s pick keeps: slots of type ``solvent`` whose
    wrapped z lies in [``lo``, ``hi``) (float32 bounds; ``Lz`` the box's
    float32 length), the ``k`` smallest keys ``(priority << 31) | slot``
    over all slots (global slots on shards, in shard order), the priority
    K4's first word of the tag under ``(stream, seed, timestep)``.
    ``fire``: a 0-d bool on the card, the kernels returning at once where
    it is unset; None is fired. ``k == 0`` flips nothing and launches
    nothing."""
    typeids, positions, tags = as_blocks(typeid), as_blocks(position), as_blocks(tag)
    n_shards = len(typeids)
    if not 1 <= n_shards <= MAX_SHARDS or len(positions) != n_shards or len(tags) != n_shards:
        raise ValueError(f"the pick takes 1 to {MAX_SHARDS} shards, each with its typeid, "
                         f"position and tag; got {len(typeids)}, {len(positions)}, {len(tags)}")
    dev = typeids[0].device
    if dev.type != "cuda":
        raise ValueError(f"the pick kernel needs CUDA tensors, got {dev}")
    n = typeids[0].numel()
    for d in range(n_shards):
        check_tensor(typeids[d], f"typeid[{d}]", torch.int32, (n,), dev)
        check_tensor(positions[d], f"position[{d}]", torch.float32, (n, 3), dev)
        check_tensor(tags[d], f"tag[{d}]", torch.int32, (n,), dev)
    if fire is not None:
        check_tensor(fire, "fire", torch.bool, (), dev)
    if n * n_shards >= 2**31:
        raise ValueError(f"{n * n_shards} slots exceed the keys' 31 slot bits")
    if k < 0:
        raise ValueError(f"k must be at least 0, got {k}")
    if n == 0 or k == 0:
        return
    blocks, span = _layout(n, n_shards)
    keys = torch.empty(n_shards * blocks * span, dtype=torch.int64, device=dev)
    counts = torch.empty(n_shards * blocks, dtype=torch.int32, device=dev)
    k0, k1 = _rng._key_words(stream, seed, timestep)
    flag = None if fire is None else fire.data_ptr()
    type_ptrs = _pointers(typeids)
    _launch("az_pick_scan", dev, type_ptrs, _pointers(positions), _pointers(tags), n, n_shards,
            int(solvent), float(lo), float(hi), float(np.float32(1.0 / Lz)),
            float(np.float32(Lz)), k0, k1, *_rng._clock_args(timestep, dev), flag,
            keys.data_ptr(), counts.data_ptr())
    _launch("az_pick_select", dev, type_ptrs, n, n_shards, min(int(k), n * n_shards),
            int(evaporated), flag, keys.data_ptr(), counts.data_ptr())
