"""The evaporator's pick on the card (K4 at the pick): the CUDA kernels and their wrapper.

``csrc/pick.cu`` holds the two kernels, on the Threefry rounds of
``csrc/threefry.cuh``. They compute ``ParticleEvaporator``'s pick on a whole
layout (``update.py``, ``ParticleEvaporator._pick``; reference
``azplugins_tpu/update.py::ParticleEvaporator._update``, which XLA
compiles: no ``pallas_call`` is replaced): the candidates (solvent slots
whose wrapped z lies in the slab), each candidate's priority (K4's first
word of its tag, ``core/rng.py::particle_bits``), the ``k`` smallest keys
``(priority << 31) | slot`` over all slots, and the flips written into
``typeid`` in place. Both kernels read the trigger's flag on the card and
return at once where it is unset, so the graphs' masked form needs no
select. Bitwise the plain pick (``ParticleEvaporator._pick_plain``).

A launch runs on the current stream, with no synchronisation and no host
read. Under :func:`~azplugins_tpu_torch.core.rng.device_clock` the scan
reads its key's timestep word from the clock on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng as _rng
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
        lib.az_pick_scan.argtypes = [p, p, p, i, i, f, f, f, f, u, u, p, i, p, p, p, p]
        lib.az_pick_select.argtypes = [p, i, i, i, p, p, p, p]
        for fn in (lib.az_pick_scan, lib.az_pick_select):
            fn.restype = ctypes.c_int
        lib.az_pick_layout.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
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


# slots -> (regions, keys a region) of the pick's scratch (az_pick_layout)
_layouts: dict[int, tuple[int, int]] = {}


def _layout(n: int) -> tuple[int, int]:
    if n not in _layouts:
        blocks, span = ctypes.c_int(), ctypes.c_int()
        _library().az_pick_layout(n, ctypes.byref(blocks), ctypes.byref(span))
        _layouts[n] = (blocks.value, span.value)
    return _layouts[n]


def evaporator_pick(typeid: torch.Tensor, position: torch.Tensor, tag: torch.Tensor, k: int,
                    solvent: int, evaporated: int, lo: float, hi: float, Lz: float, stream: int,
                    seed, timestep, fire: torch.Tensor | None = None) -> None:
    """Flip, in ``typeid`` (int32 [N] on the card, written in place), the
    candidates ``ParticleEvaporator``'s pick keeps: slots of type
    ``solvent`` whose wrapped z lies in [``lo``, ``hi``) (float32 bounds;
    ``Lz`` the box's float32 length), the ``k`` smallest keys ``(priority
    << 31) | slot`` over all slots, the priority K4's first word of the tag
    under ``(stream, seed, timestep)``. ``fire``: a 0-d bool on the card,
    the kernels returning at once where it is unset; None is fired.
    ``k == 0`` flips nothing and launches nothing."""
    dev = typeid.device
    if dev.type != "cuda":
        raise ValueError(f"the pick kernel needs CUDA tensors, got {dev}")
    n = typeid.numel()
    check_tensor(typeid, "typeid", torch.int32, (n,), dev)
    check_tensor(position, "position", torch.float32, (n, 3), dev)
    check_tensor(tag, "tag", torch.int32, (n,), dev)
    if fire is not None:
        check_tensor(fire, "fire", torch.bool, (), dev)
    if n >= 2**31:
        raise ValueError(f"{n} slots exceed the kernel's int32 index")
    if k < 0:
        raise ValueError(f"k must be at least 0, got {k}")
    if n == 0 or k == 0:
        return
    blocks, span = _layout(n)
    keys = torch.empty(blocks * span, dtype=torch.int64, device=dev)
    counts = torch.empty(blocks, dtype=torch.int32, device=dev)
    k0, k1 = _rng._key_words(stream, seed, timestep)
    flag = None if fire is None else fire.data_ptr()
    _launch("az_pick_scan", dev, typeid.data_ptr(), position.data_ptr(), tag.data_ptr(), n,
            int(solvent), float(lo), float(hi), float(np.float32(1.0 / Lz)),
            float(np.float32(Lz)), k0, k1, *_rng._clock_args(timestep, dev), flag,
            keys.data_ptr(), counts.data_ptr())
    _launch("az_pick_select", dev, typeid.data_ptr(), n, min(int(k), n), int(evaporated), flag,
            keys.data_ptr(), counts.data_ptr())
