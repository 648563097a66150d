"""The tracer's device phase marks: the CUDA kernel's wrapper.

``csrc/phase_mark.cu`` holds ``az_phase_mark<id>``, an empty kernel a phase
id (``trace.py``: the tracer's ``mark_table`` names each). A launch runs on
the current stream, with no synchronisation and no host read, so a CUDA
graph captures it with the segment's work.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load_library
from .pair_kernel import launch_error

__all__ = ["phase_mark"]

_SOURCE = "phase_mark.cu"


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    if lib.az_phase_mark_launch.argtypes is None:
        lib.az_phase_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.az_phase_mark_launch.restype = ctypes.c_int
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def phase_mark(phase_id: int, dev: torch.device) -> None:
    """Launch the mark ``az_phase_mark<phase_id>`` on ``dev``'s current stream."""
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.az_phase_mark_launch(int(phase_id), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "az_phase_mark_launch", err)
