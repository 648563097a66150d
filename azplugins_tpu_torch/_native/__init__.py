"""Native (C++) host components, built on demand with the system g++.

A copy of ``azplugins_tpu/_native/__init__.py``: the trajectory and
checkpoint engine (``aztraj.cpp``, the same source and the same bytes on
disk as the reference's) is bound through a plain C ABI with ctypes. It is
host IO code, not a device kernel. The library is built at first use into
``azplugins_tpu_torch/_build/`` (ignored by git, beside the CUDA kernels of
``ops/cuda_build.py``), named by a hash of the source and the compiler
command, as the kernels are named: an edited source is rebuilt, an
unchanged one loaded as is. If no compiler is available the callers fall
back to a pure-Python implementation of the same format.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

from ..ops.cuda_build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


def build_library(name: str) -> str | None:
    """Compile ``<name>.cpp`` into a cached shared library; None on failure."""
    src = os.path.join(_HERE, f"{name}.cpp")
    cxx = os.environ.get("CXX", "g++")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((cxx, *_FLAGS)).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build beside the target and rename into place, so processes building
    # at once never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *_FLAGS, src, "-o", tmp], capture_output=True, timeout=120)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
