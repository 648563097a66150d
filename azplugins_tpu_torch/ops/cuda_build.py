"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Libraries go to ``azplugins_tpu_torch/_build/`` (ignored by
git), named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "load_library", "build_info"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}
# source name -> {"seconds": build time (0.0 when loaded from _build/),
# "log": nvcc's output, including ptxas's register and spill report}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc was not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source on first use"
    )


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed and return the loaded library."""
    lib = _libraries.get(source)
    if lib is not None:
        return lib
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        build_info[source] = {"seconds": 0.0, "log": ""}
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        build_info[source] = {
            "seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip(),
        }
    lib = ctypes.CDLL(str(out))
    _libraries[source] = lib
    return lib
