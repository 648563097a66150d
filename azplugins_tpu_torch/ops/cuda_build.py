"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Libraries go to ``azplugins_tpu_torch/_build/`` (ignored by
git), named by a hash of the source, every shared header beside it
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as is. :func:`load_libraries` builds several
sources at once, one ``nvcc`` each. Inside :func:`sources`, the kernels are
built and loaded from another directory (an edited copy of ``csrc/``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = [
    "CSRC", "BUILD_DIR", "load_library", "load_libraries", "sources", "source_digest", "build_info",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the directory load_library builds from when none is given (see sources)
_csrc = CSRC
# source path -> its loaded library
_libraries: dict[Path, ctypes.CDLL] = {}
# source path -> {"seconds": build time (0.0 when loaded from _build/),
# "log": nvcc's output, including ptxas's register and spill report}
build_info: dict[Path, dict] = {}


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


def source_digest(source: str, csrc: Path = CSRC) -> str:
    """Hash of ``csrc/<source>``, every ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def sources(csrc: Path):
    """Within the block, :func:`load_library` (and so every kernel wrapper)
    builds and loads the kernels from ``csrc`` instead of ``csrc/``: a copy
    with one edit, say, to time what the edit is worth."""
    global _csrc
    previous, _csrc = _csrc, Path(csrc).resolve()
    try:
        yield
    finally:
        _csrc = previous


def load_library(source: str, csrc: Path | None = None) -> ctypes.CDLL:
    """Compile ``<csrc>/<source>`` if needed and return the loaded library.

    ``csrc`` defaults to ``csrc/``, or to the directory of the enclosing
    :func:`sources` block.
    """
    csrc = _csrc if csrc is None else Path(csrc).resolve()
    src = csrc / source
    lib = _libraries.get(src)
    if lib is not None:
        return lib
    out = BUILD_DIR / f"{src.stem}-{source_digest(source, csrc)}.so"
    if out.exists():
        build_info[src] = {"seconds": 0.0, "log": ""}
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        build_info[src] = {
            "seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip(),
        }
    lib = ctypes.CDLL(str(out))
    _libraries[src] = lib
    return lib


def load_libraries(*sources: str) -> list[ctypes.CDLL]:
    """:func:`load_library` for several sources, their ``nvcc`` runs at once."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(load_library, sources))
