"""The JAX package's random draws at the port's path shapes, kept in a file
so that the port's random-draw kernels can be held against the reference
on a GPU machine that has no JAX (tests/test_torch_kernels.py):

    JAX_PLATFORMS=cpu python tests/torch_rng_reference.py

rewrites ``torch_rng_reference.npz`` beside this file from
``azplugins_tpu.core.rng`` and ``jax.random.normal``.
``tests/test_torch_rng.py`` checks that the file is what they draw now.

The per-particle words and uniforms are bitwise contracts, so the file keeps
a SHA-256 of each case's output. The normals are held within 4 ulp, so it
keeps their values at ``normal_sample(n)``: every counter of a draw up to
SAMPLE values, else the first and last SAMPLE // 4 and SAMPLE // 2 spread
between. Each normal depends only on its counter and the key, so a sample
holds the same values at any shape.

Only ``draw_reference()`` imports JAX; the rest needs numpy alone.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

FILE = Path(__file__).with_suffix(".npz")

LANGEVIN, LANGEVIN_ANGULAR, PARTICLE_EVAPORATOR, THERMALIZE = 210, 213, 203, 212
# the headline's slots and particles
TAG_COUNTS = (82_944, 64_000)
KEYS = ((12345, 777), (7, 2**31 + 5))  # (seed, timestep)
# (stream, seed, timestep, tags, n_words): Langevin's and Brownian's
# uniforms (4 words), the evaporator's pick (1), thermalize (8)
BIT_CASES = [(stream, seed, t, n, n_words)
             for n in TAG_COUNTS for seed, t in KEYS
             for stream, n_words in ((PARTICLE_EVAPORATOR, 1), (LANGEVIN, 4), (THERMALIZE, 8))]
# (stream, seed, timestep, tags, low, high)
UNIFORM_CASES = [(stream, seed, t, n, low, high)
                 for n in TAG_COUNTS for seed, t in KEYS
                 for stream, (low, high) in ((LANGEVIN, (-1.0, 1.0)),
                                             (LANGEVIN_ANGULAR, (0.0, 1.0)),
                                             (LANGEVIN, (-3.5, 0.25)))]
# (name, key seed, fold-in, shape): the MPCD paths' collision grids
# (chip_smoke.py's NORMAL_SHAPES) and a count that is not a multiple of the
# kernel's block, under jax.random.fold_in(jax.random.key(seed), fold)
NORMAL_CASES = [("colloid", 11, 40, (32**3, 3)),
                ("poiseuille", 4, 1005, (16 * 16 * 17, 3)),
                ("srd", 42, 7, (64**3, 3)),
                ("odd", 3, 2**31 - 1, (1001, 3))]
SAMPLE = 16_384


def tags(n: int) -> np.ndarray:
    """A slot array's tags: random ones, a fifth empty (-1), and the first
    four -1, 0 and the two largest int32."""
    g = np.random.default_rng(n)
    t = g.integers(0, 2**31 - 1, n).astype(np.int32)
    t[g.random(n) < 0.2] = -1
    t[:4] = [-1, 0, 2**31 - 1, 2**31 - 2]
    return t


def normal_sample(n: int) -> np.ndarray:
    """The flat indices of a draw of n normals that the file keeps."""
    if n <= SAMPLE:
        return np.arange(n)
    q = SAMPLE // 4
    mid = np.linspace(q, n - q - 1, SAMPLE // 2).astype(np.int64)
    return np.concatenate([np.arange(q), mid, np.arange(n - q, n)])


def digest(arrays) -> str:
    """SHA-256 of the arrays' bytes in order: words as little-endian
    uint32 (whatever integer dtype holds them), floats as float32."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a)
        a = a.astype("<f4") if a.dtype.kind == "f" else a.astype(np.int64).astype("<u4")
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def draw_reference() -> dict:
    """Every case, drawn by the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    from azplugins_tpu.core import rng as R

    assert jax.config.jax_threefry_partitionable, "the port draws jax.random's partitionable stream"
    out = {
        "bits": np.array([digest(R.particle_bits(s, seed, t, jnp.asarray(tags(n)), n_words))
                          for s, seed, t, n, n_words in BIT_CASES]),
        "uniform": np.array([digest([R.particle_uniform3(s, seed, t, jnp.asarray(tags(n)), lo, hi)])
                             for s, seed, t, n, lo, hi in UNIFORM_CASES]),
    }
    for name, seed, fold, shape in NORMAL_CASES:
        key = jax.random.fold_in(jax.random.key(seed), fold)
        x = np.asarray(jax.random.normal(key, shape, jnp.float32)).reshape(-1)
        out[f"normal_{name}"] = x[normal_sample(x.size)]
    return out


def load() -> dict:
    with np.load(FILE) as f:
        return {k: f[k] for k in f.files}


def write() -> None:
    np.savez(FILE, **draw_reference())


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo's packages
    write()
    print(f"wrote {FILE}")
