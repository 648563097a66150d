"""Threefry-2x32 of the port against the JAX reference: bitwise.

Keys, counters and timesteps are drawn with numpy from a seed and handed
to both packages; every output word and uniform must be bit-identical.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from azplugins_tpu.core import rng as R  # noqa: E402
from azplugins_tpu_torch.core import rng as P  # noqa: E402

torch.set_num_threads(1)

ROUNDS = [P.FAST_ROUNDS, 20]


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _u32_as_i64(x):
    return np.asarray(x).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("rounds", ROUNDS)
def test_threefry2x32_bitwise(rounds):
    c0, c1 = _words(4096, 1), _words(4096, 2)
    for k0, k1 in [(0, 0), (0xFFFFFFFF, 1), (int(_words(1, 3)[0]), int(_words(1, 4)[0]))]:
        r0, r1 = R.threefry2x32(k0, k1, jnp.asarray(c0), jnp.asarray(c1), rounds=rounds)
        p0, p1 = P.threefry2x32(
            k0, k1, torch.as_tensor(c0.astype(np.int64)), torch.as_tensor(c1.astype(np.int64)),
            rounds=rounds,
        )
        np.testing.assert_array_equal(p0.numpy(), _u32_as_i64(r0))
        np.testing.assert_array_equal(p1.numpy(), _u32_as_i64(r1))


@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (0.0, 1.0), (-3.5, 0.25)])
def test_uniform_from_bits_bitwise(low, high):
    bits = np.concatenate([_words(4096, 5), np.array([0, 1, 511, 512, 2**32 - 1], np.uint32)])
    r = R.uniform_from_bits(jnp.asarray(bits), low, high)
    p = P.uniform_from_bits(torch.as_tensor(bits.astype(np.int64)), low, high)
    assert p.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy().view(np.int32), np.asarray(r).view(np.int32))


@pytest.mark.parametrize("rounds", ROUNDS)
def test_pair_uniform_bitwise(rounds):
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2**31 - 1, 2048).astype(np.int32)
    b = rng.integers(0, 2**31 - 1, 2048).astype(np.int32)
    for seed, t in [(0, 0), (42, 17), (0xFFFF, 2**31 + 5)]:
        r = R.pair_uniform(200, seed, t, jnp.asarray(a), jnp.asarray(b), rounds=rounds)
        p = P.pair_uniform(200, seed, t, torch.as_tensor(a), torch.as_tensor(b), rounds=rounds)
        np.testing.assert_array_equal(p.numpy().view(np.int32), np.asarray(r).view(np.int32))
        # symmetric in the two tags
        q = P.pair_uniform(200, seed, t, torch.as_tensor(b), torch.as_tensor(a), rounds=rounds)
        np.testing.assert_array_equal(q.numpy(), p.numpy())


@pytest.mark.parametrize("n_words", [1, 2, 3, 4, 8])
def test_particle_bits_bitwise(n_words):
    tags = np.concatenate([np.arange(-2, 1000, dtype=np.int32), np.array([2**31 - 1], np.int32)])
    for stream, seed, t in [(210, 42, 0), (212, 7, 123456), (202, 0xFFFF, 2**32 - 1)]:
        r = R.particle_bits(stream, seed, t, jnp.asarray(tags), n_words=n_words)
        p = P.particle_bits(stream, seed, t, torch.as_tensor(tags), n_words=n_words)
        assert len(p) == len(r) == n_words
        for pw, rw in zip(p, r):
            np.testing.assert_array_equal(pw.numpy(), _u32_as_i64(rw))


def test_particle_uniform3_bitwise():
    tags = np.arange(-1, 5000, dtype=np.int32)
    for stream, t in [(210, 0), (202, 99), (213, 10**6)]:
        r = R.particle_uniform3(stream, 42, t, jnp.asarray(tags))
        p = P.particle_uniform3(stream, 42, t, torch.as_tensor(tags))
        assert tuple(p.shape) == (tags.size, 3)
        np.testing.assert_array_equal(p.numpy().view(np.int32), np.asarray(r).view(np.int32))
