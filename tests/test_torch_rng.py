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
from azplugins_tpu_torch.utils import sqrt  # noqa: E402

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


# -- the card's kernels (ops/rng_kernel.py): dispatch and host-side arguments
# The kernels themselves run only on a GPU (tests/test_torch_kernels.py,
# marked cuda); here, on the CPU, the public draws must take the plain
# versions and launch nothing, every other device must raise, and what the
# wrappers form on the host (key words, float32 scalars and constants) must
# be what the plain versions use.
from azplugins_tpu_torch.ops import rng_kernel as RK  # noqa: E402


def test_cpu_draws_take_the_plain_version():
    tags = torch.arange(-1, 300, dtype=torch.int32)
    key = P.jax_fold_in(P.jax_key(11), 3)
    for got, want in [
        (P.particle_bits(210, 42, 7, tags, n_words=3), P._particle_bits_plain(210, 42, 7, tags, 3)),
        ((P.particle_uniform3(202, 42, 7, tags, 0.0, 1.0),),
         (P._particle_uniform3_plain(202, 42, 7, tags, 0.0, 1.0),)),
        (P.jax_normal_axis(key, 33, "cpu", (5, 6)),
         P._jax_normal_axis_plain(key, 33, "cpu", (5, 6))),
    ]:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "cpu" and g.dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert RK.launches == 0 and RK.launches_by_kernel == {}


@pytest.mark.parametrize("draw", ["particle_bits", "particle_uniform3", "jax_normal"])
def test_draws_on_another_device_raise(draw):
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        if draw == "particle_bits":
            P.particle_bits(210, 42, 7, meta, n_words=2)
        elif draw == "particle_uniform3":
            P.particle_uniform3(210, 42, 7, meta)
        else:  # K5: its one-key form
            P.jax_normal_axis((0, 42), 16, "meta")
    # the wrappers take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        if draw == "jax_normal":
            RK.jax_normal_axis((0, 42), 16, "cpu")
        else:
            getattr(RK, draw)(210, 42, 7, torch.zeros(16, dtype=torch.int32))
    assert RK.launches == 0


def test_key_words_are_the_references():
    for stream, seed, t in [(210, 42, 0), (202, 0xFFFF, 2**32 - 1), (203, 7, 123456),
                            (212, 2**31 + 9, 2**31)]:
        k0, k1 = P._key_words(stream, seed, t)
        r0, r1 = R._key_words(stream, seed, t)
        assert (k0, k1) == (int(r0), int(r1))
        # Python ints in [0, 2**32) (ctypes uint32 arguments); the timestep
        # and the seed are read modulo 2**32
        assert all(isinstance(k, int) and 0 <= k < 2**32 for k in (k0, k1))
        assert P._key_words(stream, seed + 2**32, t + 2**32) == (k0, k1)


@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (0.0, 1.0), (-3.5, 0.25), (0.1, 0.7)])
def test_uniform_args_give_the_plain_uniforms(low, high):
    """The kernel's scale and offset, applied as its explicitly rounded
    float32 operations (numpy float32 here), give the plain uniforms and
    the reference's bit for bit."""
    width, low32 = RK.uniform_args(low, high)
    assert width == float(np.float32(high - low)) and low32 == float(np.float32(low))
    bits = np.concatenate([_words(4096, 8), np.array([0, 511, 512, 2**32 - 1], np.uint32)])
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    got = f * np.float32(width) + np.float32(low32)
    want = P.uniform_from_bits(torch.as_tensor(bits.astype(np.int64)), low, high).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    r = np.asarray(R.uniform_from_bits(jnp.asarray(bits), low, high))
    np.testing.assert_array_equal(got.view(np.int32), r.view(np.int32))


def test_normal_args_give_jax_normal():
    """The kernel's constants are the float32 of the plain version's, and
    its arithmetic with them (each operation rounded on its own, as
    csrc/threefry.cu does it; numpy float32 here, whose log1p and sqrt are
    the C library's) is jax.random.normal within the port's 4-ulp bar."""
    width, lo, sqrt2, coeffs = RK.normal_args()
    assert coeffs.dtype == np.float32 and coeffs.shape == (18,)
    assert coeffs.tolist() == [float(np.float32(c)) for c in P._ERFINV_LT5 + P._ERFINV_GE5]
    assert (width, lo, sqrt2) == (float(P._NORMAL_WIDTH), float(P._NORMAL_LO), P._SQRT2_F32)
    import jax

    key = jax.random.fold_in(jax.random.key(11), 5)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    n = 30_000
    x0, x1 = P.threefry2x32(*words, 0, torch.arange(n, dtype=torch.int64))
    bits = (x0 ^ x1).numpy().astype(np.uint32)
    f32 = np.float32
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - f32(1.0)
    x = np.maximum(f * f32(width) + f32(lo), f32(lo))
    w = -np.log1p(-(x * x))
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, coeffs[0], coeffs[9])
    for k in range(1, 9):
        p = np.where(lt, coeffs[k], coeffs[9 + k]) + p * w
    got = f32(sqrt2) * (p * x)
    assert got.dtype == np.float32
    want = np.asarray(jax.random.normal(key, (n,), jnp.float32))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


@pytest.mark.parametrize("n_words", [1, 4, 8])
def test_plain_draws_of_empty_slots_and_no_tags(n_words):
    """Empty slots (tag -1, hashed as 0xFFFFFFFF) and an empty tag vector:
    the plain versions the kernels are held to stay the reference's."""
    for tags in (np.full(9, -1, np.int32), np.zeros(0, np.int32)):
        r = R.particle_bits(203, 42, 25, jnp.asarray(tags), n_words=n_words)
        p = P._particle_bits_plain(203, 42, 25, torch.as_tensor(tags), n_words)
        assert len(p) == n_words
        for pw, rw in zip(p, r):
            assert tuple(pw.shape) == tags.shape
            np.testing.assert_array_equal(pw.numpy(), _u32_as_i64(rw))
        r = np.asarray(R.particle_uniform3(202, 42, 25, jnp.asarray(tags)))
        p = P._particle_uniform3_plain(202, 42, 25, torch.as_tensor(tags)).numpy()
        assert p.shape == r.shape == (tags.size, 3)
        np.testing.assert_array_equal(p.view(np.int32), r.view(np.int32))
    # every empty slot draws the same words: the counter 0xFFFFFFFF
    (w,) = P._particle_bits_plain(203, 42, 25, torch.tensor([-1, 2**31 - 1, -1]), 1)
    assert int(w[0]) == int(w[2]) != int(w[1])


def test_plain_normal_of_no_draws():
    import jax

    key = jax.random.key(3)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    got = P._jax_normal_plain(words, (0, 3), "cpu")
    assert tuple(got.shape) == (0, 3) and got.dtype == torch.float32
    assert np.asarray(jax.random.normal(key, (0, 3), jnp.float32)).shape == (0, 3)


def test_rng_reference_file_is_what_the_reference_draws():
    """tests/torch_rng_reference.npz, which holds the port's draws to the
    reference on a GPU machine without JAX (tests/test_torch_kernels.py),
    is what the JAX package draws now, bit for bit."""
    import torch_rng_reference as REF

    kept, drawn = REF.load(), REF.draw_reference()
    assert sorted(kept) == sorted(drawn)
    for k in kept:
        assert kept[k].dtype == drawn[k].dtype and kept[k].shape == drawn[k].shape
        np.testing.assert_array_equal(kept[k], drawn[k])


# -- K5's axis form: the collision's unit axes and the virtual fill's normals -
COLLISION_ROWS = [(1001, 11, 40), (4352, 5, 120), (9261, 3, 2**31 + 7)]


def _collision_keys(seed, t):
    """The reference's (shift, axis, virtual-fill) keys of the collision at
    t: fold_in(fold_in(key(seed), stream), t), split in three."""
    import jax

    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), jnp.uint32(0x6D70)),
                             jnp.uint32(t))
    keys = jax.random.split(key, 3)
    words = [tuple(int(w) for w in np.asarray(jax.random.key_data(k))) for k in keys]
    return keys, words


@pytest.mark.parametrize("rows,seed,t", COLLISION_ROWS)
def test_axis_form_is_the_references_axes_and_fill(rows, seed, t):
    """The axis form's plain version (K5's, on the card) is the reference's
    unit axes, jax.random.normal over its norm clamped at 1e-12
    (azplugins_tpu/mpcd.py:323-326), within the axes' bar of
    tests/test_torch_mpcd.py (1e-6: the normals' 4 ulp through a norm
    summed in another order), and its second key's normals the virtual
    fill's (:314) within the port's 4-ulp bar for normals."""
    import jax

    keys, words = _collision_keys(seed, t)
    axis, virt = P._jax_normal_axis_plain(words[1], rows, "cpu", words[2])
    raw = jax.random.normal(keys[1], (rows, 3), jnp.float32)
    want = np.asarray(raw / jnp.maximum(jnp.linalg.norm(raw, axis=1, keepdims=True), 1e-12))
    want_virt = np.asarray(jax.random.normal(keys[2], (rows, 3), jnp.float32))
    assert axis.dtype == virt.dtype == torch.float32
    assert tuple(axis.shape) == tuple(virt.shape) == (rows, 3)
    np.testing.assert_allclose(axis.numpy(), want, rtol=0, atol=1e-6)
    ulps = np.abs(virt.numpy().view(np.int32).astype(np.int64)
                  - want_virt.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4
    norms = np.linalg.norm(axis.numpy().astype(np.float64), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,seed,t", COLLISION_ROWS)
def test_two_key_form_is_two_single_draws(rows, seed, t):
    """The two-key form is the one-key form's axes and a single plain draw
    under the second key, bit for bit; the axes are the plain draw
    normalised by the port's operations (its square root `utils.sqrt`); on
    the CPU the public form takes the plain version and launches nothing."""
    _, words = _collision_keys(seed, t)
    axis, virt = P._jax_normal_axis_plain(words[1], rows, "cpu", words[2])
    one, none = P._jax_normal_axis_plain(words[1], rows, "cpu")
    assert none is None and torch.equal(axis.view(torch.int32), one.view(torch.int32))
    single = P._jax_normal_plain(words[2], (rows, 3), "cpu")
    assert torch.equal(virt.view(torch.int32), single.view(torch.int32))
    raw = P._jax_normal_plain(words[1], (rows, 3), "cpu")
    own = raw / torch.clamp_min(sqrt(torch.sum(raw * raw, dim=1, keepdim=True)), 1e-12)
    assert torch.equal(axis.view(torch.int32), own.view(torch.int32))
    before = RK.launches
    pub_axis, pub_virt = P.jax_normal_axis(words[1], rows, "cpu", words[2])
    assert torch.equal(pub_axis, axis) and torch.equal(pub_virt, virt) and RK.launches == before


def test_axis_form_on_another_device_raises():
    with pytest.raises(ValueError, match="meta"):
        P.jax_normal_axis((0, 42), 16, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        RK.jax_normal_axis((0, 42), 16, "cpu", (1, 2))
    assert RK.launches == 0
