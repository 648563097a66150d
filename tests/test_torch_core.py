"""Core substrate of the port against the JAX reference: box, state, thermalize.

Box geometry and state construction are float32 operations in the same
order as the reference, so they match bitwise. Thermalization draws the
same Threefry words (bitwise), but its Box-Muller transform goes through
log and cos, whose float32 implementations differ by an ulp between XLA
and PyTorch, and a momentum sum taken in another order: velocities match
within a few float32 ulps (1e-6 relative to the largest).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.core import rng as Rrng  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.core import rng as Prng  # noqa: E402

torch.set_num_threads(1)

BOXES = [
    (9.0, 9.0, 9.0, 0.0, 0.0, 0.0),
    (9.0, 7.5, 11.0, 0.3, -0.2, 0.1),
    (42.17, 42.17, 42.17, 0.0, 0.0, 0.0),
    (6.0, 8.0, 5.0, -0.45, 0.35, 0.5),
]


def _snapshot(box, N=600, seed=0, spread=3.0, n_types=2):
    rng = np.random.default_rng(seed)
    snap = ref.Snapshot(N=N)
    snap.configuration.box = list(box)
    snap.particles.types = ["A", "B", "C"][:n_types]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * spread * max(box[:3])
    snap.particles.velocity[:] = rng.normal(0, 1, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, n_types, N)
    snap.particles.image[:] = rng.integers(-3, 4, (N, 3))
    snap.particles.mass[:] = rng.uniform(0.5, 2.0, N)
    snap.particles.charge[:] = rng.normal(0, 1, N)
    return snap


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("box", BOXES)
def test_box_wrap_bitwise(box):
    snap = _snapshot(box)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    ps, _, _ = port.core.state_from_snapshot(snap, "cpu")
    rw, ri = rs.box.wrap(rs.position, rs.image)
    pw, pi = ps.box.wrap(ps.position, ps.image)
    np.testing.assert_array_equal(_bits(pw.numpy()), _bits(rw))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    rw0, ri0 = rs.box.wrap(rs.position)
    pw0, pi0 = ps.box.wrap(ps.position)
    np.testing.assert_array_equal(_bits(pw0.numpy()), _bits(rw0))
    np.testing.assert_array_equal(pi0.numpy(), np.asarray(ri0))
    # fractional coordinates
    np.testing.assert_array_equal(
        _bits(ps.box.fraction(ps.position).numpy()), _bits(rs.box.fraction(rs.position))
    )


@pytest.mark.parametrize("box", BOXES)
def test_min_image_bitwise(box):
    rng = np.random.default_rng(1)
    d = rng.normal(0, max(box[:3]), (2000, 3)).astype(np.float32)
    rbox = ref.Box.from_lengths(*box)
    pbox = port.Box.from_lengths(*box)
    r = rbox.min_image_components(*[jnp.asarray(d[:, k]) for k in range(3)])
    p = pbox.min_image_components(*[torch.as_tensor(d[:, k]) for k in range(3)])
    for a, b in zip(p, r):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("box", BOXES)
def test_box_members_bitwise(box):
    """lo, hi, make_coordinates and min_image on [..., 3], ties included (a
    separation of exactly half an edge rounds half to even in both)."""
    rng = np.random.default_rng(2)
    rbox, pbox = ref.Box.from_lengths(*box), port.Box.from_lengths(*box)
    for name in ("lo", "hi"):
        got = getattr(pbox, name)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(np.asarray(getattr(rbox, name))))
    f = rng.random((4, 50, 3)).astype(np.float32)
    f[0, :3] = [[0.0, 0.5, 1.0], [0.25, 0.75, 0.5], [1.0, 0.0, 0.0]]
    np.testing.assert_array_equal(_bits(pbox.make_coordinates(torch.as_tensor(f)).numpy()),
                                  _bits(rbox.make_coordinates(jnp.asarray(f))))
    d = rng.normal(0, max(box[:3]), (4, 50, 3)).astype(np.float32)
    d[0, :4] = np.asarray([[0.5, 0.0, 0.0], [0.0, -0.5, 0.0], [0.0, 0.0, 1.5],
                           [-1.5, 2.5, -0.5]], np.float32) * np.asarray(box[:3], np.float32)
    np.testing.assert_array_equal(_bits(pbox.min_image(torch.as_tensor(d)).numpy()),
                                  _bits(rbox.min_image(jnp.asarray(d))))
    if box[:3] == (box[0],) * 3 and not any(box[3:]):
        cube = port.Box.cube(box[0])
        np.testing.assert_array_equal(cube.L, np.asarray(ref.Box.cube(box[0]).L))
        np.testing.assert_array_equal(cube.tilt, np.zeros(3, np.float32))


@pytest.mark.parametrize("box", BOXES)
def test_nearest_plane_distance(box):
    r = np.asarray(ref.Box.from_lengths(*box).nearest_plane_distance())
    p = port.Box.from_lengths(*box).nearest_plane_distance()
    assert p.dtype == np.float32
    np.testing.assert_allclose(p, r, rtol=1e-6)
    np.testing.assert_allclose(port.Box.from_lengths(*box).matrix(),
                               np.asarray(ref.Box.from_lengths(*box).matrix()), rtol=0)


def test_state_from_snapshot_matches_reference():
    snap = _snapshot(BOXES[1])
    snap.bonds.resize(3)
    snap.bonds.types = ["b"]
    snap.bonds.group[:] = [[0, 1], [1, 2], [5, 9]]
    rs, rtypes, rbtypes = ref.core.state_from_snapshot(snap)
    ps, ptypes, pbtypes = port.core.state_from_snapshot(snap, "cpu")
    assert (ptypes, pbtypes) == (rtypes, rbtypes)
    a, b = interop.state_to_numpy(rs), interop.state_to_numpy(ps)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype, k
        np.testing.assert_array_equal(_bits(b[k]), _bits(a[k]), err_msg=k)
    # and back through the interop path
    again = interop.state_to_numpy(interop.state_from_reference(rs, "cpu"))
    for k in a:
        np.testing.assert_array_equal(_bits(again[k]), _bits(a[k]), err_msg=k)


def test_state_to_snapshot_round_trip():
    snap = _snapshot(BOXES[3])
    ps, types, btypes = port.core.state_from_snapshot(snap, "cpu")
    rs, _, _ = ref.core.state_from_snapshot(snap)
    p = port.core.state_to_snapshot(ps, types, btypes)
    r = ref.core.state_to_snapshot(rs, types, btypes)
    for name in ("position", "velocity", "typeid", "image", "mass", "charge", "orientation"):
        np.testing.assert_array_equal(getattr(p.particles, name), getattr(r.particles, name))
    np.testing.assert_array_equal(p.configuration.box, r.configuration.box)


@pytest.mark.parametrize("kT,seed,masked", [(1.0, 42, False), (1.3, 7, True)])
def test_thermalize_momenta(kT, seed, masked):
    snap = _snapshot(BOXES[0], N=1000)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    ps, _, _ = port.core.state_from_snapshot(snap, "cpu")
    mask = np.random.default_rng(3).random(1000) < 0.6 if masked else None
    # the noise words: bitwise
    rw = Rrng.particle_bits(Rrng.Stream.THERMALIZE, seed, 0, rs.tag, n_words=8)
    pw = Prng.particle_bits(Prng.Stream.THERMALIZE, seed, 0, ps.tag, n_words=8)
    for a, b in zip(pw, rw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    r = ref.core.thermalize_momenta(rs, kT, seed, None if mask is None else jnp.asarray(mask))
    p = port.core.thermalize_momenta(ps, kT, seed, None if mask is None else torch.as_tensor(mask))
    rv, pv = np.asarray(r.velocity), p.velocity.numpy()
    np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-6 * np.abs(rv).max())
    if mask is not None:
        np.testing.assert_array_equal(pv[~mask], snap.particles.velocity[~mask].astype(np.float32))
    # the group's momentum is removed
    m = snap.particles.mass[:, None]
    sel = np.ones(1000, bool) if mask is None else mask
    assert np.abs((pv * m)[sel].sum(axis=0)).max() < 1e-3
