"""Velocity computes and binning of the port against the JAX reference.

``bin_particles``, the cylindrical coordinates and both velocity fields,
with and without the MPCD stream, within 1e-5 of the largest value (a bin
sum adds float32 terms in another order); ``VelocityCompute`` within 1e-6.
The compact shapes and bin coordinates are the reference's exactly. Every
port simulation here runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.ops import binning as RB  # noqa: E402
from azplugins_tpu_torch.ops import binning as PB  # noqa: E402

torch.set_num_threads(1)

BAR_FIELD = 1e-5
BAR_COM = 1e-6
NUM_BINS = [
    ((4, 3, 2), (4, 3, 2, 3)),
    ((4, 3, 0), (4, 3, 3)),
    ((4, 0, 2), (4, 2, 3)),
    ((0, 3, 2), (3, 2, 3)),
    ((4, 0, 0), (4, 3)),
    ((0, 3, 0), (3, 3)),
    ((0, 0, 2), (2, 3)),
]


def _sim(az, positions, velocities, masses=None, typeids=None, types=("A",), L=20.0,
         mpcd=None):
    """A simulation of the given particles, with an optional MPCD stream
    ``mpcd = (position, velocity, mass)``."""
    snap = az.Snapshot(N=len(positions), mpcd_N=0 if mpcd is None else len(mpcd[0]))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = list(types)
    snap.particles.position[:] = positions
    snap.particles.velocity[:] = velocities
    if masses is not None:
        snap.particles.mass[:] = masses
    if typeids is not None:
        snap.particles.typeid[:] = typeids
    if mpcd is not None:
        snap.mpcd.position[:] = mpcd[0]
        snap.mpcd.velocity[:] = mpcd[1]
        snap.mpcd.mass = mpcd[2]
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=1, **kw)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(dt=0.0, methods=[az.md.methods.ConstantVolume()])
    return sim


def _random_system(seed, n=300, n_mpcd=500, L=20.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) - 0.5) * L
    pos[:4] = [[0.0, 0.0, 1.0], [0.0, 2.0, -3.0], [-1.0, 0.0, 0.0], [2.0, -2.0, 5.0]]
    vel = rng.normal(size=(n, 3))
    mass = rng.random(n) + 0.5
    typeid = rng.integers(0, 2, n)
    mpcd = ((rng.random((n_mpcd, 3)) - 0.5) * L, rng.normal(size=(n_mpcd, 3)), 0.7)
    return pos, vel, mass, typeid, mpcd


def _both(seed, with_mpcd):
    pos, vel, mass, typeid, mpcd = _random_system(seed)
    kw = dict(masses=mass, typeids=typeid, types=("A", "B"), mpcd=mpcd if with_mpcd else None)
    return _sim(ref, pos, vel, **kw), _sim(port, pos, vel, **kw)


def _close(got, want, bar):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=bar * max(np.abs(want).max(), 1e-30))


# -- against the reference ---------------------------------------------------
@pytest.mark.parametrize("kind", ["cartesian", "collapsed", "cylindrical"])
def test_bin_particles_matches_reference(kind):
    rng = np.random.default_rng({"cartesian": 1, "collapsed": 2, "cylindrical": 3}[kind])
    n = 2000
    coords = (rng.random((n, 3)) - 0.5) * 24.0  # some outside the bounds
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (rng.random(n) + 0.5).astype(np.float32)
    select = rng.random(n) < 0.8
    bins, lo, hi = (5, 4, 3), (-10.0, -10.0, -10.0), (10.0, 10.0, 10.0)
    if kind == "collapsed":
        bins = (6, 0, 2)
    if kind == "cylindrical":
        bins, lo, hi = (4, 6, 3), (0.0, 0.0, -10.0), (12.0, 2 * np.pi, 10.0)
        rc, rv = RB.cylindrical_coords(jnp.asarray(coords, jnp.float32), jnp.asarray(vel))
        pc, pv = PB.cylindrical_coords(torch.as_tensor(coords, dtype=torch.float32),
                                       torch.as_tensor(vel))
        r_in = (np.asarray(rc), np.asarray(rv))
        p_in = (pc, pv)
    else:
        c32 = coords.astype(np.float32)
        r_in = (c32, vel)
        p_in = (torch.as_tensor(c32), torch.as_tensor(vel))
    rm, rp = RB.bin_particles(jnp.asarray(r_in[0]), jnp.asarray(r_in[1]), jnp.asarray(mass),
                              jnp.asarray(select), bins, lo, hi)
    pm, pp = PB.bin_particles(p_in[0], p_in[1], torch.as_tensor(mass), torch.as_tensor(select),
                              bins, lo, hi)
    _close(pm, rm, BAR_FIELD)
    _close(pp, rp, BAR_FIELD)
    assert float(pm.sum()) > 0


@pytest.mark.parametrize("kind", ["cartesian", "cylindrical"])
def test_bins_are_the_ordered_cell_sums(kind):
    """On the CPU the bins are bitwise the MPCD cell sums' plain ordered
    form (``mpcd._cell_sums_plain`` over ``mpcd._payload``: each bin's
    particles added in ascending row order from +0.0, the dump id left
    out), whose mass and momentum columns K10 computes on the card."""
    from azplugins_tpu_torch import mpcd as M

    rng = np.random.default_rng(5)
    n = 3000
    coords = torch.as_tensor(((rng.random((n, 3)) - 0.5) * 24.0).astype(np.float32))
    vel = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    mass = torch.as_tensor((rng.random(n) + 0.5).astype(np.float32))
    select = torch.as_tensor(rng.random(n) < 0.8)
    bins, lo, hi = (5, 4, 3), (-10.0, -10.0, -10.0), (10.0, 10.0, 10.0)
    if kind == "cylindrical":
        coords, vel = PB.cylindrical_coords(coords, vel)
        bins, lo, hi = (4, 6, 3), (0.0, 0.0, -10.0), (12.0, 2 * np.pi, 10.0)
    idx, total = PB.bin_ids(coords, select, bins, lo, hi)
    assert total == int(np.prod(bins)) and int((idx == total).sum()) > 0
    want = M._cell_sums_plain(idx, M._payload(vel, mass), total)[:, 1:5]
    got_m, got_p = PB.bin_particles(coords, vel, mass, select, bins, lo, hi)
    assert torch.equal(got_m.view(torch.int32), want[:, 0].contiguous().view(torch.int32))
    assert torch.equal(got_p.view(torch.int32), want[:, 1:].contiguous().view(torch.int32))


def test_cylindrical_coords_match_reference():
    """theta wraps to [0, 2 pi) and r = 0 takes the x basis, as in the
    reference."""
    rng = np.random.default_rng(4)
    pos = (rng.random((500, 3)) - 0.5) * 10.0
    pos[0] = [0.0, 0.0, 2.0]  # r = 0
    pos[1] = [-3.0, -1e-7, 0.0]  # theta just below zero: wraps to ~2 pi
    pos = pos.astype(np.float32)
    vel = rng.normal(size=(500, 3)).astype(np.float32)
    rc, rv = RB.cylindrical_coords(jnp.asarray(pos), jnp.asarray(vel))
    pc, pv = PB.cylindrical_coords(torch.as_tensor(pos), torch.as_tensor(vel))
    _close(pc.numpy(), rc, BAR_FIELD)
    _close(pv.numpy(), rv, BAR_FIELD)
    theta = pc[:, 1].numpy()
    assert (theta >= 0).all() and (theta < 2 * np.pi + 1e-6).all()
    np.testing.assert_array_equal(pv[0].numpy(), vel[0])  # the x basis at r = 0


@pytest.mark.parametrize("case", ["all", "type", "mpcd", "mpcd only"])
def test_velocity_compute_matches_reference(case):
    sims = _both(5, with_mpcd=case.startswith("mpcd"))
    out = []
    for az, sim in zip((ref, port), sims):
        filt = {"all": az.filter.All(), "type": az.filter.Type(["B"]), "mpcd": az.filter.All(),
                "mpcd only": None}[case]
        vc = az.compute.VelocityCompute(filter=filt,
                                        include_mpcd_particles=case.startswith("mpcd"))
        sim.operations.computes.append(vc)
        sim.run(0)
        out.append(vc.velocity)
    assert isinstance(out[1], np.ndarray) and out[1].shape == (3,)
    _close(out[1], out[0], BAR_COM)


@pytest.mark.parametrize("with_mpcd", [False, True], ids=["md", "md+mpcd"])
@pytest.mark.parametrize("kind", ["Cartesian", "Cylindrical"])
def test_velocity_field_matches_reference(kind, with_mpcd):
    sims = _both(6, with_mpcd)
    if kind == "Cartesian":
        bins, lo, hi = (4, 0, 5), (-10.0, 0.0, -10.0), (10.0, 0.0, 10.0)
    else:
        bins, lo, hi = (5, 4, 2), (0.0, 0.0, -10.0), (10.0, 2 * np.pi, 10.0)
    out = []
    for az, sim in zip((ref, port), sims):
        field = getattr(az.compute, f"{kind}VelocityFieldCompute")(
            num_bins=bins, lower_bounds=lo, upper_bounds=hi, filter=az.filter.Type(["A"]),
            include_mpcd_particles=with_mpcd)
        sim.operations.computes.append(field)
        sim.run(0)
        out.append(field.velocities)
    _close(out[1], out[0], BAR_FIELD)


@pytest.mark.parametrize("num_bins,expected_shape", NUM_BINS)
def test_field_shape_and_coordinates_match_reference(num_bins, expected_shape):
    kw = dict(num_bins=num_bins, lower_bounds=(-5, -4, -3), upper_bounds=(5, 4, 3))
    want = ref.compute.CartesianVelocityFieldCompute(**kw).coordinates
    field = port.compute.CartesianVelocityFieldCompute(filter=port.filter.All(), **kw)
    np.testing.assert_array_equal(field.coordinates, want)
    sim = _sim(port, [[0, 0, 0]], [[1, 0, 0]])
    sim.operations.computes.append(field)
    sim.run(0)
    assert field.velocities.shape == expected_shape


# -- the reference's own cases, on the port ----------------------------------
def test_velocity_compute_com():
    sim = _sim(port, [[0, 0, 0], [1, 0, 0]], [[2.0, 0, 0], [0, 0, 4.0]], masses=[1.0, 3.0])
    vc = port.compute.VelocityCompute(filter=port.filter.All())
    sim.operations.computes.append(vc)
    sim.run(0)
    np.testing.assert_allclose(vc.velocity, [0.5, 0.0, 3.0], atol=1e-6)


def test_cartesian_field_assignment_and_average():
    # two particles in one bin (mass-weighted), one in another, one outside
    sim = _sim(port, [[-2.0, 0, 0], [-2.2, 0, 0], [2.0, 0, 0], [7.0, 0, 0]],
               [[1, 0, 0], [4, 0, 0], [-2, 0, 0], [9, 9, 9]], masses=[1.0, 3.0, 2.0, 1.0])
    field = port.compute.CartesianVelocityFieldCompute(
        num_bins=(2, 0, 0), lower_bounds=(-5, 0, 0), upper_bounds=(5, 0, 0),
        filter=port.filter.All())
    sim.operations.computes.append(field)
    sim.run(0)
    v = field.velocities
    np.testing.assert_allclose(v[0], [3.25, 0, 0], atol=1e-6)
    np.testing.assert_allclose(v[1], [-2.0, 0, 0], atol=1e-6)


def test_whole_box_bin_equals_com_velocity():
    rng = np.random.default_rng(3)
    sim = _sim(port, (rng.random((20, 3)) - 0.5) * 18, rng.normal(size=(20, 3)),
               masses=rng.random(20) + 0.5)
    field = port.compute.CartesianVelocityFieldCompute(
        num_bins=(1, 1, 1), lower_bounds=(-10, -10, -10), upper_bounds=(10, 10, 10),
        filter=port.filter.All())
    vc = port.compute.VelocityCompute(filter=port.filter.All())
    sim.operations.computes.extend([field, vc])
    sim.run(0)
    np.testing.assert_allclose(field.velocities.reshape(3), vc.velocity, rtol=1e-5, atol=1e-6)


def test_cylindrical_field_basis_rotation():
    # a particle at (0, 3, 1): theta = pi/2, so v_r = vy and v_theta = -vx
    sim = _sim(port, [[0.0, 3.0, 1.0]], [[2.0, 5.0, -1.0]])
    field = port.compute.CylindricalVelocityFieldCompute(
        num_bins=(2, 4, 2), lower_bounds=(0, 0, -2), upper_bounds=(4, 2 * np.pi, 2),
        filter=port.filter.All())
    sim.operations.computes.append(field)
    sim.run(0)
    v = field.velocities
    assert v.shape == (2, 4, 2, 3)
    np.testing.assert_allclose(v[1, 1, 1], [5.0, -2.0, -1.0], atol=1e-5)
    np.testing.assert_allclose(np.abs(v).sum(), 8.0, atol=1e-5)


def test_logging_contract():
    from azplugins_tpu_torch.logging import LoggerCategories, logging_check

    logging_check(port.compute.VelocityCompute,
                  {"velocity": {"category": LoggerCategories.sequence, "default": True}})
    for cls in (port.compute.CartesianVelocityFieldCompute,
                port.compute.CylindricalVelocityFieldCompute):
        logging_check(cls, {"velocities": {"category": LoggerCategories.object}})


def test_velocity_field_compute_is_abstract():
    with pytest.raises(TypeError, match="abstract"):
        port.compute.VelocityFieldCompute((2, 0, 0), (0, 0, 0), (1, 0, 0))


def _mpcd_sim():
    """Two MD particles and three MPCD particles of mass 0.5."""
    mpcd = ([[-2, 0, 0], [2, 2, 0], [0, -3, 1]], [[1, 0, 0]] * 3, 0.5)
    return _sim(port, [[0, 0, 0], [1, 0, 0]], [[2.0, 0, 0], [0, 0, 4.0]], masses=[1.0, 3.0],
                L=10.0, mpcd=mpcd)


def test_velocity_compute_with_mpcd():
    sim = _mpcd_sim()
    vc = port.compute.VelocityCompute(filter=port.filter.All(), include_mpcd_particles=True)
    sim.operations.computes.append(vc)
    sim.run(0)
    # (1*2 + 3*0.5, 0, 3*4) / (1 + 3 + 1.5)
    np.testing.assert_allclose(vc.velocity, [3.5 / 5.5, 0.0, 12.0 / 5.5], atol=1e-6)


def test_velocity_compute_mpcd_only():
    """filter=None selects no MD particle."""
    sim = _mpcd_sim()
    vc = port.compute.VelocityCompute(include_mpcd_particles=True)
    sim.operations.computes.append(vc)
    sim.run(0)
    np.testing.assert_allclose(vc.velocity, [1.0, 0.0, 0.0], atol=1e-6)


def test_velocity_field_with_mpcd():
    sim = _mpcd_sim()
    field = port.compute.CartesianVelocityFieldCompute(
        num_bins=[2, 0, 0], lower_bounds=[-5, 0, 0], upper_bounds=[5, 0, 0],
        filter=port.filter.All(), include_mpcd_particles=True)
    sim.operations.computes.append(field)
    sim.run(0)
    v = field.velocities
    assert v.shape == (2, 3)
    np.testing.assert_allclose(v[0], [1.0, 0.0, 0.0], atol=1e-6)
    m = 1.0 + 3.0 + 2 * 0.5
    np.testing.assert_allclose(v[1], [(1 * 2 + 2 * 0.5 * 1) / m, 0.0, 3 * 4 / m], atol=1e-6)


@pytest.mark.parametrize("compute", ["VelocityCompute", "CartesianVelocityFieldCompute"])
def test_include_mpcd_needs_the_stream(compute):
    sim = _sim(port, [[0, 0, 0]], [[0, 0, 0]], L=5.0)
    args = ((2, 0, 0), (-2, 0, 0), (2, 0, 0)) if compute != "VelocityCompute" else ()
    sim.operations.computes.append(getattr(port.compute, compute)(
        *args, filter=port.filter.All(), include_mpcd_particles=True))
    with pytest.raises(ValueError, match="MPCD"):
        sim.run(0)


def test_mpcd_snapshot_roundtrip():
    sim = _mpcd_sim()
    sim.run(0)
    snap = sim.state.get_snapshot()
    assert snap.mpcd.N == 3
    np.testing.assert_allclose(snap.mpcd.position, [[-2, 0, 0], [2, 2, 0], [0, -3, 1]])
    np.testing.assert_allclose(snap.mpcd.velocity, np.ones((3, 3)) * [1, 0, 0])
    assert snap.mpcd.mass == 0.5
