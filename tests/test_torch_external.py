"""External potentials of the port against the JAX reference: harmonic
barriers and wall potentials.

The same numpy snapshot (three types, particles on both sides of every
barrier and wall, in range and beyond the cutoff) goes to both packages;
each force is read through the public observables at several timesteps,
so a variant location moves between readings. Tolerances: force and
energy per particle within 2e-5 relative (atol 2e-5 of the largest
value: the same float32 operations, only the reductions of the geometry
may round differently); virials exactly zero, as the reference's. In the
dense slot layout the empty slots, which sit at far sentinel positions,
get exactly zero force and energy, and the occupied slots the tag-order
values bit for bit.
"""

import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.ops import dense as D  # noqa: E402

torch.set_num_threads(1)

L = 12.0
TYPES = ["A", "B", "C"]


def _snapshot(az, N=150, seed=3, keep=None):
    """N random particles of three types and random diameters; ``keep``,
    a function of (positions, diameters), drops some."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, (N, 3)).astype(np.float32)
    typeid = rng.integers(0, 3, N)
    diameter = rng.uniform(0.4, 1.0, N).astype(np.float32)
    sel = np.ones(N, bool) if keep is None else keep(pos, diameter)
    snap = az.Snapshot(N=int(sel.sum()))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = list(TYPES)
    snap.particles.position[:] = pos[sel]
    snap.particles.typeid[:] = typeid[sel]
    snap.particles.diameter[:] = diameter[sel]
    return snap


def _sim(az, forces, snap=None, methods=None):
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=9, **kw)
    sim.create_state_from_snapshot(snap if snap is not None else _snapshot(az))
    sim.operations.integrator = az.md.Integrator(
        dt=0.0 if methods is None else 0.001,
        methods=methods or [az.md.methods.ConstantVolume()], forces=forces)
    if az is ref:
        sim.auto_tune_after = None
    return sim


def _barrier(az, kind, location):
    if location == "ramp":
        A = -2.5 if kind == "planar" else 2.0
        loc = az.variant.Ramp(A=A, B=5.5, t_start=10, t_ramp=1_000)
    else:
        loc = az.variant.SphereArea(R0=5.0, alpha=0.3)
    cls = (az.external.PlanarHarmonicBarrier if kind == "planar"
           else az.external.SphericalHarmonicBarrier)
    b = cls(location=loc)
    b.params["A"] = dict(k=50.0, offset=0.0)
    b.params["B"] = dict(k=12.5, offset=0.4)
    b.params["C"] = dict(k=0.0, offset=-0.3)
    return b


GEOMETRIES = {
    "plane": lambda W: W.Plane(origin=(0.3, -0.2, -2.0), normal=(0.2, -0.1, 1.0)),
    "sphere_inside": lambda W: W.Sphere(radius=4.5, origin=(0.5, 0.0, -0.5), inside=True),
    "sphere_outside": lambda W: W.Sphere(radius=2.0, origin=(0.0, 1.0, 0.0), inside=False),
    "cylinder": lambda W: W.Cylinder(radius=4.0, origin=(0.0, 0.5, 0.0), axis=(0.1, 0.0, 1.0),
                                     inside=True),
}


def _wall(az, potential, geometry, extrap):
    W = az.external.wall
    w = getattr(W, potential)(walls=[GEOMETRIES[geometry](W)])
    if potential == "LJ93":
        params = [dict(epsilon=1.0, sigma=1.0), dict(epsilon=2.5, sigma=0.8),
                  dict(epsilon=0.0, sigma=1.0)]
    else:
        params = [dict(A=3.0, sigma=1.0), dict(A=1.5, sigma=1.2), dict(A=0.0, sigma=1.0)]
    for t, p, r_extrap in zip(TYPES, params, (1.0, 0.0, 0.8)):
        w.params[t] = dict(p, r_cut=2.5, r_extrap=r_extrap if extrap else 0.0)
    return w


def _assert_tables_match(pf, rf):
    """The port's device tables are the reference's, bit for bit."""
    got = pf._device_tables("cpu")
    want = interop.external_tables_from_reference(rf._tbl, "cpu")
    assert got.keys() == want.keys() and got["params"].keys() == want["params"].keys()
    for k in got["params"]:
        assert torch.equal(got["params"][k], want["params"][k]), k
    for k in ("r_cut", "r_extrap"):
        if k in got:
            assert torch.equal(got[k], want[k]), k
    assert got.get("extrap") == want.get("extrap")


def _assert_force_matches(pf, rf):
    _assert_tables_match(pf, rf)
    re, pe = rf.energies, pf.energies
    rfo, pfo = rf.forces, pf.forces
    assert np.abs(rfo).max() > 0  # the case has particles in range
    np.testing.assert_allclose(pe, re, rtol=2e-5, atol=2e-5 * np.abs(re).max())
    np.testing.assert_allclose(pfo, rfo, rtol=2e-5, atol=2e-5 * np.abs(rfo).max())
    np.testing.assert_array_equal(pf.virials, 0.0)
    np.testing.assert_array_equal(rf.virials, 0.0)


@pytest.mark.parametrize("kind", ["planar", "spherical"])
@pytest.mark.parametrize("location", ["ramp", "sphere_area"])
def test_barrier_matches_reference(kind, location):
    rb, pb = _barrier(ref, kind, location), _barrier(port, kind, location)
    rsim, psim = _sim(ref, [rb]), _sim(port, [pb])
    with pytest.warns(UserWarning, match="virial"):
        rsim.run(0)
    with pytest.warns(UserWarning, match="virial"):
        psim.run(0)
    for t in (0, 400, 5_000):
        rsim.timestep = psim.timestep = t
        assert pb.location(t) == float(rb.location(t))
        _assert_force_matches(pb, rb)


@pytest.mark.parametrize("kind", ["planar", "spherical"])
def test_barrier_reads_its_scheduled_location(kind):
    """Inside a run the location is the schedule's 0-d float32
    (``variant.scheduled``): the force and energy keep the bits of the host
    float's."""
    pb = _barrier(port, kind, "sphere_area")
    psim = _sim(port, [pb])
    with pytest.warns(UserWarning, match="virial"):
        psim.run(0)
    state = psim._dense
    (tbl,) = [t[0] for t in psim._force_tables()]
    rows = torch.from_numpy(pb.location.values(0, 8000)[None])
    for t in (0, 400, 5_000, 7_999):
        want = pb._compute(state, t, tbl)
        with port.variant.scheduled((pb.location,), rows, 0):
            got = pb._compute(state, t, tbl)
        for k in ("force", "energy"):
            assert torch.equal(getattr(got, k), getattr(want, k)), (t, k)


@pytest.mark.parametrize("potential", ["LJ93", "Colloid"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_wall_matches_reference(potential, geometry):
    """Each wall with r_extrap on for two of the three types, then off.

    The Colloid wall's r - a cancels: within 0.25 of the surface a particle
    of radius a turns an ulp of r (the reference's compiled distance fuses
    its multiply-adds) into more than the bar, so the Colloid cases keep
    particles that far from it."""
    keep = None
    if potential == "Colloid":
        geom = GEOMETRIES[geometry](port.external.wall)

        def keep(pos, diameter):
            d = geom.distance(torch.as_tensor(pos))[0].numpy()
            return ~((d > 0) & (d < 0.5 * diameter + 0.25))

    for extrap in (True, False):
        rw, pw = _wall(ref, potential, geometry, extrap), _wall(port, potential, geometry, extrap)
        rsim = _sim(ref, [rw], snap=_snapshot(ref, keep=keep))
        psim = _sim(port, [pw], snap=_snapshot(port, keep=keep))
        rsim.run(0)
        psim.run(0)
        _assert_force_matches(pw, rw)


def _dense_and_tag_order(force, snap):
    """The port's force on the tag-order state and on its dense slot layout."""
    sim = _sim(port, [force], snap=snap)
    sim.run(0)
    state = sim._synced_state()
    spec = D.GridSpec.create(state.box, state.N, 2.5, 0.4)
    dense, _ = D.densify(state, spec, fields=("diameter",))
    assert bool((dense.tag < 0).any())
    tbl = force._device_tables("cpu")
    return force._compute(state, 400, tbl), force._compute(dense, 400, tbl), dense


@pytest.mark.parametrize("which", ["barrier", "LJ93", "Colloid"])
def test_empty_slots_get_exactly_zero(which):
    if which == "barrier":
        force = _barrier(port, "spherical", "sphere_area")
    else:
        force = _wall(port, which, "sphere_inside", extrap=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tag_order, slots, dense = _dense_and_tag_order(force, _snapshot(port))
    empty = dense.tag < 0
    for got in (slots.force, slots.energy, slots.virial):
        assert bool(torch.isfinite(got).all())
        assert bool((got[empty] == 0).all())
    tags = dense.tag[~empty].long()
    assert torch.equal(slots.force[~empty], tag_order.force[tags])
    assert torch.equal(slots.energy[~empty], tag_order.energy[tags])


@pytest.mark.parametrize("az", [ref, port], ids=["reference", "port"])
def test_barrier_outside_the_box_raises(az):
    b = az.external.PlanarHarmonicBarrier(location=az.variant.Ramp(0.0, 30.0, 0, 100))
    b.params["A"] = b.params["B"] = b.params["C"] = dict(k=1.0, offset=0.0)
    sim = _sim(az, [b])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="outside the global box"):
            sim.run(0)


def test_virial_warning_once_per_force():
    b = _barrier(port, "planar", "ramp")
    sim = _sim(port, [b])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim.run(0)
        sim.run(2)
        sim.run(3)
        b.energy
    assert sum("virial" in str(w.message) for w in caught) == 1


def _lj(az):
    lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5, mode="shift")
    lj.params[("A", "A")] = lj.params[("A", "B")] = lj.params[("B", "B")] = dict(
        epsilon=1.0, sigma=1.0)
    lj.params[("A", "C")] = lj.params[("B", "C")] = lj.params[("C", "C")] = dict(
        epsilon=0.5, sigma=0.9)
    return lj


def _lattice(az, n=6, a=1.7, seed=5):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=n**3)
    Lb = n * a
    snap.configuration.box = [Lb, Lb, Lb, 0, 0, 0]
    snap.particles.types = list(TYPES)
    x = (np.arange(n) + 0.5) * a - Lb / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-0.1, 0.1, pos.shape)
    snap.particles.typeid[:] = rng.integers(0, 3, n**3)
    snap.particles.velocity[:] = rng.normal(0, 1, (n**3, 3))
    return snap


class _NoVirial(port.md.force.Force):
    """A force that computes no virial (ForceResult.virial is None)."""

    def _build_tables(self, sim):
        pass

    def _device_tables(self, device):
        return {}

    def _compute(self, state, timestep, tbl):
        return port.md.force.ForceResult(force=torch.zeros_like(state.position),
                                         energy=torch.zeros_like(state.mass), virial=None)


def test_pressure_with_a_barrier_and_a_colloid_wall():
    """The barrier adds no virial; a force with none is skipped. The Colloid
    wall keeps the diameter column although every diameter has its
    default."""
    thermo, sims, walls = {}, {}, {}
    for az in (ref, port):
        b = _barrier(az, "spherical", "sphere_area")
        walls[az] = _wall(az, "Colloid", "plane", extrap=False)
        sims[az] = _sim(az, [_lj(az), b, walls[az]], snap=_lattice(az),
                        methods=[az.md.methods.ConstantVolume()])
        thermo[az] = az.compute.ThermodynamicQuantities()
        sims[az].operations.computes.append(thermo[az])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sims[az].run(2)
    assert "diameter" in sims[port]._fields
    assert sims[port]._fields == sims[ref]._fields
    _assert_force_matches(walls[port], walls[ref])
    for q in ("pressure", "kinetic_energy", "potential_energy"):
        np.testing.assert_allclose(getattr(thermo[port], q), getattr(thermo[ref], q),
                                   rtol=2e-5, err_msg=q)
    np.testing.assert_allclose(thermo[port].pressure_tensor, thermo[ref].pressure_tensor,
                               rtol=2e-5, atol=2e-5 * np.abs(thermo[ref].pressure_tensor).max())
    pressure = thermo[port].pressure
    sims[port].operations.integrator.forces.append(_NoVirial())
    sims[port].run(0)
    assert thermo[port].pressure == pytest.approx(pressure, rel=1e-6)
