"""The evaporating droplet (BASELINE config 5) of the port against the JAX
reference, cut to R0 = 5 (304 particles).

Every piece of the full-size configuration is here: the two-type PLJ
liquid on [T, T] tables, the SphereArea spherical barrier, the LJ93 plane
wall, the ParticleEvaporator on Periodic(25), and LangevinFlow in a
parabolic flow. The same numpy snapshot and seed build both packages.
Tolerances are those of tests/test_torch_simulation.py: after one step
positions within 2e-6 and velocities within 2e-5 of their largest value
(forces summed in another order); 20 steps past that firing positions and velocities within 1e-4,
as chaotic dynamics grow the last-bit differences. The typeids, and so
the evaporated tags, are equal.
"""

import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402

torch.set_num_threads(1)


def build_droplet(az, R0=5.0, a=1.1, seed=7):
    """``bench.py``'s build_droplet at radius R0."""
    L = 2 * R0 + 4.0
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    snap = az.Snapshot(N=len(pts))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pts
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=seed, **kw)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("solvent", "solvent")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0)
    lj.params[("solvent", "evaporated")] = dict(epsilon=0.0, sigma=1.0,
                                                attraction_scale_factor=0.0)
    lj.params[("evaporated", "evaporated")] = dict(epsilon=0.0, sigma=1.0,
                                                   attraction_scale_factor=0.0)
    barrier = az.external.SphericalHarmonicBarrier(
        location=az.variant.SphereArea(R0=R0, alpha=0.05))
    barrier.params["solvent"] = dict(k=50.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    wall = az.external.wall.LJ93(
        walls=[az.external.wall.Plane(origin=(0, 0, -L / 2 + 0.5), normal=(0, 0, 1))])
    wall.params["solvent"] = dict(epsilon=1.0, sigma=1.0, r_cut=3.0)
    wall.params["evaporated"] = dict(epsilon=0.0, sigma=1.0, r_cut=3.0)
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(25), solvent_type="solvent", evaporated_type="evaporated",
        lo=R0 / 2, hi=L / 2, N_evap_max=10))
    flow = az.flow.ParabolicFlow(mean_velocity=0.5, separation=L - 2.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.LangevinFlow(kT=1.0, flow_field=flow, default_gamma=1.0)],
        forces=[lj, barrier, wall])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, [lj, barrier, wall]


def _particles(sim):
    return sim.state.get_snapshot().particles


def test_droplet_matches_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the barrier computes no virial
        rsim, rforces = build_droplet(ref)
        psim, pforces = build_droplet(port)
        rsim.run(1)
        psim.run(1)
    r, p = _particles(rsim), _particles(psim)
    assert len(p.typeid) == 304
    np.testing.assert_array_equal(p.typeid, r.typeid)
    assert int((p.typeid == 1).sum()) == 10  # the firing after step 0
    np.testing.assert_array_equal(p.image, r.image)
    np.testing.assert_allclose(p.position, r.position, rtol=0, atol=2e-6)
    np.testing.assert_allclose(p.velocity, r.velocity, rtol=0,
                               atol=2e-5 * np.abs(r.velocity).max())
    for pf, rf in zip(pforces, rforces):
        np.testing.assert_allclose(pf.energy, rf.energy, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(pf.forces, rf.forces, rtol=2e-5,
                                   atol=2e-5 * max(np.abs(rf.forces).max(), 1e-30))

    rsim.run(20)
    psim.run(20)
    r, p = _particles(rsim), _particles(psim)
    np.testing.assert_array_equal(p.typeid, r.typeid)
    np.testing.assert_array_equal(p.image, r.image)
    np.testing.assert_allclose(p.position, r.position, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.velocity, r.velocity, rtol=0,
                               atol=1e-4 * np.abs(r.velocity).max())
    assert psim.n_builds == int(rsim._meta.n_builds)
    assert psim._grid_spec.cap == rsim._grid_spec.cap
    assert "diameter" not in psim._fields  # LJ93 reads no diameter
