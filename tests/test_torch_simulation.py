"""The port's step loop against the JAX reference, and its physics checks.

The same numpy snapshot and seed build the system in both packages. One
step matches within float32 tolerance (pair sums run in another order);
a 20-step trajectory stays within a looser bound, as chaotic dynamics
amplify the last-bit differences; NVE conserves energy and Langevin holds
its temperature, as the reference's own checks require.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402

torch.set_num_threads(1)


def _snapshot(az, n=7, a=1.15, seed=3, kick=0.1):
    """n^3 jittered simple-cubic lattice (the canonical drive's fluid)."""
    rng = np.random.default_rng(seed)
    N = n**3
    snap = az.Snapshot(N=N)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), axis=-1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-kick, kick, pos.shape)
    return snap


def _build(az, method, n=7, seed=3, r_cut=2.5, mode="shift", **sim_kw):
    """The canonical drive's fluid with one of the ported methods."""
    sim = az.Simulation(device="cpu", seed=42, **sim_kw)
    sim.create_state_from_snapshot(_snapshot(az, n=n, seed=seed))
    lj = az.pair.PerturbedLennardJones(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=r_cut, mode=mode
    )
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.7)
    if method == "nve":
        m = az.md.methods.ConstantVolume()
    elif method == "langevin":
        m = az.md.methods.Langevin(kT=1.2, default_gamma=0.5)
    elif method == "langevin_noiseless":
        m = az.md.methods.Langevin(kT=1.2, default_gamma=0.5, noiseless=True)
    else:  # a uniform flow, via the reference's flow field and a port callable
        u = (0.3, -0.1, 0.05)
        if az is ref:
            flow = ref.flow.ConstantFlow(velocity=u)
        else:
            def flow(pos):
                return torch.tensor(u, dtype=pos.dtype, device=pos.device).expand_as(pos)
        m = az.md.methods.LangevinFlow(kT=1.2, flow_field=flow, default_gamma=0.5)
    sim.operations.integrator = az.md.Integrator(dt=0.005, methods=[m], forces=[lj])
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.state.thermalize_particle_momenta(kT=1.2)
    return sim, lj, thermo


def _snap_arrays(sim):
    s = sim.state.get_snapshot()
    return s.particles.position.copy(), s.particles.velocity.copy(), s.particles.image.copy()


@pytest.mark.parametrize("method", ["nve", "langevin", "langevin_noiseless", "langevin_flow"])
def test_one_step_matches_reference(method):
    rsim, rlj, rth = _build(ref, method)
    psim, plj, pth = _build(port, method)
    rsim.auto_tune_after = None  # these runs stop short of the tune point anyway
    rsim.run(1)
    psim.run(1)
    rp, rv, ri = _snap_arrays(rsim)
    pp, pv, pi = _snap_arrays(psim)
    np.testing.assert_array_equal(pi, ri)
    # positions: float32 rounding of the drift only
    np.testing.assert_allclose(pp, rp, rtol=0, atol=2e-6)
    # velocities carry the force sums, taken in another order: f32 bar
    vscale = np.abs(rv).max()
    np.testing.assert_allclose(pv, rv, rtol=2e-5, atol=2e-5 * vscale)
    # observables on the new state
    np.testing.assert_allclose(plj.energy, rlj.energy, rtol=2e-5)
    np.testing.assert_allclose(plj.forces, rlj.forces, rtol=2e-5,
                               atol=2e-5 * np.abs(rlj.forces).max())
    np.testing.assert_allclose(plj.virials, rlj.virials, rtol=2e-5,
                               atol=2e-5 * np.abs(rlj.virials).max())
    np.testing.assert_allclose(plj.energies, rlj.energies, rtol=2e-5,
                               atol=2e-5 * np.abs(rlj.energies).max())
    for q in ("kinetic_energy", "translational_degrees_of_freedom", "kinetic_temperature",
              "potential_energy", "volume", "pressure"):
        np.testing.assert_allclose(getattr(pth, q), getattr(rth, q), rtol=2e-5, err_msg=q)
    np.testing.assert_allclose(pth.pressure_tensor, rth.pressure_tensor, rtol=2e-5,
                               atol=2e-5 * np.abs(rth.pressure_tensor).max())


def test_twenty_step_trajectory_matches_reference():
    """20 Langevin steps with one rebuild in between. The thermostat noise
    is bitwise shared, so the trajectories separate only through float32
    rounding; 1e-4 in position and velocity bounds 20 steps of that."""
    rsim, _, rth = _build(ref, "langevin")
    psim, _, pth = _build(port, "langevin")
    rsim.auto_tune_after = None
    rsim.run(20)
    psim.run(20)
    rp, rv, ri = _snap_arrays(rsim)
    pp, pv, pi = _snap_arrays(psim)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pp, rp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-4 * np.abs(rv).max())
    assert psim.n_builds == int(rsim._meta.n_builds)
    np.testing.assert_allclose(pth.kinetic_temperature, rth.kinetic_temperature, rtol=1e-4)


def test_nve_energy_drift():
    """NVE (mode shift, no thermostat) conserves total energy: drift per
    particle under 1e-2 over 400 steps at N = 512."""
    sim, lj, thermo = _build(port, "nve", n=8)
    sim.run(0)
    e0 = thermo.kinetic_energy + lj.energy
    sim.run(400)
    e1 = thermo.kinetic_energy + lj.energy
    N = sim.state.N_particles
    assert abs(e1 - e0) / N < 1e-2
    pos = sim.state.get_snapshot().particles.position
    assert np.all(np.isfinite(pos))
    L = sim.state.box.Lx
    assert np.all(np.abs(pos) <= L / 2 + 1e-4)  # wrapped into the box
    assert 0 < sim.n_builds < 400  # the Verlet buffer spares most rebuilds


def test_langevin_holds_temperature():
    """The canonical drive's check: kinetic temperature ~ kT."""
    sim, lj, thermo = _build(port, "langevin", n=8)
    sim.run(600)
    temps = []
    for _ in range(8):
        sim.run(25)
        temps.append(thermo.kinetic_temperature)
    assert abs(np.mean(temps) - 1.2) < 0.08
    assert np.isfinite(lj.energy)


def test_default_device_is_the_gpu(monkeypatch):
    """Simulation() with no device runs on CUDA; without CUDA it raises
    rather than falling back to the CPU, which is used only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.Simulation(seed=1)
    assert port.Simulation(device="cpu", seed=1).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port.Simulation(seed=1).device == torch.device("cuda")


def test_port_does_not_import_jax():
    # isolated mode (-I): no PYTHONPATH or site hooks can pull JAX in
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    code = (
        f"import sys; sys.path.insert(0, {repo!r}); import azplugins_tpu_torch as az; "
        "import azplugins_tpu_torch.interop, azplugins_tpu_torch.ops.pair_kernel, "
        "azplugins_tpu_torch.ops.aniso_kernel, azplugins_tpu_torch.io.gsd, "
        "azplugins_tpu_torch.write, azplugins_tpu_torch.examples.lj_fluid; "
        "assert az.io.native_available() in (True, False); "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
        "assert 'azplugins_tpu' not in sys.modules; print('ok')"
    )
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# Twins of the reference's robustness cases (tests/test_robustness.py)
# ---------------------------------------------------------------------------
def _lattice(n=4, a=1.4):
    """n^3 simple-cubic lattice of spacing a (the reference's fixture)."""
    snap = port.Snapshot(N=n**3)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"),
                                          axis=-1).reshape(-1, 3)
    return snap


def _hertz_lattice(method, seed=6):
    sim = port.Simulation(device="cpu", seed=seed)
    sim.create_state_from_snapshot(_lattice())
    pot = port.pair.Hertz(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=1.3)
    pot.params[("A", "A")] = dict(epsilon=2.0)
    sim.operations.integrator = port.md.Integrator(dt=0.002, methods=[method], forces=[pot])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, pot


def _momentum(sim):
    p = sim.state.get_snapshot().particles
    return (p.velocity.astype(np.float64) * p.mass[:, None]).sum(axis=0)


def test_single_particle_runs():
    """One particle runs 20 Langevin steps with finite positions and zero
    pair energy (test_robustness.py::test_single_particle_runs)."""
    snap = port.Snapshot(N=1)
    snap.configuration.box = [6, 6, 6, 0, 0, 0]
    snap.particles.types = ["A"]
    sim = port.Simulation(device="cpu", seed=5)
    sim.create_state_from_snapshot(snap)
    pot = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    pot.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=1.0, default_gamma=1.0)], forces=[pot])
    sim.run(20)
    assert np.all(np.isfinite(sim.state.get_snapshot().particles.position))
    assert pot.energy == 0.0


def test_operations_rebind_on_change():
    """An integrator swapped after a run takes effect (NVE conserves the
    momentum the Langevin run left), and a force appended after a run is
    evaluated (test_robustness.py::test_operations_rebind_on_change)."""
    sim, pot = _hertz_lattice(port.md.methods.Langevin(kT=1.0, default_gamma=0.5))
    sim.run(20)
    sim.operations.integrator = port.md.Integrator(
        dt=0.002, methods=[port.md.methods.ConstantVolume()], forces=[pot])
    p0 = _momentum(sim)
    sim.run(30)
    np.testing.assert_allclose(_momentum(sim), p0, atol=1e-4)
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=0.3, sigma=1.0)
    sim.operations.integrator.forces.append(lj)
    sim.run(1)
    assert lj.energy != 0.0


def test_force_removal_preserves_state():
    """A swap to a gridless force set after a run keeps the evolved
    positions, with or without a host read before the swap
    (test_robustness.py::test_force_removal_preserves_state)."""
    ends = []
    for sync in (False, True):
        sim, _ = _hertz_lattice(port.md.methods.ConstantVolume())
        sim.run(25)
        if sync:
            sim.state.get_snapshot()
        sim.operations.integrator = port.md.Integrator(
            dt=0.002, methods=[port.md.methods.ConstantVolume()], forces=[])
        sim.run(5)
        ends.append(sim.state.get_snapshot().particles.position)
    np.testing.assert_array_equal(ends[0], ends[1])


def test_divergence_raises_clean_error():
    """Near-overlapping pairs under a steep PLJ blow up: the run raises a
    RuntimeError naming the divergence at the first overflow
    (test_robustness.py::test_divergence_raises_clean_error)."""
    rng = np.random.default_rng(0)
    L, n_pairs = 12.0, 32
    centers = rng.uniform(-L / 2 + 1, L / 2 - 1, size=(n_pairs, 3))
    snap = port.Snapshot(N=2 * n_pairs)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = np.concatenate([centers, centers + 1e-4], axis=0)
    sim = port.Simulation(device="cpu", seed=1)
    sim.create_state_from_snapshot(snap)
    lj = port.pair.PerturbedLennardJones(nlist=port.md.nlist.Cell(buffer=0.4),
                                         default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.ConstantVolume()], forces=[lj])
    with pytest.raises(RuntimeError, match="diverged"):
        for _ in range(40):
            sim.run(10)
