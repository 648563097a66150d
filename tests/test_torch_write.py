"""The port's writers and restarts, against the JAX reference where the
reference defines the answer.

Restarts: an NVE restart reproduces the continuous run within 1e-4 (the
rebuilt slot layout sums forces in another order); two Langevin restarts
agree bitwise (the noise is counter-based on seed, timestep and tag) and
stay within 5e-2 of the continuous run (the stored acceleration folds in
the previous step's noise, which a restart cannot rebuild). Writers: frames
land at their trigger's timesteps, the first complete and the rest
dynamic-only; the Table's header and rows and ``Logger.add``'s default
quantities are the reference's. Attaching writers ends chunks at their
fires and changes the trajectory nowhere, bitwise, on a Lennard-Jones
liquid through the capacity tune and on an SRD solvent coupled to solutes
with a pair force (an overflow grows the capacity at the rebuild that
overflowed: a chunk of several rebuilds is replayed one rebuild a chunk,
up to its end); a chunk replayed for a drift violation writes no frame; a
restart past ``auto_tune_after`` does not tune again.
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu_torch.io import (  # noqa: E402
    GSDReader,
    TrajectoryReader,
    load_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)


def _small_sim(az=port, seed=11, nve=False):
    n, a = 5, 1.2
    snap = az.Snapshot(N=n**3)
    snap.configuration.box = [n * a] * 3 + [0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - n * a / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=seed, **kw)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    method = (az.md.methods.ConstantVolume() if nve
              else az.md.methods.Langevin(kT=1.0, default_gamma=0.5))
    sim.operations.integrator = az.md.Integrator(dt=0.005, methods=[method], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim


def _restart_from(path, n_steps, nve=False):
    snap, ts = load_checkpoint(path)
    sim = _small_sim(nve=nve)
    sim.state.set_snapshot(snap)
    sim.timestep = ts
    sim.run(n_steps)
    return sim.state.get_snapshot().particles.position


def test_checkpoint_restart_nve(tmp_path):
    path = str(tmp_path / "ckpt_nve.azt")
    sim = _small_sim(nve=True)
    sim.run(20)
    save_checkpoint(sim, path)
    sim.run(10)
    want = sim.state.get_snapshot().particles.position
    np.testing.assert_allclose(_restart_from(path, 10, nve=True), want, rtol=0, atol=1e-4)


def test_checkpoint_restart_langevin(tmp_path):
    path = str(tmp_path / "ckpt.azt")
    sim = _small_sim()
    sim.run(20)
    save_checkpoint(sim, path)
    assert load_checkpoint(path)[1] == 20
    sim.run(10)
    want = sim.state.get_snapshot().particles.position
    got1 = _restart_from(path, 10)
    got2 = _restart_from(path, 10)
    np.testing.assert_array_equal(got1, got2)
    np.testing.assert_allclose(got1, want, rtol=0, atol=5e-2)


def test_trajectory_writer_in_run(tmp_path):
    path = str(tmp_path / "traj.azt")
    sim = _small_sim()
    traj = port.write.Trajectory(trigger=port.trigger.Periodic(10), filename=path)
    sim.operations.writers.append(traj)
    sim.run(35)
    traj.close()
    with TrajectoryReader(path) as r:
        assert r.timesteps == [10, 20, 30]
        _, first = r.read_frame(0)
        assert "particles/typeid" in first  # first frame complete
        _, later = r.read_frame(1)
        assert "particles/typeid" not in later  # dynamic-only afterwards
        assert later["particles/position"].shape == (125, 3)


def test_table_writer(tmp_path):
    out = str(tmp_path / "log.txt")
    sim = _small_sim()
    thermo = port.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    logger = port.write.Logger()
    logger.add(thermo, ["kinetic_temperature"], prefix="thermo")
    logger["custom"] = lambda: 42
    table = port.write.Table(trigger=5, logger=logger, output=out)
    sim.operations += table
    sim.run(12)
    table.close()
    lines = open(out).read().strip().splitlines()
    assert lines[0].split() == ["timestep", "thermo.kinetic_temperature", "custom"]
    assert [ln.split()[0] for ln in lines[1:]] == ["5", "10"]
    assert all(ln.split()[2] == "42" for ln in lines[1:])
    assert 0.1 < float(lines[1].split()[1]) < 3.0


def test_table_rows_match_reference():
    """The same liquid in both packages, logged every 5 steps: the same
    header, the same timesteps, values within the f32 bar of a few steps."""
    rows = {}
    for name, az in (("ref", ref), ("port", port)):
        sim = _small_sim(az)
        thermo = az.compute.ThermodynamicQuantities()
        sim.operations.computes.append(thermo)
        logger = az.write.Logger()
        logger.add(thermo, ["kinetic_energy", "potential_energy"])
        out = io.StringIO()
        sim.operations += az.write.Table(trigger=5, logger=logger, output=out)
        sim.run(10)
        rows[name] = [ln.split() for ln in out.getvalue().strip().splitlines()]
    assert rows["port"][0] == rows["ref"][0] == [
        "timestep", "ThermodynamicQuantities.kinetic_energy",
        "ThermodynamicQuantities.potential_energy"]
    assert [r[0] for r in rows["port"][1:]] == [r[0] for r in rows["ref"][1:]] == ["5", "10"]
    np.testing.assert_allclose(np.float64([r[1:] for r in rows["port"][1:]]),
                               np.float64([r[1:] for r in rows["ref"][1:]]), rtol=1e-4)


def test_logger_add_default_loggables():
    """``Logger.add(obj)`` with no list logs every default-on loggable,
    the reference's set for the same class."""
    labels = {}
    for name, az in (("ref", ref), ("port", port)):
        logger = az.write.Logger()
        logger.add(az.compute.ThermodynamicQuantities())
        lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
        logger.add(lj, prefix="lj")
        labels[name] = logger.labels()
    assert labels["port"] == labels["ref"]
    assert "ThermodynamicQuantities.kinetic_temperature" in labels["port"]
    assert "lj.energy" in labels["port"] and "lj.virials" not in labels["port"]
    logger = port.write.Logger()
    with pytest.raises(ValueError, match="no default loggable"):
        logger.add(object())
    with pytest.raises(AttributeError):
        logger.add(port.compute.ThermodynamicQuantities(), ["no_such_quantity"])
    with pytest.raises(TypeError):
        logger["x"] = 3


# -- writers leave the trajectory alone ---------------------------------------
class _Frames(port.write.Writer):
    """Records (timestep, positions, velocities) at each fire."""

    def __init__(self, trigger):
        super().__init__(trigger)
        self.frames = []

    def write(self, sim, timestep):
        snap = sim.state.get_snapshot()
        self.frames.append((timestep, snap.particles.position.copy(),
                            snap.particles.velocity.copy()))


def _liquid():
    """216 particles in 3^3 cells melting from a lattice, Langevin."""
    n, a = 6, 1.45
    snap = port.Snapshot(N=n**3)
    snap.configuration.box = [n * a] * 3 + [0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - n * a / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim = port.Simulation(device="cpu", seed=12)
    sim.create_state_from_snapshot(snap)
    lj = port.pair.PerturbedLennardJones(nlist=port.md.nlist.Cell(buffer=0.4),
                                         default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=1.5, default_gamma=1.0)], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.5)
    return sim


def _coupled():
    """64 WCA solutes in an SRD solvent, coupled every 6 steps."""
    rng = np.random.default_rng(8)
    L, N_s, n = 8.0, 3000, 4
    snap = port.Snapshot(N=n**3, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["C"]
    x = (np.arange(n) + 0.5) * (L / n) - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.mass[:] = 5.0
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    sim = port.Simulation(device="cpu", seed=13)
    sim.create_state_from_snapshot(snap)
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.0 ** (1 / 6),
                      mode="shift")
    lj.params[("C", "C")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.02, methods=[port.md.methods.ConstantVolume()], forces=[lj])
    srd = port.mpcd.SRD(dt=0.02, period=6, angle=130.0, cell_size=1.0, kT=1.0)
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(port.mpcd.CollisionCoupling(srd))
    return sim


def _end_state(sim):
    snap = sim.state.get_snapshot()
    out = [snap.particles.position, snap.particles.velocity, snap.particles.image]
    if snap.mpcd.N:
        out += [snap.mpcd.position, snap.mpcd.velocity]
    return out


@pytest.mark.parametrize("system,steps", [("lj", 260), ("coupled_srd", 90)])
def test_writers_leave_the_trajectory_bitwise_unchanged(tmp_path, system, steps):
    """Writers firing at 7, 13 and 25 split chunks off the rebuild schedule,
    off the coupling's period and (LJ) across the capacity tune at step 200,
    the interval's quantum at 100, 200 and the overflow after the tune (the
    capacity grows at the rebuild that overflowed, not at a chunk's start);
    the run ends bitwise where the run without writers ends, and each frame
    is the state at its step."""
    build = _liquid if system == "lj" else _coupled
    plain = build()
    plain.run(steps)
    sim = build()
    probe = _Frames(7)
    logger = port.write.Logger()
    logger["t"] = lambda: sim.timestep
    sim.operations += probe
    sim.operations += port.write.Table(13, logger, output=io.StringIO())
    sim.operations += port.write.GSD(25, str(tmp_path / "w.gsd"))
    chunks, grows = [], []
    run_chunk, grow = sim._run_chunk, sim._grow_and_rebuild
    sim._run_chunk = lambda *a, **k: chunks.append(a[3]) or run_chunk(*a, **k)
    sim._grow_and_rebuild = lambda *a: grows.append(sim.timestep) or grow(*a)
    sim.run(steps)
    assert [t for t, _, _ in probe.frames] == list(range(7, steps + 1, 7))
    assert any(c < 7 for c in chunks)  # the writers did cut chunks
    if system == "lj":  # the tuned capacity overflowed and grew, off a writer's split
        assert grows and all(t % 7 for t in grows), grows
    for got, want in zip(_end_state(sim), _end_state(plain)):
        np.testing.assert_array_equal(got, want)
    # a frame is the state of its own step: rerun to it without writers
    t, pos, vel = probe.frames[-2]
    again = build()
    again.run(t)
    np.testing.assert_array_equal(pos, again.state.get_snapshot().particles.position)
    np.testing.assert_array_equal(vel, again.state.get_snapshot().particles.velocity)


def test_replayed_chunk_writes_no_frame():
    """A chunk replayed for a drift violation fires no writer: each frame is
    written once, after the accepted chunk."""
    sim = _small_sim()
    probe = _Frames(5)
    sim.operations.writers.append(probe)
    run_chunk, calls = sim._run_chunk, []

    def violated_once(*args, **kw):
        dense, meta, viol, solv = run_chunk(*args, **kw)
        calls.append(args[2])
        return dense, meta, viol | (len(calls) == 1), solv

    sim._run_chunk = violated_once
    sim.run(20)
    assert sim.viol_replays == 1
    assert [t for t, _, _ in probe.frames] == [5, 10, 15, 20]
    assert calls[0] == calls[1] == 0  # the replay restarted the first chunk
    assert len(calls) > len(probe.frames)
    np.testing.assert_array_equal(probe.frames[-1][1],
                                  sim.state.get_snapshot().particles.position)


def _record_tune(sim, tuned):
    tune = sim.tune_cell_capacity

    def recorded(*args, **kwargs):
        tuned.append(sim.timestep)
        tune(*args, **kwargs)

    sim.tune_cell_capacity = recorded


@pytest.mark.parametrize("restore", ["checkpoint", "gsd"])
def test_restart_past_the_tune_does_not_tune_again(tmp_path, restore):
    sim = _small_sim()
    gsd = port.write.GSD(trigger=230, filename=str(tmp_path / "t.gsd"))
    sim.operations += gsd
    sim.run(230)
    gsd.close()
    assert sim._auto_tuned
    save_checkpoint(sim, str(tmp_path / "t.azt"))
    new = port.Simulation(device="cpu", seed=11)
    if restore == "checkpoint":
        snap, ts = load_checkpoint(str(tmp_path / "t.azt"))
        new.create_state_from_snapshot(snap)
        new.timestep = ts
    else:
        new.create_state_from_gsd(str(tmp_path / "t.gsd"))
    assert new.timestep == 230 and new._auto_tuned
    with GSDReader(str(tmp_path / "t.gsd")) as r:
        assert r.n_frames == 1
    tuned = []
    _record_tune(new, tuned)
    lj = port.pair.PerturbedLennardJones(nlist=port.md.nlist.Cell(buffer=0.4),
                                         default_r_cut=2.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    new.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=1.0, default_gamma=0.5)], forces=[lj])
    new.run(20)
    assert tuned == [] and new.timestep == 250
    # a fresh clock below the tune point still tunes at it
    fresh = _small_sim()
    fresh.timestep = 190
    _record_tune(fresh, tuned)
    fresh.run(20)
    assert tuned == [200]


def test_overflow_probe_ends_with_its_chunk():
    """An overflow in a chunk of several rebuilds replays that chunk one
    rebuild a chunk; a replay that passes the chunk's end without an
    overflow (a CUDA replay with atomic sums need not repeat its bits)
    ends the probing, and the trajectory is the unprobed run's, bitwise."""
    plain = _liquid()
    plain.run(120)
    sim = _liquid()
    run_chunk, calls = sim._run_chunk, []

    def overflow_once(*args, **kw):
        dense, meta, viol, solv = run_chunk(*args, **kw)
        calls.append((args[2], args[3]))
        if len(calls) == 1:
            meta = meta.replace(overflow=torch.ones((), dtype=torch.bool))
        return dense, meta, viol, solv

    sim._run_chunk = overflow_once
    sim.run(120)
    assert calls[0] == (0, 100)
    assert calls[1:11] == [(t, 10) for t in range(0, 100, 10)]
    assert sim._probe_until is None and calls[11][0] == 100
    for got, want in zip(_end_state(sim), _end_state(plain)):
        np.testing.assert_array_equal(got, want)
