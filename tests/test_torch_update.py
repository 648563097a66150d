"""Updaters of the port against the JAX reference: TypeUpdater and
ParticleEvaporator.

Retyping is integer logic on float32 positions compared with float32
bounds, and the evaporator's pick is the k smallest Threefry priorities in
exact integer space: the typeids, and so the set of evaporated tags, equal
the reference's bit for bit. An updater fires after the step with index t
when its trigger holds at t, in both packages; a chunk replayed after a
Verlet violation re-applies the same firings.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402

torch.set_num_threads(1)


def _sim(az, positions, typeids, types, L=20.0, seed=2):
    snap = az.Snapshot(N=len(positions))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = types
    snap.particles.position[:] = positions
    snap.particles.typeid[:] = typeids
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=seed, **kw)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(dt=0.0, methods=[az.md.methods.ConstantVolume()])
    return sim


def _typeids(sim):
    return sim.state.get_snapshot().particles.typeid


def test_type_updater_flips_by_region():
    # region z in [0, 5): types A/B flip accordingly; type C untouched
    sim = _sim(port, [[0, 0, 1.0], [0, 0, -1.0], [0, 0, 2.0], [0, 0, 3.0]], [1, 0, 0, 2],
               ["A", "B", "C"])
    sim.operations.updaters.append(
        port.update.TypeUpdater(trigger=1, inside_type="A", outside_type="B", lo=0.0, hi=5.0))
    sim.run(1)
    assert list(_typeids(sim)) == [0, 1, 0, 2]


@pytest.mark.parametrize("az", [ref, port], ids=["reference", "port"])
def test_updater_validation(az):
    U = az.update
    with pytest.raises(ValueError):
        U.TypeUpdater(trigger=1, inside_type="A", outside_type="B", lo=3.0, hi=1.0)
    with pytest.raises(ValueError):
        U.ParticleEvaporator(trigger=1, solvent_type="A", evaporated_type="B", lo=1.0, hi=1.0)
    bad = [
        U.TypeUpdater(trigger=1, inside_type="A", outside_type="A", lo=0.0, hi=1.0),
        U.TypeUpdater(trigger=1, inside_type="A", outside_type="Q", lo=0.0, hi=1.0),
        U.TypeUpdater(trigger=1, inside_type="A", outside_type="B", lo=-30.0, hi=1.0),
        U.ParticleEvaporator(trigger=1, solvent_type="A", evaporated_type="A", lo=0.0, hi=1.0),
        U.ParticleEvaporator(trigger=1, solvent_type="A", evaporated_type="B", lo=0.0, hi=11.0),
    ]
    for up in bad:
        sim = _sim(az, [[0, 0, 0]], [0], ["A", "B"])
        sim.operations.updaters.append(up)
        with pytest.raises(ValueError):
            sim.run(1)


def test_evaporator_under_budget_takes_all():
    sim = _sim(port, [[0, 0, 0.5], [1, 1, 0.7], [2, 2, 0.9], [0, 0, -5.0]], [0, 0, 0, 0],
               ["S", "Z"])
    sim.operations.updaters.append(port.update.ParticleEvaporator(
        trigger=1, solvent_type="S", evaporated_type="Z", lo=0.0, hi=1.0, N_evap_max=10))
    sim.run(1)
    assert list(_typeids(sim)) == [1, 1, 1, 0]


def _slab(az, N=400, seed=6, k=7, trigger=1):
    """N solvent particles, most of them in the slab z in [-2, 3)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-9.5, 9.5, (N, 3))
    pos[: 3 * N // 4, 2] = rng.uniform(-2.0, 3.0, 3 * N // 4)
    sim = _sim(az, pos, rng.integers(0, 2, N) * 2, ["S", "Z", "W"])  # S and W, no Z
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=trigger, solvent_type="S", evaporated_type="Z", lo=-2.0, hi=3.0, N_evap_max=k))
    return sim


def test_evaporator_picks_the_references_tags():
    """The budget limits each firing to k, and after 5 firings the
    evaporated tags are the reference's."""
    rsim, psim = _slab(ref), _slab(port)
    counts = []
    for _ in range(5):
        rsim.run(1)
        psim.run(1)
        counts.append(int((_typeids(psim) == 1).sum()))
        np.testing.assert_array_equal(_typeids(psim), _typeids(rsim))
    assert counts == [7, 14, 21, 28, 35]
    again = _slab(port)
    again.run(5)
    np.testing.assert_array_equal(_typeids(again), _typeids(psim))


@pytest.mark.parametrize("az", [ref, port], ids=["reference", "port"])
def test_trigger_period_and_phase_fire_after_the_step(az):
    """Periodic(3, phase=1) fires after steps 1, 4, 7, ..."""
    sim = _slab(az, N=40, k=1, trigger=az.trigger.Periodic(3, phase=1))
    n = []
    for _ in range(8):
        sim.run(1)
        n.append(int((_typeids(sim) == 1).sum()))
    assert n == [0, 1, 1, 1, 2, 2, 2, 3]


def _gas(az, seed=8):
    """A hot two-type LJ gas with an evaporator firing every 4 steps: its
    fastest particles out-drift the Verlet buffer inside the first rebuild
    interval, so a chunk with firings in it is replayed."""
    rng = np.random.default_rng(seed)
    n, a = 7, 1.45
    Lb = n * a
    x = (np.arange(n) + 0.5) * a - Lb / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap = az.Snapshot(N=n**3)
    snap.configuration.box = [Lb, Lb, Lb, 0, 0, 0]
    snap.particles.types = ["S", "Z"]
    snap.particles.position[:] = pos + rng.uniform(-0.1, 0.1, pos.shape)
    snap.particles.velocity[:] = rng.normal(0.0, 6.0, pos.shape)
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=21, **kw)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("S", "S")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0)
    lj.params[("S", "Z")] = lj.params[("Z", "Z")] = dict(epsilon=0.0, sigma=1.0,
                                                          attraction_scale_factor=0.0)
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(4), solvent_type="S", evaporated_type="Z", lo=-2.0, hi=2.0,
        N_evap_max=5))
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.ConstantVolume()], forces=[lj])
    if az is ref:
        sim.auto_tune_after = None
    return sim


def test_firings_survive_a_violation_replay():
    rsim, psim = _gas(ref), _gas(port)
    rsim.run(12)
    psim.run(12)
    assert psim.viol_replays > 0 and rsim._viol_replays == psim.viol_replays
    np.testing.assert_array_equal(_typeids(psim), _typeids(rsim))
    assert int((_typeids(psim) == 1).sum()) == 15  # firings at 0, 4 and 8


def _masked_case(which):
    """A port simulation with one updater, attached by ``run(0)`` (its dense
    layout built, nothing fired), and the updater: the evaporator on the
    slab (under budget or over it) or a TypeUpdater."""
    if which == "type_updater":
        rng = np.random.default_rng(9)
        sim = _sim(port, rng.uniform(-9.5, 9.5, (300, 3)), rng.integers(0, 3, 300),
                   ["A", "B", "C"])
        sim.operations.updaters.append(port.update.TypeUpdater(
            trigger=2, inside_type="A", outside_type="B", lo=-1.0, hi=4.0))
    else:
        sim = _slab(port, k=7 if which == "evaporator" else 1000, trigger=2)
    sim.run(0)
    return sim, sim.operations.updaters[0]


@pytest.mark.parametrize("which", ["evaporator", "evaporator_all", "type_updater"])
def test_masked_update_is_the_update_where_fired(which):
    """``_update_masked`` (the graphs' form: the update every step, kept
    where the device bool fires): fired, the update's bits; unfired, the
    state's; only typeid pays a select, every other field keeps its
    object."""
    sim, u = _masked_case(which)
    state, t = sim._dense, sim.timestep
    want = u._update(state, t, sim.seed)
    assert not torch.equal(want.typeid, state.typeid)
    for fire, expect in ((True, want), (False, state)):
        got = u._update_masked(state, torch.tensor(fire), t, sim.seed)
        assert torch.equal(got.typeid, expect.typeid) and got.typeid.dtype == torch.int32
        for f in ("position", "velocity", "tag", "image", "mass"):
            assert getattr(got, f) is getattr(state, f)
