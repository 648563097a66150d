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


# ---------------------------------------------------------------------------
# The pick on a whole layout (``ParticleEvaporator._pick``): its plain
# version, which the card's kernel (K4 at the pick) is held to bitwise, and
# its masked, in-place form
# ---------------------------------------------------------------------------
from azplugins_tpu.core.state import state_from_snapshot as ref_state_from_snapshot  # noqa: E402
from azplugins_tpu_torch.core.state import state_from_snapshot  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _droplet_slots(R0=6.0, a=1.1, n_empty=150, seed=4):
    """``bench.py``'s droplet lattice at radius R0 as a slot layout in both
    packages: the particles (a fifth already evaporated) with ``n_empty``
    empty slots (tag and typeid -1, far away) shuffled among them, every
    seventh particle a box length above and every eleventh one below its
    place (wrapped back into the slab). Returns the port's state, the
    reference's and the snapshot its updater attaches to."""
    rng = np.random.default_rng(seed)
    L = 2 * R0 + 4.0
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    pts[::7, 2] += L
    pts[::11, 2] -= L
    n = len(pts) + n_empty
    order = rng.permutation(n)
    pos = np.full((n, 3), 3.0 * L, np.float32)
    pos[order[:len(pts)]] = pts
    typeid = np.full(n, -1, np.int32)
    typeid[order[:len(pts)]] = (rng.random(len(pts)) < 0.2).astype(np.int32)
    tag = np.full(n, -1, np.int32)
    tag[order[:len(pts)]] = np.arange(len(pts), dtype=np.int32)
    snap = port.Snapshot(N=n)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pos
    state, _, _ = state_from_snapshot(snap, "cpu")
    state = state.replace(tag=torch.as_tensor(tag), typeid=torch.as_tensor(typeid))
    rsnap = ref.Snapshot(N=n)
    rsnap.configuration.box = [L, L, L, 0, 0, 0]
    rsnap.particles.types = ["solvent", "evaporated"]
    rsnap.particles.position[:] = pos
    ref_state = ref_state_from_snapshot(rsnap)[0]
    ref_state = ref_state.replace(tag=jnp.asarray(tag), typeid=jnp.asarray(typeid))
    return state, ref_state, snap, rsnap


def _evaporators(snap, rsnap, k, lo, hi):
    """The port's and the reference's evaporator on the slab [lo, hi),
    attached to a simulation of the snapshot's box."""
    out = []
    for az, s in ((port, snap), (ref, rsnap)):
        e = az.update.ParticleEvaporator(trigger=1, solvent_type="solvent",
                                         evaporated_type="evaporated", lo=lo, hi=hi, N_evap_max=k)
        kw = {} if az is ref else {"device": "cpu"}
        sim = az.Simulation(seed=3, **kw)
        sim.create_state_from_snapshot(s)
        e._attach(sim)
        out.append(e)
    return out


PICK_STEPS = (0, 25, 1000, 2**32 - 7)


@pytest.mark.parametrize("k", ["1", "10", "n_marked - 1", "n_marked", "slots"])
def test_pick_plain_is_the_references_typeids(k):
    """The pick's plain version (the kernel's, on the card) on a
    droplet-like slot layout gives the reference's typeids bit for bit at
    several timesteps, for k below, at and above the candidates' count
    and at least the slot count; it flips min(k, candidates)."""
    state, ref_state, snap, rsnap = _droplet_slots()
    R0, L = 6.0, float(state.box.L[2])
    lo, hi = R0 / 2, L / 2
    probe, _ = _evaporators(snap, rsnap, 10, lo, hi)
    m = int(probe._candidates(state).sum())
    assert 20 < m < state.N
    k = {"1": 1, "10": 10, "n_marked - 1": m - 1, "n_marked": m, "slots": state.N + 3}[k]
    evap, ref_evap = _evaporators(snap, rsnap, k, lo, hi)
    for t in PICK_STEPS:
        want = np.asarray(ref_evap._update(ref_state, t, 3).typeid)
        got = state.typeid.clone()
        evap._pick_plain(got, state, None, t, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(evap._update(state, t, 3).typeid.numpy(), want)
        assert int((got != state.typeid).sum()) == min(k, m)


@pytest.mark.parametrize("k", [1, 10, 10**6])
def test_masked_pick_flips_in_place_where_fired(k):
    """The evaporator's masked form (the graphs' form) flips ``typeid`` in
    place: with the flag unset its bits stay, with the flag set it is the
    fired update's; it returns the state it was given, every field (typeid
    too) the same object."""
    state, _, snap, rsnap = _droplet_slots(n_empty=40, seed=8)
    evap, _ = _evaporators(snap, rsnap, k, 3.0, float(state.box.L[2]) / 2)
    for t in PICK_STEPS:
        want = evap._update(state, t, 3).typeid
        assert not torch.equal(want, state.typeid)
        for fire in (False, True):
            own = state.replace(typeid=state.typeid.clone())
            before = own.typeid.clone()
            got = evap._update_masked(own, torch.tensor(fire), t, 3)
            assert got is own and got.typeid is own.typeid and got.typeid.dtype == torch.int32
            assert torch.equal(got.typeid, want if fire else before)


@pytest.mark.parametrize("k", ["below the ties", "one into the ties", "two into the ties",
                               "all but one"])
def test_pick_ties_the_non_candidates_as_the_reference(monkeypatch, k):
    """A candidate whose word is 0xFFFFFFFF ties the non-candidates'
    priority, the slot breaking the tie: with crafted words (every tag
    divisible by 3 hashing to 0xFFFFFFFF) the pick keeps what
    ``jax.lax.top_k`` on the reference's complement key keeps, for k up to
    the candidates below the tie, into the tying ones and one short of
    all."""
    state, ref_state, snap, rsnap = _droplet_slots(n_empty=60, seed=11)
    R0, L = 6.0, float(state.box.L[2])
    lo, hi = R0 / 2, L / 2

    def tied(module):
        draw = module.particle_bits

        def particle_bits(stream, seed, timestep, tag, n_words=4):
            words = list(draw(stream, seed, timestep, tag, n_words))
            if isinstance(tag, torch.Tensor):
                words[0] = torch.where(tag % 3 == 0, 0xFFFFFFFF, words[0])
            else:
                words[0] = jnp.where(tag % 3 == 0, jnp.uint32(0xFFFFFFFF), words[0])
            return tuple(words)

        monkeypatch.setattr(module, "particle_bits", particle_bits)

    import azplugins_tpu.update as ref_update
    import azplugins_tpu_torch.update as port_update

    tied(port_update._rng)
    tied(ref_update._rng)
    probe, _ = _evaporators(snap, rsnap, 10, lo, hi)
    cand = probe._candidates(state)
    m = int(cand.sum())
    m_lt = int((cand & (state.tag % 3 != 0)).sum())
    assert 5 < m_lt < m - 5
    k = {"below the ties": m_lt, "one into the ties": m_lt + 1, "two into the ties": m_lt + 2,
         "all but one": m - 1}[k]
    evap, ref_evap = _evaporators(snap, rsnap, k, lo, hi)
    for t in PICK_STEPS[:2]:
        want = np.asarray(ref_evap._update(ref_state, t, 3).typeid)
        got = state.typeid.clone()
        evap._pick_plain(got, state, None, t, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        # the reference's rule written out: the k largest complement keys
        (bits,) = ref_update._rng.particle_bits(203, 3, t, jnp.asarray(state.tag.numpy()), 1)
        priority = jnp.where(jnp.asarray(cand.numpy()), bits, jnp.uint32(0xFFFFFFFF))
        key = ((jnp.uint32(0xFFFFFFFF) - priority) ^ jnp.uint32(0x80000000)).view(jnp.int32)
        _, idx = jax.lax.top_k(key, k)
        keep = np.zeros(state.N, bool)
        keep[np.asarray(idx)] = True
        flip = cand.numpy() & keep
        np.testing.assert_array_equal(got.numpy(), np.where(flip, 1, state.typeid.numpy()))


def test_pick_of_no_budget_flips_nothing():
    """N_evap_max = 0: the reference's top_k of nothing keeps no slot, so no
    candidate flips (the kernel launches nothing)."""
    state, ref_state, snap, rsnap = _droplet_slots(n_empty=10, seed=2)
    evap, ref_evap = _evaporators(snap, rsnap, 0, 3.0, float(state.box.L[2]) / 2)
    assert evap._k == 0
    want = np.asarray(ref_evap._update(ref_state, 25, 3).typeid)
    np.testing.assert_array_equal(evap._update(state, 25, 3).typeid.numpy(), want)
    np.testing.assert_array_equal(want, state.typeid.numpy())


# a (seed, timestep, tag) whose evaporator word is 0xFFFFFFFF: a real tie
TIE = (7, 3, 1853371083)


@pytest.mark.parametrize("into", [0, 1, 2])
def test_pick_of_a_real_tying_word_is_the_references(into):
    """TIE's tag on two candidates at the two lowest slots: its word ties
    the non-candidates' priority, so with k at the candidates below it
    plus ``into``, the slots' order decides; the typeids are the
    reference's bit for bit (slot 0 flips from one in, slot 1 from two)."""
    seed, t, tag = TIE
    state, ref_state, snap, rsnap = _droplet_slots(n_empty=60, seed=5)
    (word,) = port.core.rng._particle_bits_plain(203, seed, t, torch.tensor([tag]), 1)
    assert int(word[0]) == 0xFFFFFFFF
    R0, L = 6.0, float(state.box.L[2])
    lo, hi = R0 / 2, L / 2
    first = torch.arange(2)
    pos = state.position.clone()
    pos[first] = torch.tensor([[0.0, 0.0, 0.5 * (lo + hi)]] * 2)
    state = state.replace(position=pos, typeid=state.typeid.index_fill(0, first, 0),
                          tag=state.tag.index_fill(0, first, tag))
    ref_state = ref_state.replace(position=jnp.asarray(pos.numpy()),
                                  typeid=jnp.asarray(state.typeid.numpy()),
                                  tag=jnp.asarray(state.tag.numpy()))
    probe, _ = _evaporators(snap, rsnap, 10, lo, hi)
    m = int(probe._candidates(state).sum())
    evap, ref_evap = _evaporators(snap, rsnap, m - 2 + into, lo, hi)
    want = np.asarray(ref_evap._update(ref_state, t, seed).typeid)
    got = state.typeid.clone()
    evap._pick_plain(got, state, None, t, seed)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:2].tolist() == [[0, 0], [1, 0], [1, 1]][into]
