"""Updaters, bonds and the MPCD solvent on the port's sharded mesh.

On ``make_mesh(n, device="cpu", sharded=True)`` (n shards of slot storage
of their own on one device, as the reference's suite runs its mesh on
virtual CPU devices) held bitwise against the port's undecomposed run:

- the droplet's composition (pair, moving barrier, ``ParticleEvaporator``,
  velocity field, aztraj writer; the reference's
  ``tests/test_spatial.py::test_spatial_droplet_workload_bitwise``), and
  within the 20-step bars of ``test_torch_spatial_sharded.py`` of the
  reference's decomposed run (positions 1e-4, velocities 1e-4 of max|v|),
  typeids equal;
- the evaporator's pick on shards (each shard's k smallest keys on global
  slots, merged) and on one shard against the reference's whole pick, and
  a ``TypeUpdater`` on slabs and strips;
- a bonded melt through rebuilds and migrations, a bond longer than any
  halo window included: trajectory, the global tag->slot map, and the bond
  energy, virial and forces; and against the reference's decomposed run
  (its replicated map and gathered partners) within the bars above, with
  the bond energy and virial within 1e-5 relative.

The sharded solvent regroups the float32 cell sums of a collision across
its particle blocks, as the reference's does (``azplugins_tpu/simulation.py``
``_place_spatial``): the stream and the cell ids stay bitwise, velocities are
held within SOLVENT_BAR of max|v| (the reference documents ~1e-7 relative a
collision) of the whole run's and of the reference's decomposed run (which
shards the solvent's particle axis), and a sharded run on the CPU is
bitwise independent of the ``run`` chunking. A solvent whose size the mesh does not divide stays whole
and bitwise.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from torch_compile_cache import no_compile_cache  # noqa: E402, F401
from azplugins_tpu.core.state import state_from_snapshot as ref_state_from_snapshot  # noqa: E402
from azplugins_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from azplugins_tpu_torch.core.state import state_from_snapshot  # noqa: E402
from azplugins_tpu_torch.mpcd import _joined, _place_solvent  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.parallel import make_mesh, shard_dense  # noqa: E402
from azplugins_tpu_torch.parallel.spatial import halo_runs  # noqa: E402

torch.set_num_threads(1)

SLABS = [14.5, 7.3, 7.3]  # dims (8, 4, 4) at r_list 1.8: one x plane a block of 8
CUBE = [7.3, 7.3, 7.3]  # dims (4, 4, 4): 8 blocks of two z columns
# a sharded solvent's velocities against the whole run's, of max|v|: the
# reference's ~1e-7 relative a collision, with room for a few collisions
SOLVENT_BAR = 1e-6


def _sharded(n):
    return make_mesh(n, device="cpu", sharded=True)


def _bits(a):
    a = np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_run(got, want):
    a, b = got.state.get_snapshot().particles, want.state.get_snapshot().particles
    for f in ("position", "velocity", "image", "typeid"):
        np.testing.assert_array_equal(_bits(getattr(a, f)), _bits(getattr(b, f)), err_msg=f)
    assert (got.timestep, got.n_builds, got.viol_replays) == (want.timestep, want.n_builds,
                                                               want.viol_replays)
    assert got._grid_spec == want._grid_spec


# ---------------------------------------------------------------------------
# The droplet's composition
# ---------------------------------------------------------------------------
def _droplet_sim(az, traj_path):
    """The reference's spatial droplet case (BASELINE config 5's
    composition on the 8-slab grid) in either package."""
    rng = np.random.default_rng(44)
    N = 500
    snap = az.Snapshot(N=N)
    snap.configuration.box = SLABS + [0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(SLABS)
    kw = {"device": "cpu"} if az is port else {}
    sim = az.Simulation(seed=11, **kw)
    sim.create_state_from_snapshot(snap)
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    pot.params[("solvent", "solvent")] = dict(epsilon=5.0)
    pot.params[("solvent", "evaporated")] = dict(epsilon=1.0)
    pot.params[("evaporated", "evaporated")] = dict(epsilon=0.0)
    barrier = az.external.PlanarHarmonicBarrier(
        location=az.variant.Ramp(A=3.0, B=2.0, t_start=0, t_ramp=100))
    barrier.params["solvent"] = dict(k=20.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(5), solvent_type="solvent",
        evaporated_type="evaporated", lo=1.0, hi=3.6, N_evap_max=4))
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)],
        forces=[pot, barrier])
    field = az.compute.CartesianVelocityFieldCompute(
        num_bins=[4, 0, 0], lower_bounds=[-SLABS[0] / 2, 0, 0],
        upper_bounds=[SLABS[0] / 2, 0, 0], filter=az.filter.All())
    sim.operations.computes.append(field)
    sim.operations += az.write.Trajectory(trigger=az.trigger.Periodic(10),
                                          filename=str(traj_path))
    sim.state.thermalize_particle_momenta(kT=0.8)
    return sim, field


@pytest.mark.usefixtures("no_compile_cache")
def test_droplet_on_shards(tmp_path):
    """8 shards, 40 steps: trajectory, typeids, the velocity field and the
    aztraj file's bytes equal the undecomposed run's; within the 20-step
    bars of the reference's run on its 8-device mesh, typeids equal."""
    want, want_field = _droplet_sim(port, tmp_path / "whole.azt")
    want.run(40)
    sim, field = _droplet_sim(port, tmp_path / "shards.azt")
    sim.enable_spatial_decomposition(_sharded(8))
    sim.run(40)
    assert isinstance(sim._dense, tuple) and len(sim._dense) == 8
    _assert_same_run(sim, want)
    got = sim.state.get_snapshot().particles
    assert (got.typeid == 1).sum() > 0  # the evaporator fired on shards
    np.testing.assert_array_equal(_bits(field.velocities), _bits(want_field.velocities))
    assert (tmp_path / "whole.azt").read_bytes() == (tmp_path / "shards.azt").read_bytes()

    rsim, _ = _droplet_sim(ref, tmp_path / "ref.azt")
    rsim.auto_tune_after = None  # 40 steps stop short of the tune anyway
    rsim.enable_spatial_decomposition(ref_make_mesh(8))
    rsim.run(40)
    rs = rsim.state.get_snapshot().particles
    np.testing.assert_array_equal(got.typeid, rs.typeid)
    np.testing.assert_array_equal(got.image, rs.image)
    np.testing.assert_allclose(got.position, rs.position, rtol=0, atol=1e-4)
    rv = rs.velocity
    np.testing.assert_allclose(got.velocity, rv, rtol=0, atol=1e-4 * np.abs(rv).max())


# ---------------------------------------------------------------------------
# Updaters on shards
# ---------------------------------------------------------------------------
def _slot_state(n_empty, seed=5, S=240, L=8.0):
    """S slots of a two-type state, ``n_empty`` of them empty (tag -1), in
    a (slot-order) State as the step loop holds it."""
    rng = np.random.default_rng(seed)
    snap = port.Snapshot(N=S)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = (rng.random((S, 3)) - 0.5) * L
    snap.particles.typeid[:] = rng.integers(0, 2, S)
    state, _, _ = state_from_snapshot(snap, "cpu")
    empty = torch.as_tensor(rng.permutation(S)[:n_empty])
    return state.replace(tag=state.tag.index_fill(0, empty, -1))


def _snap_of(state, az=port):
    """A snapshot of ``state``'s box and types, for attaching an updater."""
    snap = az.Snapshot(N=state.N)
    snap.configuration.box = [*state.box.L.tolist(), 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    return snap


@pytest.mark.parametrize("case", ["few_candidates", "many_candidates", "k_above_slots"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_evaporator_sharded_pick_is_the_whole_pick(case, n):
    """The pick on n shards and on one equals the reference's whole pick,
    bit for bit: fewer candidates than k, more than k, and k at least the
    slot count."""
    lo, hi, n_max, n_empty = {"few_candidates": (3.5, 3.9, 40, 30),
                              "many_candidates": (-3.0, 3.0, 7, 30),
                              "k_above_slots": (-3.0, 3.0, 10**6, 0)}[case]
    state = _slot_state(n_empty)
    evap = port.update.ParticleEvaporator(trigger=1, solvent_type="solvent",
                                          evaporated_type="evaporated", lo=lo, hi=hi,
                                          N_evap_max=n_max)
    host = port.Simulation(device="cpu", seed=3)
    host.create_state_from_snapshot(_snap_of(state))
    evap._attach(host)
    ref_evap = ref.update.ParticleEvaporator(trigger=1, solvent_type="solvent",
                                             evaporated_type="evaporated", lo=lo, hi=hi,
                                             N_evap_max=n_max)
    ref_host = ref.Simulation(seed=3)
    ref_host.create_state_from_snapshot(_snap_of(state, ref))
    ref_evap._attach(ref_host)
    snap = _snap_of(state, ref)
    snap.particles.position[:] = state.position.numpy()
    snap.particles.typeid[:] = state.typeid.numpy()
    ref_state = ref_state_from_snapshot(snap)[0]
    ref_state = ref_state.replace(tag=jnp.asarray(state.tag.numpy()))
    if case == "k_above_slots":
        assert evap._k >= state.N
    for t in (0, 35, 120):
        want = np.asarray(ref_evap._update(ref_state, t, 3).typeid)
        whole = evap._update(state, t, 3).typeid
        shards = evap._update_shards(shard_dense(state, _sharded(n)), t, 3)
        got = torch.cat([s.typeid for s in shards])
        np.testing.assert_array_equal(whole.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), want)
        flipped = int((whole != state.typeid).sum())
        cand = int(((state.typeid == 0) & (state.position[:, 2] >= lo)
                    & (state.position[:, 2] < hi)).sum())
        assert flipped == min(cand, evap._k) > 0


def _two_type_sim(L, seed, n_shards=None, N=400):
    """A two-type Hertz fluid whose types a TypeUpdater flips by z every 3
    steps, whole or on ``n_shards`` shards."""
    rng = np.random.default_rng(seed)
    snap = port.Snapshot(N=N)
    snap.configuration.box = list(L) + [0, 0, 0]
    snap.particles.types = ["A", "B"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    sim = port.Simulation(device="cpu", seed=seed)
    sim.create_state_from_snapshot(snap)
    pot = port.pair.Hertz(nlist=port.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    for pair in (("A", "A"), ("A", "B"), ("B", "B")):
        pot.params[pair] = dict(epsilon=5.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.002, methods=[port.md.methods.Langevin(kT=0.8, default_gamma=1.0)], forces=[pot])
    sim.operations.updaters.append(port.update.TypeUpdater(
        trigger=port.trigger.Periodic(3), inside_type="A", outside_type="B", lo=-1.0, hi=2.0))
    sim.state.thermalize_particle_momenta(kT=0.8)
    if n_shards is not None:
        sim.enable_spatial_decomposition(_sharded(n_shards))
    return sim


@pytest.mark.parametrize("L,n", [(SLABS, 8), (CUBE, 8)], ids=["slabs", "strips"])
def test_type_updater_on_shards(L, n):
    """A TypeUpdater once a shard: bitwise the undecomposed run."""
    want = _two_type_sim(L, 17)
    want.run(20)
    sim = _two_type_sim(L, 17, n)
    sim.run(20)
    assert isinstance(sim._dense, tuple) and len(sim._dense) == n
    _assert_same_run(sim, want)
    assert len(set(sim.state.get_snapshot().particles.typeid.tolist())) == 2


# ---------------------------------------------------------------------------
# Bonds on shards
# ---------------------------------------------------------------------------
# the long bond along x, from 1.5 into the first x plane: longer than the
# halo window reaches on each box, shorter than half the edge
LONG_BOND = {SLABS[0]: 6.2, CUBE[0]: 3.3}


def _melt_sim(L, n_shards=None, chain=8, n_chains=40, seed=23, kT=1.0, az=port):
    """Harmonic chains in a Hertz fluid, one extra bond along x between the
    first beads of the first two chains (its partners lie in shards beyond
    each other's halo window), in either package."""
    rng = np.random.default_rng(seed)
    N = chain * n_chains
    start = (rng.random((n_chains, 3)) - 0.5) * np.asarray(L)
    start[0] = [-L[0] / 2 + 1.5, 0.0, 0.0]
    start[1] = [-L[0] / 2 + 1.5 + LONG_BOND[L[0]], 0.0, 0.5]
    steps = rng.normal(0, 1, (n_chains, chain, 3))
    steps *= 0.9 / np.linalg.norm(steps, axis=-1, keepdims=True)
    steps[:, 0] = 0.0
    pos = (start[:, None, :] + np.cumsum(steps, axis=1)).reshape(-1, 3)
    first = (np.arange(n_chains)[:, None] * chain + np.arange(chain - 1)[None, :]).reshape(-1)
    groups = np.concatenate([np.stack([first, first + 1], axis=-1), [[0, chain]]])
    snap = az.Snapshot(N=N, bond_N=len(groups))
    snap.configuration.box = list(L) + [0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = pos - np.asarray(L) * np.round(pos / np.asarray(L))
    snap.bonds.types = ["backbone", "long"]
    snap.bonds.group[:] = groups
    snap.bonds.typeid[:] = [0] * len(first) + [1]
    sim = az.Simulation(seed=seed, **({"device": "cpu"} if az is port else {}))
    sim.create_state_from_snapshot(snap)
    bonds = az.bond.Harmonic()
    bonds.params["backbone"] = dict(k=50.0, r0=0.9)
    bonds.params["long"] = dict(k=5.0, r0=LONG_BOND[L[0]])
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    pot.params[("A", "A")] = dict(epsilon=2.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=kT, default_gamma=1.0)],
        forces=[bonds, pot])
    sim.state.thermalize_particle_momenta(kT=kT)
    if n_shards is not None:
        sim.enable_spatial_decomposition(_sharded(n_shards) if az is port
                                         else ref_make_mesh(n_shards))
    return sim, bonds


def _shard_of_tags(sim):
    S_loc = sim._dense[0].N
    return (sim._meta[0].slot_of // S_loc).numpy()


@pytest.mark.parametrize("L,n", [(SLABS, 8), (CUBE, 8), (SLABS, 3)],
                         ids=["slabs", "strips", "snapped_strips"])
def test_bonds_on_shards(L, n, monkeypatch):
    """A melt through rebuilds and migrations: the trajectory, the global
    tag->slot map on every shard (D.rebin's, from the undecomposed run) and
    the bond energy, virial and forces equal the undecomposed run's; the
    long bond's partners lie in shards beyond each other's halo window."""
    if n == 3:  # the undecomposed run on the grid a mesh of 3 snaps to
        orig = PD.GridSpec.create.__func__
        monkeypatch.setattr(PD.GridSpec, "create", classmethod(
            lambda cls, box, N, r_cut, buffer, strip_devices=1: orig(cls, box, N, r_cut,
                                                                     buffer, 3)))
    want, want_bonds = _melt_sim(L)
    want.run(60)
    monkeypatch.undo()
    sim, bonds = _melt_sim(L, n)
    sim.run(0)
    shard0 = _shard_of_tags(sim)
    spec = sim._grid_spec
    Dx, Dy, _ = spec.dims
    w0, n_cols, _ = halo_runs(tuple(spec.dims), n, int(shard0[0]))
    window_planes = {((w0 + k) % (Dx * Dy)) // Dy for k in range(n_cols)}
    x = sim.state.get_snapshot().particles.position[8, 0]
    assert int((x / L[0] + 0.5) * Dx) not in window_planes  # the long bond's partner
    sim.run(60)
    assert isinstance(sim._dense, tuple) and sim.n_builds > 3
    assert (_shard_of_tags(sim) != shard0).any()  # particles migrated
    _assert_same_run(sim, want)
    for m in sim._meta:
        np.testing.assert_array_equal(m.slot_of.numpy(), want._meta.slot_of.numpy())
    for name in ("forces", "energies", "virials"):
        np.testing.assert_array_equal(_bits(getattr(bonds, name)),
                                      _bits(getattr(want_bonds, name)), err_msg=name)
    assert bonds.energy == want_bonds.energy


@pytest.mark.usefixtures("no_compile_cache")
@pytest.mark.parametrize("L", [SLABS, CUBE], ids=["slabs", "strips"])
def test_bonds_on_shards_match_reference(L):
    """The melt on 8 shards against the reference's run on its 8-device
    mesh (which keeps the tag->slot map replicated and gathers the
    partners): within the 20-step bars of ``test_torch_spatial_sharded.py``
    after 40 steps (positions 1e-4, velocities 1e-4 of max|v|), images
    equal, and the bond energy and virial within 1e-5 relative."""
    sim, bonds = _melt_sim(L, 8)
    sim.run(40)
    rsim, rbonds = _melt_sim(L, 8, az=ref)
    rsim.auto_tune_after = None
    rsim.run(40)
    ps, rs = sim.state.get_snapshot().particles, rsim.state.get_snapshot().particles
    np.testing.assert_array_equal(ps.image, rs.image)
    np.testing.assert_allclose(ps.position, rs.position, rtol=0, atol=1e-4)
    rv = rs.velocity
    np.testing.assert_allclose(ps.velocity, rv, rtol=0, atol=1e-4 * np.abs(rv).max())
    assert sim.n_builds == int(rsim._meta.n_builds) > 1
    np.testing.assert_allclose(bonds.energy, rbonds.energy, rtol=1e-5)
    got, want = np.asarray(bonds.virials).sum(axis=0), np.asarray(rbonds.virials).sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_bond_force_reads_partners_across_shards():
    """dense_bond_force on each shard, reading every slot's position, gives
    the whole layout's force, energy and virial on the shard's own rows."""
    sim, bonds = _melt_sim(SLABS)
    sim.run(0)
    dense, meta = sim._dense, sim._meta
    tbl = bonds._device_tables("cpu")
    whole = PD.dense_bond_force(bonds._def.energy_force, dense, meta.slot_of, tbl["group"],
                                tbl["params"])
    shards = shard_dense(dense, _sharded(4))
    first = 0
    for s in shards:
        got = PD.dense_bond_force(bonds._def.energy_force, s, meta.slot_of, tbl["group"],
                                  tbl["params"], positions=dense.position, first=first)
        for k in ("force", "energy", "virial"):
            np.testing.assert_array_equal(_bits(getattr(got, k)),
                                          _bits(getattr(whole, k)[first:first + s.N]))
        first += s.N


# ---------------------------------------------------------------------------
# The MPCD solvent on shards
# ---------------------------------------------------------------------------
def _srd_arrays(N=4096, L=8.0, seed=3):
    rng = np.random.default_rng(seed)
    pos = (rng.random((N, 3)).astype(np.float32) - 0.5) * L
    vel = rng.normal(0, 1.0, (N, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    return torch.as_tensor(pos), torch.as_tensor(vel)


@pytest.mark.usefixtures("no_compile_cache")
def test_srd_solvent_in_blocks():
    """The reference's sharded-advance case on 8 blocks: the stream and the
    cell ids bitwise, the velocities after two collisions within
    SOLVENT_BAR of max|v| of the whole advance's and of the reference's on
    its 8-device mesh, momentum conserved, the output still in blocks."""
    box = port.Box.cube(8.0)
    pos, vel = _srd_arrays()
    whole_srd = port.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0)
    want = whole_srd._advance({"position": (pos,), "velocity": (vel,), "mass": 1.0}, box, 0,
                              10, 11)
    srd = port.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0)
    cpu8 = (torch.device("cpu"),) * 8
    blocks = _place_solvent({"position": (pos,), "velocity": (vel,), "mass": 1.0}, "cpu", cpu8)
    got = srd._advance(blocks, box, 0, 10, 11)
    assert len(got["velocity"]) == 8
    assert len(got["_srd_anchor"][0]) == 8

    srd._ensure_built(box, 11)
    x_b, v_b = srd._stream(blocks["position"], blocks["velocity"], 7, srd._L)
    (x_w,), (v_w,) = srd._stream((pos,), (vel,), 7, srd._L)
    np.testing.assert_array_equal(_bits(_joined(x_b, "cpu")), _bits(x_w))
    np.testing.assert_array_equal(_bits(_joined(v_b, "cpu")), _bits(v_w))
    shift = np.asarray([0.25, 0.5, 0.75], np.float32)
    np.testing.assert_array_equal(torch.cat([srd._cell_ids(x, shift) for x in x_b]).numpy(),
                                  srd._cell_ids(x_w, shift).numpy())

    v_got, v_want = _joined(got["velocity"], "cpu").numpy(), _joined(want["velocity"], "cpu").numpy()
    bar = SOLVENT_BAR * np.abs(v_want).max()
    np.testing.assert_allclose(v_got, v_want, rtol=0, atol=bar)
    assert not np.array_equal(v_got, vel.numpy())
    np.testing.assert_allclose(_joined(got["position"], "cpu").numpy(),
                               _joined(want["position"], "cpu").numpy(), rtol=0, atol=1e-6 * 8.0)
    np.testing.assert_allclose(v_got.astype(np.float64).sum(axis=0),
                               vel.numpy().astype(np.float64).sum(axis=0), atol=2e-2)

    on_mesh = NamedSharding(ref_make_mesh(8), PartitionSpec("d"))
    ref_srd = ref.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0)
    ref_out = ref_srd._advance({"position": jax.device_put(pos.numpy(), on_mesh),
                                "velocity": jax.device_put(vel.numpy(), on_mesh), "mass": 1.0},
                               ref.Box.cube(8.0), 0, 10, 11)
    assert not ref_out["velocity"].sharding.is_fully_replicated
    v_ref = np.asarray(ref_out["velocity"])
    np.testing.assert_allclose(v_got, v_ref, rtol=0, atol=SOLVENT_BAR * np.abs(v_ref).max())
    np.testing.assert_allclose(_joined(got["position"], "cpu").numpy(),
                               np.asarray(ref_out["position"]), rtol=0, atol=1e-6 * 8.0)


def _solvent_sim(N_s=4096, coupled=False, n_shards=None, N=600, seed=5, az=port):
    """Hertz solutes in an SRD solvent on the 8-slab box (the reference's
    sharded-solvent case), coupled to the solutes every 10 steps or not, in
    either package."""
    rng = np.random.default_rng(seed)
    L = [14.6, 7.3, 7.3]
    snap = az.Snapshot(N=N, mpcd_N=N_s)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * np.asarray(L)
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    sim = az.Simulation(seed=7, **({"device": "cpu"} if az is port else {}))
    sim.create_state_from_snapshot(snap)
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    pot.params[("A", "A")] = dict(epsilon=5.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)], forces=[pot])
    srd = az.mpcd.SRD(dt=0.002, period=10 if coupled else 5, angle=130.0,
                      cell_size=7.3 / 8, kT=0.8)
    sim.mpcd_dynamics = srd
    if coupled:
        sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    if n_shards is not None:
        sim.enable_spatial_decomposition(_sharded(n_shards) if az is port
                                         else ref_make_mesh(n_shards))
    return sim


def _solvent_close(got, want):
    """The solvent's and the solutes' velocities within SOLVENT_BAR of
    max|v|, positions within the bar times a step's drift."""
    g, w = got.state.get_snapshot(), want.state.get_snapshot()
    for part in ("mpcd", "particles"):
        gv, wv = getattr(g, part).velocity, getattr(w, part).velocity
        np.testing.assert_allclose(gv, wv, rtol=0, atol=SOLVENT_BAR * np.abs(wv).max(),
                                   err_msg=part)
        np.testing.assert_allclose(getattr(g, part).position, getattr(w, part).position,
                                   rtol=0, atol=1e-6, err_msg=part)


def test_simulation_places_the_solvent_in_blocks():
    """The reference's sharded-solvent simulation: the stream in 8 blocks
    through the run, advanced through two collisions; the solutes (which
    it does not touch) bitwise, the solvent within the bar; joining the
    mesh back puts it whole."""
    want = _solvent_sim()
    want.run(12)
    sim = _solvent_sim(n_shards=8)
    sim.run(12)
    assert len(sim._mpcd["position"]) == len(sim._mpcd["_srd_anchor"][1]) == 8
    assert sim._mpcd["_srd_anchor"][2] == 10
    _assert_same_run(sim, want)
    _solvent_close(sim, want)
    sim.enable_spatial_decomposition(make_mesh(8, device="cpu"))  # views: whole again
    assert len(sim._mpcd["position"]) == len(sim._mpcd["_srd_anchor"][0]) == 1


def test_solvent_the_mesh_does_not_divide_stays_whole():
    """4,095 solvent particles on 8 shards stay whole: bitwise the
    undecomposed run, coupled to the sharded solutes."""
    want = _solvent_sim(N_s=4095, coupled=True)
    want.run(12)
    sim = _solvent_sim(N_s=4095, coupled=True, n_shards=8)
    sim.run(12)
    assert isinstance(sim._dense, tuple)
    assert len(sim._mpcd["position"]) == 1
    _assert_same_run(sim, want)
    g, w = sim.state.get_snapshot().mpcd, want.state.get_snapshot().mpcd
    np.testing.assert_array_equal(_bits(g.position), _bits(w.position))
    np.testing.assert_array_equal(_bits(g.velocity), _bits(w.velocity))


@pytest.mark.parametrize("coupled", [False, True], ids=["srd", "coupled"])
def test_sharded_solvent_within_the_bar_and_chunking_invariant(coupled):
    """The solvent on 8 shards, uncoupled or coupled to the solutes every
    10 steps, through two collisions: within the bar of the whole run; and
    bitwise the same whatever the run() chunking."""
    want = _solvent_sim(coupled=coupled)
    want.run(22)
    sim = _solvent_sim(coupled=coupled, n_shards=8)
    sim.run(22)
    assert sim._mpcd["_srd_anchor"][2] == 20
    _solvent_close(sim, want)
    split = _solvent_sim(coupled=coupled, n_shards=8)
    for n in (3, 8, 11):
        split.run(n)
    a, b = split.state.get_snapshot(), sim.state.get_snapshot()
    for part in ("mpcd", "particles"):
        for f in ("position", "velocity"):
            np.testing.assert_array_equal(_bits(getattr(getattr(a, part), f)),
                                          _bits(getattr(getattr(b, part), f)),
                                          err_msg=f"{part} {f}")


@pytest.mark.usefixtures("no_compile_cache")
@pytest.mark.parametrize("coupled", [False, True], ids=["srd", "coupled"])
def test_sharded_solvent_matches_reference(coupled):
    """The solvent on 8 shards, uncoupled or coupled, through two
    collisions, against the reference's run on its 8-device mesh (which
    shards the solvent's particle axis): the solvent's and the solutes'
    velocities within SOLVENT_BAR of max|v|, positions within 1e-6."""
    sim = _solvent_sim(coupled=coupled, n_shards=8)
    sim.run(22)
    rsim = _solvent_sim(coupled=coupled, n_shards=8, az=ref)
    rsim.auto_tune_after = None
    rsim.run(22)
    assert int(rsim._mpcd["_srd_anchor"][2]) == sim._mpcd["_srd_anchor"][2] == 20
    assert len(sim._mpcd["position"]) == 8
    assert not rsim._mpcd["velocity"].sharding.is_fully_replicated
    _solvent_close(sim, rsim)
