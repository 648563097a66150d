"""The rebuild segments of a sharded mesh on one device as CUDA graphs, on
the CPU.

A mesh whose blocks all lie on one device (``make_mesh(n, device=...,
sharded=True)``) runs on the segment graphs (``graph.SegmentGraphs``: one
buffer State and one GridMeta a shard) and its uncoupled solvent's advance
on the advance graphs (``graph.AdvanceGraphs``: an anchor and an
observable pair a block). Here the graphs are ``test_torch_graph.py``'s
stand-in capture (``FakeCapture``), which records and replays as a CUDA
capture does.

Checked: graph runs on 2 and 4 shards, in slabs and in strips, bitwise the
eager run on the same shards and the whole run (the headline's PLJ liquid,
the droplet with its SphereArea barrier, wall and evaporator masked every
step, the polymer melt with its bonds across shards); the coupled colloids
on 2 solvent blocks and an uncoupled SRD stream beside a 2-shard layout
bitwise their eager runs on the same blocks; no host read inside a sharded
segment (masked updaters, bonds, the joint collision on blocks) or its
capture and replays; the counters exact under replay (n pair launches a
force evaluation, the pick's two launches a step on the graphs and a fire
eagerly); a chunk thrown away after an overflow or a drift violation
replayed bitwise; a mesh swapped mid-run drops the runner; the masked pick
over shards the fired pick where it fires and nothing elsewhere; the bond
partners joined once a device; and graph runs on shards within the 20-step
bars of the JAX reference's sharded run (its XLA path).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from azplugins_tpu_torch import simulation as S  # noqa: E402
from azplugins_tpu_torch.core import rng as RNG  # noqa: E402
from azplugins_tpu_torch.graph import Steps  # noqa: E402
from azplugins_tpu_torch.ops import pair_kernel as PK  # noqa: E402
from azplugins_tpu_torch.ops import pick_kernel as XK  # noqa: E402
from azplugins_tpu_torch.parallel import make_mesh  # noqa: E402
from test_torch_graph import (  # noqa: E402
    FakeCapture, _assert_same, _build, _coupled, _inject, _same_stream, _snap, _solvent,
    no_host_reads,
)

torch.set_num_threads(1)


def _sharded(n):
    return make_mesh(n, device="cpu", sharded=True)


def _liquid(az):
    """The headline's path (PLJ under Langevin) on a 17.55 x 5.85 x 5.85 box:
    a (6, 2, 2) grid at r_list 2.9, so 2 shards are slabs of 3 x planes and
    4 shards strips of 3 z columns."""
    from test_torch_graph import _simulation

    rng = np.random.default_rng(5)
    a, counts = 1.17, (15, 5, 5)
    L = [a * c for c in counts]
    snap = az.Snapshot(N=int(np.prod(counts)))
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A"]
    axes = [(np.arange(c) + 0.5) * a - l / 2 for c, l in zip(counts, L)]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-0.05, 0.05, pos.shape)
    sim = _simulation(az, snap, 42)
    f = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5,
                                      mode="shift")
    f.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.7)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.Langevin(kT=1.2, default_gamma=0.5)], forces=[f])
    sim.state.thermalize_particle_momenta(kT=1.2)
    return sim


def _system(name, n=None, graphs=False, az=port):
    """A small system of a sharded path, whole (``n`` None) or on ``n``
    shards of the CPU, on the stand-in graphs when ``graphs``."""
    sim = _liquid(az) if name == "liquid" else _build(az, name)
    if n is not None:
        sim.enable_spatial_decomposition(_sharded(n) if az is port else ref_make_mesh(n))
    if graphs:
        sim._capture = FakeCapture()
    return sim


def _whole_bits(sim):
    """A run's slot layout joined in block order (a whole run's as it is)."""
    return sim._whole_dense()


# (path, shards): the kind of blocks each gives
LAYOUTS = [("liquid", 2), ("liquid", 4), ("droplet", 2), ("droplet", 4), ("polymer", 2),
           ("polymer", 4)]


def _kind(sim) -> str:
    n = sim._spatial_mesh.size
    return "slabs" if sim._grid_spec.dims[0] % n == 0 else "strips"


@pytest.mark.parametrize("name,n", LAYOUTS, ids=[f"{p}-{n}" for p, n in LAYOUTS])
def test_sharded_graphs_are_the_eager_and_the_whole_run(name, n):
    """Two stretches of 20 steps: the graph run on n shards (its second
    segment of a shape captured, the rest replayed) is bitwise the eager run
    on the same shards, shard by shard, and the whole run in block order
    (typeids too: the droplet's evaporator masked every step on the graphs,
    fired from the host eagerly), with the same steps and force
    evaluations."""
    whole = _system(name)
    eager, graphs = _system(name, n), _system(name, n, graphs=True)
    for _ in range(2):
        for sim in (whole, eager, graphs):
            sim.run(20)
        _assert_same(graphs._dense, eager._dense, f"{name} on {n}: graphs against eager")
        _assert_same(graphs._meta, eager._meta, f"{name} on {n}: meta")
        _assert_same(_whole_bits(graphs), whole._dense, f"{name} on {n}: against the whole run")
        assert (graphs.steps_run, graphs.force_evaluations, graphs.timestep) == (
            eager.steps_run, eager.force_evaluations, eager.timestep)
    runner = graphs._runner
    assert graphs._graphs_apply() and eager._runner is None
    assert isinstance(graphs._dense, tuple) and len(runner.shards) == n
    assert runner.captures >= 1 and runner.replays >= 2
    assert runner.key[-1] == ("mesh", n, _kind(graphs), (graphs._grid_spec.S // n,) * n)
    if name == "liquid":
        assert _kind(graphs) == ("slabs" if n == 2 else "strips")
    if name == "droplet":
        assert int((_snap(graphs)["typeid"] == 1).sum()) >= 40  # 10 a fire while they last


@pytest.mark.parametrize("name,n", [("liquid", 4), ("droplet", 2)],
                         ids=["liquid-4", "droplet-2"])
def test_sharded_graphs_match_reference(name, n):
    """20 steps on n shards on the stand-in graphs (a segment replayed)
    within the 20-step bars of the JAX reference's run on its n-device
    mesh (1e-4 in position, 1e-4 of max|v| in velocity), images and
    typeids equal."""
    rsim = _system(name, n, az=ref)
    rsim.auto_tune_after = None
    psim = _system(name, n, graphs=True)
    for sim in (rsim, psim):
        sim.run(20)
    assert psim._runner.replays >= 1
    r, p = _snap(rsim), _snap(psim)
    np.testing.assert_array_equal(p["image"], r["image"])
    np.testing.assert_array_equal(p["typeid"], r["typeid"])
    np.testing.assert_allclose(p["position"], r["position"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p["velocity"], r["velocity"], rtol=0,
                               atol=1e-4 * np.abs(r["velocity"]).max())


def _coupled_blocks(graphs):
    sim = _coupled(port)
    sim.enable_spatial_decomposition(_sharded(2))
    sim._capture, sim._eager = FakeCapture(), not graphs
    return sim


def test_coupled_colloids_on_solvent_blocks():
    """Colloid hydrodynamics on 2 shards, its solvent in 2 blocks: the
    joint collision inside the segment graphs (an anchor pair a block in
    the buffers, the blocks' partial cell sums in block order) is bitwise
    the eager loop on the same blocks over uneven chunks: colloids,
    solvent and anchor."""
    eager, graphs = _coupled_blocks(False), _coupled_blocks(True)
    for n in (7, 13, 25, 9, 31):
        for sim in (eager, graphs):
            sim.run(n)
        _assert_same(graphs._dense, eager._dense, f"after {graphs.timestep} steps")
        _same_stream(graphs, eager, f"after {graphs.timestep} steps")
    assert len(graphs._mpcd["position"]) == 2 and len(graphs._dense) == 2
    runner = graphs._runner
    assert graphs._graphs_apply() and runner.replays >= 3
    assert [p.shape for p in runner.pos_a] == [(600, 3), (600, 3)]
    assert any(len(k) == 3 for k in runner.graph_keys())


def _srd_beside_shards(graphs):
    sim = _solvent(port, "plates")
    f = port.pair.Hertz(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=1.5)
    f.params[("A", "A")] = dict(epsilon=1.0)
    sim.operations.integrator.forces = [f]
    sim.enable_spatial_decomposition(_sharded(2))
    sim._capture, sim._eager = FakeCapture(), not graphs
    return sim


def test_srd_beside_shards_on_the_advance_graphs():
    """An uncoupled SRD stream (plates, a body force) in 2 blocks beside a
    2-shard layout: its advance on the advance graphs (a collision a graph,
    the blocks' partial sums in block order) and the layout on the segment
    graphs are bitwise their eager runs on the same blocks, over uneven
    chunks."""
    eager, graphs = _srd_beside_shards(False), _srd_beside_shards(True)
    for n in (17, 6, 23):
        for sim in (eager, graphs):
            sim.run(n)
        _same_stream(graphs, eager, f"after {graphs.timestep} steps")
        _assert_same(graphs._dense, eager._dense, f"after {graphs.timestep} steps")
    adv = graphs._advance_graphs
    assert graphs._advance_graphs_apply() and not eager._advance_graphs_apply()
    assert len(adv.pos_a) == 2 and adv.replays >= 2 and adv.captures >= 1
    assert graphs._runner is not None and graphs._runner.replays >= 1


@pytest.mark.parametrize("name", ["liquid", "droplet", "polymer", "colloids"])
def test_sharded_segment_makes_no_host_read(name):
    """A segment on 2 shards, with a rebuild and without, with the host's
    timestep and under the device clock, with the graphs' schedule (the
    updaters masked on every shard), the joint collision on 2 solvent
    blocks (colloids), and a stand-in capture and replays of it, read
    nothing on the host."""
    sim = _coupled_blocks(True) if name == "colloids" else _system(name, 2, graphs=True)
    sim.run(20 if name == "colloids" else 3)
    tbls = sim._force_tables()
    t = sim.timestep
    clock = torch.tensor(t, dtype=torch.int64)
    values, masks = sim._variant_values(t, 10), sim._trigger_masks(t, 10)
    masked = Steps(t, None if values is None else torch.from_numpy(values),
                   None if masks is None else torch.from_numpy(masks), graph=True)
    solv = sim._mpcd["_srd_anchor"] if name == "colloids" else None
    n_steps = 10 if name == "colloids" else 2
    shards, metas = sim._dense, sim._meta
    with no_host_reads():
        for rebuild in (True, False):
            viol = torch.zeros((), dtype=torch.bool)
            sim._run_segment(shards, metas, viol, t, n_steps, rebuild, tbls, solv)
            with RNG.device_clock(clock, t):
                sim._run_segment(shards, metas, viol, t, n_steps, rebuild, tbls, solv,
                                 steps=masked)
    runner = sim._build_runner(tbls)
    assert runner is sim._runner and len(runner.shards) == 2
    replays = runner.replays
    lead = n_steps if name == "colloids" else None
    with no_host_reads():
        runner.load(shards, metas, t, values, masks, None if solv is None else solv[:2])
        for k in range(3):
            runner.run(t + n_steps * k, n_steps, True, lead)
        runner.result()
        if solv is not None:
            runner.anchor()
    assert runner.replays >= replays + 2


def test_sharded_counters_under_replay(monkeypatch):
    """Under replay the droplet on 4 shards counts what the eager loop
    counts: a pair launch a shard a force evaluation, and the pick over
    every shard two launches a step on the graphs (masked), a fire eagerly
    (the kernels stand in on the CPU as counting wrappers of the plain
    versions), every step and force evaluation."""
    evaluate, pick = S.Simulation._evaluate, port.update.ParticleEvaporator._pick

    def counted_evaluate(self, f, *args, **kwargs):
        if f._needs_nlist:
            PK.launches += 1
        return evaluate(self, f, *args, **kwargs)

    def counted_pick(self, *args, **kwargs):
        XK.launches += 2
        return pick(self, *args, **kwargs)

    # counted into copies, which teardown drops: other tests read the counts
    monkeypatch.setattr(PK, "launches", PK.launches)
    monkeypatch.setattr(XK, "launches", XK.launches)
    monkeypatch.setattr(S.Simulation, "_evaluate", counted_evaluate)
    monkeypatch.setattr(port.update.ParticleEvaporator, "_pick", counted_pick)
    counted = {}
    for graphs in (False, True):
        sim = _system("droplet", 4, graphs=graphs)
        pk, xk = PK.launches, XK.launches
        sim.run(20)
        sim.run(25)
        counted[graphs] = (sim, PK.launches - pk, XK.launches - xk)
    (eager, e_pk, e_xk), (graphs, g_pk, g_xk) = counted[False], counted[True]
    assert graphs._runner.replays >= 3
    assert (graphs.steps_run, graphs.force_evaluations) == (eager.steps_run,
                                                            eager.force_evaluations)
    evals = graphs.force_evaluations // 3  # a PLJ, a barrier and a wall
    assert e_pk == g_pk == 4 * evals and evals >= 45
    assert g_xk == 2 * graphs.steps_run and e_xk == 2 * 9  # fires after 0, 5, ..., 40
    _assert_same(graphs._dense, eager._dense, "counted runs")


@pytest.mark.parametrize("which", ["violation", "overflow"])
def test_sharded_rollback_is_bitwise(which):
    """A chunk on 2 shards thrown away after it ran (a drift violation,
    replayed at a lower interval; an overflow, replayed one rebuild a
    chunk) starts again from the shards the simulation holds: on the graphs
    bitwise the eager run through the same replay, and after an overflow
    bitwise a run without it."""
    runs = {}
    for graphs in (False, True):
        for replayed in (False, True):
            sim = _system("liquid", 2, graphs=graphs)
            sim.run(20)
            done = _inject(sim, 20, which) if replayed else None
            sim.run(30)
            if replayed:
                assert done == [20]
                assert sim.viol_replays == (1 if which == "violation" else 0)
            runs[graphs, replayed] = sim
    _assert_same(runs[True, True]._dense, runs[False, True]._dense, "replayed: graphs")
    if which == "overflow":
        _assert_same(runs[True, True]._dense, runs[False, False]._dense, "against no replay")
    _assert_same(runs[True, False]._dense, runs[False, False]._dense, "not replayed: graphs")
    assert runs[True, True]._runner.replays >= 2
    assert runs[True, True].steps_run > runs[True, False].steps_run


def test_a_mesh_swapped_midrun_drops_the_runner():
    """A 2-shard graph run swapped onto 4 shards mid-run, then joined back
    (a whole layout): each change drops the runner, the next run binds
    one of the new layout's shards, and the run stays the whole run's,
    bitwise."""
    whole = _system("liquid")
    sim = _system("liquid", 2, graphs=True)
    for s in (whole, sim):
        s.run(20)
    first = sim._runner
    assert len(first.shards) == 2
    sim.enable_spatial_decomposition(_sharded(4))
    assert sim._runner is None
    for s in (whole, sim):
        s.run(20)
    assert sim._runner is not first and len(sim._runner.shards) == 4
    _assert_same(_whole_bits(sim), whole._dense, "on 4 shards")
    sim.enable_spatial_decomposition(make_mesh(1, device="cpu"))
    assert sim._runner is None
    for s in (whole, sim):
        s.run(20)
    assert len(sim._runner.shards) == 1 and not isinstance(sim._dense, tuple)
    _assert_same(sim._dense, whole._dense, "joined back")


@pytest.mark.parametrize("fire", [True, False])
def test_masked_pick_on_shards_is_the_fired_pick(fire):
    """The evaporator's masked form over 4 shards (one pick over every
    shard, in each shard's typeid in place) flips what its host-fired form
    flips where the trigger's bool is set, and nothing where it is not."""
    sim = _system("droplet", 4)
    sim.run(6)
    evap = sim.operations.updaters[0]
    shards, t = sim._dense, sim.timestep
    own = tuple(s.replace(typeid=s.typeid.clone()) for s in shards)
    got = evap._update_masked_shards(own, torch.tensor(fire), t, sim.seed)
    want = evap._update_shards(shards, t, sim.seed) if fire else shards
    assert all(g is o for g, o in zip(got, own))
    _assert_same(got, want, "masked pick")
    flipped = sum(int((w.typeid != s.typeid).sum()) for w, s in zip(want, shards))
    assert flipped == (10 if fire else 0)


def test_partners_join_once_a_device(monkeypatch):
    """The bond partners of 4 shards on one device are one join of every
    shard's positions (one ``cat`` a step), shared by every shard, each with
    its first global slot."""
    sim = _system("polymer", 4)
    sim.run(2)
    shards = sim._dense
    cats = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1) or cat(*a, **k))
    partners = sim._partners(shards)
    monkeypatch.undo()
    assert len(cats) == 1
    assert all(p is partners[0][0] for p, _ in partners)
    assert [first for _, first in partners] == [d * shards[0].N for d in range(4)]
    assert torch.equal(partners[0][0], torch.cat([s.position for s in shards]))

