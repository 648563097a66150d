"""The run loop's tracer (``azplugins_tpu_torch/trace.py``): host spans,
counters and device phase marks.

On the CPU the segment graphs are a stand-in capture (``FakeCapture``, as
``test_torch_graph.py``'s), and a mark is its count alone. Checked: the
trajectory is bitwise the same with the tracer off, with spans on and with
marks on, on the graphs and on the eager loop; spans nest ``az.run`` >
``az.chunk`` > ``az.segment.*`` and count the cache's first sights,
captures and replays; the marks' counts by phase are exact under replay;
evictions and recaptures at a bound of two graphs; chunk ends by reason
and the steps thrown away; runner builds by cause; with the tracer off
the graph keys are today's and nothing is recorded. On the card (``-m
cuda``, ``--noconftest``): marks on against off, bitwise, on the segment
graphs of the benchmark's two configurations at a small size.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu_torch import trace as T  # noqa: E402
from azplugins_tpu_torch.graph import Counters, SegmentGraphs  # noqa: E402

torch.set_num_threads(1)

STEP_PHASES = ("integrate_step1", "verlet_drift_check", "force.LJ", "integrate_step2")


class FakeCapture:
    """Records a segment as a CUDA capture does: its Python runs (the
    runner takes its counters back) and its buffers stay as they were; a
    replay does the segment's tensor work with its Python counters held."""

    def __call__(self, runner, fn):
        saved = [b.clone() for b in runner.buffers()]
        fn()
        for b, v in zip(runner.buffers(), saved, strict=True):
            b.copy_(v)

        class Graph:
            def replay(self):
                before = runner._counters.read()
                fn()
                runner._counters.restore(before)

        return Graph()


def _fluid(evaporate=True, loop="graphs", kT=1.2, buffer=0.4):
    """A 512-particle LJ liquid under Langevin; with ``evaporate``, an
    evaporator that retypes a few particles every 5 steps; on the stand-in
    graphs (``loop="graphs"``) or the eager loop."""
    rng = np.random.default_rng(3)
    n, a = 8, 1.15
    snap = port.Snapshot(N=n**3)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A", "B"]
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-0.1, 0.1, pos.shape)
    sim = port.Simulation(device="cpu", seed=42)
    sim.create_state_from_snapshot(snap)
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=buffer), default_r_cut=2.5, mode="shift")
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    lj.params[("A", "B")] = dict(epsilon=0.5, sigma=1.0)
    lj.params[("B", "B")] = dict(epsilon=0.5, sigma=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=kT, default_gamma=0.5)], forces=[lj])
    if evaporate:
        sim.operations.updaters.append(port.update.ParticleEvaporator(
            trigger=port.trigger.Periodic(5), solvent_type="A", evaporated_type="B",
            lo=2.0, hi=L / 2 - 0.01, N_evap_max=3))
    sim.state.thermalize_particle_momenta(kT=kT)
    sim._capture = FakeCapture()
    sim._eager = loop == "eager"
    return sim


def _same(a, b, what):
    sa, sb = a.state.get_snapshot(), b.state.get_snapshot()
    for f in ("position", "velocity", "image", "typeid"):
        np.testing.assert_array_equal(getattr(sa.particles, f), getattr(sb.particles, f),
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("loop", ["graphs", "eager"])
@pytest.mark.parametrize("mode", ["spans", "marks"])
def test_the_trajectory_is_bitwise_the_same_traced(mode, loop):
    """40 steps through the tune at step 30 (a new runner): the tracer on
    from the start, and switched on mid-run, against the tracer off."""
    want, sim, late = _fluid(loop=loop), _fluid(loop=loop), _fluid(loop=loop)
    for s in (want, sim, late):
        s.auto_tune_after = 30
    sim.tracer.enable(spans=True, marks=mode == "marks")
    for s in (want, sim, late):
        s.run(17)
    late.tracer.enable(spans=True, marks=mode == "marks")
    for s in (want, sim, late):
        s.run(23)
    _same(want, sim, f"{mode} {loop}")
    _same(want, late, f"{mode} {loop}, switched on mid-run")
    assert (typeid := want.state.get_snapshot().particles.typeid).sum() > 0, typeid
    assert want.tracer.drain() == [] and want.tracer.counters()["marks"] == {}
    assert sim.tracer.drain() and (sim.tracer.counters()["marks"] != {}) == (mode == "marks")
    if loop == "graphs":
        assert sim._graph_totals["replays"] >= 1


def test_spans_nest_and_count_the_cache():
    """``az.run`` > ``az.chunk`` > ``az.segment.first/capture/replay``,
    ``az.runner.build``, ``az.runner.load`` and ``az.chunk.read``; one
    ``az.chunk.read`` a chunk; each span inside its parent on the clock and
    tagged with its run; the segment spans as many as the cache's first
    sights, captures and replays."""
    sim = _fluid()
    sim.auto_tune_after = None
    sim.tracer.enable()
    sim.run(40)
    sim.run(25)
    spans = sim.tracer.drain()
    by_id = {s.id: s for s in spans}
    runs = [s for s in spans if s.name == "az.run"]
    assert [s.run for s in runs] == [1, 2] and all(s.parent is None for s in runs)
    parents = {"az.chunk": "az.run", "az.chunk.read": "az.chunk", "az.runner.build": "az.chunk",
               "az.runner.load": "az.chunk", "az.segment.first": "az.chunk",
               "az.segment.capture": "az.chunk", "az.segment.replay": "az.chunk"}
    for s in spans:
        if s.name == "az.run":
            continue
        p = by_id[s.parent]
        assert p.name == parents[s.name], (s.name, p.name)
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert s.run == p.run
    names = [s.name for s in spans]
    totals = sim._graph_totals
    assert names.count("az.segment.first") == totals["eager_segments"] >= 1
    assert names.count("az.segment.capture") == totals["captures"] >= 1
    assert names.count("az.segment.replay") == totals["replays"] >= 1
    assert names.count("az.chunk.read") == names.count("az.chunk") == sum(
        sim.tracer.counters()["chunk_ends"].values())
    assert names.count("az.runner.build") == 1 and "az.segment.loop" not in names


@pytest.mark.parametrize("loop", ["graphs", "eager"])
def test_marks_count_exactly_under_replay(loop):
    """25 steps: 25 marks of each step phase, ``rebin`` once a build, the
    evaporator's phase 25 times on the graphs (its masked select every
    step) and at its 5 fires on the eager loop, ``end`` once a segment."""
    sim = _fluid(loop=loop)
    sim.auto_tune_after = None
    sim.run(5)
    sim.tracer.enable(spans=True, marks=True)
    builds0 = sim.n_builds
    sim.run(25)
    assert sim.viol_replays == 0
    marks = sim.tracer.counters()["marks"]
    for phase in STEP_PHASES:
        assert marks[phase] == 25, (phase, marks)
    assert marks["rebin"] == sim.n_builds - builds0 >= 2
    assert marks["updater.ParticleEvaporator"] == (25 if loop == "graphs" else 5)
    segments = [s.name for s in sim.tracer.drain() if s.name.startswith("az.segment.")]
    if loop == "graphs":
        assert "az.segment.replay" in segments and "az.segment.capture" in segments
        # a capture runs the segment's Python but its work is the next replay's
        segments = [n for n in segments if n != "az.segment.capture"]
        # the segment graphs' copy of the results into the runner's buffers
        assert marks["writeback"] == len(segments)
    else:
        assert set(segments) == {"az.segment.loop"} and "writeback" not in marks
    assert marks["end"] == len(segments)
    table = sim.tracer.mark_table()
    assert set(table.values()) >= set(marks)
    assert table[0] == "end" and len(set(table)) == len(table)


def test_mark_ids_come_from_the_kernel_name():
    assert T.mark_id("void (anonymous namespace)::az_phase_mark<7>()") == 7
    assert T.mark_id("void az_phase_mark<63>()") == 63
    assert T.mark_id("void (anonymous namespace)::drift_kernel<1, false>(float const*)") is None
    assert T.phase_names("force", [1, 2.0, 3]) == ["force.int", "force.float", "force.int.1"]


def test_evictions_and_recaptures_at_two_graphs():
    """Segment shapes 1 1 2 2 3 3 1 1 in a cache of two: the third shape's
    capture evicts the first, whose next sight is a recapture (and evicts
    the second), counted on the runner and in the tracer's graph counters."""
    sim = _fluid(evaporate=False)
    sim.run(1)
    runner = SegmentGraphs("key", lambda d, m, v, t0, n, r: (d, m, v), sim._dense, sim._meta,
                           Counters(sim), capture=FakeCapture(), max_graphs=2,
                           totals=sim._graph_totals, tracer=sim.tracer)
    sim.tracer.enable()
    for n in (1, 1, 2, 2, 3, 3, 1, 1):
        runner.run(sim.timestep, n, True)
    assert (runner.eager_segments, runner.captures, runner.replays) == (3, 4, 5)
    assert (runner.evictions, runner.recaptures) == (2, 1)
    graph = sim.tracer.counters()["graph"]
    assert graph["evictions"] == 2 and graph["recaptures"] == 1
    assert runner.graph_keys() == [(3, True), (1, True)]
    names = [s.name for s in sim.tracer.drain()]
    assert names.count("az.segment.capture") == 4 and names.count("az.segment.replay") == 5


@pytest.mark.parametrize("loop", ["graphs", "eager"])
def test_chunk_ends_and_discarded_steps(loop, tmp_path):
    """A hot liquid on a thin buffer (drift violations), the tune at step
    30, a writer every 11 steps and chunks of at most 5: the chunk-end
    reasons sum to the chunks run, and the steps thrown away to the steps
    run less the timestep's advance."""
    sim = _fluid(loop=loop, kT=3.0, buffer=0.15)
    sim.auto_tune_after = 30
    sim.max_chunk = 5
    sim.operations.writers.append(port.write.GSD(port.trigger.Periodic(11),
                                                 str(tmp_path / "t.gsd")))
    sim.tracer.enable()
    sim.run(60)
    counters = sim.tracer.counters()
    ends, dropped = counters["chunk_ends"], counters["discarded_steps"]
    chunks = [s for s in sim.tracer.drain() if s.name == "az.chunk"]
    assert sum(ends.values()) == len(chunks)
    assert {"writer", "tune", "max_chunk"} <= set(ends), ends
    assert sim.viol_replays >= 1 and dropped["violation"] >= 1
    assert sum(dropped.values()) == sim.steps_run - sim.timestep
    assert counters["sync_reads"]["chunk_flags"] == len(chunks)
    assert counters["sync_reads"]["vmax"] >= 2 * sim.viol_replays


def test_runner_builds_by_cause():
    sim = _fluid(evaporate=False)
    sim.auto_tune_after = None
    sim.run(10)
    sim._grow_and_rebuild()
    sim.run(10)
    lj = sim.operations.integrator.forces[0]
    lj.params[("A", "B")] = dict(epsilon=0.6, sigma=1.0)
    sim.run(10)
    sim.operations.integrator.methods = [port.md.methods.Langevin(kT=1.2, default_gamma=0.6)]
    sim.run(10)
    sim._drop_runner()
    sim.run(10)
    assert sim.tracer.counters()["runner_builds"] == {
        "first": 1, "grid": 1, "tables": 1, "operations": 1, "dropped": 1}


def test_off_the_graph_keys_are_todays_and_nothing_is_recorded():
    sim = _fluid()
    sim.auto_tune_after = None
    assert sim.tracer.span("az.run") is sim.tracer.span("az.chunk")  # one shared null
    assert sim.tracer.marker(sim.device, True) is None
    sim.run(30)
    assert all(len(k) == 2 for k in sim._runner.graph_keys())
    assert sim.tracer.drain() == [] and sim.tracer.counters()["marks"] == {}
    assert not sim.tracer.spans_on and not sim.tracer.marks_on
    assert sim.tracer.counters()["graph"] is not sim._graph_totals  # a copy
    with pytest.raises(AttributeError):
        sim.tracer = T.Tracer()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
# the benchmark's configurations at the sizes of its CPU tests
# (portbench/tests/_small.py)
SMALL = {"plj_langevin": ({"n_particles": 1000}, {}),
         "droplet_evaporation": ({"n_particles": 552}, {"R0": 6.0})}


def _cell(config, device, marks):
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench import initial, manifest

    traffic, overrides = SMALL[config]
    params = {**manifest.config_params(manifest.load(), config), **overrides}
    builder = manifest.config_builder(config)
    init = builder.initial_state(params, traffic, initial.generator(1234567, device))
    sim = port.Simulation(device=device, seed=initial.simulation_seed(1234567))
    sim.create_state_from_snapshot(initial.snapshot(port, init))
    builder.build(port, sim, params)
    sim.tracer.enable(spans=True, marks=marks)
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(SMALL))
def test_marks_leave_the_cells_bitwise_on_the_card(config):
    """Each configuration of the benchmark at a small size, 300 steps
    through the tune on the segment CUDA graphs: marks on against off,
    bitwise, the marked run replaying marked graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase marks are kernels")
    dev = torch.device("cuda", 0)
    off, on = _cell(config, dev, False), _cell(config, dev, True)
    for s in (off, on):
        for _ in range(6):
            s.run(50)
    torch.cuda.synchronize(dev)
    for a, b in ((off._dense, on._dense), (off._meta, on._meta)):
        for f in ("position", "velocity", "typeid", "tag", "ref_position", "slot_of"):
            if hasattr(a, f) and isinstance(getattr(a, f), torch.Tensor):
                assert torch.equal(getattr(a, f), getattr(b, f)), f"{config}: {f}"
    assert off.timestep == on.timestep == 300
    assert on._graph_totals["replays"] >= 1
    # a capacity grown late makes a new runner: its graphs may be fewer
    assert all(k[-1] == "marks" for k in on._runner.graph_keys())
    assert all(k[-1] != "marks" for k in off._runner.graph_keys())
    marks = on.tracer.counters()["marks"]
    assert marks["integrate_step1"] == on.steps_run
    assert marks["end"] == marks["writeback"] >= 1


@pytest.mark.cuda
def test_profile_on_the_card_replays_marked_graphs(tmp_path):
    """``Simulation.profile`` on the card keeps the segment CUDA graphs: the
    window replays marked graphs, and its trace holds the phase marks, each
    named by the tracer's table, as many as the tracer counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase marks are kernels")
    import collections
    import json

    sim = _cell("plj_langevin", torch.device("cuda", 0), False)
    sim.run(300)
    replays, steps = sim._graph_totals["replays"], sim.steps_run
    with sim.profile(tmp_path):
        for _ in range(3):
            sim.run(100)
    assert sim._graph_totals["replays"] > replays
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    table = sim.tracer.mark_table()
    got = collections.Counter(table[k] for e in events if e.get("cat") == "kernel"
                              and (k := T.mark_id(e.get("name", ""))) is not None)
    marks = sim.tracer.counters()["marks"]
    assert got == collections.Counter(marks)
    assert got["force.PerturbedLennardJones"] == sim.steps_run - steps >= 300
    spans = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert spans["az.run"] == 3 and spans["az.segment.replay"] >= 1
