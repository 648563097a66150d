"""``Simulation.profile``: the port's twin of the reference's
``jax.profiler`` trace.

A run under ``sim.profile(logdir)`` writes one TensorBoard trace with the
tracer's spans and phase marks on (``azplugins_tpu_torch/trace.py``). On
the eager loop (the CPU here, with no capture) each step phase is also a
``record_function`` range named after the reference's scope:
``integrate_step1``, ``verlet_drift_check``, ``force.<Class>`` (one a
force) and ``integrate_step2`` once a step, ``rebin`` once a rebuild,
``updater.<Class>`` on the steps the updater fires and
``mpcd_joint_collision`` once a collision, each as often as its mark. The
segments keep their CUDA graphs inside it (a stand-in capture here), and
profiling changes the trajectory nowhere, bitwise.
"""

import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import azplugins_tpu_torch as port  # noqa: E402
from test_torch_trace import FakeCapture  # noqa: E402

torch.set_num_threads(1)

PHASES = ("rebin", "integrate_step1", "verlet_drift_check", "integrate_step2",
          "mpcd_joint_collision")


def _is_phase(name):
    return name in PHASES or name.startswith(("force.", "updater."))


def _ranges(logdir, spans=False):
    """{phase: count} of the one trace file in ``logdir`` (with ``spans``,
    of the tracer's spans, ``az.*``, instead)."""
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json"), files
    events = json.loads(files[0].read_text())["traceEvents"]
    keep = (lambda n: n.startswith("az.")) if spans else _is_phase
    return collections.Counter(e["name"] for e in events
                               if e.get("cat") == "user_annotation" and keep(e["name"]))


def _fluid(evaporate=False):
    """A 512-particle LJ liquid under Langevin; with ``evaporate``, an
    evaporator that retypes a few particles every 5 steps."""
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
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.5, mode="shift")
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    lj.params[("A", "B")] = dict(epsilon=0.5, sigma=1.0)
    lj.params[("B", "B")] = dict(epsilon=0.5, sigma=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=1.2, default_gamma=0.5)], forces=[lj])
    if evaporate:
        sim.operations.updaters.append(port.update.ParticleEvaporator(
            trigger=port.trigger.Periodic(5), solvent_type="A", evaporated_type="B",
            lo=2.0, hi=L / 2 - 0.01, N_evap_max=3))
    sim.state.thermalize_particle_momenta(kT=1.2)
    return sim


def test_profile_writes_the_phase_ranges(tmp_path):
    """25 steps on the eager loop: one range of each step phase a step,
    ``rebin`` once a build of the window, ``updater.ParticleEvaporator`` at
    the 5 steps the evaporator fires, each as often as its mark; the spans
    ``az.run``, ``az.chunk`` and ``az.segment.loop`` as ranges too; the
    tracer off again after, its spans dropped."""
    sim = _fluid(evaporate=True)
    sim.run(0)  # attach and prepare outside the window
    builds0 = sim.n_builds
    with sim.profile(tmp_path) as prof:
        assert isinstance(prof, torch.profiler.profile)
        sim.run(25)
    assert sim.viol_replays == 0
    got = _ranges(tmp_path)
    for phase in ("integrate_step1", "verlet_drift_check", "force.LJ", "integrate_step2"):
        assert got[phase] == 25, (phase, got)
    assert got["rebin"] == sim.n_builds - builds0 >= 2
    assert got["updater.ParticleEvaporator"] == 5
    assert got["mpcd_joint_collision"] == 0
    marks = sim.tracer.counters()["marks"]
    assert {k: v for k, v in marks.items() if k != "end"} == dict(got)
    spans = _ranges(tmp_path, spans=True)
    assert spans["az.run"] == 1 and spans["az.chunk"] >= 1
    assert spans["az.segment.loop"] == marks["end"] >= 3
    assert not sim.tracer.spans_on and not sim.tracer.marks_on and sim.tracer.drain() == []


def test_profile_marks_each_joint_collision(tmp_path):
    """An SRD solvent coupled every 6 steps: 30 steps, 5 joint collisions."""
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
    with sim.profile(tmp_path):
        sim.run(30)
    got = _ranges(tmp_path)
    assert got["mpcd_joint_collision"] == 5
    assert got["force.LJ"] == 30
    # the coupling is the joint collision, not an updater's range
    assert not any(k.startswith("updater.") for k in got)


def test_profile_leaves_the_trajectory_bitwise(tmp_path):
    """Steps inside profile on the (stand-in) CUDA graphs, marked ones
    replayed among them, and after it, bitwise an unprofiled run."""
    want = _fluid(evaporate=True)
    want.run(45)
    sim = _fluid(evaporate=True)
    sim._capture = FakeCapture()
    sim.run(10)
    replays = sim._graph_totals.get("replays", 0)
    with sim.profile(tmp_path):
        sim.run(30)
    assert sim._graph_totals["replays"] > replays
    assert any(k[-1] == "marks" for k in sim._runner.graph_keys())
    sim.run(5)
    a, b = want.state.get_snapshot(), sim.state.get_snapshot()
    assert (b.particles.typeid == 1).sum() > 0  # the evaporator fired inside the window
    for f in ("position", "velocity", "image", "typeid"):
        np.testing.assert_array_equal(getattr(b.particles, f), getattr(a.particles, f), err_msg=f)
