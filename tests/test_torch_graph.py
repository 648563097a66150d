"""The run loop's rebuild segments and their CUDA graphs, on the CPU.

``Simulation._run_chunk`` runs a chunk as rebuild segments
(``_run_segment``); on CUDA each segment of an eligible simulation is a
CUDA graph (``azplugins_tpu_torch/graph.py``). Here, with no card, the
graphs are a stand-in capture (``FakeCapture``) that behaves as a CUDA
capture does: recording runs the segment's Python (its counters move) but
leaves the buffers as they were, and a replay does the segment's tensor
work while its Python counters stay where they are. So the buffers, the
clock the draws key on, the counter accounting, the cache and its
invalidation all run as on the card.

Checked: chunks through the segments (eager and as stand-in graphs) are
bitwise the step loop the segments replaced (``_old_run_chunk``, kept here
as it was) on a small LJ liquid, DPD fluid, patchy colloids with rotation,
polymer melt and Brownian liquid, and on the paths whose steps read a
schedule: a small evaporating droplet (a SphereArea barrier, an evaporator
on Periodic(5), LangevinFlow in a parabolic flow), an LJ liquid under a
Ramp and under a Cycle kT, a DPD fluid under a Ramp kT and an LJ mixture
with a TypeUpdater (on the graphs the updaters run as masked selects every
step, the variants' values come from the chunk's rows on the device);
each within the 20-step bars of ``test_torch_simulation.py`` (1e-4 in
position, 1e-4 of max|v| in velocity) of the JAX reference's run, the
typeids (the evaporated tags) equal; a segment makes no host read (every
``Tensor`` method that reads a value on the host raises), the schedule's
load and gather included; the rule that picks the eager loop (an updater
or a Ramp kT now on the graphs, bitwise the eager loop); the cache's keys,
bound and invalidations; a failing
capture propagates; the overflow and violation carries across segments;
the counters under replay; the force tables' cache; the drift check made
by the last method's step1 on a grid path, bitwise the old loop.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu_torch import simulation as S  # noqa: E402
from azplugins_tpu_torch.core import rng as RNG  # noqa: E402
from azplugins_tpu_torch.graph import Counters, SegmentGraphs, Steps  # noqa: E402
from azplugins_tpu_torch.ops import integrate_kernel as IK  # noqa: E402
from azplugins_tpu_torch.ops import pair_kernel as PK  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The stand-in capture and the host-read guard
# ---------------------------------------------------------------------------
class FakeGraph:
    """A replay runs the segment's tensor work; its Python counters stay."""

    def __init__(self, runner, fn):
        self.runner, self.fn = runner, fn
        self.replays = 0

    def replay(self):
        counters = self.runner._counters
        before = counters.read()
        self.fn()
        counters.restore(before)
        self.replays += 1


class FakeCapture:
    """Records a segment as a CUDA capture does: its Python runs (and moves
    the counters, which the runner takes back), its buffers stay as they
    were (the captured work has not run)."""

    def __init__(self):
        self.graphs = []

    def __call__(self, runner, fn):
        saved = [b.clone() for b in runner.buffers()]
        fn()
        for b, v in zip(runner.buffers(), saved, strict=True):
            b.copy_(v)
        graph = FakeGraph(runner, fn)
        self.graphs.append(graph)
        return graph


_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Every Tensor method that brings a value to the host raises inside:
    the CPU's stand-in for a capture's synchronisation check."""
    saved = {n: getattr(torch.Tensor, n) for n in _READS}

    def refuse(name):
        def method(self, *args, **kwargs):
            raise AssertionError(f"host read inside a segment: Tensor.{name}")

        return method

    try:
        for n in _READS:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


# ---------------------------------------------------------------------------
# The systems: one snapshot and seed, either package
# ---------------------------------------------------------------------------
def _lattice(az, n, a, seed=3, kick=0.05, types=("A",)):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=n**3)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = list(types)
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-kick, kick, pos.shape)
    return snap


def _melt_snapshot(az, n_chains=27, chain_len=8, rho=0.5):
    """Straight rods along x on a (y, z) grid, as the bench's polymer melt."""
    N = n_chains * chain_len
    L = (N / rho) ** (1 / 3)
    snap = az.Snapshot(N=N, bond_N=n_chains * (chain_len - 1))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.bonds.types = ["backbone"]
    g = int(np.ceil(np.sqrt(n_chains)))
    c = np.arange(n_chains)
    y = ((c % g) + 0.5) * L / g - L / 2
    z = ((c // g) + 0.5) * L / g - L / 2
    x = -0.97 * (chain_len - 1) / 2 + 0.97 * np.arange(chain_len)
    pos = np.zeros((n_chains, chain_len, 3))
    pos[:, :, 0], pos[:, :, 1], pos[:, :, 2] = x[None, :], y[:, None], z[:, None]
    snap.particles.position[:] = pos.reshape(-1, 3)
    first = (c[:, None] * chain_len + np.arange(chain_len - 1)[None, :]).reshape(-1)
    snap.bonds.typeid[:] = 0
    snap.bonds.group[:] = np.stack([first, first + 1], axis=-1)
    return snap


def _simulation(az, snap, seed):
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=seed, **kw)
    sim.create_state_from_snapshot(snap)
    if az is ref:
        sim.auto_tune_after = None  # these runs stop short of the tune point
    return sim


def _droplet(az, R0=5.0, a=1.1, seed=7):
    """``bench.py``'s droplet at radius R0 (304 particles), its evaporator
    on Periodic(5): every piece of BASELINE config 5."""
    L = 2 * R0 + 4.0
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    snap = az.Snapshot(N=len(pts))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pts
    sim = _simulation(az, snap, seed)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("solvent", "solvent")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0)
    for pair in (("solvent", "evaporated"), ("evaporated", "evaporated")):
        lj.params[pair] = dict(epsilon=0.0, sigma=1.0, attraction_scale_factor=0.0)
    barrier = az.external.SphericalHarmonicBarrier(
        location=az.variant.SphereArea(R0=R0, alpha=0.05))
    barrier.params["solvent"] = dict(k=50.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    wall = az.external.wall.LJ93(
        walls=[az.external.wall.Plane(origin=(0, 0, -L / 2 + 0.5), normal=(0, 0, 1))])
    wall.params["solvent"] = dict(epsilon=1.0, sigma=1.0, r_cut=3.0)
    wall.params["evaporated"] = dict(epsilon=0.0, sigma=1.0, r_cut=3.0)
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(5), solvent_type="solvent", evaporated_type="evaporated",
        lo=R0 / 2, hi=L / 2, N_evap_max=10))
    flow = az.flow.ParabolicFlow(mean_velocity=0.5, separation=L - 2.0)
    method = az.md.methods.LangevinFlow(kT=1.0, flow_field=flow, default_gamma=1.0)
    return sim, [lj, barrier, wall], method


def _build(az, name):
    """A small system of one of the graph-eligible paths."""
    cell = az.md.nlist.Cell
    rotational = False
    if name == "droplet":
        sim, forces, method = _droplet(az)
        dt, kT = 0.002, 1.0
    elif name in ("lj_ramp", "lj_cycle"):  # the headline's path under a variant kT
        sim = _simulation(az, _lattice(az, 6, 1.15), 42)
        f = az.pair.PerturbedLennardJones(nlist=cell(buffer=0.4), default_r_cut=2.5, mode="shift")
        f.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.7)
        kT_of = (az.variant.Ramp(1.2, 0.8, 3, 30) if name == "lj_ramp" else
                 az.variant.Cycle(1.2, 1.5, 2, 4, 9, 5, 7))
        forces, method = [f], az.md.methods.Langevin(kT=kT_of, default_gamma=0.5)
        dt, kT = 0.005, 1.2
    elif name == "dpd_ramp":
        sim = _simulation(az, _lattice(az, 6, 0.7), 5)
        f = az.pair.DPDGeneralWeight(nlist=cell(buffer=0.4), kT=az.variant.Ramp(1.0, 0.4, 0, 25),
                                     default_r_cut=1.0)
        f.params[("A", "A")] = dict(A=25.0, gamma=4.5, s=0.5)
        forces, method, dt, kT = [f], az.md.methods.ConstantVolume(), 0.01, 1.0
    elif name == "type_updater":  # an LJ mixture whose types follow a z slab
        snap = _lattice(az, 6, 1.15, types=("A", "B"))
        snap.particles.typeid[:] = np.arange(snap.particles.N) % 2
        sim = _simulation(az, snap, 21)
        f = az.pair.PerturbedLennardJones(nlist=cell(buffer=0.4), default_r_cut=2.5, mode="shift")
        for pair, eps in ((("A", "A"), 1.0), (("A", "B"), 0.6), (("B", "B"), 0.3)):
            f.params[pair] = dict(epsilon=eps, sigma=1.0, attraction_scale_factor=0.7)
        sim.operations.updaters.append(az.update.TypeUpdater(
            trigger=az.trigger.Periodic(3, 1), inside_type="A", outside_type="B", lo=-1.0,
            hi=1.5))
        forces, method = [f], az.md.methods.Langevin(kT=1.2, default_gamma=0.5)
        dt, kT = 0.005, 1.2
    elif name == "lj":  # the headline's path: PLJ under Langevin
        sim = _simulation(az, _lattice(az, 6, 1.15), 42)
        f = az.pair.PerturbedLennardJones(nlist=cell(buffer=0.4), default_r_cut=2.5, mode="shift")
        f.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.7)
        forces, method, dt, kT = [f], az.md.methods.Langevin(kT=1.2, default_gamma=0.5), 0.005, 1.2
    elif name == "dpd":
        sim = _simulation(az, _lattice(az, 6, 0.7), 5)
        f = az.pair.DPDGeneralWeight(nlist=cell(buffer=0.4), kT=1.0, default_r_cut=1.0)
        f.params[("A", "A")] = dict(A=25.0, gamma=4.5, s=0.5)
        forces, method, dt, kT = [f], az.md.methods.ConstantVolume(), 0.01, 1.0
    elif name == "patchy":
        snap = _lattice(az, 5, 1.3, types=("P",))
        q = np.random.default_rng(11).normal(size=(snap.particles.N, 4))
        snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
        snap.particles.moment_inertia[:] = [0.4, 0.4, 0.4]
        sim = _simulation(az, snap, 7)
        f = az.pair.TwoPatchMorse(nlist=cell(buffer=0.3), default_r_cut=1.6, mode="shift")
        f.params[("P", "P")] = dict(M_d=1.5, M_r=0.05, r_eq=1.0, omega=20.0, alpha=0.4,
                                    repulsion=True)
        forces, method, dt, kT = [f], az.md.methods.Langevin(kT=0.5, default_gamma=1.0), 0.002, 0.5
        rotational = True
    elif name == "polymer":
        sim = _simulation(az, _melt_snapshot(az), 14)
        bonds = az.bond.Quartic()
        bonds.params["backbone"] = dict(k=1434.3, r_0=1.5, b_1=-0.7589, b_2=0.0, U_0=67.2234,
                                        sigma=1.0, epsilon=1.0, delta=0.0)
        pairs = az.pair.ExpandedYukawa(nlist=cell(buffer=0.4), default_r_cut=2.5)
        pairs.params[("A", "A")] = dict(epsilon=2.0, kappa=1.5, delta=0.5)
        forces = [bonds, pairs]
        method, dt, kT = az.md.methods.Langevin(kT=1.0, default_gamma=0.5), 0.002, 1.0
    else:  # brownian
        sim = _simulation(az, _lattice(az, 6, 1.2), 31)
        f = az.pair.PerturbedLennardJones(nlist=cell(buffer=0.4), default_r_cut=2.5, mode="shift")
        f.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
        forces, method, dt, kT = [f], az.md.methods.Brownian(kT=1.0, default_gamma=5.0), 0.001, None
    sim.operations.integrator = az.md.Integrator(dt=dt, methods=[method], forces=forces,
                                                 integrate_rotational_dof=rotational)
    if kT is not None:
        sim.state.thermalize_particle_momenta(kT=kT)
    return sim


PATHS = ["lj", "dpd", "patchy", "polymer", "brownian", "droplet", "lj_ramp", "lj_cycle",
         "dpd_ramp", "type_updater"]


def _old_run_chunk(self, dense, meta, t0, n_steps, seg_len, tbls, rebin_first=True, solv=None):
    """The step loop the rebuild segments replaced, as it was."""
    spec = self._grid_spec
    scope = self._phase_range
    integ = self.operations.integrator
    methods = integ.methods if integ is not None else []
    updaters = [u for u in self.operations.updaters if not getattr(u, "_updates_mpcd", False)]
    coupling = self._coupling
    mass_s = self._mpcd["mass"] if coupling is not None else None
    dt = self.dt_ref()
    seed = self.seed
    shards, metas = S._as_shards(dense), S._as_shards(meta)
    viol = torch.zeros((), dtype=torch.bool, device=shards[0].device)
    for j in range(n_steps):
        t = t0 + j
        self.steps_run += 1
        if spec is not None and rebin_first and j % seg_len == 0:
            with scope("rebin"):
                shards, metas = self._rebuild(shards, metas)
        with scope("integrate_step1"):
            for m in methods:
                shards = tuple(m.step1(s, dt, t, seed) for s in shards)
        if spec is not None:
            with scope("verlet_drift_check"):
                viol = self._drifted(shards, metas, viol)
        with scope("forces"):
            shards = self._with_forces(shards, metas, t, tbls)
        with scope("integrate_step2"):
            for m in methods:
                shards = tuple(m.step2(s, dt, t, seed) for s in shards)
        fired = [u for u in updaters if u.trigger(t)]
        if fired:
            with scope("updaters"):
                for u in fired:
                    shards = u._update_shards(shards, t, seed)
        if coupling is not None and coupling.trigger(t):
            with scope("mpcd_joint_collision"):
                shards, solv = coupling._collide(shards, solv, t + 1, seed, mass_s)
    return self._as_layout(shards), self._as_layout(metas), viol, solv


def _fields(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)}


def _assert_same(got, want, what):
    for name, a in _fields(want).items():
        assert torch.equal(_fields(got)[name], a), f"{what}: {name} differs"


def _snap(sim):
    p = sim.state.get_snapshot().particles
    return {k: getattr(p, k).copy() for k in ("position", "velocity", "orientation", "angmom",
                                               "image", "typeid")}


# ---------------------------------------------------------------------------
# Segments against the old loop and the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", PATHS)
def test_segments_are_the_old_loop_and_near_the_reference(name):
    """Chunks through the segments, eagerly and as stand-in graphs (the
    second 10-step segment captured, the rest replayed), give the old
    loop's trajectory bit for bit (the old loop reads variants as host
    floats and fires updaters from the host: the graphs read the chunk's
    rows on the device and run the updaters masked every step), and 20
    steps stay within the 20-step bars of the JAX reference's run, with
    its typeids (the droplet's evaporated tags) exactly."""
    rsim = _build(ref, name)
    old, eager, graphs = (_build(port, name) for _ in range(3))
    old._run_chunk = _old_run_chunk.__get__(old)
    graphs._capture = capture = FakeCapture()
    for stretch in range(2):
        for sim in (old, eager, graphs):
            sim.run(20)
        for sim, what in ((eager, "eager segments"), (graphs, "graphs")):
            _assert_same(sim._dense, old._dense, what)
            _assert_same(sim._meta, old._meta, what)
            assert (sim.steps_run, sim.force_evaluations, sim.timestep) == (
                old.steps_run, old.force_evaluations, old.timestep)
        if stretch == 0:
            rsim.run(20)
            r, p = _snap(rsim), _snap(graphs)
            np.testing.assert_array_equal(p["image"], r["image"])
            np.testing.assert_array_equal(p["typeid"], r["typeid"])
            if name == "droplet":  # fires after steps 0, 5, 10 and 15, 10 each
                assert int((p["typeid"] == 1).sum()) == 40
            np.testing.assert_allclose(p["position"], r["position"], rtol=0, atol=1e-4)
            for k in ("velocity", "orientation", "angmom"):
                np.testing.assert_allclose(p[k], r[k], rtol=0, atol=1e-4 * np.abs(r[k]).max(),
                                           err_msg=k)
    runner = graphs._runner
    assert runner is not None and eager._runner is None
    assert runner.captures >= 1 and runner.replays >= 2
    assert sum(g.replays for g in capture.graphs) == runner.replays


def _routing_case(layout):
    """A small port simulation for the drift check's routing: the LJ path
    whole ("lj") and on 2 shards ("shards"), the Brownian path, two methods
    on different filters ("two_methods": Langevin on A, NVE on B) and
    Langevin with no pair force, so no grid ("no_grid")."""
    if layout in ("lj", "shards", "brownian"):
        sim = _build(port, "lj" if layout == "shards" else layout)
        if layout == "shards":
            sim.enable_spatial_decomposition(port.parallel.make_mesh(2, device="cpu",
                                                                     sharded=True))
        return sim
    snap = _lattice(port, 6, 1.15, types=("A", "B"))
    snap.particles.typeid[:] = np.arange(snap.particles.N) % 2
    sim = _simulation(port, snap, 42)
    methods = [port.md.methods.Langevin(kT=1.2, default_gamma=0.5)]
    forces = []
    if layout == "two_methods":
        f = port.pair.PerturbedLennardJones(nlist=port.md.nlist.Cell(buffer=0.4),
                                            default_r_cut=2.5, mode="shift")
        for pair in (("A", "A"), ("A", "B"), ("B", "B")):
            f.params[pair] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.7)
        forces = [f]
        methods = [port.md.methods.Langevin(kT=1.2, default_gamma=0.5,
                                            filter=port.md.filter.Type(["A"])),
                   port.md.methods.ConstantVolume(filter=port.md.filter.Type(["B"]))]
    sim.operations.integrator = port.md.Integrator(dt=0.005, methods=methods, forces=forces)
    sim.state.thermalize_particle_momenta(kT=1.2)
    return sim


def _spy_step1(sim, calls):
    """Record each method's step1 calls as (method index, drift form): None
    without a drift check, "verdict" or "top two"."""
    for k, m in enumerate(sim.operations.integrator.methods):
        def step1(state, dt, t, seed, drift=None, k=k, plain=m.step1):
            calls.append((k, None if drift is None else
                          "top two" if drift.viol is None else "verdict"))
            return plain(state, dt, t, seed) if drift is None else plain(state, dt, t, seed, drift)

        m.step1 = step1


@pytest.mark.parametrize("layout", ["lj", "two_methods", "no_grid", "shards", "brownian"])
def test_last_step1_carries_the_drift_check(layout):
    """With a grid the last method's step1 makes the drift check (the
    verdict on a whole layout, each shard's top two on shards), earlier
    methods and a layout without a grid step plainly; a chunk's trajectory
    and violation flag are bitwise the old loop's (a short chunk and one
    long enough to violate), and the profile's ranges keep their counts."""
    old, new = _routing_case(layout), _routing_case(layout)
    old._run_chunk = _old_run_chunk.__get__(old)
    for sim in (old, new):
        sim.auto_tune_after = None
        sim.run(2)
    calls = []
    _spy_step1(new, calls)
    n_methods = len(new.operations.integrator.methods)
    shards = len(S._as_shards(new._dense))
    flags = []
    for n_steps, buffer in ((4, None), (30, 0.05)):
        got = {}
        for sim in (old, new):
            if buffer is not None and sim._grid_spec is not None:
                sim._grid_spec = sim._grid_spec.replace(buffer=buffer)  # drifts past it
            calls.clear()
            dense, meta, viol, _ = sim._run_chunk(sim._dense, sim._meta, sim.timestep, n_steps,
                                                  n_steps, sim._force_tables())
            got[sim is new] = (dense, meta, viol)
        (dense, meta, viol), (odense, ometa, oviol) = got[True], got[False]
        for d, o in zip(S._as_shards(dense), S._as_shards(odense), strict=True):
            _assert_same(d, o, f"{layout} {n_steps} steps")
        for d, o in zip(S._as_shards(meta), S._as_shards(ometa), strict=True):
            _assert_same(d, o, f"{layout} {n_steps} steps: meta")
        assert viol.dtype == torch.bool and torch.equal(viol, oviol)
        flags.append(bool(viol))
        form = None if layout == "no_grid" else "top two" if layout == "shards" else "verdict"
        want = [(k, form if k == n_methods - 1 else None) for k in range(n_methods)
                for _ in range(shards)]
        assert calls == want * n_steps, (layout, calls[:4])
    if layout != "no_grid":
        assert flags == [False, True]
    else:
        assert new._grid_spec is None and flags == [False, False]


@pytest.mark.parametrize("name", PATHS)
def test_segment_makes_no_host_read(name):
    """A segment, with a rebuild and without, with the draws keyed on the
    host's timestep and on the device clock, with the eager loop's
    schedule (made inside) and with the graphs' (the variants' rows and
    the triggers' masks: the updaters masked), and a stand-in capture and
    replay of one, the chunk's schedule loaded and gathered on the device,
    read nothing on the host."""
    sim = _build(port, name)
    sim._capture = FakeCapture()
    sim.run(3)
    tbls = sim._force_tables()
    t = sim.timestep
    clock = torch.tensor(t, dtype=torch.int64)
    values, masks = sim._variant_values(t, 6), sim._trigger_masks(t, 6)
    scheduled = name in ("droplet", "lj_ramp", "lj_cycle", "dpd_ramp", "type_updater")
    assert ((values is not None) or (masks is not None)) == scheduled
    masked = Steps(t, None if values is None else torch.from_numpy(values),
                   None if masks is None else torch.from_numpy(masks))
    with no_host_reads():
        for rebuild in (True, False):
            viol = torch.zeros((), dtype=torch.bool)
            sim._run_segment((sim._dense,), (sim._meta,), viol, t, 2, rebuild, tbls)
            sim._run_segment((sim._dense,), (sim._meta,), viol, t, 2, rebuild, tbls,
                             steps=masked)
            with RNG.device_clock(clock, t):
                sim._run_segment((sim._dense,), (sim._meta,), viol, t, 2, rebuild, tbls)
    runner = sim._build_runner(tbls)
    assert (runner.schedule is not None) == scheduled
    with no_host_reads():
        runner.load(sim._dense, sim._meta, t, values, masks)
        for _ in range(3):  # eagerly, captured and replayed, replayed
            runner.run(t, 2, True)
    assert runner.captures == 1 and runner.replays == 2


def test_the_clock_keys_the_plain_draws():
    """Under device_clock the plain draws key on the clock's word, as a
    tensor: the host timestep's bits, past 2**32 too."""
    tag = torch.arange(-1, 40, dtype=torch.int32)
    for t in (0, 7, 2**32 - 1, 2**32 + 5):
        want = RNG.particle_uniform3(RNG.Stream.LANGEVIN, 42, t, tag)
        want_pair = RNG.pair_uniform(200, 42, t, tag, tag.flip(0), rounds=13)
        clock = torch.tensor(t - 3, dtype=torch.int64)
        with RNG.device_clock(clock, 100):
            got = RNG.particle_uniform3(RNG.Stream.LANGEVIN, 42, 103, tag)
            got_pair = RNG.pair_uniform(200, 42, 103, tag, tag.flip(0), rounds=13)
            assert RNG._clock_args(103, "cpu") == (clock.data_ptr(), 3)
        assert torch.equal(got, want) and torch.equal(got_pair, want_pair)
        assert RNG._clock_args(103, "cpu") == (None, 0)


# ---------------------------------------------------------------------------
# Which loop runs
# ---------------------------------------------------------------------------
class _Recolor(port.update.Updater):
    """An updater that keeps every particle as it is."""

    def _update(self, state, timestep, seed):
        return state.replace(typeid=state.typeid.clone())


def _eligibility_case(case):
    if case == "coupling":
        rng = np.random.default_rng(3)
        snap = port.Snapshot(N=8, mpcd_N=500)
        snap.configuration.box = [6.0, 6.0, 6.0, 0, 0, 0]
        snap.particles.types = ["C"]
        x = (np.arange(2) + 0.5) * 3.0 - 3.0
        snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"),
                                              -1).reshape(-1, 3)
        snap.mpcd.position[:] = (rng.random((500, 3)) - 0.5) * 6.0
        snap.mpcd.velocity[:] = rng.normal(0, 1.0, (500, 3))
        sim = port.Simulation(device="cpu", seed=13)
        sim.create_state_from_snapshot(snap)
        sim.operations.integrator = port.md.Integrator(
            dt=0.02, methods=[port.md.methods.ConstantVolume()], forces=[])
        srd = port.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0)
        sim.mpcd_dynamics = srd
        sim.operations.updaters.append(port.mpcd.CollisionCoupling(srd))
        return sim
    sim = _build(port, "lj")
    if case == "updater":
        sim.operations.updaters.append(_Recolor(port.trigger.Periodic(5)))
    elif case == "sharded":
        sim.enable_spatial_decomposition(port.parallel.make_mesh(2, device="cpu", sharded=True))
    elif case == "ramp":
        sim.operations.integrator.methods[0].kT = port.variant.Ramp(1.2, 1.0, 0, 100)
    return sim


@pytest.mark.parametrize("case", ["updater", "coupling", "sharded", "ramp"])
def test_eligibility_selects_the_eager_loop(case):
    """An MPCD coupling or a sharded mesh keeps the eager loop, by the rule
    on the operations, before any capture; an updater or a Ramp kT takes
    the graphs (the updater masked every step, kT from the chunk's rows),
    bitwise the eager loop."""
    sim = _eligibility_case(case)
    sim._capture = capture = FakeCapture()
    if case in ("coupling", "sharded"):
        sim.run(25)
        assert not sim._graph_eligible() and not sim._graphs_apply()
        assert sim._runner is None and capture.graphs == []
        return
    eager = _eligibility_case(case)
    eager._capture, eager._eager = FakeCapture(), True
    for s in (sim, eager):
        s.run(25)
    assert sim._graph_eligible() and sim._graphs_apply() and not eager._graphs_apply()
    assert sim._runner is not None and sim._runner.replays >= 1 and capture.graphs
    assert eager._runner is None
    _assert_same(sim._dense, eager._dense, case)
    _assert_same(sim._meta, eager._meta, case)


def test_the_schedule_keeps_the_graph_keys():
    """The droplet's schedule (its SphereArea radius, its evaporator's
    trigger) lives in rows sized to the longest chunk and listed among the
    buffers: the graphs stay keyed on ``(L, rebuild)`` alone, whatever the
    firing steps, and a schedule of the wrong shape is refused."""
    sim = _build(port, "droplet")
    sim._capture = FakeCapture()
    sim.run(40)
    runner = sim._runner
    assert runner.n_values == 1 and runner.n_fires == 1 and runner.replays >= 1
    assert runner.values.shape == runner.fires.shape == (1, sim.max_chunk)
    assert any(b is runner.schedule for b in runner.buffers())
    assert all(len(k) == 2 for k in runner.graph_keys())
    with pytest.raises(ValueError, match="schedule of 1 rows"):
        runner.load(sim._dense, sim._meta, 40, np.zeros((2, 4), np.float32),
                    np.zeros((1, 4), bool))


def test_eligible_runs_take_the_graphs_but_not_profile_or_eager(tmp_path):
    sim = _build(port, "lj")
    assert sim._graph_eligible() and not sim._graphs_apply()  # the CPU: no CUDA capture
    sim._capture = FakeCapture()
    assert sim._graphs_apply()
    sim._eager = True
    assert not sim._graphs_apply()
    sim._eager = False
    with sim.profile(tmp_path):
        assert not sim._graphs_apply()
        sim.run(20)
    assert sim._runner is None
    sim.run(20)
    assert sim._runner is not None and sim._runner.captures == 1


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------
def _graphed_lj():
    sim = _build(port, "lj")
    sim._capture = FakeCapture()
    sim.auto_tune_after = None
    sim.run(30)
    return sim


def test_cache_keys():
    sim = _graphed_lj()
    runner = sim._runner
    tbls = sim._force_tables()
    assert runner.key == (sim._grid_spec, sim._fields, sim._ops_fp, id(tbls), False,
                          sim._dense.N, sim.state.N_particles, (), (), sim.max_chunk)
    assert runner.schedule is None  # no variant and no updater: no rows to load
    assert runner.graph_keys() == [(10, True)]
    sim.run(25)  # steps 30-54: segments of 10 and one of 5
    assert sim._runner is runner and runner.graph_keys() == [(10, True)]
    sim.run(10)  # 55-64: one of 5 (the second: captured), then one of 5
    assert set(runner.graph_keys()) == {(10, True), (5, True)}
    runner.max_graphs = 1
    sim.run(10)
    assert len(runner.graph_keys()) == 1


def _drop_by(sim, how):
    if how == "invalidate":
        sim._invalidate()
    elif how == "grow":
        sim._grow_and_rebuild()
    elif how == "tune":
        sim.tune_cell_capacity()
    elif how == "set_snapshot":
        sim.state.set_snapshot(sim.state.get_snapshot())
    elif how == "mesh":
        sim.enable_spatial_decomposition(port.parallel.make_mesh(1, device="cpu"))
    elif how == "operations":
        sim.operations.integrator.methods = [port.md.methods.Langevin(kT=1.2, default_gamma=0.6)]
    elif how == "parameters":
        f = sim.operations.integrator.forces[0]
        f.params[("A", "A")] = dict(epsilon=1.1, sigma=1.0, attraction_scale_factor=0.7)


@pytest.mark.parametrize("how", ["invalidate", "grow", "tune", "set_snapshot", "mesh",
                                 "operations", "parameters"])
def test_cache_invalidation(how):
    """Everything that changes the shapes or pointers a graph was captured
    with drops the graphs; the next run binds new ones."""
    sim = _graphed_lj()
    runner = sim._runner
    tbls = sim._force_tables()
    _drop_by(sim, how)
    if how in ("operations", "parameters"):
        sim.run(1)  # noticed by the next run
        assert sim._runner is not runner
    else:
        assert sim._runner is None
    sim.run(150)  # a tune may set the interval to 50
    assert sim._runner is not None and sim._runner is not runner
    assert sim._runner.captures >= 1
    if how in ("invalidate", "set_snapshot", "operations", "parameters"):
        assert sim._force_tables() is not tbls


def test_a_failing_capture_raises():
    sim = _build(port, "lj")

    def refuse(runner, fn):
        raise RuntimeError("capture refused")

    sim._capture = refuse
    with pytest.raises(RuntimeError, match="capture refused"):
        sim.run(30)


def test_force_tables_are_cached():
    """The device tables stay the same tensors across runs while no
    parameter changes (no copy to the device); a change makes new ones."""
    sim = _build(port, "lj")
    sim.run(2)
    first = sim._force_tables()[0][0]
    sim.run(2)
    again = sim._force_tables()[0][0]
    for name, table in first["params"].items():
        assert again["params"][name].data_ptr() == table.data_ptr()
    f = sim.operations.integrator.forces[0]
    f.params[("A", "A")] = dict(epsilon=1.3, sigma=1.0, attraction_scale_factor=0.7)
    sim.run(2)
    changed = sim._force_tables()[0][0]
    assert changed["r_cut"].data_ptr() != first["r_cut"].data_ptr()
    assert not torch.equal(changed["params"]["lj1"], first["params"]["lj1"])


# ---------------------------------------------------------------------------
# Carries and counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_flags_are_carried_across_segments(graphs):
    """Four segments of one chunk: a particle jumps past the buffer before
    the second (which continues without a rebuild: a violation), half the
    particles crowd into one cell before the third (its rebuild
    overflows), and they are put back before the fourth (its rebuild does
    not). The chunk's flags still show the violation and the overflow, with
    the third rebuild's occupancy."""
    sim = _build(port, "lj")
    sim.auto_tune_after = None
    sim.run(2)
    tbls = sim._force_tables()
    t0 = sim.timestep
    if graphs:
        sim._capture = FakeCapture()
        runner = sim._build_runner(tbls)
        runner.load(sim._dense, sim._meta, t0)
        state = lambda: runner.dense  # noqa: E731
    else:
        shards, metas = (sim._dense.replace(position=sim._dense.position.clone()),), (sim._meta,)
        viol = torch.zeros((), dtype=torch.bool)
        state = lambda: shards[0]  # noqa: E731
    half = sim.state.N_particles // 2
    saved = None
    for k, rebuild in enumerate((True, False, True, True)):
        pos, tag = state().position, state().tag
        if k == 1:
            pos[:, 0].add_(torch.where(tag == 0, 1.0, 0.0))
        elif k == 2:  # into the cell whose corner is the box's centre
            saved = pos.clone()
            centre = 0.5 * float(sim.state.box.Lx) / sim._grid_spec.dims[0]
            pos.copy_(torch.where((tag >= half)[:, None], pos * 1e-3 + centre, pos))
        elif k == 3:
            pos.copy_(saved)
        if graphs:
            runner.run(t0 + 3 * k, 3, rebuild)
        else:
            shards, metas, viol, _ = sim._run_segment(shards, metas, viol, t0 + 3 * k, 3,
                                                      rebuild, tbls)
    if graphs:
        assert runner.captures == 1 and runner.replays == 2
        _, meta, viol = runner.result()
    else:
        meta = metas[0]
    overflow, violated, max_occ = sim._chunk_flags(meta, viol)
    assert overflow and violated
    assert max_occ >= half > sim._grid_spec.cap


@pytest.mark.parametrize("kernel", ["step1", "step1_drift"])
def test_counters_under_replay(kernel):
    """A capture's launches (and steps, force evaluations) are taken back
    and added at every replay: a stand-in graph whose capture runs the
    segment's Python once and whose replays run none of it; K7 alone
    ("step1") and K7+K6 in one launch ("step1_drift", a grid path's)."""
    sim = _build(port, "lj")
    sim.run(1)
    counters = Counters(sim)

    def segment(dense, meta, viol, t0, n_steps, rebuild):
        IK.launches_by_kernel[kernel] = IK.launches_by_kernel.get(kernel, 0) + n_steps
        IK.launches += 2 * n_steps
        PK.launches_by_potential["LJ"] = PK.launches_by_potential.get("LJ", 0) + n_steps
        sim.steps_run += n_steps
        return dense, meta, viol

    class Recorded:
        def replay(self):
            pass

    def capture(runner, fn):
        fn()
        return Recorded()

    runner = SegmentGraphs("key", segment, sim._dense, sim._meta, counters, capture=capture)
    before = counters.read()
    steps0, step1_0 = sim.steps_run, IK.launches_by_kernel.get(kernel, 0)
    ik0 = IK.launches
    runner.run(sim.timestep, 4, True)  # eagerly: counted as it runs
    assert counters.since(before)[-2:] == [4, 0]
    runner.run(sim.timestep, 4, True)  # captured (taken back), replayed once
    runner.run(sim.timestep, 4, True)
    runner.run(sim.timestep, 4, True)
    assert runner.captures == 1 and runner.replays == 3
    assert sim.steps_run - steps0 == 16
    assert IK.launches_by_kernel[kernel] - step1_0 == 16
    gained = dict(zip([a for _, a in counters._targets], counters.since(before), strict=True))
    assert gained["launches_by_potential"] == {"LJ": 16}
    assert IK.launches - ik0 == 32
