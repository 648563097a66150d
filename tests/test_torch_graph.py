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
on Periodic(5), LangevinFlow in a parabolic flow), a two-type liquid under
BrownianFlow in a parabolic flow on a Type filter and a Ramp kT (its
counters under replay gaining exactly the eager loop's), an LJ liquid under a
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

The SRD advance of the MPCD-only paths (``graph.AdvanceGraphs``: a graph a
collision, its keys and grid shift from the clock): bitwise the eager
advance on small streams (a collision every step, plates with a body
force, a body force at cell size 0.75, no shift) over two chunkings, and
within the two-collision bars of the JAX reference's jitted advance; no
host read inside a collision's or a stream's body; K5's clock form and
K10 counted exactly once a collision under replay; a coupled stream, a
solvent in several blocks, ``profile`` and ``_eager`` keep the eager
advance.

The MPCD coupling inside the segment graphs (colloid hydrodynamics at a
small size, the solvent's anchor in the runner's buffers, a colliding
segment keyed by its lead): bitwise the eager loop, colloids, solvent and
anchor, with and without a grid, from a start inside a collision window
(a short first window) and with chunks a writer cuts; a chunk thrown away
after its collisions (a drift violation, an overflow) replays bitwise a
run without the replay; no host read inside a coupled segment; K5's clock
form and K10 once a collision and every step counted under replay; a
replaced trigger keeps the eager loop; and the graphed coupled run within
the JAX reference's two-collision bars.
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
    elif name == "brownian_flow":  # BrownianFlow in a parabolic flow on type A, a Ramp kT
        snap = _lattice(az, 6, 1.2, types=("A", "B"))
        snap.particles.typeid[:] = np.arange(snap.particles.N) % 2
        sim = _simulation(az, snap, 37)
        f = az.pair.PerturbedLennardJones(nlist=cell(buffer=0.4), default_r_cut=2.5, mode="shift")
        for pair, eps in ((("A", "A"), 1.0), (("A", "B"), 0.6), (("B", "B"), 0.3)):
            f.params[pair] = dict(epsilon=eps, sigma=1.0, attraction_scale_factor=0.5)
        method = az.md.methods.BrownianFlow(
            kT=az.variant.Ramp(1.2, 0.8, 3, 30), flow_field=az.flow.ParabolicFlow(0.5, 6.0),
            filter=az.md.filter.Type(["A"]), default_gamma=5.0)
        method.gamma["B"] = 3.0
        forces, dt, kT = [f], 0.001, None
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


PATHS = ["lj", "dpd", "patchy", "polymer", "brownian", "brownian_flow", "droplet", "lj_ramp",
         "lj_cycle", "dpd_ramp", "type_updater"]


def _old_run_chunk(self, dense, meta, t0, n_steps, seg_len, tbls, rebin_first=True, solv=None):
    """The step loop the rebuild segments replaced, as it was (its profile
    scopes, which the simulation no longer holds, enter nothing)."""
    spec = self._grid_spec
    scope = lambda name: contextlib.nullcontext()  # noqa: E731
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
    """Bitwise the same tensor fields; shards (tuples) shard by shard."""
    got, want = S._as_shards(got), S._as_shards(want)
    assert len(got) == len(want), f"{what}: {len(got)} shards against {len(want)}"
    for g, w in zip(got, want, strict=True):
        for name, a in _fields(w).items():
            assert torch.equal(_fields(g)[name], a), f"{what}: {name} differs"


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
    scheduled = name in ("droplet", "lj_ramp", "lj_cycle", "dpd_ramp", "type_updater",
                         "brownian_flow")
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
    elif case == "distinct":
        sim.enable_spatial_decomposition(_TwoDevices(devices=("cpu", "cpu"), sharded=True))
    elif case == "ramp":
        sim.operations.integrator.methods[0].kT = port.variant.Ramp(1.2, 1.0, 0, 100)
    return sim


class _TwoDevices(port.parallel.Mesh):
    """A sharded mesh that says its blocks lie on distinct devices, while
    they lie on the CPU: a mesh over two cards, as the rule sees it."""

    @property
    def distinct(self) -> bool:
        return True


@pytest.mark.parametrize("case", ["updater", "coupling", "sharded", "ramp", "distinct"])
def test_eligibility_selects_the_eager_loop(case):
    """A mesh over distinct devices keeps the eager loop, by the rule on
    the operations, before any capture; an updater, a Ramp kT, an MPCD
    coupling on its default trigger or a sharded mesh on one device takes
    the graphs (the updater masked every step, kT from the chunk's rows,
    the joint collision on a segment's last step with the solvent's anchor
    in the runner's buffers, one buffer State a shard), bitwise the eager
    loop (the solvent too)."""
    sim = _eligibility_case(case)
    sim._capture = capture = FakeCapture()
    if case == "distinct":
        sim.run(25)
        assert isinstance(sim._dense, tuple) and len(sim._dense) == 2
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
    if case == "coupling":
        _same_stream(sim, eager, case)


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
    """An eligible run takes the graphs where a capture exists, the private
    ``_eager`` keeps the eager loop, and ``profile`` keeps the graphs: its
    segments are marked graphs of their own (keys ending in "marks"), the
    unmarked ones after it graphs of today's keys."""
    sim = _build(port, "lj")
    assert sim._graph_eligible() and not sim._graphs_apply()  # the CPU: no CUDA capture
    sim._capture = FakeCapture()
    assert sim._graphs_apply()
    sim._eager = True
    assert not sim._graphs_apply()
    sim._eager = False
    with sim.profile(tmp_path):
        assert sim._graphs_apply() and sim.tracer.marks_on and sim.tracer.spans_on
        sim.run(20)
    runner = sim._runner
    assert runner is not None and runner.captures == 1 and runner.replays == 1
    assert runner.graph_keys() == [(10, True, "marks")]
    assert not sim.tracer.marks_on and not sim.tracer.spans_on
    sim.run(20)
    assert sim._runner is runner and runner.captures == 2
    assert runner.graph_keys() == [(10, True, "marks"), (10, True)]


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


@pytest.mark.parametrize("kernel", ["step1", "step1_drift", "brownian_step",
                                    "brownian_step_drift"])
def test_counters_under_replay(kernel):
    """A capture's launches (and steps, force evaluations) are taken back
    and added at every replay: a stand-in graph whose capture runs the
    segment's Python once and whose replays run none of it; K7 alone
    ("step1") and K7+K6 in one launch ("step1_drift", a grid path's), K11
    alone and with the drift check (BrownianFlow's)."""
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


def test_brownian_flow_graphs_count_as_the_eager_loop():
    """BrownianFlow in a parabolic flow under a Type filter and a Ramp kT,
    with PLJ forces on the cell grid: through the stand-in capture, chunks
    that capture and replay segments are the eager loop's bit for bit, and
    every counter a segment advances (the launch counts, steps, force
    evaluations) gains exactly what the eager loop's gains, replays
    included; the builds and the violation replays are the eager loop's."""
    graphs, eager = _build(port, "brownian_flow"), _build(port, "brownian_flow")
    graphs._capture = FakeCapture()
    eager._capture, eager._eager = FakeCapture(), True
    gained = {}
    for sim in (graphs, eager):
        counters = Counters(sim)
        before = counters.read()
        for _ in range(3):
            sim.run(20)
        gained[sim is graphs] = counters.since(before)
    _assert_same(graphs._dense, eager._dense, "brownian_flow")
    _assert_same(graphs._meta, eager._meta, "brownian_flow")
    assert gained[True] == gained[False]
    assert graphs.steps_run == eager.steps_run >= 60
    assert (graphs.n_builds, graphs.viol_replays) == (eager.n_builds, eager.viol_replays)
    runner = graphs._runner
    assert runner is not None and runner.captures >= 1 and runner.replays >= 2
    assert eager._runner is None


# ---------------------------------------------------------------------------
# The SRD advance of the MPCD-only paths as graphs (graph.AdvanceGraphs)
# ---------------------------------------------------------------------------
ADVANCE_CASES = {
    # a collision every step, the thermostat on (pure SRD's path)
    "srd": dict(period=1, kT=1.0),
    # the Poiseuille slit's: plates, their virtual fill, a body force
    "plates": dict(period=5, kT=1.0, body_force=(0.05, 0.0, 0.0), plates=("z", 6.0)),
    # a body force with no thermostat, and a cell size whose reciprocal
    # is not a float32 (the shift's quotient)
    "body_force": dict(period=3, body_force=(0.03, -0.01, 0.02), cell_size=0.75),
    # no grid shift
    "no_shift": dict(period=2, kT=1.0, shift=False),
}


def _solvent(az, case, N=1500, L=6.0, seed=3):
    """An MPCD-only simulation: two idle MD particles and an SRD solvent of
    a few hundred cells."""
    kw = ADVANCE_CASES[case]
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    z_fill = 0.98 if "plates" in kw else 1.0
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray([L, L, z_fill * L])
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = az.Simulation(seed=5, **({} if az is ref else {"device": "cpu"}))
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
    sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, **kw)
    return sim


def _stream_bits(sim) -> dict:
    mpcd = sim._mpcd
    pos_a, vel_a, t_a = mpcd["_srd_anchor"]
    return {"position": torch.cat(mpcd["position"]), "velocity": torch.cat(mpcd["velocity"]),
            "anchor position": torch.cat(pos_a), "anchor velocity": torch.cat(vel_a),
            "anchor time": torch.tensor(t_a)}


def _same_stream(got, want, what):
    for k, v in _stream_bits(want).items():
        assert torch.equal(_stream_bits(got)[k], v), (what, k)


@pytest.mark.parametrize("case", list(ADVANCE_CASES))
def test_advance_graphs_are_the_eager_advance(case):
    """The SRD advance on the graphs (a stand-in capture) is bitwise the
    eager advance, over two chunkings each, the keys and the grid shift
    drawn from the clock in the graphs and on the host eagerly: position,
    velocity and the anchor after every stretch; the graphs hold one
    collision key and the observation streams' keys."""
    eager = _solvent(port, case)
    graphs = [_solvent(port, case) for _ in range(2)]
    for sim in graphs:
        sim._capture = FakeCapture()
    for n in (17, 6, 23):  # the eager run's chunks, graphs[0]'s too
        eager.run(n)
        graphs[0].run(n)
        _same_stream(graphs[0], eager, f"{case} after {eager.timestep} steps")
    for n in (9, 14, 5, 18):  # another chunking
        graphs[1].run(n)
    period = eager.mpcd_dynamics.period
    for sim in graphs:
        assert sim.timestep == eager.timestep == 46
        assert not eager._advance_graphs_apply() and sim._advance_graphs_apply()
        _same_stream(sim, eager, case)
        runner = sim._advance_graphs
        assert runner.replays >= 1 and runner.captures >= 1
        leads = {k[1] for k in runner.graph_keys() if k[0] == "collide"}
        assert leads <= set(range(1, period + 1)) and period in leads
        assert all(0 <= k[1] < period for k in runner.graph_keys() if k[0] == "stream")
    assert eager._advance_graphs is None


@pytest.mark.parametrize("case", ["srd", "plates"])
def test_advance_body_makes_no_host_read(case):
    """A collision's graph body and the observation stream's, eagerly, as
    captured and replayed, the draws keyed on the clock, read nothing on
    the host."""
    sim = _solvent(port, case)
    sim._capture = FakeCapture()
    sim.run(7)
    runner, srd = sim._advance_graphs, sim.mpcd_dynamics
    t_a = sim._mpcd["_srd_anchor"][2]
    lead = srd.period
    with no_host_reads():
        runner.load(runner.pos_a, runner.vel_a, t_a)
        for _ in range(3):  # first runs eagerly, captured and replayed, replayed
            runner.run(("collide", 1000 + lead), lambda: srd._collide_body(
                runner, t_a, lead, sim.seed))
            runner.run(("stream", 1000), lambda: srd._stream_body(runner, 2))
            t_a += lead
    assert torch.equal(runner.clock, torch.tensor(t_a))
    assert runner.captures >= 2 and runner.replays >= 4


def test_advance_counters_under_replay(monkeypatch):
    """K5's clock form and K10 count one launch a collision under replay:
    a capture's launches are taken back and added at every replay (the
    kernels stand in on the CPU as counting wrappers of the plain
    versions)."""
    from azplugins_tpu_torch import mpcd as M
    from azplugins_tpu_torch.ops import cellsum_kernel as CK
    from azplugins_tpu_torch.ops import rng_kernel as RK

    draws, sums = RNG.collision_draws, M._cell_sums

    def counted_draws(*args, **kwargs):
        RK.launches_by_kernel["jax_normal_axis_clock"] = (
            RK.launches_by_kernel.get("jax_normal_axis_clock", 0) + 1)
        return draws(*args, **kwargs)

    def counted_sums(*args, **kwargs):
        CK.launches += 1
        return sums(*args, **kwargs)

    # counted into copies, which teardown drops: other tests read the counts
    monkeypatch.setattr(RK, "launches_by_kernel", dict(RK.launches_by_kernel))
    monkeypatch.setattr(CK, "launches", CK.launches)
    monkeypatch.setattr(RNG, "collision_draws", counted_draws)
    monkeypatch.setattr(M, "_cell_sums", counted_sums)
    sim = _solvent(port, "srd")
    sim._capture = FakeCapture()
    k5, k10 = RK.launches_by_kernel.get("jax_normal_axis_clock", 0), CK.launches
    sim.run(10)
    sim.run(15)
    assert sim._advance_graphs.replays >= 20 and sim._advance_graphs.captures >= 1
    assert RK.launches_by_kernel["jax_normal_axis_clock"] - k5 == 25
    assert CK.launches - k10 == 25


@pytest.mark.parametrize("case", ["coupled", "sharded", "profile", "eager", "whole"])
def test_advance_eligibility(case, tmp_path):
    """A coupled stream and the private _eager keep the eager advance, by
    the rule, before any capture; a whole uncoupled stream takes the
    graphs, inside profile too, and so does one in several blocks beside a
    sharded layout on one device (whose segments take the segment graphs).
    A coupled stream's collisions run on the segment graphs instead (the
    coupling owns them): only its observation stream is eager."""
    if case == "coupled":
        sim = _eligibility_case("coupling")
    else:
        sim = _solvent(port, "srd")
    sim._capture = FakeCapture()
    if case == "sharded":  # a grid (a pair force) on 2 shards: the solvent in 2 blocks
        f = port.pair.Hertz(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=1.5)
        f.params[("A", "A")] = dict(epsilon=1.0)
        sim.operations.integrator.forces = [f]
        sim.enable_spatial_decomposition(port.parallel.make_mesh(2, device="cpu", sharded=True))
    sim._eager = case == "eager"
    graphed = ("whole", "sharded", "profile")
    if case == "profile":
        with sim.profile(tmp_path):
            sim.run(6)
            assert sim._advance_graphs_apply()
    else:
        sim.run(6)
        assert sim._advance_graphs_apply() == (case in graphed)
    if case == "sharded":
        assert len(sim._mpcd["position"]) == 2 and len(sim._advance_graphs.pos_a) == 2
    assert (sim._advance_graphs is None) == (case not in graphed)
    assert (sim._runner is not None) == (case in ("coupled", *graphed))
    if case in ("coupled", "sharded"):
        assert sim._graphs_apply() and sim._graph_totals["eager_segments"] >= 1
    if case in graphed:
        assert sim._advance_totals["replays"] >= 1


@pytest.mark.parametrize("kind", ["uncoupled", "uncoupled with plates"])
def test_advance_graphs_match_reference(kind):
    """Ten steps (two collisions) of the graphed advance within the bars of
    test_torch_mpcd.py's two collisions (1e-6 of L in position, 1e-5 of
    max|v| in velocity) of the JAX reference's jitted advance, the anchor
    at the same clock."""
    kw = dict(kT=1.0, body_force=(0.05, 0.0, 0.0))
    if kind.endswith("plates"):
        kw["plates"] = ("z", 8.0)
    sims = []
    for az in (ref, port):
        rng = np.random.default_rng(3)
        snap = az.Snapshot(N=8, mpcd_N=3000)
        snap.configuration.box = [8.0, 8.0, 8.0, 0, 0, 0]
        snap.particles.types = ["A"]
        snap.particles.position[:] = (rng.random((8, 3)) - 0.5) * 7.2
        snap.mpcd.position[:] = (rng.random((3000, 3)) - 0.5) * 8.0
        snap.mpcd.velocity[:] = rng.normal(0, 1.0, (3000, 3))
        snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
        sim = az.Simulation(seed=7, **({} if az is ref else {"device": "cpu"}))
        sim.create_state_from_snapshot(snap)
        sim.operations.integrator = az.md.Integrator(
            dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
        sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, **kw)
        sims.append(sim)
    sims[1]._capture = FakeCapture()
    for sim in sims:
        sim.run(7)
        sim.run(3)
    assert sims[1]._advance_graphs.replays >= 1
    (xr, vr), (xp, vp) = ((s.state.get_snapshot().mpcd.position,
                           s.state.get_snapshot().mpcd.velocity) for s in sims)
    np.testing.assert_allclose(xp, xr, rtol=0, atol=1e-6 * 8.0)
    np.testing.assert_allclose(vp, vr, rtol=0, atol=1e-5 * np.abs(vr).max())
    assert int(np.asarray(sims[0]._mpcd["_srd_anchor"][2])) == sims[1]._mpcd["_srd_anchor"][2] == 10


# ---------------------------------------------------------------------------
# The MPCD coupling inside the segment graphs
# ---------------------------------------------------------------------------
def _coupled(az, forces=True, N_s=1200, n=3, L=6.0, period=10, seed=3, lattice=True):
    """Colloid hydrodynamics at a small size (``bench.py``'s colloid path):
    n^3 colloids of mass 5 in an SRD solvent (kT 1) coupled through the
    joint collision every ``period`` steps. With ``forces`` the colloids sit
    on a lattice under the path's WCA LJ (a grid) at dt 0.005, the solvent
    driven by a body force; without, they sit at random with no force (no
    grid) at dt 0.02, as ``test_torch_mpcd.py``'s coupled case."""
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=n**3, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["C"]
    snap.particles.position[:] = (rng.random((n**3, 3)) - 0.5) * L
    if lattice:
        x = (np.arange(n) + 0.5) * (L / n) - L / 2
        snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"),
                                              -1).reshape(-1, 3)
    snap.particles.mass[:] = 5.0
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    sim = _simulation(az, snap, 13)
    pots, dt, body = [], 0.02, None
    if forces:
        lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0 ** (1 / 6),
                        mode="shift")
        lj.params[("C", "C")] = dict(epsilon=1.0, sigma=1.0)
        pots, dt, body = [lj], 0.005, (0.02, 0.0, 0.0)
    sim.operations.integrator = az.md.Integrator(
        dt=dt, methods=[az.md.methods.ConstantVolume()], forces=pots)
    srd = az.mpcd.SRD(dt=dt, period=period, angle=130.0, cell_size=1.0, kT=1.0,
                      body_force=body)
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    return sim


class _Cut(port.write.Writer):
    """A writer that only ends chunks: the run loop cuts a chunk at each
    of its fires."""

    def __init__(self, trigger):
        super().__init__(trigger)
        self.fired = []

    def write(self, sim, timestep):
        self.fired.append(timestep)


def _coupled_pair(case):
    """An eager and a graphed port simulation of one coupled case."""
    sims = []
    for graphs in (False, True):
        sim = _coupled(port, forces=case != "no_grid")
        sim._capture, sim._eager = FakeCapture(), not graphs
        if case == "short_first_window":
            sim.timestep = 3  # the stream anchors at 3: the first window has 7 steps
        elif case == "writer":
            sim.operations.writers.append(_Cut(port.trigger.Periodic(7)))
        sims.append(sim)
    return sims


def _same_coupled(got, want, what, counted=True):
    """Bitwise the same slot layout and solvent (and anchor), at the same
    timestep; with ``counted`` after as many steps and force evaluations."""
    _assert_same(got._dense, want._dense, what)
    _same_stream(got, want, what)
    assert got.timestep == want.timestep, what
    if counted:
        assert (got.steps_run, got.force_evaluations) == (
            want.steps_run, want.force_evaluations), what


@pytest.mark.parametrize("case", ["colloids", "no_grid", "short_first_window", "writer"])
def test_coupled_segments_are_the_eager_loop(case):
    """With its default trigger the joint collision runs inside the segment
    graphs (a stand-in capture): the colloids, the solvent and its anchor
    are bitwise the eager loop over uneven chunks, also from a start that is
    not a multiple of the period (a short first window: a smaller lead) and
    with chunks that a writer cuts inside a segment; a segment whose last
    step collides is keyed by its lead, and at most one collision lands in
    a segment, on its last step."""
    eager, graphs = _coupled_pair(case)
    for n in (7, 13, 25, 9, 31):
        for sim in (eager, graphs):
            sim.run(n)
        _same_coupled(graphs, eager, f"{case} after {graphs.timestep} steps")
    assert graphs._graph_eligible() and graphs._graphs_apply() and not eager._graphs_apply()
    runner = graphs._runner
    assert runner is not None and eager._runner is None
    assert runner.replays >= 3 and runner.captures >= 1
    assert runner.pos_a is not None and [p.shape for p in runner.pos_a] == [(1200, 3)]
    period = graphs.mpcd_dynamics.period
    leads = {k[2] for k in runner.graph_keys() if len(k) == 3}
    assert leads and leads <= set(range(1, period + 1))
    if case == "short_first_window":
        assert graphs._mpcd["_srd_anchor"][2] % period == 0
    if case == "writer":
        assert graphs.operations.writers[0].fired == [7, 14, 21, 28, 35, 42, 49, 56, 63, 70,
                                                      77, 84]


def _inject(sim, at: int, which: str):
    """The chunk flags of the chunk that starts at timestep ``at`` read once
    as an overflow or a drift violation, as if a rebuild overflowed or a
    particle out-drifted the buffer there."""
    flags, done = sim._chunk_flags, []

    def once(meta, violated):
        overflow, viol, max_occ = flags(meta, violated)
        if sim.timestep == at and not done:
            done.append(at)
            if which == "overflow":
                return True, viol, max_occ
            return overflow, True, max_occ
        return overflow, viol, max_occ

    sim._chunk_flags = once
    return done


@pytest.mark.parametrize("which", ["violation", "overflow"])
def test_coupled_rollback_after_a_collision(which):
    """A chunk thrown away after its joint collisions ran (a drift
    violation, replayed at an interval of 9 that snaps to the same rebuild
    schedule on the period of 9; an overflow, replayed one rebuild a chunk)
    starts again from the anchor it was given: the run is bitwise a run
    without the replay, on the graphs and eagerly. The anchor the
    simulation keeps is never the runner's buffers."""
    runs = {}
    for graphs in (False, True):
        for replayed in (False, True):
            sim = _coupled(port, period=9)
            sim._capture, sim._eager = FakeCapture(), not graphs
            sim.run(18)
            done = _inject(sim, 18, which) if replayed else None
            sim.run(30)  # collisions at 27, 36 and 45
            if replayed:
                assert done == [18]
                assert sim.viol_replays == (1 if which == "violation" else 0)
            runs[graphs, replayed] = sim
    for (graphs, replayed), sim in runs.items():
        _same_coupled(sim, runs[False, False], f"graphs {graphs}, replayed {replayed}",
                      counted=not replayed)
    assert runs[True, True].steps_run > runs[True, False].steps_run
    runner = runs[True, True]._runner
    assert runner.replays >= 3
    anchor = runs[True, True]._mpcd["_srd_anchor"]
    assert anchor[0][0].data_ptr() != runner.pos_a[0].data_ptr()
    assert anchor[1][0].data_ptr() != runner.vel_a[0].data_ptr()


def test_coupled_segment_makes_no_host_read():
    """A coupled segment that collides on its last step, eagerly with the
    host's keys and under the device clock, and a stand-in capture and
    replays of its graph, with the anchor loaded and cloned out, read
    nothing on the host."""
    sim = _coupled(port)
    sim._capture = FakeCapture()
    sim.run(20)
    tbls = sim._force_tables()
    t = sim.timestep
    solv = sim._mpcd["_srd_anchor"]
    clock = torch.tensor(t, dtype=torch.int64)
    with no_host_reads():
        viol = torch.zeros((), dtype=torch.bool)
        sim._run_segment((sim._dense,), (sim._meta,), viol, t, 10, True, tbls, solv)
        with RNG.device_clock(clock, t):
            sim._run_segment((sim._dense,), (sim._meta,), viol, t, 10, True, tbls, solv)
    runner = sim._build_runner(tbls)
    assert runner is sim._runner
    replays = runner.replays
    with no_host_reads():
        runner.load(sim._dense, sim._meta, t, anchor=(solv[0][0], solv[1][0]))
        for k in range(3):  # already replayed by the run: three more replays
            runner.run(t + 10 * k, 10, True, 10)
        runner.anchor()
    assert runner.replays == replays + 3


def test_coupled_counters_under_replay(monkeypatch):
    """Under replay the coupled graphs count exactly what the eager loop
    counts: one K5 clock-form launch and one K10 call a joint collision (the
    kernels stand in on the CPU as counting wrappers of the plain
    versions), and every step and force evaluation."""
    from azplugins_tpu_torch import mpcd as M
    from azplugins_tpu_torch.ops import cellsum_kernel as CK
    from azplugins_tpu_torch.ops import rng_kernel as RK

    draws, axes, sums = RNG.collision_draws, RNG.jax_normal_axis, M._cell_sums

    def counted(name, fn):
        def call(*args, **kwargs):
            RK.launches_by_kernel[name] = RK.launches_by_kernel.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    def counted_sums(*args, **kwargs):
        CK.launches += 1
        return sums(*args, **kwargs)

    # counted into copies, which teardown drops: other tests read the counts
    monkeypatch.setattr(RK, "launches_by_kernel", dict(RK.launches_by_kernel))
    monkeypatch.setattr(CK, "launches", CK.launches)
    monkeypatch.setattr(RNG, "collision_draws", counted("jax_normal_axis_clock", draws))
    monkeypatch.setattr(RNG, "jax_normal_axis", counted("jax_normal_axis", axes))
    monkeypatch.setattr(M, "_cell_sums", counted_sums)
    eager, graphs = _coupled_pair("colloids")
    for sim in (eager, graphs):
        clock0, host0 = (RK.launches_by_kernel.get(k, 0)
                         for k in ("jax_normal_axis_clock", "jax_normal_axis"))
        k10 = CK.launches
        sim.run(30)
        sim.run(30)
        clock, host = (RK.launches_by_kernel.get(k, 0) - n
                       for k, n in (("jax_normal_axis_clock", clock0), ("jax_normal_axis", host0)))
        assert (clock, host) == ((6, 0) if sim is graphs else (0, 6))
        assert CK.launches - k10 == 6
    assert graphs._runner.replays >= 4
    assert (graphs.steps_run, graphs.force_evaluations) == (eager.steps_run,
                                                            eager.force_evaluations) == (60, 61)


@pytest.mark.parametrize("trigger", ["phase", "period", "after"])
def test_a_replaced_trigger_keeps_the_eager_loop(trigger):
    """A coupling whose trigger is not the default (another phase, another
    period, a trigger of another kind) fires at the host's steps on the
    eager loop, before any capture; the default trigger takes the graphs."""
    sim = _coupled(port)
    sim._capture = capture = FakeCapture()
    coupling = sim.operations.updaters[0]
    coupling.trigger = {"phase": port.trigger.Periodic(10, phase=2),
                        "period": port.trigger.Periodic(5, phase=4),
                        "after": port.trigger.After(12)}[trigger]
    sim.run(20)
    assert not coupling._ingraph
    assert not sim._graph_eligible() and not sim._graphs_apply()
    assert sim._runner is None and capture.graphs == []
    coupling.trigger = port.trigger.Periodic(10, phase=9)
    sim.run(20)
    assert coupling._ingraph and sim._graph_eligible() and sim._runner is not None


def test_coupled_graphs_match_reference():
    """The coupled case of test_torch_mpcd.py's two collisions on the
    segment graphs: seven steps in chunks of 2, 3 and 2 (the second sight
    of a key is captured and replayed), the solvent continued from the
    reference's stream and anchor, three more steps (a replayed collision):
    the solvent and the solutes within the same bars (1e-6 of L in position,
    1e-5 of max|v| in velocity) of the JAX reference's run, the anchor at
    the same clock."""
    from azplugins_tpu_torch import interop

    sims = [_coupled(az, forces=False, N_s=3000, n=2, L=8.0, period=5, lattice=False)
            for az in (ref, port)]
    rsim, psim = sims
    psim._capture = FakeCapture()
    rsim.run(7)
    for n in (2, 3, 2):
        psim.run(n)
    psim._mpcd = interop.mpcd_from_reference(rsim._mpcd, "cpu")
    assert psim._mpcd["_srd_anchor"][2] == 5
    replays = psim._runner.replays
    for sim in sims:
        sim.run(3)
    assert psim._runner.replays > replays and psim._runner.captures >= 2
    (xr, vr, mr), (xp, vp, mp) = ((s.state.get_snapshot().mpcd.position,
                                   s.state.get_snapshot().mpcd.velocity,
                                   s.state.get_snapshot().particles.velocity) for s in sims)
    np.testing.assert_allclose(xp, xr, rtol=0, atol=1e-6 * 8.0)
    np.testing.assert_allclose(vp, vr, rtol=0, atol=1e-5 * np.abs(vr).max())
    np.testing.assert_allclose(mp, mr, rtol=0, atol=1e-5 * np.abs(vr).max())
    assert int(np.asarray(rsim._mpcd["_srd_anchor"][2])) == psim._mpcd["_srd_anchor"][2] == 10
