"""K1's Verlet pair lists (ops/pair_kernel.py, csrc/cell_pair_force.cu).

Inside a rebuild segment on the card, K1's force-only calls sweep per-lane
lists that a build at the segment's start made from the positions of the
layout's last rebuild (``GridMeta.ref_position``, what the drift check
measures against), at the largest cutoff plus the Verlet buffer.

On the CPU (the plain version sweeps every candidate; the lists stand in
through ``lists_apply``, the build recorded): the list buffer's size from
a layout, the list radius, which K1 calls of a segment plan build and which
sweep (every segment builds first, a continuation segment and the segments
of a violation replay too, and each sweep reads the list of its own
layout; the force of ``_prepare`` and of observables takes none), on the
stand-in graphs and the eager loop, one list a layout for every K1 force
and both loops, and the tracer's ``pair_list`` counters, exact under
replay.

On the card (``-m cuda``; no JAX, so ``--noconftest`` runs it): the
sweep's forces bitwise the full sweep's, and within the kernel tests' bar
of the plain PyTorch version, after steps that pass the drift check, for
every potential of ``KERNEL_POTENTIALS``, with lattice shifts and with
minimum image, modes none and xplor; a pair that enters the
cutoff between rebuilds; a simulation with continuation segments and
violation replays bitwise the one without lists, on the graphs and the
eager loop, one build a segment; crowded cells whose lists overflow fall
back with the same bits and are counted in ``fallback_blocks``.
"""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu_torch import trace as T  # noqa: E402
from azplugins_tpu_torch.md import pair as P  # noqa: E402
from azplugins_tpu_torch.ops import dense as D  # noqa: E402
from azplugins_tpu_torch.ops import pair_kernel as PK  # noqa: E402

torch.set_num_threads(1)


def _liquid(n=8, a=1.15, kT=1.2, buffer=0.4, device="cpu", seed=3, dpd=False, gauss=False):
    """An LJ liquid of n^3 particles under Langevin (with ``dpd``, a DPD
    force beside it, which takes no list; with ``gauss``, a Gaussian core
    of cutoff 1.5, another K1 force)."""
    rng = np.random.default_rng(seed)
    snap = port.Snapshot(N=n**3)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A", "B"]
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-0.1, 0.1, pos.shape)
    snap.particles.typeid[:] = rng.integers(0, 2, n**3)
    sim = port.Simulation(device=device, seed=42)
    sim.create_state_from_snapshot(snap)
    cell = port.md.nlist.Cell(buffer=buffer)
    lj = port.pair.LJ(nlist=cell, default_r_cut=2.5, mode="shift")
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    lj.params[("A", "B")] = dict(epsilon=0.5, sigma=1.0)
    lj.params[("B", "B")] = dict(epsilon=0.5, sigma=1.0)
    forces = [lj]
    if dpd:
        d = port.pair.DPDGeneralWeight(nlist=cell, kT=kT, default_r_cut=1.0)
        d.params[("A", "A")] = d.params[("A", "B")] = d.params[("B", "B")] = dict(
            A=5.0, gamma=1.0, s=1.0)
        forces.append(d)
    if gauss:
        g = port.pair.Gaussian(nlist=cell, default_r_cut=1.5)
        g.params[("A", "A")] = g.params[("A", "B")] = g.params[("B", "B")] = dict(
            epsilon=1.0, sigma=0.5)
        forces.append(g)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=kT, default_gamma=0.5)], forces=forces)
    sim.state.thermalize_particle_momenta(kT=kT)
    return sim


class _Capture:
    """The stand-in capture: the segment's Python runs (the runner takes its
    counters back) and its buffers stay as they were; a replay does the
    segment's work with its Python counters held."""

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


def _on(sim, loop):
    sim._capture = _Capture()
    sim._eager = loop == "eager"
    return sim


# ---------------------------------------------------------------------------
# CPU: sizes, radius, the segment plan, the counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap, want", [(8, 8), (48, 56), (56, 80), (72, 128), (304, 1344)])
def test_list_capacity_from_the_layout(cap, want):
    """A lane's entries: a sphere one cell edge wide at full occupancy
    (4 pi / 3 cap particles) over the fewest lanes a slot gets (256 // cap),
    a quarter more, rounded up to 8; past 256 slots it stops growing."""
    assert PK.list_capacity(cap) == want
    c = min(cap, 256)
    assert want >= 1.25 * 4 * math.pi / 3 * c / (256 // c) and want % 8 == 0


def test_pair_list_buffers_are_sized_from_the_grid():
    spec = D.GridSpec(dims=(5, 4, 3), cap=24, r_cut=2.5, buffer=0.4)
    total = torch.zeros((), dtype=torch.int64)
    pl = PK.PairList(spec, "cpu", total)
    assert pl.cap_e == PK.list_capacity(24)
    assert tuple(pl.entries.shape) == (60, pl.cap_e, PK.LIST_LANES)
    assert tuple(pl.counts.shape) == (60, PK.LIST_LANES)
    # every block sweeps every candidate until the first build
    assert pl.fallback.shape == (60,) and bool((pl.fallback == 1).all())
    assert tuple(pl.plans.shape) == (60, PK.PLAN_INTS)
    assert pl.n_fallback is total and pl.tensors()[-1] is total
    pl.check(spec, torch.device("cpu"))
    with pytest.raises(ValueError, match="grid"):
        pl.check(spec.replace(cap=32), torch.device("cpu"))
    with pytest.raises(TypeError, match="n_fallback"):
        PK.PairList(spec, "cpu", torch.zeros((), dtype=torch.int32))


def test_plan_ints_are_the_kernels_plan():
    """``PLAN_INTS`` is ``sizeof(az::StencilPlan) / sizeof(int)``, counted
    from the struct's fields in ``csrc/cell_stencil.cuh`` (a mismatch makes
    the kernel refuse the launch)."""
    from azplugins_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "cell_stencil.cuh").read_text()
    body = re.search(r"struct StencilPlan \{(.*?)\};", src, re.S).group(1)
    ints = 0
    for decl in re.findall(r"^\s*int ([^;]*);", body, re.M):
        for name in decl.split(","):
            size = re.search(r"\[kMaxSegments( \+ 1)?\]", name)
            ints += (28 if size.group(1) else 27) if size else 1
    assert ints == PK.PLAN_INTS == 195


def test_list_radius_covers_the_drift_and_the_rounding():
    box = port.core.box.Box(np.array([40.0, 30.0, 20.0]), np.array([0.5, 0.0, 0.0]))
    rsq = PK.list_rsq(2.5, 0.4, box)
    r = math.sqrt(rsq)
    assert 2.9 * (1 + 1e-5) < r < 2.9 * (1 + 1e-4)
    assert r - 2.9 * (1 + 1e-5) == pytest.approx(2.0**-20 * 40.0 * 1.5)
    assert PK.list_rsq(2.5, 0.5, box) > rsq > PK.list_rsq(2.0, 0.4, box)


class _Lists:
    """Stands the card in on the CPU: lists allocated, each build recorded
    (the layout and reference it read), each force call recorded as
    ``build``, ``sweep``, ``force`` (no list) or ``all``, and each sweep
    checked to read the list of its own layout."""

    def __init__(self, monkeypatch, fallback=0, r_max=2.5):
        self.events = []
        self.fallback = fallback
        self.r_max = r_max
        self._pair_force = P.pair_force
        monkeypatch.setattr(PK, "lists_apply", lambda device: True)
        monkeypatch.setattr(PK, "build_pair_list", self.build)
        monkeypatch.setattr(P, "pair_force", self.force)

    def build(self, dense, ref_position, spec, r_max, pl):
        assert r_max == self.r_max and ref_position.shape == dense.position.shape
        pl.built = (dense.tag.clone(), ref_position.clone())
        pl.n_fallback.add_(self.fallback)
        self.events.append("build")

    def force(self, fn, dense, spec, tbl, mode="none", want="all", window=None, pair_list=None):
        if pair_list is None:
            self.events.append(want)
        else:
            tag, ref = pair_list.built
            assert want == "force" and window is None
            assert torch.equal(tag, dense.tag), "a sweep of another layout's list"
            self.events.append("sweep")
        return self._pair_force(fn, dense, spec, tbl, mode, want, window=window)

    def segments(self):
        """Each segment's sweeps, a segment being a build and what follows."""
        out = []
        for e in self.events:
            if e == "build":
                out.append(0)
            elif e == "sweep":
                out[-1] += 1
        return out


@pytest.mark.parametrize("loop", ["graphs", "eager"])
def test_every_segment_builds_then_sweeps(monkeypatch, loop):
    """Chunks of at most 7 steps split the rebuild segments, so chunks that
    continue a segment (no rebuild) come; each segment, rebuilding or not,
    builds first and sweeps once a step. The prepared force and an
    observable's take no list."""
    lists = _Lists(monkeypatch)
    sim = _on(_liquid(), loop)
    sim.auto_tune_after = None
    sim.max_chunk = 7
    sim.tracer.enable()
    sim.run(60)
    assert lists.events[0] == "force"  # _prepare
    spans = [s.name for s in sim.tracer.drain()]
    segments = lists.segments()
    n_seg = sum(spans.count(f"az.segment.{k}") for k in ("first", "capture", "replay", "loop"))
    assert len(segments) == n_seg and all(n >= 1 for n in segments)
    assert sum(segments) >= 60 and ("az.segment.capture" in spans) == (loop == "graphs")
    chunk_ends = sim.tracer.counters()["chunk_ends"]
    assert chunk_ends.get("max_chunk", 0) + chunk_ends.get("align", 0) > 0
    n = len(lists.events)
    sim.operations.integrator.forces[0].energy
    assert lists.events[n:] == ["all"]


@pytest.mark.parametrize("loop", ["graphs", "eager"])
def test_violation_replays_build_their_own_lists(monkeypatch, loop):
    """A hot liquid on a thin buffer: drift violations replay chunks from
    their start state, whose layout predates the thrown-away chunk's; each
    replayed segment builds from its own layout before it sweeps (the
    recorder checks every sweep against its list's layout)."""
    lists = _Lists(monkeypatch)
    sim = _on(_liquid(kT=3.0, buffer=0.15), loop)
    sim.auto_tune_after = None
    sim.run(60)
    assert sim.viol_replays >= 1
    assert "sweep" in lists.events and lists.events.index("build") < lists.events.index("sweep")


def test_only_the_pair_potentials_of_k1_take_a_list(monkeypatch):
    """Beside LJ, a DPD force (its own kernel) sweeps no list; the list
    applies only where ``lists_apply`` holds (the card), and not on
    shards."""
    lists = _Lists(monkeypatch)
    sim = _liquid(dpd=True)
    monkeypatch.setattr(PK, "lists_apply", lambda device: False)
    sim.run(2)
    assert sim._pair_list() is None and lists.events.count("sweep") == 0  # the CPU
    monkeypatch.setattr(PK, "lists_apply", lambda device: True)
    pl = sim._pair_list()
    assert isinstance(pl, PK.PairList) and pl.spec == sim._grid_spec
    assert pl.n_fallback is sim.tracer.fallback_total(sim.device)
    sim.run(4)
    assert lists.events.count("sweep") == 4  # the LJ's, one a step
    sim.enable_spatial_decomposition(port.parallel.make_mesh(2, device="cpu", sharded=True))
    sim.run(1)
    assert sim._pair_list() is None


@pytest.mark.parametrize("loop", ["graphs", "eager"])
def test_one_list_a_layout_serves_every_k1_force(monkeypatch, loop):
    """Two K1 forces of cutoffs 2.5 and 1.5: one build a segment at the
    larger, swept by both (each by its own cutoffs), and one list buffer,
    which the runner and the eager loop share while the grid keeps its
    spec and which the capacity tune's new spec replaces."""
    lists = _Lists(monkeypatch, r_max=2.5)
    sim = _on(_liquid(gauss=True), loop)
    sim.auto_tune_after = None
    sim.max_chunk = 7
    sim.tracer.enable()
    sim.run(30)
    assert all(n >= 2 and n % 2 == 0 for n in lists.segments())
    spans = [s.name for s in sim.tracer.drain()]
    run = sum(spans.count(f"az.segment.{k}") for k in ("first", "replay", "loop"))
    counted = sim.tracer.counters()["pair_list"]
    assert counted == {"builds": run, "sweeps": 2 * sim.steps_run, "fallback_blocks": 0}
    pl = sim._pair_list()
    assert pl is sim._pair_list() and pl.spec == sim._grid_spec
    if loop == "graphs":
        assert sim._runner.pair_list is pl
    sim._grid_spec = sim._grid_spec.replace(cap=sim._grid_spec.cap + 8)
    assert sim._pair_list() is not pl and sim._pair_list().spec == sim._grid_spec


@pytest.mark.parametrize("loop", ["graphs", "eager"])
def test_pair_list_counters_are_exact_under_replay(monkeypatch, loop):
    """``builds`` one a segment run, ``sweeps`` one a step (one pair
    force), ``fallback_blocks`` what the builds added on the device (2 a
    build here), the captures' work taken back; the trajectory is the one
    without lists (the CPU's plain force sweeps every candidate)."""
    plain = _on(_liquid(), loop)
    plain.auto_tune_after = None
    plain.run(40)
    _Lists(monkeypatch, fallback=2)
    sim = _on(_liquid(), loop)
    sim.auto_tune_after = None
    assert sim.tracer.counters()["pair_list"] == {"builds": 0, "sweeps": 0,
                                                  "fallback_blocks": 0}
    sim.tracer.enable()
    sim.run(40)
    spans = [s.name for s in sim.tracer.drain()]
    run = sum(spans.count(f"az.segment.{k}") for k in ("first", "replay", "loop"))
    counted = sim.tracer.counters()["pair_list"]
    assert counted == {"builds": run, "sweeps": sim.steps_run, "fallback_blocks": 2 * run}
    assert sim.steps_run >= 40
    a, b = sim.state.get_snapshot(), plain.state.get_snapshot()
    np.testing.assert_array_equal(a.particles.position, b.particles.position)


def test_the_fallback_total_is_one_tensor_a_device():
    tracer = T.Tracer()
    t = tracer.fallback_total(torch.device("cpu"))
    assert t is tracer.fallback_total("cpu") and t.dtype == torch.int64 and t.ndim == 0
    t.add_(5)
    assert tracer.counters()["pair_list"]["fallback_blocks"] == 5
    assert T.mark_id("void az_phase_mark<7>()") == 7
    assert "pair_list" in tracer.mark_table().values()


def test_the_segment_marks_the_build(monkeypatch):
    """With marks on, a segment marks ``pair_list`` once a build, after
    ``rebin``."""
    lists = _Lists(monkeypatch)
    sim = _on(_liquid(), "eager")
    sim.auto_tune_after = None
    sim.run(3)
    builds = lists.events.count("build")
    sim.tracer.enable(marks=True)
    sim.run(30)
    marks = sim.tracer.counters()["marks"]
    assert marks["pair_list"] == lists.events.count("build") - builds >= marks["rebin"] >= 2


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair lists run only on the GPU")
    return torch.device("cuda")


def _kernel_system(name, device, potential):
    from test_torch_kernels import _system

    return _system(name, device, potential)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _walk(dense, spec, steps, seed):
    """Positions after each of ``steps`` random steps from ``dense``'s, each
    particle at most buffer / (2 steps) a step: the two largest drifts sum
    under the buffer, so every state passes the drift check."""
    g = torch.Generator(device=dense.position.device).manual_seed(seed)
    occupied = (dense.tag >= 0)[:, None]
    pos, out = dense.position.clone(), []
    for _ in range(steps):
        d = torch.randn(pos.shape, generator=g, device=pos.device)
        d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-6)
        d = d * torch.rand((pos.shape[0], 1), generator=g, device=pos.device)
        pos = torch.where(occupied, pos + d * (0.999 * spec.buffer / (2 * steps)), pos)
        out.append(dense.replace(position=pos))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "xplor"])
@pytest.mark.parametrize("system", ["tilted", "axis_under_3"])
@pytest.mark.parametrize("potential", list(PK.KERNEL_POTENTIALS))
def test_sweep_is_bitwise_the_full_filter(cuda_device, potential, system, mode):
    """The lists built at a rebuild's positions, then 1..4 steps that pass
    the drift check: each step's force from the lists is bitwise the force
    from every candidate, and within the kernel tests' bar of the plain
    PyTorch version (``tilted``: lattice shifts; ``axis_under_3``: minimum
    image), every occupied block on its lists."""
    from test_torch_kernels import _close, _plain

    dense, spec, tbl = _kernel_system(system, cuda_device, potential)
    assert spec.newton_ok == (system == "tilted")
    tables = PK.kernel_tables(potential, tbl["params"], tbl["r_cut"], tbl["r_on"], mode)
    pl = PK.PairList(spec, cuda_device, torch.zeros((), dtype=torch.int64, device=cuda_device))
    builds = PK.list_builds
    PK.build_pair_list(dense, dense.position.clone(), spec, float(tbl["r_cut"].max()), pl)
    assert PK.list_builds == builds + 1
    for k, state in enumerate(_walk(dense, spec, 4, seed=7)):
        full = PK.cell_pair_force(state, spec, tables, potential, mode, "force")
        swept = PK.cell_pair_force(state, spec, tables, potential, mode, "force", pair_list=pl)
        assert torch.equal(_bits(swept.force), _bits(full.force)), f"step {k + 1}"
        _close(swept.force, _plain(state, spec, tbl, mode, "force", potential).force,
               f"{potential} {system} {mode}: the sweep against the plain version, step {k + 1}")
    torch.cuda.synchronize()
    occupied = (dense.tag >= 0).view(-1, spec.cap).any(1)
    assert not bool(pl.fallback[occupied].all())
    if system == "tilted":
        assert int(pl.n_fallback) == 0 and not bool(pl.fallback[occupied].any())


@pytest.mark.cuda
def test_a_pair_entering_the_cutoff_between_rebuilds(cuda_device):
    """Two particles r_cut + buffer less 0.01 apart at the rebuild, each
    then drifting just under buffer / 2 toward the other: inside r_cut, the
    pair is on the lists and its force is the full sweep's, and nonzero."""
    snap = port.Snapshot(N=2)
    snap.configuration.box = [14.0, 14.0, 14.0, 0, 0, 0]
    snap.particles.types = ["A"]
    state, _, _ = port.core.state_from_snapshot(snap, cuda_device)
    spec = D.GridSpec.create(state.box, 2, 2.5, 0.4)
    d0 = 2.5 + spec.buffer - 0.01
    state = state.replace(position=torch.tensor([[0.0, 0.0, 0.0], [d0, 0.0, 0.0]],
                                                device=cuda_device))
    dense, meta = D.densify(state, spec, fields=())
    lj = {"params": PK.PAIR_POTENTIALS["LJ"].precompute(
        {"epsilon": np.ones((1, 1)), "sigma": np.ones((1, 1))})}
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=cuda_device)
              for k, v in lj["params"].items()}
    r_cut = torch.full((1, 1), 2.5, device=cuda_device)
    tables = PK.kernel_tables("LJ", params, r_cut, torch.zeros_like(r_cut), "none")
    pl = PK.PairList(spec, cuda_device, torch.zeros((), dtype=torch.int64, device=cuda_device))
    PK.build_pair_list(dense, meta.ref_position, spec, 2.5, pl)
    step = 0.4999 * spec.buffer
    x, occ = dense.position[:, 0], dense.tag >= 0
    moved = torch.where(occ & (x > d0 / 2), x - step, torch.where(occ, x + step, x))
    now = dense.replace(position=torch.stack([moved, dense.position[:, 1],
                                              dense.position[:, 2]], 1))
    viol = torch.zeros((), dtype=torch.bool, device=cuda_device)
    assert not bool(D.needs_rebin(now, meta, spec, viol))
    full = PK.cell_pair_force(now, spec, tables, "LJ", "none", "force")
    swept = PK.cell_pair_force(now, spec, tables, "LJ", "none", "force", pair_list=pl)
    assert torch.equal(_bits(swept.force), _bits(full.force))
    assert float(swept.force.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["graphs", "eager"])
def test_runs_with_lists_are_bitwise_runs_without(cuda_device, monkeypatch, loop):
    """4,096 particles, hot, on a thin buffer, in chunks of at most 7 steps:
    continuation segments and violation replays come, and every state is
    bitwise the run without lists; one build a segment run, one sweep a
    step, no block falls back."""
    runs = {}
    for lists in (False, True):
        with monkeypatch.context() as m:
            if not lists:
                m.setattr(PK, "lists_apply", lambda device: False)
            sim = _liquid(n=16, kT=3.0, buffer=0.15, device=cuda_device)
            sim._eager = loop == "eager"
            sim.auto_tune_after = 50
            sim.max_chunk = 7
            sim.tracer.enable()
            sim.run(150)
            runs[lists] = sim
    sim = runs[True]
    assert sim.viol_replays >= 1
    assert sim.tracer.counters()["chunk_ends"].get("max_chunk", 0) > 0
    a, b = sim.state.get_snapshot(), runs[False].state.get_snapshot()
    for f in ("position", "velocity", "image"):
        np.testing.assert_array_equal(getattr(a.particles, f), getattr(b.particles, f), f)
    spans = [s.name for s in sim.tracer.drain()]
    run = sum(spans.count(f"az.segment.{k}") for k in ("first", "replay", "loop"))
    counted = sim.tracer.counters()["pair_list"]
    assert counted == {"builds": run, "sweeps": sim.steps_run, "fallback_blocks": 0}
    assert runs[False].tracer.counters()["pair_list"]["builds"] == 0


@pytest.mark.cuda
def test_crowded_cells_fall_back_with_the_same_bits(cuda_device):
    """Eight clumps of 100 non-interacting particles, one in each cell
    around a corner (as evaporated particles overlap), in an LJ liquid:
    their lanes' lists outgrow the capacity, those blocks sweep every
    candidate, counted in the tracer's ``fallback_blocks``, and the forces
    stay bitwise the full sweep's."""
    rng = np.random.default_rng(11)
    L, a = 16.0, 1.2
    x = (np.arange(13) + 0.5) * a - L / 2
    liquid = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    corner = np.array([-4.8, -4.8, -4.8])
    liquid = liquid[np.linalg.norm(liquid - corner, axis=1) > 1.0]
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    clumps = np.concatenate([corner + s * rng.uniform(0.01, 0.1, (100, 3)) for s in signs])
    pos = np.concatenate([liquid, clumps])
    snap = port.Snapshot(N=len(pos))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A", "B"]
    snap.particles.position[:] = pos
    snap.particles.typeid[:] = [0] * len(liquid) + [1] * len(clumps)
    state, _, _ = port.core.state_from_snapshot(snap, cuda_device)
    spec = D.GridSpec.create(state.box, len(pos), 2.5, 0.4)
    dense, meta = D.densify(state, spec, fields=())
    while bool(meta.overflow):
        spec = spec.replace(cap=int(np.ceil((int(meta.max_occ) + 1) / 8.0) * 8))
        dense, meta = D.densify(state, spec, fields=())
    host = PK.PAIR_POTENTIALS["LJ"].precompute(
        {"epsilon": np.array([[1.0, 0.0], [0.0, 0.0]]), "sigma": np.ones((2, 2))})
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=cuda_device)
              for k, v in host.items()}
    r_cut = torch.tensor([[2.5, 0.0], [0.0, 0.0]], device=cuda_device)
    tables = PK.kernel_tables("LJ", params, r_cut, torch.zeros_like(r_cut), "shift")
    tracer = T.Tracer()
    pl = PK.PairList(spec, cuda_device, tracer.fallback_total(cuda_device))
    PK.build_pair_list(dense, meta.ref_position, spec, 2.5, pl)
    for state in _walk(dense, spec, 2, seed=5):
        full = PK.cell_pair_force(state, spec, tables, "LJ", "shift", "force")
        swept = PK.cell_pair_force(state, spec, tables, "LJ", "shift", "force", pair_list=pl)
        assert torch.equal(_bits(swept.force), _bits(full.force))
    fell = int(pl.fallback.sum())
    assert fell >= 8 and tracer.counters()["pair_list"]["fallback_blocks"] == fell
    assert fell < spec.n_cells // 2  # the liquid's blocks keep their lists
