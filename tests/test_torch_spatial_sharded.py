"""The port's sharded spatial decomposition against the JAX reference and
against the port's own undecomposed runs.

On a sharded mesh (``make_mesh(n, device="cpu", sharded=True)``: n shards
with slot storage of their own on one device, as the reference's suite runs
its mesh on virtual CPU devices) each block rebuilds with the block-local
rebin and migration (``parallel/spatial.py::spatial_rebin``) and its
stencil forces read a halo window. Held bitwise:

- ``spatial_rebin``'s payload, overflow flag and max occupancy against the
  reference's ``spatial_rebin`` on its 8-device CPU mesh, and the payload
  against the port's global ``rebin`` (drifts, slabs, strips, a tilted box,
  1, 2, 4 and 8 blocks); a fast particle and a full migrant buffer raise
  the flag as the reference raises it;
- the plain windowed pair, DPD and anisotropic forces against the plain
  whole-grid forces on each shard's own slots;
- sharded simulations against undecomposed ones: trajectory, images,
  rebuild counts, capacity and observables.

Against the reference's decomposed run the port holds the 20-step bars of
``test_torch_simulation.py`` (positions 1e-4, velocities 1e-4 of max|v|).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from torch_compile_cache import no_compile_cache  # noqa: E402, F401
from azplugins_tpu.core.state import state_from_snapshot as ref_state_from_snapshot  # noqa: E402
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from azplugins_tpu.parallel import shard_state as ref_shard_state  # noqa: E402
from azplugins_tpu.parallel import spatial as RS  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.ops import pair_kernel as PK  # noqa: E402
from azplugins_tpu_torch.ops.evaluators.aniso import ANISO_PAIR_POTENTIALS  # noqa: E402
from azplugins_tpu_torch.ops.evaluators.pair import PAIR_POTENTIALS  # noqa: E402
from azplugins_tpu_torch.parallel import (  # noqa: E402
    gather_dense, halo_window, make_mesh, shard_dense, spatial_rebin,
)
from azplugins_tpu_torch.parallel import spatial as PS  # noqa: E402

torch.set_num_threads(1)

SLABS = [14.5, 7.3, 7.3]  # dims (8, 4, 4) at r_list 1.8: one x plane a block of 8
CUBE = [7.3, 7.3, 7.3]  # dims (4, 4, 4): 8 blocks of two z columns
TILT = (0.2, 0.0, 0.1)
PAYLOAD = ("position", "velocity", "acceleration", "typeid", "tag", "image", "mass",
           "orientation")


def _sharded(n):
    return make_mesh(n, device="cpu", sharded=True)


def _positions(rng, L, N, tilt=(0.0, 0.0, 0.0)):
    """N uniform positions in a (tilted) box of edges L."""
    f = rng.random((N, 3)) - 0.5
    xy, xz, yz = tilt
    return np.stack([f[:, 0] * L[0] + f[:, 1] * xy * L[1] + f[:, 2] * xz * L[2],
                     f[:, 1] * L[1] + f[:, 2] * yz * L[2],
                     f[:, 2] * L[2]], axis=1)


def _bits(a):
    a = np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# spatial_rebin against the reference's and the global rebin
# ---------------------------------------------------------------------------
def _grid_system(L, N, seed, tilt=(0.0, 0.0, 0.0), drift=0.0, drift_seed=9, jump=None):
    """The reference's densified system, drifted (numpy), in both packages:
    (reference dense, reference meta, port dense, port meta, spec, N)."""
    rng = np.random.default_rng(seed)
    snap = ref.Snapshot(N=N)
    snap.configuration.box = list(L) + list(tilt)
    snap.particles.types = ["A", "B"]
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    snap.particles.position[:] = _positions(rng, L, N, tilt)
    state, _, _ = ref_state_from_snapshot(snap)
    rspec = RD.GridSpec.create(state.box, N, r_cut=1.5, buffer=0.3)
    rdense, rmeta = RD.densify(state, rspec)
    assert not bool(rmeta.overflow)
    occupied = np.asarray(rdense.tag) >= 0
    dpos = np.zeros(np.asarray(rdense.position).shape, np.float32)
    if drift:
        dpos = np.random.default_rng(drift_seed).uniform(-drift, drift, dpos.shape)
        dpos = np.where(occupied[:, None], dpos, 0.0).astype(np.float32)
    if jump is not None:  # a particle jumping two slabs, as the reference's test
        dpos[int(np.argmax(occupied)), 0] += jump
    rdense = rdense.replace(position=rdense.position + jax.numpy.asarray(dpos))
    pdense = interop.state_from_reference(rdense, "cpu")
    pmeta = interop.grid_meta_from_reference(rmeta, "cpu")
    spec = interop.grid_spec_from_reference(rspec)
    return rdense, rmeta, rspec, pdense, pmeta, spec, N


def _ref_spatial(rdense, rmeta, rspec, N, n, migrate_cap=None):
    mesh = ref_make_mesh(n)
    fn = jax.jit(lambda d, m: RS.spatial_rebin(d, m, rspec, N, need_slot_of=False, mesh=mesh,
                                               migrate_cap=migrate_cap))
    return fn(ref_shard_state(rdense, mesh), rmeta)


def _port_spatial(pdense, pmeta, spec, N, n, migrate_cap=None):
    mesh = _sharded(n)
    shards = shard_dense(pdense, mesh)
    out, metas = spatial_rebin(shards, PS.shard_meta(pmeta, shards), spec, N, mesh=mesh,
                               migrate_cap=migrate_cap)
    overflow = bool(torch.stack([m.overflow for m in metas]).any())
    max_occ = int(torch.stack([m.max_occ for m in metas]).max())
    assert len({int(m.n_builds) for m in metas}) == 1
    return gather_dense(out, "cpu"), overflow, max_occ, out


def _check_rebin(case, n, migrate_cap=None, expect_overflow=False):
    """The payload bitwise the reference's spatial rebin, but for the x
    sentinel of empty slots: ``Lx + (slot + 1) * stride``, which XLA
    contracts into one rounding under jit (the reference's own eager densify
    rounds twice, as the port does), is held within 1 ulp there, and bitwise
    to the port's global rebin."""
    rdense, rmeta, rspec, pdense, pmeta, spec, N = case
    got, overflow, max_occ, shards = _port_spatial(pdense, pmeta, spec, N, n, migrate_cap)
    assert all(s.N == spec.S // n for s in shards)
    want, wmeta = _ref_spatial(rdense, rmeta, rspec, N, n, migrate_cap)
    empty = got.tag.numpy() < 0
    for f in PAYLOAD:
        a, b = _bits(getattr(got, f)), _bits(np.asarray(getattr(want, f)))
        if f == "position":
            np.testing.assert_array_max_ulp(got.position.numpy()[empty, 0],
                                            np.asarray(want.position)[empty, 0], maxulp=1)
            a, b = a.copy(), b.copy()
            a[empty, 0] = b[empty, 0] = 0
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert overflow == bool(wmeta.overflow) == expect_overflow
    assert max_occ == int(wmeta.max_occ)
    if not expect_overflow:  # and the global rebin's layout
        glob, gmeta = PD.rebin(pdense, pmeta, spec, N, need_slot_of=False)
        for f in PAYLOAD:
            np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(glob, f)),
                                          err_msg=f)
        assert max_occ == int(gmeta.max_occ)


@pytest.mark.parametrize("drift", [0.0, 1.0])
def test_rebin_slabs(drift):
    _check_rebin(_grid_system(SLABS, 700, 4, drift=drift), 8)


@pytest.mark.parametrize("drift", [0.0, 1.0])
def test_rebin_strips(drift):
    """8 blocks on 4 x planes: the y and x wraps hop several blocks."""
    case = _grid_system(CUBE, 500, 4, drift=drift)
    assert PS._hop_bound(case[5].dims, 8) > 1
    _check_rebin(case, 8)


@pytest.mark.parametrize("drift", [0.0, 0.5])
def test_rebin_triclinic(drift):
    case = _grid_system(SLABS, 700, 4, tilt=TILT, drift=drift)
    assert (case[5].dims[0] * case[5].dims[1]) % 4 == 0
    _check_rebin(case, 4)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_rebin_mesh_sizes(n):
    """n = 1 (both neighbours are the shard itself) and n = 2 (the left
    neighbour is the right one) neither duplicate a migrant nor flag one."""
    _check_rebin(_grid_system(SLABS, 700, 6, drift=1.0, drift_seed=8), n)


def test_rebin_fused_key_fallback(monkeypatch):
    """Past the fused key's 32 bits the two-operand sort gives the same layout."""
    monkeypatch.setattr(PS, "_FUSED_KEY_LIMIT", 0)
    _check_rebin(_grid_system(CUBE, 500, 4, drift=1.0), 8)


@pytest.mark.parametrize("flag", ["fast_particle", "migrant_overflow"])
def test_rebin_flags_as_the_reference(flag):
    """A particle jumping two slabs (impossible under the Verlet margin) is
    lost and a tiny migrant buffer overflows: both raise the overflow flag,
    with the reference's layout and max occupancy."""
    if flag == "fast_particle":
        _check_rebin(_grid_system(SLABS, 700, 5, jump=2 * 14.5 / 8 + 0.2), 8,
                     expect_overflow=True)
    else:
        _check_rebin(_grid_system(SLABS, 700, 4, drift=1.5, drift_seed=3), 8, migrate_cap=8,
                     expect_overflow=True)


@pytest.mark.parametrize("dims,n", [((8, 4, 4), 8), ((8, 4, 4), 2), ((8, 4, 4), 1),
                                    ((4, 4, 4), 8), ((8, 3, 4), 3), ((7, 4, 4), 4),
                                    ((12, 12, 12), 4), ((12, 12, 12), 16)])
def test_hop_bound_matches_reference(dims, n):
    assert PS._hop_bound(dims, n) == RS._hop_bound(dims, n)
    spec = PD.GridSpec(dims=dims, cap=16, r_cut=1.5, buffer=0.3)
    rspec = RD.GridSpec(dims=dims, cap=16, r_cut=1.5, buffer=0.3)
    assert PS.slab_migrate_capacity(spec, n) == RS.slab_migrate_capacity(rspec, n)


# ---------------------------------------------------------------------------
# the plain windowed stencil
# ---------------------------------------------------------------------------
def _window_system(kind, seed=3):
    """A two-type system densified for ``kind``'s cutoff, with velocities and
    unit quaternions: (dense, spec, force(dense, window))."""
    rng = np.random.default_rng(seed)
    L, N = [9.6, 8.0, 7.2], 520
    snap = port.Snapshot(N=N)
    snap.configuration.box = L + [0.1, 0.0, 0.05]
    snap.particles.types = ["A", "B"]
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    snap.particles.position[:] = _positions(rng, L, N, (0.1, 0.0, 0.05))
    snap.particles.velocity[:] = rng.normal(0, 1, (N, 3))
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    state, _, _ = port.core.state_from_snapshot(snap, "cpu")
    r_cut = {"pair": 1.5, "dpd": 1.0, "aniso": 1.6}[kind]
    spec = PD.GridSpec.create(state.box, N, r_cut, 0.3)
    dense, meta = PD.densify(state, spec, fields=("quat",))
    while bool(meta.overflow):
        spec = spec.grow()
        dense, meta = PD.densify(state, spec, fields=("quat",))

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (2, 2))
        return torch.as_tensor(((m + m.T) / 2).astype(np.float32))

    rc = torch.full((2, 2), r_cut)
    rc[0, 1] = rc[1, 0] = 0.85 * r_cut
    if kind == "pair":
        tbl = {"params": {"epsilon": sym(1.0, 5.0)}, "r_cut": rc, "r_on": 0.7 * rc}

        def force(d, window=None):
            return PK.pair_force(PAIR_POTENTIALS["Hertz"].energy_force, d, spec, tbl, "xplor",
                                 "all", window=window)
    elif kind == "dpd":
        from azplugins_tpu_torch.ops import dpd_kernel as DK

        tbl = {"params": {"A": sym(15.0, 30.0), "gamma": sym(3.0, 6.0), "s": sym(0.3, 2.0)},
               "r_cut": rc}

        def force(d, window=None):
            return DK.dpd_force(d, spec, tbl, 1.3, 0.01, 77, 2**24 + 5, "all", window=window)
    else:
        from azplugins_tpu_torch.ops import aniso_kernel as AK

        tpm = ANISO_PAIR_POTENTIALS["TwoPatchMorse"]
        host = {"M_d": np.full((2, 2), 1.5), "M_r": np.full((2, 2), 0.1),
                "r_eq": np.full((2, 2), 1.0), "omega": np.full((2, 2), 10.0),
                "alpha": np.full((2, 2), 0.4), "repulsion": np.ones((2, 2))}
        tbl = {"params": {k: torch.as_tensor(np.asarray(v, np.float32))
                          for k, v in tpm.precompute(host).items()}, "r_cut": rc}

        def force(d, window=None):
            return AK.aniso_force(tpm.energy_force_torque, d, spec, tbl, "shift", "all",
                                  window=window)
    return dense, spec, force


@pytest.mark.parametrize("layout", ["slabs", "strips"])
@pytest.mark.parametrize("kind", ["pair", "dpd", "aniso"])
def test_windowed_plain_force_equals_whole_grid(kind, layout):
    """Each shard's windowed force, torque, energy and virial are the
    whole grid's on its own slots, bit for bit."""
    dense, spec, force = _window_system(kind)
    Dx, Dy, _ = spec.dims
    n = Dx if layout == "slabs" else Dx * Dy // 2
    assert Dx >= 4  # a window of three planes is not the grid
    whole = force(dense)
    shards = shard_dense(dense, _sharded(n))
    fields = ("position", "typeid", "tag", "velocity", "orientation")
    windows = [halo_window(shards, d, spec, fields) for d in range(n)]
    assert all(w.n_cols < Dx * Dy for w in windows)
    got = [force(shards[d], window=windows[d]) for d in range(n)]
    for k in ("force", "torque", "energy", "virial"):
        if getattr(whole, k) is not None:
            joined = torch.cat([getattr(g, k) for g in got])
            np.testing.assert_array_equal(_bits(joined), _bits(getattr(whole, k)), err_msg=k)


def test_halo_window_holds_whole_planes():
    """16 strips of 9 columns on a 12 x 12 grid: windows of 3 or 4 planes,
    from the plane before the first own column; the other shards' columns
    copied in ring order."""
    for d in range(16):
        w0, n_cols, runs = PS.halo_runs((12, 12, 12), 16, d)
        c0 = 9 * d
        assert n_cols in (36, 48) and w0 == ((c0 // 12 - 1) % 12) * 12
        assert sum(k for _, _, k in runs) == n_cols
        assert len({e for e, _, _ in runs}) in (4, 5, 6)
    assert PS.halo_runs((3, 4, 4), 3, 1)[:2] == (0, 12)  # three planes cover the grid


# ---------------------------------------------------------------------------
# Simulations: sharded against undecomposed, bitwise
# ---------------------------------------------------------------------------
def _hertz_sim(az, L, seed, N=400, tilt=(0.0, 0.0, 0.0)):
    """A Hertz fluid under Langevin, as the reference's spatial tests run."""
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N)
    snap.configuration.box = list(L) + list(tilt)
    snap.particles.types = ["A"]
    snap.particles.position[:] = _positions(rng, L, N, tilt)
    kw = {"device": "cpu"} if az is port else {}
    sim = az.Simulation(seed=7, **kw)
    sim.create_state_from_snapshot(snap)
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    pot.params[("A", "A")] = dict(epsilon=5.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)], forces=[pot])
    sim.state.thermalize_particle_momenta(kT=0.8)
    return sim


def _assert_same_run(got, want):
    a, b = got.state.get_snapshot().particles, want.state.get_snapshot().particles
    for f in ("position", "velocity", "image", "typeid"):
        np.testing.assert_array_equal(_bits(getattr(a, f)), _bits(getattr(b, f)), err_msg=f)
    assert (got.timestep, got.n_builds, got.viol_replays) == (want.timestep, want.n_builds,
                                                               want.viol_replays)
    assert got._grid_spec == want._grid_spec


CASES = {  # box, seed, N, tilt, shards, steps
    "slabs": (SLABS, 21, 400, (0.0, 0.0, 0.0), 8, 20),
    "strips_snapped": (SLABS, 33, 400, (0.0, 0.0, 0.0), 3, 20),
    "more_shards_than_planes": (CUBE, 21, 350, (0.0, 0.0, 0.0), 8, 20),
    "triclinic": (SLABS, 21, 400, TILT, 4, 20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_simulation_bitwise(case, monkeypatch):
    """Every phase once a shard, the spatial rebin, the windowed forces:
    the undecomposed run's trajectory, images, builds and grid. A mesh of 3
    on Dx*Dy = 32 snaps the grid; the undecomposed run is made on the same
    snapped grid (GridSpec.create patched as the reference's test patches
    it)."""
    L, seed, N, tilt, n, steps = CASES[case]
    if case == "strips_snapped":
        orig = PD.GridSpec.create.__func__
        monkeypatch.setattr(PD.GridSpec, "create", classmethod(
            lambda cls, box, N, r_cut, buffer, strip_devices=1: orig(cls, box, N, r_cut,
                                                                     buffer, 3)))
    want = _hertz_sim(port, L, seed, N, tilt)
    want.run(steps)
    monkeypatch.undo()
    sim = _hertz_sim(port, L, seed, N, tilt)
    sim.enable_spatial_decomposition(_sharded(n))
    rebins = []
    spatial = PS.spatial_rebin
    monkeypatch.setattr(PS, "spatial_rebin", lambda *a, **k: rebins.append(1) or spatial(*a, **k))
    monkeypatch.setattr(PD, "rebin", lambda *a, **k: pytest.fail("a global rebin ran"))
    sim.run(steps)
    assert isinstance(sim._dense, tuple) and len(sim._dense) == n
    assert len(rebins) == sim.n_builds - 1 > 1  # every build after densify was block-local
    _assert_same_run(sim, want)


def test_sharded_enabled_midrun():
    """A mesh enabled between runs shards the layout as it stands: the run
    goes on exactly as the undecomposed one, and back again."""
    want = _hertz_sim(port, SLABS, 27)
    want.run(30)
    sim = _hertz_sim(port, SLABS, 27)
    sim.run(10)
    sim.enable_spatial_decomposition(_sharded(4))
    assert isinstance(sim._dense, tuple)
    sim.run(10)
    sim.enable_spatial_decomposition(make_mesh(4, device="cpu"))  # views again
    assert not isinstance(sim._dense, tuple)
    sim.run(10)
    _assert_same_run(sim, want)


def test_sharded_mesh_swapped_midrun():
    """One sharded mesh swapped for another between runs (8, 4, 2, then 16
    shards, then views): the layout is joined and split anew for each, and
    the run goes on exactly as the undecomposed one."""
    want = _hertz_sim(port, SLABS, 29)
    want.run(50)
    sim = _hertz_sim(port, SLABS, 29)
    for mesh in (_sharded(8), _sharded(4), _sharded(2), _sharded(16),
                 make_mesh(4, device="cpu")):
        sim.enable_spatial_decomposition(mesh)
        sim.run(10)
        shards = sim._dense if isinstance(sim._dense, tuple) else ()
        assert len(shards) == (mesh.size if mesh.sharded else 0)
    _assert_same_run(sim, want)


def test_spatial_rebin_refuses_shards_of_another_mesh():
    """Shards split for one mesh do not rebuild on a mesh of another size."""
    _, _, _, pdense, pmeta, spec, N = _grid_system(SLABS, 300, seed=5)
    shards = shard_dense(pdense, _sharded(4))
    with pytest.raises(ValueError, match="another mesh"):
        spatial_rebin(shards, PS.shard_meta(pmeta, shards), spec, N, mesh=_sharded(8))


def test_mesh_is_one_device_or_one_each():
    """A mesh holds every block on one device or each on its own; one
    block is not distinct, and a mixed mesh is refused."""
    cuda = torch.device("cuda", 0)
    assert not port.parallel.Mesh(devices=(cuda,)).distinct
    assert not port.parallel.Mesh(devices=(cuda,) * 3).sharded
    assert port.parallel.Mesh(devices=(cuda, torch.device("cuda", 1))).sharded
    with pytest.raises(ValueError, match="each on a device of its own"):
        port.parallel.Mesh(devices=(cuda, cuda, torch.device("cuda", 1)))


def _melting_lattice(auto_tune_after):
    """512 PLJ particles melting from a lattice in 4^3 cells, the tune early."""
    n, a = 8, 1.45
    snap = port.Snapshot(N=n**3)
    snap.configuration.box = [n * a] * 3 + [0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - n * a / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim = port.Simulation(device="cpu", seed=12)
    sim.create_state_from_snapshot(snap)
    sim.auto_tune_after = auto_tune_after
    lj = port.pair.PerturbedLennardJones(nlist=port.md.nlist.Cell(buffer=0.4),
                                         default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=1.5, default_gamma=1.0)], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.5)
    return sim


def _tune_to_the_occupancy(sim):
    """The capacity tune, then the capacity set to the cell occupancy it
    measured, not rounded up to 8 slots: a later fluctuation overflows it."""
    tune = sim.tune_cell_capacity

    def tune_exactly(slack=0, safety=1.0):
        tune(slack, safety)
        state, spec = sim._synced_state(), sim._grid_spec
        pos = state.position
        cid = PD._cell_id(pos[:, 0], pos[:, 1], pos[:, 2], state.box, spec.dims)
        sim._grid_spec = spec.replace(cap=int(torch.bincount(cid).max()))
        sim._drop_dense()

    sim.tune_cell_capacity = tune_exactly


def test_sharded_through_the_tune_and_an_overflow():
    """The capacity tune and an overflow after it (replayed one rebuild a
    chunk, the capacity grown at the rebuild that overflowed) on 4 slabs:
    the same capacities at the same steps as the undecomposed run."""
    runs = []
    for mesh in (None, _sharded(4)):
        sim = _melting_lattice(auto_tune_after=20)
        _tune_to_the_occupancy(sim)
        if mesh is not None:
            sim.enable_spatial_decomposition(mesh)
        caps, grow = [], sim._grow_and_rebuild
        sim._grow_and_rebuild = lambda *a, s=sim, g=grow: (caps.append((s.timestep,
                                                                        s._grid_spec.cap)),
                                                           g(*a))
        sim.run(60)
        runs.append((sim, caps))
    (want, want_caps), (sim, caps) = runs
    assert sim._grid_spec.dims == (4, 4, 4)
    assert caps == want_caps and any(t > 20 for t, _ in caps), caps  # grew after the tune
    _assert_same_run(sim, want)


def test_sharded_observables_bitwise():
    """Per-particle forces, energies and virials, the potential energy, the
    pressure and the kinetic temperature equal the undecomposed run's."""
    out = []
    for mesh in (None, _sharded(8)):
        sim = _hertz_sim(port, SLABS, 5)
        thermo = port.compute.ThermodynamicQuantities()
        sim.operations.computes.append(thermo)
        if mesh is not None:
            sim.enable_spatial_decomposition(mesh)
        sim.run(12)
        pot = sim.operations.integrator.forces[0]
        out.append([pot.forces, pot.energies, pot.virials, pot.energy, thermo.pressure,
                    thermo.kinetic_temperature, thermo.pressure_tensor])
    for got, want in zip(*reversed(out)):
        np.testing.assert_array_equal(_bits(np.asarray(got)), _bits(np.asarray(want)))


@pytest.mark.usefixtures("no_compile_cache")
def test_sharded_run_matches_reference():
    """20 steps on 8 slabs in both packages, the port sharded, within the
    20-step bars of test_torch_simulation.py (positions 1e-4, velocities
    1e-4 of max|v|)."""
    rsim = _hertz_sim(ref, SLABS, 21)
    rsim.auto_tune_after = None
    rsim.enable_spatial_decomposition(ref_make_mesh(8))
    rsim.run(20)
    psim = _hertz_sim(port, SLABS, 21)
    psim.enable_spatial_decomposition(_sharded(8))
    psim.run(20)
    rs, ps = rsim.state.get_snapshot(), psim.state.get_snapshot()
    np.testing.assert_array_equal(ps.particles.image, rs.particles.image)
    np.testing.assert_allclose(ps.particles.position, rs.particles.position, rtol=0, atol=1e-4)
    rv = rs.particles.velocity
    np.testing.assert_allclose(ps.particles.velocity, rv, rtol=0, atol=1e-4 * np.abs(rv).max())
    assert psim.n_builds == int(rsim._meta.n_builds)


def test_sharded_mesh_enabled_midrun_with_an_updater():
    """A sharded mesh enabled between runs, an updater appended after it:
    the run goes on, the updater once a shard at each firing, bit for bit
    the undecomposed run with the same updater appended at the same step."""
    class Idle(port.update.Updater):
        def _attach(self, sim):
            self.fired = []

        def _update(self, dense, t, seed):
            self.fired.append(t)
            return dense

    runs = []
    for mesh in (None, _sharded(8)):
        sim = _hertz_sim(port, SLABS, 3)
        sim.run(10)
        if mesh is not None:
            sim.enable_spatial_decomposition(mesh)
        idle = Idle(port.trigger.Periodic(5))
        sim.operations.updaters.append(idle)  # a new operation set: prepared anew
        sim.run(10)
        runs.append((sim, idle.fired))
    (want, want_fired), (sim, fired) = runs
    assert isinstance(sim._dense, tuple) and len(sim._dense) == 8
    assert want_fired == [10, 15] and fired == [10] * 8 + [15] * 8
    _assert_same_run(sim, want)
