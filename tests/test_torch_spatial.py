"""The port's spatial decomposition against the JAX reference and against
the port's own undecomposed runs.

With every block on the simulation's device the port keeps the global
rebin: its slot layout is the one the reference's block-local rebin
reproduces bit for bit, so a decomposed simulation is bitwise the
undecomposed one on the same (snapped) grid, updaters, writers,
observables and an SRD solvent included. Against the reference's
decomposed simulation the port holds the 20-step bars of
``test_torch_simulation.py`` (positions 1e-4, velocities 1e-4 of max|v|).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from torch_compile_cache import no_compile_cache  # noqa: E402, F401
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.parallel import Mesh, make_mesh  # noqa: E402

torch.set_num_threads(1)

SLABS = [14.5, 7.3, 7.3]  # dims (8, 4, 4) at r_list 1.8: one x plane a block of 8
CUBE = [7.3, 7.3, 7.3]  # dims (4, 4, 4): 8 blocks of two z columns
TILT = (0.2, 0.0, 0.1)


def _cpu_mesh(n):
    return make_mesh(n, device="cpu")


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
# GridSpec.create's snapping
# ---------------------------------------------------------------------------
def _create(D, box, N, **kw):
    try:
        spec = D.GridSpec.create(box, N, 1.5, 0.3, **kw)
    except ValueError as e:
        return str(e)
    return tuple(spec.dims), spec.cap, spec.buffer


BOXES = [(14.5, 7.3, 7.3, 0, 0, 0), (7.3, 7.3, 7.3, 0, 0, 0), (21.84, 7.3, 7.3, 0, 0, 0),
         (14.5, 7.3, 7.3, 0.2, 0.0, 0.1), (3.0, 11.0, 9.0, 0, 0, 0), (40.0, 2.0, 20.0, 0, 0, 0)]


@pytest.mark.parametrize("box", BOXES)
def test_grid_create_matches_reference(box):
    """dims, cap and buffer over strip_devices, the error included; the
    default gives the dims it gave before."""
    rbox = ref.Box(L=box[:3], tilt=box[3:])
    pbox = port.Box(L=box[:3], tilt=box[3:])
    default = _create(PD, pbox, 700)
    assert default == _create(RD, rbox, 700)
    assert _create(PD, pbox, 700, strip_devices=1) == default
    for strips in (2, 3, 5, 7, 16, 64):
        got = _create(PD, pbox, 700, strip_devices=strips)
        assert got == _create(RD, rbox, 700, strip_devices=strips), (box, strips)


def test_grid_create_snaps_and_refuses():
    box = port.Box(L=(14.5, 7.3, 7.3), tilt=(0, 0, 0))
    assert _create(PD, box, 700)[0] == (8, 4, 4)
    assert _create(PD, box, 700, strip_devices=3)[0] == (8, 3, 4)
    assert "spatial strips" in _create(PD, port.Box(L=(3.0, 2.0, 9.0), tilt=(0, 0, 0)), 70,
                                       strip_devices=3)


# ---------------------------------------------------------------------------
# the mesh and its errors
# ---------------------------------------------------------------------------
def test_mesh_on_one_device():
    mesh = make_mesh(4, device="cpu")
    assert mesh.shape == {"d": 4} and mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(device="cpu")
    with pytest.raises(ValueError, match="at least one block"):
        make_mesh(0, device="cpu")


def test_make_mesh_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="GPU"):
        port.Simulation()


def test_make_mesh_takes_one_block_a_card(monkeypatch):
    """Without a device, a mesh on a machine of two cards has one block on
    each (the reference's jax.devices()), held as shards, which a
    simulation accepts; more blocks than cards need a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.sharded and mesh.distinct
    assert make_mesh(1).devices == (torch.device("cuda", 0),)
    assert not make_mesh(1).sharded
    with pytest.raises(ValueError, match="2 are present"):
        make_mesh(4)
    assert make_mesh(4, device="cuda").devices == (torch.device("cuda"),) * 4
    assert not make_mesh(4, device="cuda").sharded
    assert make_mesh(4, device="cuda", sharded=True).sharded
    sim = _lj_sim(port, SLABS, seed=21)
    sim.enable_spatial_decomposition(mesh)
    assert sim._spatial_mesh is mesh


def test_mesh_off_the_device_raises():
    """Views must lie on the simulation's device, and so must shards that
    share one device; shards on distinct cards are accepted, and a mesh
    over distinct devices is always sharded."""
    sim = _lj_sim(port, SLABS, seed=21)
    with pytest.raises(ValueError, match="lie on"):
        sim.enable_spatial_decomposition(Mesh(devices=(torch.device("cuda"),) * 2))
    with pytest.raises(ValueError, match="distinct CUDA devices"):
        sim.enable_spatial_decomposition(Mesh(devices=(torch.device("cuda"),) * 2, sharded=True))
    assert sim._spatial_mesh is None
    cards = Mesh(devices=(torch.device("cuda", 0), torch.device("cuda", 1)))
    assert cards.sharded
    with pytest.raises(ValueError, match="sharded must be True"):
        Mesh(devices=cards.devices, sharded=False)
    sim.enable_spatial_decomposition(cards)
    assert sim._spatial_mesh is cards


# ---------------------------------------------------------------------------
# Simulation: decomposed against undecomposed, bitwise
# ---------------------------------------------------------------------------
def _lj_sim(az, L, seed, N=600, tilt=(0.0, 0.0, 0.0)):
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


def _end(sim):
    s = sim.state.get_snapshot()
    out = [s.particles.position, s.particles.velocity, s.particles.image, s.particles.typeid]
    if s.mpcd.N:
        out += [s.mpcd.position, s.mpcd.velocity]
    return [np.array(a) for a in out]


def _assert_end_equal(got, want):
    for g, w in zip(_end(got), _end(want)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_simulation_slabs_bitwise():
    want = _lj_sim(port, SLABS, seed=21)
    want.run(30)
    sim = _lj_sim(port, SLABS, seed=21)
    sim._attach()
    assert sim._grid_spec.dims[0] == 8
    sim.enable_spatial_decomposition(_cpu_mesh(8))
    sim.run(30)
    _assert_end_equal(sim, want)
    assert sim.n_builds == want.n_builds > 1


def test_simulation_snapped_strips_bitwise(monkeypatch):
    """A mesh of 3 on Dx*Dy = 32 snaps the grid; the undecomposed run is
    made on the same snapped grid (GridSpec.create patched as the
    reference's test patches it)."""
    orig = PD.GridSpec.create.__func__

    def snapped(cls, box, N, r_cut, buffer, strip_devices=1):
        return orig(cls, box, N, r_cut, buffer, 3)

    monkeypatch.setattr(PD.GridSpec, "create", classmethod(snapped))
    want = _lj_sim(port, SLABS, seed=33)
    want.run(25)
    dims = want._grid_spec.dims
    assert (dims[0] * dims[1]) % 3 == 0 and dims[0] * dims[1] < 32, dims
    monkeypatch.undo()
    sim = _lj_sim(port, SLABS, seed=33)
    sim.enable_spatial_decomposition(_cpu_mesh(3))
    sim.run(25)
    assert sim._grid_spec.dims == dims
    _assert_end_equal(sim, want)


def test_enable_midrun_keeps_the_trajectory():
    """Enabling a mesh that does not divide the grid mid-run regrids; the
    positions are synced first, not rolled back to the last host read."""
    want = _lj_sim(port, SLABS, seed=27)
    want.run(50)
    sim = _lj_sim(port, SLABS, seed=27)
    sim.run(30)
    sim.state.get_snapshot()
    sim.run(20)
    sim.enable_spatial_decomposition(_cpu_mesh(3))
    assert sim.timestep == 50 and sim._dense is None
    _assert_end_equal(sim, want)
    sim.run(10)  # the regridded run goes on
    assert (sim._grid_spec.dims[0] * sim._grid_spec.dims[1]) % 3 == 0


def test_simulation_more_blocks_than_planes_bitwise():
    want = _lj_sim(port, CUBE, seed=21, N=500)
    want.run(30)
    assert want._grid_spec.dims == (4, 4, 4)
    sim = _lj_sim(port, CUBE, seed=21, N=500)
    sim.enable_spatial_decomposition(_cpu_mesh(8))
    sim.run(30)
    assert sim._grid_spec.dims == (4, 4, 4)
    _assert_end_equal(sim, want)


def test_simulation_triclinic_bitwise():
    want = _lj_sim(port, SLABS, seed=21, tilt=TILT)
    want.run(30)
    sim = _lj_sim(port, SLABS, seed=21, tilt=TILT)
    sim.enable_spatial_decomposition(_cpu_mesh(4))
    sim.run(30)
    _assert_end_equal(sim, want)


def _droplet_sim(traj_path):
    """The droplet's composition on the 8-slab grid: a pair force, a moving
    planar barrier, an evaporator, a velocity field and an aztraj writer."""
    rng = np.random.default_rng(44)
    N = 500
    snap = port.Snapshot(N=N)
    snap.configuration.box = SLABS + [0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(SLABS)
    sim = port.Simulation(device="cpu", seed=11)
    sim.create_state_from_snapshot(snap)
    pot = port.pair.Hertz(nlist=port.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    pot.params[("solvent", "solvent")] = dict(epsilon=5.0)
    pot.params[("solvent", "evaporated")] = dict(epsilon=1.0)
    pot.params[("evaporated", "evaporated")] = dict(epsilon=0.0)
    barrier = port.external.PlanarHarmonicBarrier(
        location=port.variant.Ramp(A=3.0, B=2.0, t_start=0, t_ramp=100))
    barrier.params["solvent"] = dict(k=20.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    sim.operations.updaters.append(port.update.ParticleEvaporator(
        trigger=port.trigger.Periodic(5), solvent_type="solvent",
        evaporated_type="evaporated", lo=1.0, hi=3.6, N_evap_max=4))
    sim.operations.integrator = port.md.Integrator(
        dt=0.002, methods=[port.md.methods.Langevin(kT=0.8, default_gamma=1.0)],
        forces=[pot, barrier])
    field = port.compute.CartesianVelocityFieldCompute(
        num_bins=[4, 0, 0], lower_bounds=[-SLABS[0] / 2, 0, 0],
        upper_bounds=[SLABS[0] / 2, 0, 0], filter=port.filter.All())
    sim.operations.computes.append(field)
    sim.operations += port.write.Trajectory(trigger=port.trigger.Periodic(10),
                                            filename=str(traj_path))
    sim.state.thermalize_particle_momenta(kT=0.8)
    return sim, field


def test_droplet_workload_bitwise(tmp_path):
    """Updaters, writers and observables under the mesh: trajectory,
    typeids, the velocity field and the trajectory file's bytes."""
    want, want_field = _droplet_sim(tmp_path / "ref.azt")
    want.run(40)
    sim, field = _droplet_sim(tmp_path / "spatial.azt")
    sim.enable_spatial_decomposition(_cpu_mesh(8))
    sim.run(40)
    assert sim._grid_spec.dims[0] == 8
    _assert_end_equal(sim, want)
    assert (sim.state.get_snapshot().particles.typeid == 1).sum() > 0
    np.testing.assert_array_equal(_bits(field.velocities), _bits(want_field.velocities))
    assert (tmp_path / "ref.azt").read_bytes() == (tmp_path / "spatial.azt").read_bytes()


def _srd_sim():
    """Hertz solutes in an SRD solvent on the 8-slab box (the reference's
    solvent test), the solvent also coupled to the solutes every 10 steps."""
    rng = np.random.default_rng(5)
    N, N_s = 600, 4096
    L = [14.6, 7.3, 7.3]
    snap = port.Snapshot(N=N, mpcd_N=N_s)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * np.asarray(L)
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    sim = port.Simulation(device="cpu", seed=7)
    sim.create_state_from_snapshot(snap)
    pot = port.pair.Hertz(nlist=port.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    pot.params[("A", "A")] = dict(epsilon=5.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.002, methods=[port.md.methods.Langevin(kT=0.8, default_gamma=1.0)], forces=[pot])
    srd = port.mpcd.SRD(dt=0.002, period=10, angle=130.0, cell_size=7.3 / 8, kT=0.8)
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(port.mpcd.CollisionCoupling(srd))
    return sim


def test_srd_coupled_solvent_bitwise():
    """The solvent stays where it is under the mesh: its streaming, its
    collisions and the joint collisions with the solutes are bitwise the
    undecomposed run's on the CPU."""
    want = _srd_sim()
    want.run(12)
    sim = _srd_sim()
    sim.enable_spatial_decomposition(_cpu_mesh(8))
    sim.run(12)
    assert sim._grid_spec.dims[0] == 8
    assert sim._mpcd["_srd_anchor"][2] == 10
    _assert_end_equal(sim, want)


@pytest.mark.usefixtures("no_compile_cache")
def test_decomposed_run_matches_reference():
    """30 steps on 8 slabs in both packages, within the 20-step bars of
    test_torch_simulation.py (positions 1e-4, velocities 1e-4 of max|v|)."""
    rsim = _lj_sim(ref, SLABS, seed=21)
    rsim.auto_tune_after = None  # 30 steps stop short of the tune anyway
    rsim.enable_spatial_decomposition(ref_make_mesh(8))
    rsim.run(30)
    psim = _lj_sim(port, SLABS, seed=21)
    psim.enable_spatial_decomposition(_cpu_mesh(8))
    psim.run(30)
    rs, ps = rsim.state.get_snapshot(), psim.state.get_snapshot()
    np.testing.assert_array_equal(ps.particles.image, rs.particles.image)
    np.testing.assert_allclose(ps.particles.position, rs.particles.position, rtol=0, atol=1e-4)
    rv = rs.particles.velocity
    np.testing.assert_allclose(ps.particles.velocity, rv, rtol=0, atol=1e-4 * np.abs(rv).max())
    assert psim.n_builds == int(rsim._meta.n_builds)
