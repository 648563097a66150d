"""MPCD-SRD of the port (``azplugins_tpu_torch.mpcd``) against the JAX
reference, and the reference's own MPCD cases on the port.

Against the reference, from identical inputs made with numpy:
  * the collision keys (``jax.random`` with partitionable Threefry): the
    folded key, the split keys, the uniform words and the grid shift
    bitwise, and the cell ids bitwise;
  * the normals behind the rotation axes and the virtual momenta within
    ``NORMAL_ULP`` ulp each (the port evaluates XLA's float32 ``ErfInv``
    polynomial, but with its own ``log1p``), the unit axes within 1e-6;
  * one collision (periodic, with kT, with plates and the virtual fill,
    mixed masses with invalid rows) within 1e-5 of max|v|;
  * streaming, periodic and with plates, within 1e-6 of L;
  * two collisions of an uncoupled and of a coupled run, within the same
    bars (longer runs are held by their invariants: an ulp in a position
    can move a particle across a cell face and change its velocity by
    O(1)).
Within the port: the collision's keys, draws and grid shift formed on the
device from a clock (``core/rng.py::collision_draws``, what a CUDA graph of
a collision runs) bitwise the host's, past 2**31 and at a cell size whose
reciprocal is not a float32; the plain ordered cell sum
(``mpcd._cell_sums_plain``, which the card's K10 is held to) bitwise the
CPU's ``index_add_``; the conservation laws, the thermostat, bitwise
chunking invariance (uncoupled and coupled), the body force, a small
Poiseuille slit, the coupling's firing inside the chunk and its anchor on
the MD clock, and the errors.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.core.box import Box as RefBox  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.core import rng as P  # noqa: E402
from azplugins_tpu_torch.core.box import Box  # noqa: E402

torch.set_num_threads(1)

NORMAL_ULP = 4
BAR_V = 1e-5
BAR_X = 1e-6


def _cube(L):
    return Box.from_lengths(L, L, L)


def _ref_key(seed, t):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), jnp.uint32(0x6D70)),
                             jnp.uint32(t))
    return key, jax.random.split(key, 3)


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _pair(cell_size=1.0, L=8.0, seed=11, **kw):
    """The same SRD in both packages, built for an L^3 box."""
    r = ref.mpcd.SRD(dt=0.02, period=5, cell_size=cell_size, **kw)
    r._validate(RefBox.cube(L))
    p = port.mpcd.SRD(dt=0.02, period=5, cell_size=cell_size, **kw)
    p._build(_cube(L), seed)
    return r, p


def _stream_input(seed, N=3000, L=8.0, z_fill=1.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((N, 3)) - 0.5) * np.asarray([L, L, z_fill * L])
    vel = rng.normal(0.0, 1.0, (N, 3))
    return pos.astype(np.float32), vel.astype(np.float32)


def _close(got, want, bar, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=bar * scale)


# -- the collision's random numbers -----------------------------------------
def test_jax_derivation_is_partitionable():
    """The port rebuilds jax.random's partitionable derivation; a change of
    JAX's default would change the reference's draws."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,t", [(0, 0), (11, 120), (0xFFFF, 2**31 + 5), (7, 4_000_000_000)])
def test_collision_keys_and_shift_bitwise(seed, t):
    key, subkeys = _ref_key(seed, t)
    keys = port.mpcd._collision_keys(seed, t)
    assert P.jax_fold_in(P.jax_fold_in(P.jax_key(seed), 0x6D70), t) == _words(key)
    assert [tuple(k) for k in keys] == [_words(k) for k in subkeys]
    for cell_size in (1.0, 0.5):
        want = np.asarray(jax.random.uniform(subkeys[0], (3,), jnp.float32)
                          * jnp.float32(cell_size))
        got = P.jax_uniform_host(keys[0], 3) * np.float32(cell_size)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("t", [0, 120, 2**31 + 5, 4_000_000_000])
@pytest.mark.parametrize("cell_size", [1.0, 0.75])
def test_collision_draws_on_the_clock_bitwise(t, cell_size):
    """The collision's draws formed from a clock (the timestep word a
    tensor: the keys hashed as tensors, the shift's uniforms and its
    quotient by the cell size as tensor operations) are bitwise the host
    keys' draws and the host's shift, with and without the shift and the
    virtual fill's second key; the shift as the reference draws it."""
    for seed in (0, 11, 0xFFFF):
        kshift, kaxis, kvirt = port.mpcd._collision_keys(seed, t)
        _, subkeys = _ref_key(seed, t)
        a = np.float32(cell_size)
        want_shift = np.asarray(jax.random.uniform(subkeys[0], (3,), jnp.float32) * a)
        for shift_on in (True, False):
            host = P.jax_uniform_host(kshift, 3) * a if shift_on else np.zeros(3, np.float32)
            if shift_on:
                np.testing.assert_array_equal(host.view(np.uint32), want_shift.view(np.uint32))
            axis, virt = P._jax_normal_axis_plain(kaxis, 64, "cpu", kvirt)
            clock = torch.tensor(t - 7, dtype=torch.int64)
            with P.device_clock(clock, 100):
                got = P.collision_draws(port.mpcd._inner_key(seed), 107, 64, "cpu", cell_size,
                                        shift_on, second=True)
            assert got[0].shape == (64, 3) and got[1].shape == (64, 3)
            for g, w in ((got[0], axis), (got[1], virt)):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
            for g, w in ((got[2], host), (got[3], host / a)):
                np.testing.assert_array_equal(g.numpy().view(np.uint32), w.view(np.uint32))
            one = P.collision_draws(port.mpcd._inner_key(seed), t, 64, "cpu", cell_size,
                                    shift_on)
            assert one[1] is None and torch.equal(one[0], got[0])
            assert torch.equal(one[2], got[2]) and torch.equal(one[3], got[3])


@pytest.mark.parametrize("case", ["srd", "duplicates", "trash"])
def test_cell_sums_plain_is_index_add(case):
    """The plain ordered cell sum (a stable sort by cell, rounds by rank)
    is bitwise ``index_add_`` on the CPU (each cell's rows in ascending row
    order from +0.0), with duplicates, empty cells and trash rows (binned
    to cell C, left out); the CPU's dispatch takes ``index_add_``."""
    rng = np.random.default_rng({"srd": 1, "duplicates": 2, "trash": 3}[case])
    C, n = {"srd": (512, 512), "duplicates": (40, 3000), "trash": (300, 1200)}[case]
    cid = rng.integers(0, C, n)
    if case == "duplicates":
        cid[:1500] = 7  # one deep cell; most of the 40 others hold ~40 rows
        cid[cid == 11] = 12  # an empty cell
    vel = (rng.normal(0, 1.0, (n, 3)) * rng.choice([1e-3, 1.0, 30.0], (n, 1))).astype(np.float32)
    mass = None
    if case == "trash":
        invalid = rng.random(n) < 0.4
        cid[invalid] = C
        mass = np.where(invalid, 0.0, rng.choice([1.0, 5.0], n)).astype(np.float32)
        mass = torch.as_tensor(mass)
    cid, vel = torch.as_tensor(cid), torch.as_tensor(vel)
    pay = port.mpcd._payload(vel, mass)
    want = torch.zeros((C + 1, 6), dtype=torch.float32).index_add_(0, cid, pay)[:C]
    got = port.mpcd._cell_sums_plain(cid, pay, C)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(port.mpcd._cell_sums(cid, vel, mass, C).view(torch.int32),
                       want.view(torch.int32))
    if case == "duplicates":
        assert float(got[7, 0]) >= 1500 and float(got[11, 0]) == 0.0
    # the order matters: the sums of the deepest cell in another order differ
    # somewhere, so the plain version holds the order, not only the value
    if case == "duplicates":
        rev = torch.zeros((C + 1, 6), dtype=torch.float32).index_add_(
            0, cid.flip(0), pay.flip(0))[:C]
        assert not torch.equal(rev, want)


def test_normals_and_axes_within_bar():
    _, subkeys = _ref_key(11, 40)
    keys = port.mpcd._collision_keys(11, 40)
    C = 4096
    for i in (1, 2):  # the axis and the virtual-fill keys
        want = np.asarray(jax.random.normal(subkeys[i], (C, 3), jnp.float32))
        got = P._jax_normal_plain(keys[i], (C, 3), "cpu").numpy()
        assert _ulps(got, want).max() <= NORMAL_ULP
    want_axis = want / np.linalg.norm(want, axis=1, keepdims=True)
    got_axis = got / np.sqrt((got * got).sum(axis=1, keepdims=True))
    _close(got_axis, want_axis, 1e-6, scale=1.0)


def test_xla_erfinv_within_bar():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0, 1.0, 100_000).astype(np.float32)
    x[:2] = [np.nextafter(np.float32(-1.0), np.float32(0.0)), np.float32(0.9999999)]
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert _ulps(P.xla_erfinv(torch.as_tensor(x)).numpy(), want).max() <= NORMAL_ULP


@pytest.mark.parametrize("plates", [False, True], ids=["periodic", "plates"])
def test_cell_ids_bitwise(plates):
    kw = dict(kT=1.0, plates=("z", 8.0)) if plates else {}
    r, p = _pair(**kw)
    pos, _ = _stream_input(3, z_fill=0.99 if plates else 1.0)
    for t in (5, 10, 15):
        shift = P.jax_uniform_host(port.mpcd._collision_keys(11, t)[0], 3)
        want = np.asarray(r._cell_ids(jnp.asarray(pos), jnp.asarray(shift)))
        np.testing.assert_array_equal(p._cell_ids(torch.as_tensor(pos), shift).numpy(), want)


def test_plates_seam_binning():
    """With a grid shift, the layer at the top plate bins into the extra
    boundary cell, never across the periodic seam into the bottom layer."""
    L, eps = 8.0, 1e-3
    srd = port.mpcd.SRD(dt=0.02, cell_size=1.0, kT=1.0, plates=("z", L))
    srd._build(_cube(L), 0)
    pos = torch.tensor([[0.0, 0.0, L / 2 - eps], [0.0, 0.0, -L / 2 + eps]])
    for s in np.linspace(0.0, 0.999, 21):
        cid = srd._cell_ids(pos, np.asarray([0.0, 0.0, s], np.float32))
        assert int(cid[0]) != int(cid[1]), s
    # an unconfined axis wraps: periodic images share a cell
    srd_p = port.mpcd.SRD(dt=0.02, cell_size=1.0)
    srd_p._build(_cube(L), 0)
    cid = srd_p._cell_ids(torch.tensor([[L / 2 - eps, 0.0, 0.0], [-L / 2 + eps, 0.0, 0.0]]),
                          np.asarray([0.5, 0.0, 0.0], np.float32))
    assert int(cid[0]) == int(cid[1])


# -- one collision, streaming ------------------------------------------------
@pytest.mark.parametrize("case", ["periodic", "kT", "plates", "mixed"])
def test_collide_matches_reference(case):
    L = 8.0
    kw = {"periodic": {}, "kT": dict(kT=1.0), "plates": dict(kT=1.5, plates=("z", L)),
          "mixed": dict(kT=1.0)}[case]
    r, p = _pair(L=L, **kw)
    pos, vel = _stream_input(4, z_fill=0.98 if case == "plates" else 1.0)
    extra_r, extra_p = {}, {}
    if case == "mixed":
        # solvent plus dense MD slots of mass 5, a fifth of them empty:
        # mass 0, far away, binned to the trash cell, returned untouched
        rng = np.random.default_rng(5)
        M, N_s = 200, pos.shape[0]
        invalid = np.concatenate([np.zeros(N_s, bool), rng.random(M) < 0.2])
        pos = np.concatenate([pos, ((rng.random((M, 3)) - 0.5) * L).astype(np.float32)])
        vel = np.concatenate([vel, rng.normal(0.0, 0.4, (M, 3)).astype(np.float32)])
        pos[invalid] = 1e6
        mass = np.concatenate([np.ones(N_s), np.full(M, 5.0)]).astype(np.float32)
        mass[invalid] = 0.0
        extra_r = dict(mass=jnp.asarray(mass), invalid=jnp.asarray(invalid), n_fill=N_s,
                       mass_fill=1.0)
        extra_p = dict(mass=torch.as_tensor(mass), invalid=torch.as_tensor(invalid), n_fill=N_s,
                       mass_fill=1.0)
    want = np.asarray(r._collide(jnp.asarray(pos), jnp.asarray(vel), jnp.int32(120),
                                 jnp.asarray([L] * 3, jnp.float32), 11, **extra_r))
    extra_p = {k: (v,) if isinstance(v, torch.Tensor) else v for k, v in extra_p.items()}
    (got,) = p._collide((torch.as_tensor(pos),), (torch.as_tensor(vel),), 120, p._L, 11,
                        **extra_p)
    got = got.numpy()
    _close(got, want, BAR_V)
    if case == "mixed":
        np.testing.assert_array_equal(got[invalid], vel[invalid])
    # the collision did something
    assert np.abs(got - vel).max() > 0.1


@pytest.mark.parametrize("case", ["periodic", "body force", "plates"])
def test_stream_matches_reference(case):
    L = 8.0
    kw = {"periodic": {}, "body force": dict(body_force=(0.3, -0.1, 0.05)),
          "plates": dict(kT=1.0, body_force=(0.3, 0.0, 0.0), plates=("z", L))}[case]
    r, p = _pair(L=L, **kw)
    pos, vel = _stream_input(6, z_fill=0.98 if case == "plates" else 1.0)
    vel = vel * 3.0  # reach the plates and the box edges within the steps
    Lr = jnp.asarray([L] * 3, jnp.float32)
    for n in (0, 1, 7):
        xr, vr = r._stream(jnp.asarray(pos), jnp.asarray(vel), jnp.int32(n), Lr)
        (xp,), (vp,) = p._stream((torch.as_tensor(pos),), (torch.as_tensor(vel),), n, p._L)
        _close(xp.numpy(), xr, BAR_X, scale=L)
        _close(vp.numpy(), vr, BAR_V)
    if case == "plates":
        assert np.abs(xp.numpy()[:, 2]).max() <= L / 2 + 1e-5


# -- whole runs against the reference ----------------------------------------
def _solvent_sim(az, N=3000, L=8.0, kT_init=1.0, seed=3, forces=True, **srd_kw):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=8, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((8, 3)) - 0.5) * L * 0.9
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, np.sqrt(kT_init), (N, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=7, **kw)
    sim.create_state_from_snapshot(snap)
    pots = []
    if forces:
        pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=1.5)
        pot.params[("A", "A")] = dict(epsilon=1.0)
        pots = [pot]
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=pots)
    sim.mpcd_dynamics = az.mpcd.SRD(
        dt=0.02, **(dict(period=5, angle=130.0, cell_size=1.0) | srd_kw))
    return sim


def _coupled_sim(az, N_s=3000, N_m=32, L=8.0, mass_m=5.0, seed=3, solvent_drift=0.0, kT=None,
                 period=10, lattice=False):
    """Solutes of mass 5 in an SRD solvent, coupled; with ``lattice`` the
    N_m = n^3 solutes sit on a simple-cubic lattice (no overlaps for a
    pair force)."""
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N_m, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["C"]
    snap.particles.position[:] = (rng.random((N_m, 3)) - 0.5) * L
    if lattice:
        n = round(N_m ** (1 / 3))
        x = (np.arange(n) + 0.5) * (L / n) - L / 2
        snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"),
                                              -1).reshape(-1, 3)
    snap.particles.mass[:] = mass_m
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    snap.mpcd.velocity[:, 0] += solvent_drift
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=13, **kw)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
    srd = az.mpcd.SRD(dt=0.02, period=period, angle=130.0, cell_size=1.0, kT=kT)
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    return sim


def _stream_of(sim):
    snap = sim.state.get_snapshot()
    return snap.mpcd.position, snap.mpcd.velocity, snap.particles.velocity


@pytest.mark.parametrize("kind", ["uncoupled", "uncoupled with plates", "coupled"])
def test_two_collisions_match_reference(kind):
    """Ten steps (two collisions): the solvent and the solutes within the
    one-collision bars, the anchor at the same clock; the port's stream
    converted from the reference's with its anchor runs on to the same
    state."""
    if kind == "coupled":
        sims = [_coupled_sim(az, period=5, kT=1.0) for az in (ref, port)]
    else:
        kw = dict(kT=1.0, body_force=(0.05, 0.0, 0.0))
        if kind.endswith("plates"):
            kw["plates"] = ("z", 8.0)
        sims = [_solvent_sim(az, forces=False, **kw) for az in (ref, port)]
    for sim in sims:
        sim.run(7)
    # the port continues from the reference's stream and anchor
    sims[1]._mpcd = interop.mpcd_from_reference(sims[0]._mpcd, "cpu")
    assert sims[1]._mpcd["_srd_anchor"][2] == 5
    for sim in sims:
        sim.run(3)
    (xr, vr, mr), (xp, vp, mp) = (_stream_of(s) for s in sims)
    _close(xp, xr, BAR_X, scale=8.0)
    _close(vp, vr, BAR_V)
    _close(mp, mr, BAR_V, scale=np.abs(vr).max())
    assert int(np.asarray(sims[0]._mpcd["_srd_anchor"][2])) == sims[1]._mpcd["_srd_anchor"][2] == 10


# -- the reference's cases, on the port --------------------------------------
def _kT(vel):
    return float(np.mean(np.sum(np.asarray(vel) ** 2, axis=1)) / 3.0)


def _mpcd_np(sim, key):
    return torch.cat(sim._mpcd[key]).numpy()


def test_srd_conserves_momentum_and_energy():
    sim = _solvent_sim(port)
    v0 = _mpcd_np(sim, "velocity")
    sim.run(60)  # 12 collisions
    v1 = _mpcd_np(sim, "velocity")
    assert not np.allclose(v0, v1)
    np.testing.assert_allclose(v1.sum(axis=0), v0.sum(axis=0), atol=2e-2)
    np.testing.assert_allclose(np.sum(v1 * v1), np.sum(v0 * v0), rtol=1e-4)
    assert np.all(np.abs(_mpcd_np(sim, "position")) <= 4.0 + 1e-5)


def test_srd_thermostat_drives_kT():
    sim = _solvent_sim(port, kT_init=4.0, forces=False, kT=1.0)
    assert _kT(_mpcd_np(sim, "velocity")) > 3.0
    sim.run(100)
    assert abs(_kT(_mpcd_np(sim, "velocity")) - 1.0) < 0.15


def test_srd_chunking_invariant():
    a = _solvent_sim(port, seed=11)
    a.run(40)
    b = _solvent_sim(port, seed=11)
    for n in (7, 13, 20):
        b.run(n)
    for key in ("position", "velocity"):
        np.testing.assert_array_equal(_mpcd_np(a, key), _mpcd_np(b, key))


def test_srd_resume_reproduces():
    """A restart from the mid-run stream at a collision timestep reproduces
    the continuous trajectory bitwise (collisions key on the timestep)."""
    a = _solvent_sim(port, seed=21, forces=False)
    a.run(50)
    b = _solvent_sim(port, seed=21, forces=False)
    b.run(30)
    c = _solvent_sim(port, seed=21, forces=False)
    c._mpcd = {**c._mpcd, "position": (torch.cat(b._mpcd["position"]),),
               "velocity": (torch.cat(b._mpcd["velocity"]),)}
    c.timestep = 30
    c.run(20)
    np.testing.assert_array_equal(_mpcd_np(c, "position"), _mpcd_np(a, "position"))


def test_srd_body_force_accelerates():
    sim = _solvent_sim(port, forces=False, body_force=(0.05, 0.0, 0.0), kT=1.0)
    v0x = float(_mpcd_np(sim, "velocity")[:, 0].mean())
    sim.run(50)
    v1x = float(_mpcd_np(sim, "velocity")[:, 0].mean())
    # the centre-of-mass momentum is immune to collisions and the
    # thermostat, so the drift integrates the body force
    np.testing.assert_allclose(v1x - v0x, 0.05 * 50 * 0.02, rtol=0.05)


def test_srd_feeds_velocity_compute():
    sim = _solvent_sim(port, forces=False, body_force=(0.1, 0.0, 0.0))
    vc = port.compute.VelocityCompute(filter=port.filter.All(), include_mpcd_particles=True)
    sim.operations.computes.append(vc)
    sim.run(40)
    assert abs(vc.velocity[0]) > 0.05


def test_srd_plates_confine_and_poiseuille():
    """A slit: bounce-back plates confine the solvent, and a tangential
    body force develops the parabolic profile, read with the velocity
    field compute."""
    rng = np.random.default_rng(5)
    N, L = 6000, 8.0
    snap = port.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray([L, L, 0.98 * L])
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = port.Simulation(seed=9, device="cpu")
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = port.md.Integrator(
        dt=0.02, methods=[port.md.methods.ConstantVolume()], forces=[])
    sim.mpcd_dynamics = port.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0,
                                      body_force=(0.06, 0.0, 0.0), plates=("z", L))
    sim.run(800)
    nbins = 8
    field = port.compute.CartesianVelocityFieldCompute(
        num_bins=(0, 0, nbins), lower_bounds=(0, 0, -L / 2), upper_bounds=(0, 0, L / 2),
        include_mpcd_particles=True)
    sim.operations.computes.append(field)
    prof = np.zeros(nbins)
    for _ in range(6):
        sim.run(50)
        assert np.all(np.abs(_mpcd_np(sim, "position")[:, 2]) <= L / 2 + 1e-4)
        prof += field.velocities[:, 0] / 6
    center = prof[nbins // 2 - 1: nbins // 2 + 1].mean()
    walls = (prof[0] + prof[-1]) / 2
    assert center > 0.05, prof
    assert center > 3.0 * max(walls, 1e-6), prof
    assert np.abs(prof - prof[::-1]).max() < 0.5 * center + 0.05, prof


def test_coupling_conserves_momentum_and_energy():
    """A joint collision is a mass-weighted rotation about each cell's
    centre of mass: total momentum and kinetic energy are invariants."""
    sim = _coupled_sim(port)
    m = sim._state.mass.numpy()[:, None]
    v_m0 = sim._state.velocity.numpy()
    v_s0 = _mpcd_np(sim, "velocity")
    sim.run(60)
    _, v_s1, v_m1 = _stream_of(sim)
    assert not np.allclose(v_m1, v_m0)  # the solutes were kicked
    np.testing.assert_allclose(v_s1.sum(0) + (m * v_m1).sum(0), v_s0.sum(0) + (m * v_m0).sum(0),
                               atol=5e-2)
    np.testing.assert_allclose(np.sum(v_s1**2) + np.sum(m * v_m1**2),
                               np.sum(v_s0**2) + np.sum(m * v_m0**2), rtol=5e-4)


def test_coupling_advects_solutes():
    """Solutes at rest in a drifting solvent take up its drift through the
    collisions alone."""
    sim = _coupled_sim(port, N_s=4000, solvent_drift=0.6, period=5)
    sim.run(200)
    v_m = sim.state.get_snapshot().particles.velocity
    assert abs(v_m[:, 0].mean() - 0.6) < 0.15, v_m[:, 0].mean()
    assert abs(v_m[:, 1].mean()) < 0.15


def test_coupling_chunking_invariant():
    a = _coupled_sim(port, seed=7)
    a.run(50)
    b = _coupled_sim(port, seed=7)
    for n in (9, 21, 20):
        b.run(n)
    for x, y in zip(_stream_of(a), _stream_of(b)):
        np.testing.assert_array_equal(x, y)


def test_coupled_chunking_invariant_with_pair_forces():
    """Coupled with a pair force on the cell grid: the rebuild schedule,
    the collisions and the solvent bitwise whatever the run() chunking."""
    def build():
        sim = _coupled_sim(port, N_m=64, seed=8, kT=1.0, period=6, lattice=True)
        lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.0 ** (1 / 6),
                          mode="shift")
        lj.params[("C", "C")] = dict(epsilon=1.0, sigma=1.0)
        sim.operations.integrator.forces.append(lj)
        return sim

    a = build()
    a.run(60)
    b = build()
    for n in (11, 25, 24):
        b.run(n)
    assert a.operations.updaters[0]._ingraph
    for x, y in zip(_stream_of(a), _stream_of(b)):
        np.testing.assert_array_equal(x, y)


def test_coupling_collides_inside_the_chunk():
    """With the default trigger an aligned 100-step run at period 10 is one
    chunk, and its collisions moved the anchor to the last collision."""
    sim = _coupled_sim(port, period=10)
    sim.run(10)
    sim._seg_adapt = False  # no chunk splits at the interval's quanta
    coupling = sim.operations.updaters[0]
    assert coupling._ingraph
    calls = []
    orig = sim._run_chunk

    def counting(*args, **kw):
        calls.append(args[3])
        return orig(*args, **kw)

    sim._run_chunk = counting
    sim.run(100)
    assert calls == [100]
    assert sim._mpcd["_srd_anchor"][2] == 110


def test_coupling_custom_trigger_fires_at_its_steps():
    """A replaced trigger is not the default schedule (no divisor snap) and
    still couples the solutes, at its own steps."""
    sim = _coupled_sim(port, period=10)
    coupling = sim.operations.updaters[0]
    coupling.trigger = port.trigger.Periodic(10, phase=3)
    v0 = sim._state.velocity.numpy().copy()
    sim.run(30)
    assert not coupling._ingraph
    assert not np.allclose(sim.state.get_snapshot().particles.velocity, v0)
    assert sim._mpcd["_srd_anchor"][2] == 24  # fired after steps 3, 13, 23


def test_coupling_anchor_matches_md_clock():
    sim = _coupled_sim(port, period=10)
    sim.run(10)
    assert sim._mpcd["_srd_anchor"][2] == sim.timestep == 10
    sim.run(7)  # no collision: the anchor stays
    assert sim._mpcd["_srd_anchor"][2] == 10
    sim.run(3)
    assert sim._mpcd["_srd_anchor"][2] == sim.timestep == 20


def test_coupling_divisor_snap_warns_once():
    """A prime collision period snaps the rebuild interval to 1, and says
    so once."""
    sim = _coupled_sim(port, N_s=500, period=11)
    with pytest.warns(UserWarning, match="no divisor near"):
        sim.run(11)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim.run(11)


def test_coupling_attach_errors():
    sim = _coupled_sim(port, N_s=500)
    sim.mpcd_dynamics = port.mpcd.SRD(dt=0.02, period=10)
    with pytest.raises(ValueError, match="same SRD"):
        sim.run(1)
    snap = port.Snapshot(N=2)
    snap.configuration.box = [8, 8, 8, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    sim2 = port.Simulation(seed=1, device="cpu")
    sim2.create_state_from_snapshot(snap)
    sim2.operations.integrator = port.md.Integrator(
        dt=0.02, methods=[port.md.methods.ConstantVolume()], forces=[])
    srd = port.mpcd.SRD(dt=0.02, period=10)
    sim2.mpcd_dynamics = srd
    sim2.operations.updaters.append(port.mpcd.CollisionCoupling(srd))
    with pytest.raises(ValueError, match="MPCD stream"):
        sim2.run(1)


def test_srd_rejects_bad_geometry():
    sim = _solvent_sim(port, N=200, forces=False, cell_size=0.9)
    with pytest.raises(ValueError, match="multiple"):
        sim.run(5)
    snap = port.Snapshot(N=2, mpcd_N=10)
    snap.configuration.box = [8, 8, 8, 0.2, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    sim2 = port.Simulation(seed=1, device="cpu")
    sim2.create_state_from_snapshot(snap)
    sim2.operations.integrator = port.md.Integrator(
        dt=0.01, methods=[port.md.methods.ConstantVolume()], forces=[])
    sim2.mpcd_dynamics = port.mpcd.SRD(dt=0.01)
    with pytest.raises(ValueError, match="orthorhombic"):
        sim2.run(5)


def test_srd_plates_require_kT():
    with pytest.raises(ValueError, match="kT"):
        port.mpcd.SRD(dt=0.02, plates=("z", 8.0))
    with pytest.raises(ValueError, match="tangential"):
        port.mpcd.SRD(dt=0.02, kT=1.0, body_force=(0.0, 0.0, 0.1), plates=("z", 8.0))


def test_srd_rebuilds_on_box_change():
    """A new box rebuilds the SRD's grid instead of wrapping to the old L."""
    rng = np.random.default_rng(0)

    def stream(L):
        return {"position": (torch.as_tensor((rng.random((64, 3)) - 0.5) * L,
                                             dtype=torch.float32),),
                "velocity": (torch.as_tensor(rng.normal(0, 1, (64, 3)), dtype=torch.float32),)}

    srd = port.mpcd.SRD(dt=0.02, period=1, cell_size=1.0)
    srd._advance(stream(8.0), _cube(8.0), 0, 2, seed=1)
    assert srd._dims == (8, 8, 8)
    out = srd._advance(stream(16.0), _cube(16.0), 0, 2, seed=1)
    assert srd._dims == (16, 16, 16)
    assert np.all(np.abs(torch.cat(out["position"]).numpy()) <= 8.0 + 1e-5)


def test_replayed_chunk_does_not_advance_the_stream_twice():
    """A replayed chunk starts again from the untouched stream: a coupled
    run whose first chunk is replayed (a Verlet violation reported once)
    ends bitwise where an unreplayed run ends."""
    a = _coupled_sim(port, N_s=1000, kT=1.0, period=5)
    a.run(20)
    b = _coupled_sim(port, N_s=1000, kT=1.0, period=5)
    orig = b._run_chunk
    calls = []

    def violated_once(*args, **kw):
        dense, meta, viol, solv = orig(*args, **kw)
        calls.append(args[3])
        return dense, meta, viol | (len(calls) == 1), solv

    b._run_chunk = violated_once
    b.run(20)
    assert b.viol_replays == 1 and len(calls) >= 2
    for x, y in zip(_stream_of(a), _stream_of(b)):
        np.testing.assert_array_equal(x, y)
    assert b._mpcd["_srd_anchor"][2] == 20
