"""The port's bonds against the JAX reference: evaluators, the dense bond
force, and a small polymer melt (Quartic bonds + ExpandedYukawa pairs under
Langevin, the bench's polymer configuration at a tenth of its size).

Bars: evaluators and per-slot bond forces within rtol = 2e-5 and atol =
2e-5 * max|ref| (the same float32 formulas; sqrt, log and the scatter
order may differ by an ulp); the melt within the bars of
tests/test_torch_simulation.py.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu.ops.evaluators.bond import BOND_POTENTIALS as REF_BOND  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.ops.evaluators.bond import BOND_POTENTIALS as PORT_BOND  # noqa: E402

torch.set_num_threads(1)

BAR = 2e-5

# per bond type (two types): user parameters as the reference's tests set them
BOND_PARAMS = {
    "DoubleWell": [dict(r_0=0.8, r_1=1.2, U_1=5.0, U_tilt=0.5),
                   dict(r_0=1.0, r_1=1.5, U_1=2.0, U_tilt=0.0)],
    "Quartic": [dict(k=1434.3, r_0=1.5, b_1=-0.7589, b_2=0.0, U_0=67.2234, sigma=1.0,
                     epsilon=1.0, delta=0.0),
                dict(k=1000.0, r_0=1.3, b_1=-0.7, b_2=0.1, U_0=50.0, sigma=0.9, epsilon=1.2,
                     delta=0.2)],
    "Harmonic": [dict(k=300.0, r0=1.0), dict(k=100.0, r0=1.2)],
    "FENEWCA": [dict(k=30.0, R0=1.5, epsilon=1.0, sigma=1.0, delta=0.0),
                dict(k=20.0, R0=1.8, epsilon=0.8, sigma=0.9, delta=0.2)],
}


def _host_tables(name):
    spec = PORT_BOND[name].spec
    rows = BOND_PARAMS[name]
    return {k: np.asarray([row.get(k, spec[k]) for row in rows], np.float64) for k in spec}


def _close(got, exp, what):
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    np.testing.assert_allclose(got, exp, rtol=BAR, atol=BAR * np.abs(exp).max(), err_msg=what)


@pytest.mark.parametrize("name", list(PORT_BOND))
def test_bond_evaluator_matches_reference(name):
    host = _host_tables(name)
    rpre = {k: np.asarray(v, np.float32) for k, v in REF_BOND[name].precompute(host).items()}
    ppre = {k: np.asarray(v, np.float32) for k, v in PORT_BOND[name].precompute(host).items()}
    assert rpre.keys() == ppre.keys()
    for k in rpre:
        np.testing.assert_array_equal(ppre[k], rpre[k])
    rng = np.random.default_rng(1)
    # bond lengths from the WCA core to past the quartic's r_0 (broken bonds)
    r = rng.uniform(0.75, 1.75, 4096).astype(np.float32)
    typeid = rng.integers(0, 2, r.size)
    rsq = r * r
    re, rf = REF_BOND[name].energy_force(jnp.asarray(rsq), {k: jnp.asarray(v[typeid])
                                                            for k, v in rpre.items()})
    pe, pf = PORT_BOND[name].energy_force(torch.as_tensor(rsq), {k: torch.as_tensor(v[typeid])
                                                                 for k, v in ppre.items()})
    assert np.isfinite(np.asarray(rf)).all()
    _close(pe.numpy(), re, "energy")
    _close(pf.numpy(), rf, "force / r")


def _melt_snapshot(az, n_chains=100, chain_len=10, rho=0.5, n_bond_types=1):
    """Straight rods along x on a (y, z) grid, as the bench's polymer melt."""
    N = n_chains * chain_len
    L = (N / rho) ** (1 / 3)
    snap = az.Snapshot(N=N, bond_N=n_chains * (chain_len - 1))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.bonds.types = ["backbone", "other"][:n_bond_types]
    gy = int(np.floor(np.sqrt(n_chains)))
    gz = (n_chains + gy - 1) // gy
    b = 0
    for c in range(n_chains):
        y = ((c % gy) + 0.5) * L / gy - L / 2
        z = ((c // gy) + 0.5) * L / gz - L / 2
        x0 = -0.97 * (chain_len - 1) / 2
        for m in range(chain_len):
            i = c * chain_len + m
            snap.particles.position[i] = [x0 + 0.97 * m, y, z]
            if m < chain_len - 1:
                snap.bonds.typeid[b] = b % n_bond_types
                snap.bonds.group[b] = [i, i + 1]
                b += 1
    return snap


@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("name", list(PORT_BOND))
def test_dense_bond_force_matches_reference(name, want):
    snap = _melt_snapshot(ref, n_chains=36, chain_len=8, n_bond_types=2)
    rng = np.random.default_rng(2)
    snap.particles.position[:] += rng.normal(0, 0.05, (snap.particles.N, 3))
    rs, _, _ = ref.core.state_from_snapshot(snap)
    spec = RD.GridSpec.create(rs.box, rs.N, 1.2, 0.4)
    rd, meta = RD.densify(rs, spec, fields=())
    host = _host_tables(name)
    pre = {k: np.asarray(v, np.float32) for k, v in REF_BOND[name].precompute(host).items()}
    r = RD.dense_bond_force(REF_BOND[name].energy_force, rd, meta.slot_of, rd.bond_group,
                            rd.bond_typeid, {k: jnp.asarray(v) for k, v in pre.items()}, want)
    pd = interop.state_from_reference(rd, "cpu")
    pmeta = interop.grid_meta_from_reference(meta, "cpu")
    tbl = interop.bond_tables_from_reference({"params": pre}, rd, "cpu")
    p = PD.dense_bond_force(PORT_BOND[name].energy_force, pd, pmeta.slot_of, tbl["group"],
                            tbl["params"], want)
    assert np.abs(np.asarray(r.force)).max() > 1.0
    _close(p.force.numpy(), r.force, "force")
    if want == "all":
        _close(p.energy.numpy(), r.energy, "energy")
        _close(p.virial.numpy(), r.virial, "virial")
    else:
        assert p.energy is None and p.virial is None


def _melt(az, seed=14):
    sim = az.Simulation(device="cpu", seed=seed)
    sim.create_state_from_snapshot(_melt_snapshot(az))
    bonds = az.bond.Quartic()
    bonds.params["backbone"] = dict(k=1434.3, r_0=1.5, b_1=-0.7589, b_2=0.0, U_0=67.2234,
                                    sigma=1.0, epsilon=1.0, delta=0.0)
    pairs = az.pair.ExpandedYukawa(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    pairs.params[("A", "A")] = dict(epsilon=2.0, kappa=1.5, delta=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[bonds, pairs])
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, bonds, pairs, thermo


def _snap(sim):
    s = sim.state.get_snapshot()
    return s.particles.position.copy(), s.particles.velocity.copy(), s.particles.image.copy()


def test_melt_one_step_matches_reference():
    """Observables on the identical start state within the f32 bar, then one
    step. Forces are compared before the step: after it, positions differ
    by float32 rounding (~5e-7) and the stiff Quartic bond (dF/dr ~ 2e3)
    turns that into force differences above 2e-5 of max|f|."""
    rsim, rb, rp, rth = _melt(ref)
    psim, pb, pp, pth = _melt(port)
    rsim.auto_tune_after = None  # these runs stop short of the tune point anyway
    rsim.run(0)
    psim.run(0)
    for pf, rf in ((pb, rb), (pp, rp)):
        np.testing.assert_allclose(pf.energy, rf.energy, rtol=2e-5)
        np.testing.assert_allclose(pf.forces, rf.forces, rtol=2e-5,
                                   atol=2e-5 * np.abs(rf.forces).max())
        np.testing.assert_allclose(pf.virials, rf.virials, rtol=2e-5,
                                   atol=2e-5 * np.abs(rf.virials).max())
        np.testing.assert_allclose(pf.energies, rf.energies, rtol=2e-5,
                                   atol=2e-5 * np.abs(rf.energies).max())
    for q in ("potential_energy", "pressure"):
        np.testing.assert_allclose(getattr(pth, q), getattr(rth, q), rtol=2e-5, err_msg=q)
    rsim.run(1)
    psim.run(1)
    rpos, rv, ri = _snap(rsim)
    ppos, pv, pi = _snap(psim)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ppos, rpos, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pv, rv, rtol=2e-5, atol=2e-5 * np.abs(rv).max())
    np.testing.assert_allclose(pth.kinetic_temperature, rth.kinetic_temperature, rtol=2e-5)


def test_melt_twenty_steps_matches_reference():
    """20 Langevin steps; the noise is bitwise shared, so the trajectories
    separate only through float32 rounding (1e-4, as the LJ fluid's)."""
    rsim, _, _, rth = _melt(ref)
    psim, _, _, pth = _melt(port)
    rsim.auto_tune_after = None
    rsim.run(20)
    psim.run(20)
    rpos, rv, ri = _snap(rsim)
    ppos, pv, pi = _snap(psim)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ppos, rpos, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-4 * np.abs(rv).max())
    assert psim.n_builds == int(rsim._meta.n_builds)
    np.testing.assert_allclose(pth.kinetic_temperature, rth.kinetic_temperature, rtol=1e-4)


def test_bonds_without_pairs_run_in_tag_order():
    """A bonds-only system has no grid: the force takes tag order with the
    identity tag->slot map, and the two endpoint forces cancel."""
    sim = port.Simulation(device="cpu", seed=1)
    snap = _melt_snapshot(port, n_chains=4, chain_len=5)
    sim.create_state_from_snapshot(snap)
    h = port.bond.Harmonic()
    h.params["backbone"] = dict(k=100.0, r0=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.001, methods=[port.md.methods.ConstantVolume()], forces=[h])
    sim.run(10)
    assert sim._grid_spec is None
    f = h.forces
    assert np.abs(f).max() > 0.1 and np.abs(f.sum(axis=0)).max() < 1e-4
    assert np.isfinite(h.energy) and h.energy > 0


def _branched(az, device="cpu", n_stars=27, L=12.0, seed=5):
    """Branched molecules: stars of a centre and four arms on a lattice,
    bonded (c, c+1), (c, c+2), (c, c+3) and (c+4, c), so each centre is the
    first member of three bonds and the second member of one; Harmonic
    bonds and a WCA pair force (a grid, and a tag->slot map)."""
    rng = np.random.default_rng(seed)
    g = round(n_stars ** (1 / 3))
    x = (np.arange(g) + 0.5) * (L / g) - L / 2
    centres = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    arms = 0.9 * np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0]])
    pos = np.concatenate([np.concatenate([c[None], c + arms]) for c in centres])
    pos += rng.normal(0, 0.05, pos.shape)
    snap = az.Snapshot(N=len(pos), bond_N=4 * len(centres))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = pos
    snap.bonds.types = ["arm"]
    c = 5 * np.arange(len(centres))
    snap.bonds.group[:] = np.concatenate(
        [np.stack([c, c + 1], 1), np.stack([c, c + 2], 1), np.stack([c, c + 3], 1),
         np.stack([c + 4, c], 1)])
    sim = az.Simulation(device=device, seed=3)
    sim.create_state_from_snapshot(snap)
    bonds = az.bond.Harmonic()
    bonds.params["arm"] = dict(k=100.0, r0=1.0)
    wca = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0 ** (1 / 6),
                     mode="shift")
    wca.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[bonds, wca])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, bonds


@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("layout", ["whole", "shard"])
def test_bond_scatter_in_the_cards_order(monkeypatch, layout, want):
    """The bond force's scatter on the card (``_bond_scatter``: K10 over
    the bonds' first members, then their second members, at unit mass)
    with K10 in its plain ordered form (``mpcd._cell_sums_plain``) is bitwise
    the CPU's ``index_add_`` form, on branched molecules whose centres are
    the first member of three bonds and the second of one; on a shard
    (every slot's positions, the rows past it dropped) too."""
    from azplugins_tpu_torch import mpcd as M
    from azplugins_tpu_torch.ops import cellsum_kernel as CK

    sim, bonds = _branched(port)
    sim.run(5)
    dense, slot_of = sim._dense, sim._meta.slot_of
    tbl = bonds._device_tables(sim.device)
    a = slot_of[tbl["group"][:, 0]]
    assert int(torch.bincount(a).max()) == 3  # a slot first in three bonds
    kw, part = {}, dense
    if layout == "shard":  # the middle third of the slots
        lo, hi = dense.N // 3, 2 * dense.N // 3
        kw, part = dict(positions=dense.position, first=lo), dense.replace(
            position=dense.position[lo:hi])

    def force():
        return PD.dense_bond_force(bonds._def.energy_force, part, slot_of, tbl["group"],
                                   tbl["params"], want, **kw)

    want_r = force()
    monkeypatch.setattr(CK, "cell_sums", lambda cid, vel, mass, cells: M._cell_sums_plain(
        cid, M._payload(vel, mass), cells))
    monkeypatch.setattr(PD, "_rng", type("OnCard", (), {"_on_card": staticmethod(
        lambda device: True)}))
    got = force()
    for name in ("force", "energy", "virial"):
        w, g = getattr(want_r, name), getattr(got, name)
        if want == "force" and name != "force":
            assert w is None and g is None
            continue
        assert g.shape == w.shape and torch.equal(g.contiguous().view(torch.int32),
                                                  w.view(torch.int32)), name
    assert float(want_r.force.abs().max()) > 1.0
