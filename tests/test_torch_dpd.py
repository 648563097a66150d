"""The port's DPD thermostat against the JAX reference, and the reference's
own DPD checks run on the port.

``dense_dpd_force`` of both packages gets the same dense state (the
reference's densify, carried over bitwise) with numpy-seeded velocities and
the same tables. The reference runs its XLA path (AZTPU_PALLAS=0) and its
Pallas kernel in interpret mode (AZTPU_PALLAS=1). Per-slot force, energy
and virial agree within atol = 2e-5 * max|ref| and rtol = 2e-5: the noise
is bitwise shared, the pair terms are the same float32 values (up to
``pow``), and only the order of the per-slot sums differs.

One caveat is the reference's own: its Pallas kernel forms r through an
approximate ``rsqrt``, and for s < 2 the weight (1 - r/rc)^(s/2) has an
unbounded slope at the cutoff, so a pair within ~1e-5 of r_cut moves by
more than the bar between the reference's XLA and Pallas paths (measured
8e-3 at max|f| 89 on the tilted system with s drawn from [0.3, 2]). The
tilted system therefore takes s >= 2, where the weight is smooth; the
others keep s < 2, the DPD fluid's 0.5 included.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.core import rng as RR  # noqa: E402
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.core import rng as PR  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.ops import dpd_kernel as DK  # noqa: E402

torch.set_num_threads(1)

BAR = 2e-5
KT, DT, SEED, TIMESTEP = 1.3, 0.01, 77, 2**24 + 3

# name: (lattice counts, number density, tilt, types, range of s)
SYSTEMS = {
    "half_T1": ((8, 8, 8), 3.0, (0.0, 0.0, 0.0), 1, (0.3, 2.0)),
    "half_tilted": ((9, 8, 8), 3.0, (0.3, -0.2, 0.15), 1, (2.0, 3.0)),
    "full_axis_under_3": ((4, 8, 8), 3.0, (0.0, 0.0, 0.0), 1, (0.3, 2.0)),
    "half_T2": ((8, 8, 8), 3.0, (0.0, 0.0, 0.0), 2, (0.3, 2.0)),
}


def _system(name):
    counts, rho, tilt, T, s_range = SYSTEMS[name]
    rng = np.random.default_rng(100 + list(SYSTEMS).index(name))
    N = int(np.prod(counts))
    a = (1.0 / rho) ** (1.0 / 3.0)
    Ls = [c * a for c in counts]
    snap = ref.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = ["A", "B"][:T]
    f = (np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / np.asarray(counts)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0, Ls[1], tilt[2] * Ls[2]], [0, 0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0, 0.08, (N, 3))
    snap.particles.velocity[:] = rng.normal(0, 1.0, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, T, N)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    spec = RD.GridSpec.create(rs.box, N, 1.0, 0.4)
    rd, meta = RD.densify(rs, spec, fields=())
    assert not bool(meta.overflow)

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return (m + m.T) / 2

    tabs = {"A": sym(15.0, 30.0), "gamma": sym(3.0, 6.0), "s": sym(*s_range)}
    tabs = {k: np.asarray(v, np.float32) for k, v in tabs.items()}
    rcut = np.full((T, T), 1.0, np.float32)
    rcut[0, -1] = rcut[-1, 0] = 0.85  # a per-pair cutoff where T > 1
    return rd, spec, tabs, rcut


def _reference(rd, spec, tabs, rcut, want):
    T = rcut.shape[0]
    masked = bool(np.any(np.asarray(rd.box.tilt) != 0)) or not spec.newton_ok
    jb = RD.make_jblocks(rd, spec, need_velocity=True, need_tag=True, half=spec.newton_ok,
                         need_typeid=masked or T > 1)
    return RD.dense_dpd_force(rd, jb, spec, {k: jnp.asarray(v) for k, v in tabs.items()},
                              jnp.asarray(rcut), KT, DT, SEED, TIMESTEP, want, masked)


def _close(got, exp, what):
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    np.testing.assert_allclose(got, exp, rtol=BAR, atol=BAR * np.abs(exp).max(), err_msg=what)


@pytest.mark.parametrize("pallas", ["0", "1"], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_plain_dpd_matches_reference(monkeypatch, name, want, pallas):
    rd, spec, tabs, rcut = _system(name)
    assert spec.newton_ok == name.startswith("half")
    monkeypatch.setenv("AZTPU_PALLAS", pallas)
    r = _reference(rd, spec, tabs, rcut, want)
    pd = interop.state_from_reference(rd, "cpu")
    tbl = interop.pair_tables_from_reference(
        {"params": tabs, "r_cut": rcut, "r_on": np.zeros_like(rcut)}, "cpu")
    p = DK.dpd_force(pd, interop.grid_spec_from_reference(spec), tbl, KT, DT, SEED, TIMESTEP,
                     want)
    _close(p.force.numpy(), r.force, "force")
    assert np.abs(np.asarray(r.force)).max() > 10.0  # a real test: forces are not ~0
    if want == "all":
        _close(p.energy.numpy(), r.energy, "energy")
        _close(p.virial.numpy(), r.virial, "virial")
    else:
        assert p.energy is None and p.virial is None
    # Newton's third law term by term: the total force vanishes
    assert float(p.force.double().sum(0).abs().max()) < 1e-3 * float(p.force.abs().max())


def test_dpd_noise_bitwise_at_large_tags_and_timesteps():
    """The DPD stream at 13 rounds, bitwise, with tags and timesteps at and
    above 2**24 (where the reference's TPU kernel could not reach)."""
    rng = np.random.default_rng(9)
    a = np.concatenate([rng.integers(2**24 - 8, 2**31 - 1, 2000),
                        [2**24 - 1, 2**24, 2**24 + 1, 2**31 - 1]]).astype(np.int32)
    b = np.concatenate([rng.integers(0, 2**31 - 1, 2000), [2**24, 2**24 - 1, 0, 2**31 - 2]])
    b = b.astype(np.int32)
    for seed, t in [(5, 2**24 - 1), (5, 2**24), (0xFFFF, 2**24 + 12345), (1, 2**32 - 1)]:
        r = RR.pair_uniform(RR.Stream.DPD_GENERAL_WEIGHT, seed, t, jnp.asarray(a),
                            jnp.asarray(b), rounds=RR.FAST_ROUNDS)
        p = PR.pair_uniform(PR.Stream.DPD_GENERAL_WEIGHT, seed, t, torch.as_tensor(a),
                            torch.as_tensor(b), rounds=PR.FAST_ROUNDS)
        np.testing.assert_array_equal(p.numpy().view(np.int32), np.asarray(r).view(np.int32))


def test_sigma_table_and_kernel_tables():
    gamma = torch.tensor([[4.5, 3.0], [3.0, 0.0]])
    sig = PD.dpd_sigma_table(gamma, 1.5, 0.01)
    expect = np.sqrt(6.0 * np.float32(4.5) * np.float32(1.5) / np.float32(0.01))
    np.testing.assert_allclose(sig[0, 0].item(), expect, rtol=1e-6)
    assert sig[1, 1].item() == 0.0
    assert not PD.dpd_sigma_table(gamma, 1.5, 0.0).any()
    params = {"A": torch.ones(2, 2), "gamma": gamma, "s": torch.full((2, 2), 0.5)}
    kt = DK.dpd_kernel_tables(params, torch.ones(2, 2), 1.5, 0.01)
    assert tuple(kt.shape) == (5, 2, 2) and kt.is_contiguous()
    np.testing.assert_array_equal(kt[4].numpy(), sig.numpy())
    rd, spec, _, _ = _system("half_T1")
    with pytest.raises(ValueError, match="CUDA"):  # the kernel takes CUDA tensors only
        DK.cell_dpd_force(interop.state_from_reference(rd, "cpu"),
                          interop.grid_spec_from_reference(spec), kt[:, :1, :1].contiguous(),
                          SEED, TIMESTEP)


def test_sigma_table_from_a_tensor_kT_is_the_float_ones():
    """A variant kT reaches the DPD tables as a 0-d float32 (a run's
    schedule): the sigma table keeps the float's bits, the division by dt
    still one by the Python scalar."""
    g = np.random.default_rng(4)
    gamma = torch.as_tensor(g.uniform(0.0, 9.0, (3, 3)).astype(np.float32))
    params = {"A": torch.ones(3, 3), "gamma": gamma, "s": torch.full((3, 3), 0.5)}
    for kT in (0.3, 1.0, 1.2345678, 7.5):
        for dt in (0.01, 0.005, 0.0):
            want = PD.dpd_sigma_table(gamma, kT, dt)
            got = PD.dpd_sigma_table(gamma, torch.tensor(np.float32(kT)), dt)
            assert got.dtype == torch.float32
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (kT, dt)
            kt = DK.dpd_kernel_tables(params, torch.ones(3, 3), torch.tensor(np.float32(kT)), dt)
            assert torch.equal(kt[4], want)


# ---------------------------------------------------------------------------
# Simulations: the same snapshot and seed in both packages
# ---------------------------------------------------------------------------
def _lattice(az, n, a, seed=3, kick=0.05):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=n**3)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-kick, kick, pos.shape)
    return snap


def _dpd_sim(az, n=7, a=0.7, kT=1.0, A=25.0, gamma=4.5, s=0.5, seed=5, dt=0.01, thermalize=True):
    sim = az.Simulation(device="cpu", seed=seed)
    sim.create_state_from_snapshot(_lattice(az, n, a))
    dpd = az.pair.DPDGeneralWeight(nlist=az.md.nlist.Cell(buffer=0.4), kT=kT, default_r_cut=1.0)
    dpd.params[("A", "A")] = dict(A=A, gamma=gamma, s=s)
    sim.operations.integrator = az.md.Integrator(
        dt=dt, methods=[az.md.methods.ConstantVolume()], forces=[dpd])
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    if thermalize:
        sim.state.thermalize_particle_momenta(kT=kT)
    return sim, dpd, thermo


def _snap(sim):
    s = sim.state.get_snapshot()
    return s.particles.position.copy(), s.particles.velocity.copy(), s.particles.image.copy()


def test_one_step_matches_reference():
    rsim, rdpd, rth = _dpd_sim(ref)
    psim, pdpd, pth = _dpd_sim(port)
    rsim.auto_tune_after = None  # these runs stop short of the tune point anyway
    rsim.run(1)
    psim.run(1)
    rp, rv, ri = _snap(rsim)
    pp, pv, pi = _snap(psim)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pp, rp, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pv, rv, rtol=2e-5, atol=2e-5 * np.abs(rv).max())
    np.testing.assert_allclose(pdpd.forces, rdpd.forces, rtol=2e-5,
                               atol=2e-5 * np.abs(rdpd.forces).max())
    np.testing.assert_allclose(pdpd.energy, rdpd.energy, rtol=2e-5)
    np.testing.assert_allclose(pdpd.virials, rdpd.virials, rtol=2e-5,
                               atol=2e-5 * np.abs(rdpd.virials).max())
    for q in ("kinetic_energy", "translational_degrees_of_freedom", "kinetic_temperature",
              "pressure"):
        np.testing.assert_allclose(getattr(pth, q), getattr(rth, q), rtol=2e-5, err_msg=q)
    # ConstantVolume conserves momentum: DOF 3N - 3, as the reference
    assert pth.translational_degrees_of_freedom == 3 * psim.state.N_particles - 3


def test_twenty_step_trajectory_matches_reference():
    """20 DPD steps with rebuilds between them. The noise is bitwise shared,
    so the trajectories separate only through float32 rounding; 1e-4 in
    position and velocity bounds 20 steps of that."""
    rsim, _, rth = _dpd_sim(ref)
    psim, _, pth = _dpd_sim(port)
    rsim.auto_tune_after = None
    rsim.run(20)
    psim.run(20)
    rp, rv, ri = _snap(rsim)
    pp, pv, pi = _snap(psim)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pp, rp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-4 * np.abs(rv).max())
    assert psim.n_builds == int(rsim._meta.n_builds)
    np.testing.assert_allclose(pth.kinetic_temperature, rth.kinetic_temperature, rtol=1e-4)


# ---------------------------------------------------------------------------
# The reference's own DPD checks (tests/test_pair_dpd.py), on the port
# ---------------------------------------------------------------------------
def test_dpd_temperature():
    """A=0 DPD (drag + noise only) must thermostat NVE to kT=1.5."""
    sim, _, thermo = _dpd_sim(port, n=10, a=0.6, kT=1.5, A=0.0, thermalize=True)
    sim.run(10)
    kT = np.zeros(100)
    for sample in range(100):
        kT[sample] = thermo.kinetic_temperature
        sim.run(1)
    assert np.mean(kT) == pytest.approx(1.5, 0.1)


def test_dpd_trajectory_reproducible():
    """Same seed -> bitwise identical trajectory, whatever the chunking."""

    def build():
        sim, _, _ = _dpd_sim(port, n=6, a=0.8, A=5.0, s=2.0, seed=9)
        return sim

    sim1, sim2 = build(), build()
    sim1.run(30)
    for _ in range(3):
        sim2.run(10)
    np.testing.assert_array_equal(sim1.state.get_snapshot().particles.velocity,
                                  sim2.state.get_snapshot().particles.velocity)


def test_dpd_conservative_force():
    """kT=0: random force zero, force = A(1 - r/rc) along x."""
    snap = port.Snapshot(N=2)
    snap.configuration.box = [20, 20, 20, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-0.25, 0, 0], [0.25, 0, 0]]
    sim = port.Simulation(device="cpu", seed=42)
    sim.create_state_from_snapshot(snap)
    dpd = port.pair.DPDGeneralWeight(nlist=port.md.nlist.Cell(buffer=0.4), kT=0.0,
                                     default_r_cut=1.0)
    dpd.params[("A", "A")] = dict(A=2.0, gamma=4.5, s=2.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.001, methods=[port.md.methods.ConstantVolume()], forces=[dpd])
    sim.run(0)
    np.testing.assert_allclose(dpd.forces[1][0], 2.0 * (1 - 0.5), rtol=1e-5)


def test_dpd_conserves_momentum():
    """Drag and random forces are pairwise antisymmetric, so total momentum
    is conserved up to float32 round-off of the per-slot sums."""
    sim, _, _ = _dpd_sim(port, n=8, a=0.9, thermalize=False)
    sim.run(200)
    snap = sim.state.get_snapshot()
    p = (snap.particles.velocity * snap.particles.mass[:, None]).sum(axis=0)
    v_scale = np.abs(snap.particles.velocity).max()
    assert np.abs(p).max() < 5e-3 * v_scale * snap.particles.N ** 0.5
