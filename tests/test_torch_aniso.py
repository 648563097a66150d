"""The port's anisotropic TwoPatchMorse force against the JAX reference.

The evaluator gets the same numpy-seeded pair batches in both packages;
``dense_aniso_force`` of both gets the same dense state (the reference's
densify, carried over bitwise) with random unit quaternions and the same
tables. The reference runs its XLA path (AZTPU_PALLAS=0), and one small
case its Pallas kernel in interpret mode (AZTPU_PALLAS=1). Per slot, force
and torque (and energy and virial with ``want="all"``) agree within atol =
3e-5 * max|ref| and rtol = 3e-5, the reference's own bar between its two
paths for this kernel: the pair terms are the same float32 formulas, and
only the order of the per-slot sums and the last ulp of exp differ.
"""

import collections

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu.ops.evaluators import aniso as RA  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.ops import aniso_kernel as AK  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.ops.evaluators import aniso as PA  # noqa: E402

torch.set_num_threads(1)

BAR = 3e-5
R_TPM = RA.ANISO_PAIR_POTENTIALS["TwoPatchMorse"]
P_TPM = PA.ANISO_PAIR_POTENTIALS["TwoPatchMorse"]


def _close(got, exp, what, bar=BAR):
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    np.testing.assert_allclose(got, exp, rtol=bar, atol=bar * np.abs(exp).max(), err_msg=what)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shift", [False, True], ids=["none", "shift"])
@pytest.mark.parametrize("repulsion", [True, False], ids=["repulsive", "flat_bottom"])
def test_two_patch_morse_matches_reference(repulsion, shift):
    """Pairs from r = 0.7 to the cutoff, random orientations: the flat
    bottom (r < r_eq without repulsion) and the shift branch included."""
    rng = np.random.default_rng(5)
    n = 4000
    d = rng.normal(size=(n, 3))
    d *= (rng.uniform(0.7, 1.6, n) / np.linalg.norm(d, axis=1))[:, None]
    d = d.astype(np.float32)
    qi, qj = _unit_quats(rng, n), _unit_quats(rng, n)
    host = dict(M_d=1.5, M_r=0.08, r_eq=1.05, omega=12.0, alpha=0.4, repulsion=repulsion)
    pre = {k: np.float32(v) for k, v in R_TPM.precompute(host).items()}
    rcutsq = np.float32(1.6) * np.float32(1.6)
    r = R_TPM.energy_force_torque(
        tuple(jnp.asarray(d[:, k]) for k in range(3)), tuple(jnp.asarray(qi[:, k]) for k in range(4)),
        tuple(jnp.asarray(qj[:, k]) for k in range(4)), jnp.float32(rcutsq),
        {k: jnp.float32(v) for k, v in pre.items()}, shift)
    p = P_TPM.energy_force_torque(
        tuple(torch.as_tensor(d[:, k]) for k in range(3)),
        tuple(torch.as_tensor(qi[:, k]) for k in range(4)),
        tuple(torch.as_tensor(qj[:, k]) for k in range(4)), torch.tensor(rcutsq),
        {k: torch.tensor(v) for k, v in pre.items()}, shift)
    _close(p[0].numpy(), r[0], "energy", 2e-5)
    for name, a, b in (("force", p[1], r[1]), ("torque_i", p[2], r[2]), ("torque_j", p[3], r[3])):
        _close(np.stack([c.numpy() for c in a]), np.stack([np.asarray(c) for c in b]), name, 2e-5)
    r_ = np.linalg.norm(d, axis=1)
    flat = (r_ < 1.05) & (not repulsion)
    assert flat.any() == (not repulsion)
    if not repulsion:  # the flat bottom: no radial force, U = -M_d Omega_i Omega_j
        np.testing.assert_array_equal(p[0].numpy()[flat] == 0, np.asarray(r[0])[flat] == 0)


PotentialTestCase = collections.namedtuple(
    "PotentialTestCase", ["params", "r_cut", "shift", "energy", "force", "torque"])

_MD = {"M_d": 1.8341, "M_r": 0.0302, "r_eq": 1.0043, "omega": 5.0, "alpha": 0.40,
       "repulsion": False}
# the reference plugin's golden table (its pytest/test_pair_aniso.py:15-110),
# as the JAX package's tests/test_pair_aniso.py carries it
GOLDEN = [
    PotentialTestCase(_MD, 1.6, False, -0.20567 * 2, (-11.75766, -2.46991, -3.70487),
                      (-0.000000, -0.08879, 0.05919)),
    PotentialTestCase(_MD, 1.10, True, -0.14195 * 2, None, None),
    PotentialTestCase(_MD, 1.0, True, 0, None, None),  # outside the cutoff
    PotentialTestCase(dict(_MD, M_d=0.0), 1.6, True, 0, None, None),
    PotentialTestCase(dict(_MD, r_eq=1.1, omega=100.0), 1.6, False, -1.8341, (0, 0, 0), None),
]


def _pair_sim(positions, orientations, r_cut, shift, params):
    snap = port.Snapshot(N=2)
    snap.configuration.box = [20, 20, 20, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = positions
    snap.particles.orientation[:] = orientations
    sim = port.Simulation(device="cpu", seed=1)
    sim.create_state_from_snapshot(snap)
    pot = port.pair.TwoPatchMorse(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=r_cut,
                                  mode="shift" if shift else "none")
    pot.params[("A", "A")] = params
    sim.operations.integrator = port.md.Integrator(
        dt=0.001, methods=[port.md.methods.ConstantVolume()], forces=[pot])
    sim.run(0)
    return pot


@pytest.mark.parametrize("case", GOLDEN, ids=["full", "shift", "outside", "M_d_0", "flat"])
def test_golden_energy_force_and_torque(case):
    pot = _pair_sim([[-0.5, -0.10, -0.15], [0.5, 0.10, 0.15]], [[1, 0, 0, 0], [1, 0, 0, 0]],
                    case.r_cut, case.shift, case.params)
    np.testing.assert_allclose(pot.energies, [0.5 * case.energy] * 2, rtol=1e-4, atol=1e-4)
    if case.force is not None:
        f = np.asarray(case.force)
        np.testing.assert_allclose(pot.forces, [-f, f], rtol=1e-3, atol=2e-4)
    if case.torque is not None:
        t = np.asarray(case.torque)
        np.testing.assert_allclose(pot.torques, [t, t], rtol=1e-3, atol=2e-4)


def test_torque_turns_the_misaligned_patch():
    th = np.deg2rad(30.0) / 2
    pot = _pair_sim([[-0.5, 0, 0], [0.5, 0, 0]], [[np.cos(th), 0, 0, np.sin(th)], [1, 0, 0, 0]],
                    1.6, False, dict(M_d=1.0, M_r=0.05, r_eq=1.0, omega=5.0, alpha=0.4,
                                     repulsion=True))
    torq = pot.torques
    assert abs(torq[1][2]) < 1e-4  # aligned: no torque
    assert abs(torq[0][2]) > 1e-4  # misaligned: a torque about z


# ---------------------------------------------------------------------------
# The dense force
# ---------------------------------------------------------------------------
# name: (lattice counts, tilt, types)
SYSTEMS = {
    "half_T1": ((8, 8, 8), (0.0, 0.0, 0.0), 1),
    "half_tilted": ((9, 8, 8), (0.3, -0.2, 0.15), 1),
    "full_axis_under_3": ((3, 8, 8), (0.0, 0.0, 0.0), 1),
    "half_T2": ((8, 8, 8), (0.0, 0.0, 0.0), 2),
}


def _system(name, counts=None, a=1.15, jitter=0.08):
    counts0, tilt, T = SYSTEMS[name]
    counts = counts or counts0
    rng = np.random.default_rng(300 + list(SYSTEMS).index(name))
    N = int(np.prod(counts))
    Ls = [c * a for c in counts]
    snap = ref.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = ["A", "B"][:T]
    f = (np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / np.asarray(counts)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0, Ls[1], tilt[2] * Ls[2]], [0, 0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0, jitter, (N, 3))
    snap.particles.orientation[:] = _unit_quats(rng, N)
    snap.particles.typeid[:] = rng.integers(0, T, N)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    spec = RD.GridSpec.create(rs.box, N, 1.6, 0.3)
    rd, meta = RD.densify(rs, spec, fields=("quat",))
    assert not bool(meta.overflow)

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return (m + m.T) / 2

    host = {"M_d": sym(1.0, 2.0), "M_r": sym(0.06, 0.15), "r_eq": sym(0.95, 1.1),
            "omega": sym(5.0, 20.0), "alpha": sym(0.3, 0.5), "repulsion": np.ones((T, T))}
    host["repulsion"][-1, -1] = 0.0 if T > 1 else 1.0  # a flat-bottom pair where T > 1
    tabs = {k: np.asarray(v, np.float32) for k, v in R_TPM.precompute(host).items()}
    rcut = np.full((T, T), 1.6, np.float32)
    rcut[0, -1] = rcut[-1, 0] = 1.4 if T > 1 else 1.6  # a per-pair cutoff where T > 1
    return rd, spec, tabs, rcut


def _reference(rd, spec, tabs, rcut, mode, want):
    masked = bool(np.any(np.asarray(rd.box.tilt) != 0)) or not spec.newton_ok
    jb = RD.make_jblocks(rd, spec, need_quat=True, half=spec.newton_ok, need_typeid=True)
    return RD.dense_aniso_force(R_TPM.energy_force_torque, rd, jb, spec,
                                {k: jnp.asarray(v) for k, v in tabs.items()}, jnp.asarray(rcut),
                                mode, want, masked)


def _port(rd, spec, tabs, rcut, mode, want):
    tbl = interop.aniso_tables_from_reference({"params": tabs, "r_cut": rcut}, "cpu")
    return AK.aniso_force(P_TPM.energy_force_torque, interop.state_from_reference(rd, "cpu"),
                          interop.grid_spec_from_reference(spec), tbl, mode, want)


@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("mode", ["none", "shift"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_plain_aniso_matches_reference(monkeypatch, name, mode, want):
    monkeypatch.setenv("AZTPU_PALLAS", "0")
    rd, spec, tabs, rcut = _system(name)
    assert spec.newton_ok == name.startswith("half")
    r = _reference(rd, spec, tabs, rcut, mode, want)
    p = _port(rd, spec, tabs, rcut, mode, want)
    _close(p.force.numpy(), r.force, "force")
    _close(p.torque.numpy(), r.torque, "torque")
    assert np.abs(np.asarray(r.force)).max() > 10.0  # a real test: forces are not ~0
    assert np.abs(np.asarray(r.torque)).max() > 1.0
    if want == "all":
        _close(p.energy.numpy(), r.energy, "energy")
        _close(p.virial.numpy(), r.virial, "virial")
    else:
        assert p.energy is None and p.virial is None
    # Newton's third law: the total force vanishes to round-off
    assert float(p.force.double().sum(0).abs().max()) < 1e-3 * float(p.force.abs().max())
    # empty slots get exactly zero
    empty = (p.torque.new_tensor(np.asarray(rd.tag)) < 0).numpy()
    assert not p.force.numpy()[empty].any() and not p.torque.numpy()[empty].any()


def test_plain_aniso_matches_reference_pallas_interpret(monkeypatch):
    """The reference's Pallas kernel for this force (interpret mode, the
    shape of its own tests/test_pallas_pair.py check), force and torque."""
    monkeypatch.setenv("AZTPU_PALLAS", "1")
    rd, spec, tabs, rcut = _system("half_T1", counts=(6, 6, 6))
    assert spec.newton_ok and spec.cap % 8 == 0
    r = _reference(rd, spec, tabs, rcut, "shift", "force")
    p = _port(rd, spec, tabs, rcut, "shift", "force")
    _close(p.force.numpy(), r.force, "force")
    _close(p.torque.numpy(), r.torque, "torque")


def test_cpu_dispatch_and_kernel_tables():
    rd, spec, tabs, rcut = _system("half_T2")
    pd, ps = interop.state_from_reference(rd, "cpu"), interop.grid_spec_from_reference(spec)
    tbl = interop.aniso_tables_from_reference({"params": tabs, "r_cut": rcut}, "cpu")
    before = AK.launches
    got = AK.aniso_force(P_TPM.energy_force_torque, pd, ps, tbl, "shift", "all")
    jb = PD.make_jblocks(pd, ps, half=True, need_quat=True)
    exp = PD.dense_aniso_force(P_TPM.energy_force_torque, pd, jb, ps, tbl["params"],
                               tbl["r_cut"], "shift", "all")
    assert AK.launches == before  # CPU tensors never launch
    for k in ("force", "torque", "energy", "virial"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(exp, k).numpy())
    for mode in ("none", "shift"):
        kt = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], mode)
        assert tuple(kt.shape) == (len(AK.KERNEL_TABLES), 2, 2) and kt.is_contiguous()
        for i, k in enumerate(AK.KERNEL_TABLES[:6]):
            np.testing.assert_array_equal(kt[i].numpy(), tabs[k])
        np.testing.assert_array_equal(kt[6].numpy(), rcut * rcut)
        u_cut = PA.morse_cut(tbl["r_cut"] * tbl["r_cut"], tbl["params"]).numpy()
        np.testing.assert_array_equal(kt[7].numpy(), u_cut if mode == "shift" else 0 * u_cut)
    with pytest.raises(ValueError, match="mode"):
        AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "xplor")
    with pytest.raises(ValueError, match="CUDA"):  # the kernel takes CUDA tensors only
        AK.cell_aniso_force(pd, ps, kt)
