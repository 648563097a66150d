"""The port's rotational integration against the JAX reference, and the
reference's own rotational checks run on the port.

Each function of md/rotation.py gets the same numpy inputs in both
packages: they are the same elementwise float32 formulas, and the
reference's jit may fuse a product into a fused multiply-add, so they
agree within 1e-6 of max|value| (exactly where XLA does not fuse). The
noise words of the angular thermalisation and the rotational Langevin
noise are bitwise the reference's; the Box-Muller gaussians differ from
XLA's log and cos in the last ulp, so the thermalised angular momenta
agree within 1e-6 of max|value|. A small patchy system (TwoPatchMorse with
NO_SQUISH Langevin) is built from the same snapshot and seed in both
packages: one step agrees within float32 bars, 20 steps within 1e-4.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.core import rng as Rrng  # noqa: E402
from azplugins_tpu.md import rotation as RR  # noqa: E402
from azplugins_tpu.utils import quaternion as RQ  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.core import rng as Prng  # noqa: E402
from azplugins_tpu_torch.md import rotation as PR  # noqa: E402
from azplugins_tpu_torch.utils import quaternion as PQ  # noqa: E402

torch.set_num_threads(1)


def _close(got, exp, what="", bar=1e-6):
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    np.testing.assert_allclose(got, exp, rtol=bar, atol=bar * max(np.abs(exp).max(), 1e-30),
                               err_msg=what)


def _inputs(n=3000, seed=0):
    """Unit quaternions, angular-momentum quaternions, lab vectors and
    moments of inertia with about a fifth of the axes at zero."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    p = rng.normal(size=(n, 4)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    inertia = (rng.uniform(0.2, 2.0, (n, 3)) * (rng.uniform(size=(n, 3)) > 0.2)).astype(np.float32)
    return q, p, v, inertia


# (name, the reference's call, the port's call) on (q, p, v, inertia)
FUNCTIONS = {
    "quat_mul": lambda R, q, p, v, i: R.quat_mul(q, p),
    "rotate": lambda R, q, p, v, i: R.rotate(q, v),
    "rotate_inv": lambda R, q, p, v, i: R.rotate_inv(q, v),
    "angmom_kick": lambda R, q, p, v, i: R.angmom_kick(q, p, v, i, 0.005),
    "free_rotation_q": lambda R, q, p, v, i: R.free_rotation(q, p, i, 0.005)[0],
    "free_rotation_p": lambda R, q, p, v, i: R.free_rotation(q, p, i, 0.005)[1],
    "body_angular_momentum": lambda R, q, p, v, i: R.body_angular_momentum(q, p),
    "rotational_kinetic_energy": lambda R, q, p, v, i: R.rotational_kinetic_energy(q, p, i),
    "perm1": lambda R, q, p, v, i: R._perm1(q),
    "perm2": lambda R, q, p, v, i: R._perm2(q),
    "perm3": lambda R, q, p, v, i: R._perm3(q),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_rotation_function_matches_reference(name):
    host = _inputs()
    r = FUNCTIONS[name](RR, *(jnp.asarray(a) for a in host))
    p = FUNCTIONS[name](PR, *(torch.as_tensor(a) for a in host))
    _close(p.numpy(), r, name, bar=2e-6)


def test_permutations_and_frozen_axes():
    q, p, v, inertia = _inputs(n=200)
    qt, pt = torch.as_tensor(q), torch.as_tensor(p)
    # the permutations are exact sign-and-swap maps
    for perm in (PR._perm1, PR._perm2, PR._perm3):
        np.testing.assert_array_equal(perm(perm(qt)).numpy(), -q)
    # a particle with no inertia at all neither rotates nor changes p
    it = torch.zeros((200, 3))
    q1, p1 = PR.free_rotation(qt, pt, it, 0.01)
    np.testing.assert_allclose(q1.numpy(), q, atol=1e-6)
    np.testing.assert_array_equal(p1.numpy(), p)


@pytest.mark.parametrize("name", ["rotate", "rotate_x"])
def test_quaternion_utils_match_reference(name):
    q, _, v, _ = _inputs()
    if name == "rotate":
        r, p = RQ.rotate(jnp.asarray(q), jnp.asarray(v)), PQ.rotate(torch.as_tensor(q),
                                                                  torch.as_tensor(v))
    else:
        r, p = RQ.rotate_x(jnp.asarray(q)), PQ.rotate_x(torch.as_tensor(q))
    _close(p.numpy(), r, name)
    # a rotation keeps lengths
    if name == "rotate":
        np.testing.assert_allclose(np.linalg.norm(p.numpy(), axis=1), np.linalg.norm(v, axis=1),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# Noise: angular thermalisation and the rotational Langevin thermostat
# ---------------------------------------------------------------------------
def _state_snapshot(az, N=2000, seed=4, identity=False):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [30, 30, 30, 0, 0, 0]
    snap.particles.types = ["P", "Q"]
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    snap.particles.position[:] = rng.uniform(-15, 15, (N, 3))
    if not identity:
        q = rng.normal(size=(N, 4))
        snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.moment_inertia[:] = (rng.uniform(0.1, 1.0, (N, 3))
                                        * (rng.uniform(size=(N, 3)) > 0.2))
    return snap


@pytest.mark.parametrize("kT,seed,masked", [(0.8, 7, False), (1.3, 42, True)])
def test_angular_thermalisation_matches_reference(kT, seed, masked):
    snap = _state_snapshot(ref)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    ps = interop.state_from_reference(rs, "cpu")
    mask = np.random.default_rng(3).random(snap.particles.N) < 0.6 if masked else None
    # the noise words of the angular stream: bitwise
    rw = Rrng.particle_bits(Rrng.Stream.THERMALIZE_ANGULAR, seed, 0, rs.tag, n_words=8)
    pw = Prng.particle_bits(Prng.Stream.THERMALIZE_ANGULAR, seed, 0, ps.tag, n_words=8)
    for a, b in zip(pw, rw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    r = ref.core.thermalize_momenta(rs, kT, seed, None if mask is None else jnp.asarray(mask))
    p = port.core.thermalize_momenta(ps, kT, seed, None if mask is None else torch.as_tensor(mask))
    _close(p.angmom.numpy(), r.angmom, "angmom")
    _close(PR.body_angular_momentum(p.orientation, p.angmom).numpy(),
           RR.body_angular_momentum(r.orientation, r.angmom), "L_body", bar=2e-6)
    still = ~np.any(snap.particles.moment_inertia > 0, axis=1)
    if mask is not None:
        still |= ~mask
    assert still.any() and not p.angmom.numpy()[still].any()
    # equipartition: kT per active axis
    L = PR.body_angular_momentum(p.orientation, p.angmom).numpy()
    act = (snap.particles.moment_inertia > 0) & ~still[:, None]
    kT_rot = np.sum(L[act] ** 2 / snap.particles.moment_inertia[act]) / act.sum()
    assert abs(kT_rot - kT) < 0.1 * kT


def _method_on(az, method, state_types):
    integ = types.SimpleNamespace(integrate_rotational_dof=True)
    sim = types.SimpleNamespace(_particle_types=state_types, device="cpu",
                                operations=types.SimpleNamespace(integrator=integ))
    method._attach(sim)
    return method


def test_rotational_langevin_noise_bitwise():
    """With identity orientations, zero angular momenta and no conservative
    torque, the stored effective torque of the second half-step is the
    body-frame noise sqrt(6 gamma_r kT / dt) U(-1, 1) itself."""
    snap = _state_snapshot(ref, identity=True)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    ps = interop.state_from_reference(rs, "cpu")
    out = {}
    for az, st in ((ref, rs), (port, ps)):
        m = az.md.methods.Langevin(kT=1.3, default_gamma=0.5)
        m.gamma_r["P"] = 0.7
        m.gamma_r["Q"] = 2.5
        m = _method_on(az, m, ["P", "Q"])
        out[az] = m._rot_step2_langevin(st, 0.004, 2**24 + 17, 77, 1.3).net_torque
    r, p = np.asarray(out[ref]), out[port].numpy()
    np.testing.assert_array_equal(p.view(np.int32), r.view(np.int32))
    frozen = snap.particles.moment_inertia == 0
    assert frozen.any() and not p[frozen].any() and np.abs(p[~frozen]).min() > 0


# ---------------------------------------------------------------------------
# Simulations: the same snapshot and seed in both packages
# ---------------------------------------------------------------------------
def _patchy_sim(az, kT=0.5, seed=7, n=6, a=1.3, inertia=(0.4, 0.4, 0.4), nve_params=False,
                thermalize=True):
    """n^3 lattice of patchy particles with random orientations, the
    BASELINE config 4 potential (or, with ``nve_params``, the reference's
    conservation-test parameters, whose tail is ~5e-4 M_d at the cutoff)."""
    rng = np.random.default_rng(11)
    N = n**3
    L = n * a
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["P"]
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + (0.0 if nve_params else rng.uniform(-0.05, 0.05, pos.shape))
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.moment_inertia[:] = inertia
    sim = az.Simulation(device="cpu", seed=seed)
    sim.create_state_from_snapshot(snap)
    patchy = az.pair.TwoPatchMorse(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.6,
                                   mode="shift")
    if nve_params:
        patchy.params[("P", "P")] = dict(M_d=0.5, M_r=0.08, r_eq=1.0, omega=4.0, alpha=0.4,
                                         repulsion=True)
    else:
        patchy.params[("P", "P")] = dict(M_d=1.5, M_r=0.05, r_eq=1.0, omega=20.0, alpha=0.4,
                                         repulsion=True)
    if kT is None:
        method = az.md.methods.ConstantVolume()
    else:
        method = az.md.methods.Langevin(kT=kT, default_gamma=1.0)
    sim.operations.integrator = az.md.Integrator(dt=0.002, methods=[method], forces=[patchy],
                                                 integrate_rotational_dof=True)
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    if thermalize and kT is not None:
        sim.state.thermalize_particle_momenta(kT=kT)
    return sim, patchy, thermo


def _arrays(sim):
    s = sim.state.get_snapshot().particles
    return {k: getattr(s, k).copy() for k in ("position", "velocity", "orientation", "angmom",
                                               "image")}


def test_one_patchy_step_matches_reference():
    rsim, rpot, rth = _patchy_sim(ref)
    psim, ppot, pth = _patchy_sim(port)
    rsim.auto_tune_after = None  # these runs stop short of the tune point anyway
    rsim.run(1)
    psim.run(1)
    r, p = _arrays(rsim), _arrays(psim)
    np.testing.assert_array_equal(p["image"], r["image"])
    np.testing.assert_allclose(p["position"], r["position"], rtol=0, atol=2e-6)
    for k in ("velocity", "orientation", "angmom"):
        np.testing.assert_allclose(p[k], r[k], rtol=2e-5, atol=2e-5 * np.abs(r[k]).max(),
                                   err_msg=k)
    for k in ("forces", "torques", "virials", "energies"):
        np.testing.assert_allclose(getattr(ppot, k), getattr(rpot, k), rtol=3e-5,
                                   atol=3e-5 * np.abs(getattr(rpot, k)).max(), err_msg=k)
    assert np.abs(rpot.torques).max() > 0.01  # the torques are real
    for q in ("kinetic_energy", "translational_degrees_of_freedom",
              "rotational_degrees_of_freedom", "rotational_kinetic_energy",
              "kinetic_temperature", "potential_energy"):
        np.testing.assert_allclose(getattr(pth, q), getattr(rth, q), rtol=2e-5, err_msg=q)
    assert pth.rotational_degrees_of_freedom == 3 * psim.state.N_particles


def test_twenty_patchy_steps_match_reference():
    """20 Langevin steps with rebuilds in between: the translational and
    angular noise is bitwise shared, so the trajectories separate only
    through float32 rounding; 1e-4 bounds 20 steps of that."""
    rsim, _, rth = _patchy_sim(ref)
    psim, _, pth = _patchy_sim(port)
    rsim.auto_tune_after = None
    rsim.run(20)
    psim.run(20)
    r, p = _arrays(rsim), _arrays(psim)
    np.testing.assert_array_equal(p["image"], r["image"])
    np.testing.assert_allclose(p["position"], r["position"], rtol=0, atol=1e-4)
    for k in ("velocity", "orientation", "angmom"):
        np.testing.assert_allclose(p[k], r[k], rtol=0, atol=1e-4 * np.abs(r[k]).max(), err_msg=k)
    assert psim.n_builds == int(rsim._meta.n_builds) > 1
    np.testing.assert_allclose(pth.kinetic_temperature, rth.kinetic_temperature, rtol=1e-4)


# ---------------------------------------------------------------------------
# The reference's own rotational checks (tests/test_rotation.py), on the port
# ---------------------------------------------------------------------------
def test_free_rotor_principal_axis():
    """Spin about a principal axis advances the orientation at omega = L/I."""
    I = torch.tensor([[2.0, 2.0, 4.0]])
    L = 0.8
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    p = torch.tensor([[0.0, 0.0, 0.0, 2.0 * L]])  # 2 q (0, L e_z)
    dt, n_steps = 0.01, 200
    for _ in range(n_steps):
        q, p = PR.free_rotation(q, p, I, dt)
    theta = L / 4.0 * dt * n_steps
    np.testing.assert_allclose(q.numpy()[0], [np.cos(theta / 2), 0, 0, np.sin(theta / 2)],
                               atol=1e-4)
    np.testing.assert_allclose(PR.body_angular_momentum(q, p).numpy()[0], [0, 0, L], atol=1e-5)


def test_free_rotor_energy_conservation():
    """Asymmetric-top tumbling conserves rotational KE and |q| = 1."""
    rng = np.random.default_rng(3)
    I = torch.tensor([[1.0, 2.0, 3.5]])
    q0 = rng.normal(size=4)
    q = torch.as_tensor((q0 / np.linalg.norm(q0))[None], dtype=torch.float32)
    p = 2.0 * PR.quat_mul(q, torch.tensor([[0.0, 0.4, -0.7, 0.9]]))
    ke0 = float(PR.rotational_kinetic_energy(q, p, I))
    for _ in range(500):
        q, p = PR.free_rotation(q, p, I, 0.005)
    assert abs(float(PR.rotational_kinetic_energy(q, p, I)) - ke0) < 2e-3 * abs(ke0)
    assert abs(float(torch.sum(q * q)) - 1.0) < 1e-5


def test_zero_inertia_axis_frozen():
    """Torque about a zero-inertia axis is dropped; the z axis integrates."""
    I = torch.tensor([[0.0, 0.0, 2.0]])
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    p = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    p = PR.angmom_kick(q, p, torch.tensor([[3.0, 3.0, 0.5]]), I, 0.01)
    Lb = PR.body_angular_momentum(q, p).numpy()[0]
    np.testing.assert_allclose(Lb[:2], 0.0, atol=1e-6)
    assert Lb[2] > 0.5


def test_nve_patchy_energy_conservation():
    """NVE with rotating patchy particles conserves total energy."""
    sim, patchy, thermo = _patchy_sim(port, kT=None, n=4, a=1.4, inertia=(1.0, 1.0, 1.0),
                                      nve_params=True)
    sim.state.thermalize_particle_momenta(kT=0.2)
    sim.run(10)  # settle transients from the lattice start
    e0 = thermo.kinetic_energy + thermo.rotational_kinetic_energy + patchy.energy
    sim.run(400)
    ke_r1 = thermo.rotational_kinetic_energy
    e1 = thermo.kinetic_energy + ke_r1 + patchy.energy
    N = sim.state.N_particles
    assert ke_r1 > 1e-4  # the torques pumped energy into the spins
    assert abs(e1 - e0) / N < 5e-4
    q1 = sim.state.get_snapshot().particles.orientation
    np.testing.assert_allclose(np.linalg.norm(q1, axis=1), 1.0, atol=1e-4)


def test_langevin_rotation_thermalizes():
    """Rotational KE relaxes toward (3/2) N kT under the Langevin kicks."""
    sim, _, thermo = _patchy_sim(port, kT=0.5, seed=3, n=4, a=1.4, inertia=(1.0, 1.0, 1.0),
                                 nve_params=True, thermalize=False)
    sim.run(600)
    kT_rot = 2.0 * thermo.rotational_kinetic_energy / thermo.rotational_degrees_of_freedom
    assert 0.3 < kT_rot < 0.75  # target 0.5 within statistical slop


def test_langevin_rotation_thermalizes_without_a_torque_force():
    """An isotropic force under rotational Langevin: no force produces a
    torque, so each step's net torque starts from zero and holds only that
    step's Brownian torque, and the spins settle at kT (a torque carried
    over from step to step would random-walk and heat them without bound)."""
    n, a, kT = 5, 1.2, 0.5
    snap = port.Snapshot(N=n**3)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.moment_inertia[:] = [1.0, 1.0, 1.0]
    sim = port.Simulation(device="cpu", seed=9)
    sim.create_state_from_snapshot(snap)
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=kT, default_gamma=1.0)], forces=[lj],
        integrate_rotational_dof=True)
    thermo = port.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.run(600)  # 3 rotational relaxation times (I / gamma_r = 1)
    samples = []
    for _ in range(8):
        sim.run(50)
        samples.append(2.0 * thermo.rotational_kinetic_energy
                       / thermo.rotational_degrees_of_freedom)
    assert thermo.rotational_degrees_of_freedom == 3 * n**3
    assert abs(np.mean(samples) - kT) < 0.15 * kT


def test_rotation_payload_survives_rebin():
    """Angular state, and the stored effective torque, ride the rebin."""
    sim, _, _ = _patchy_sim(port, kT=None, n=4, a=1.4, inertia=(1.0, 1.0, 1.0), nve_params=True)
    sim.state.thermalize_particle_momenta(kT=0.2)
    sim.run(25)  # crosses at least one rebuild (seg_len <= 10)
    assert sim.n_builds > 1 and "rotation" in sim._fields
    snap = sim.state.get_snapshot()
    assert np.all(snap.particles.moment_inertia == [1.0, 1.0, 1.0])
    assert np.abs(snap.particles.angmom).max() > 0
    assert float(sim._dense.net_torque.abs().max()) > 0
