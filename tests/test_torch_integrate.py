"""The integrator and the Verlet drift check: dispatch by device, and the
plain versions against the JAX package.

On CUDA tensors ``Method.step1`` / ``step2`` launch K7-K9 and
``ops/dense.py``'s drift check K6 (``ops/integrate_kernel.py``), and
``step1`` with a drift check K7 and K6 in one launch; on CPU tensors they
run their plain versions (with a drift check, the plain step1 then the
plain check), which launch nothing; a ``meta`` tensor raises. The plain
versions are held here to the reference on the same numpy inputs
(``torch_integrate_cases.py``: a slot layout with empty slots, two types
and frozen axes): the drift check's verdict exactly (a NaN drift, ties at
the maximum, every slot empty, the violation flag ORed in), one step1 +
step2 of every method case with rotation at the bars of
``test_torch_simulation.py``'s one-step test (positions within 2e-6;
velocities, accelerations and the rotational fields within 2e-5 of their
largest value: XLA may fuse a product into a multiply-add), and step1
with the drift check against the reference's step1 then ``needs_rebin``
(positions and velocities bit for bit, the verdict exactly; whole and on
two shards). BrownianFlow alike: on CPU tensors its step1 (alone and
with the drift check) and step2 are their plain versions and launch
nothing, its kernels' wrappers (K11, K8's acceleration-only instance)
refuse CPU tensors, one step1 + step2 of every Brownian case is within
the one-step bars of the reference's, and the plain noiseless step keeps
the sign of a zero as the kernels must (a 0 coefficient times a uniform
below 0 is -0; a step without a flow adds a zeros_like flow, which makes
it +0). The kernels are held to these plain versions on the card bitwise
(``test_torch_kernels.py``).
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_integrate_cases as IC  # noqa: E402
import torch_integrate_reference as IREF  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.ops import integrate_kernel as IK  # noqa: E402
from azplugins_tpu_torch.utils import sqrt  # noqa: E402

torch.set_num_threads(1)

N = 1001
FIELDS = ("position", "velocity", "acceleration", "orientation", "angmom", "net_torque")


def _port_state(arrays, device="cpu"):
    return IC.state_of(port, arrays, lambda a: torch.as_tensor(a).to(device))


def _ref_state(arrays):
    return IC.state_of(ref, arrays, jnp.asarray)


# -- dispatch -----------------------------------------------------------------
@pytest.mark.parametrize("rotational", [False, True])
@pytest.mark.parametrize("case", IC.CASES)
def test_cpu_steps_take_the_plain_versions(case, rotational):
    state = _port_state(IC.slot_arrays(N, 1))
    m = IC.attached(IC.methods(port, case), rotational)
    before = (IK.launches, dict(IK.launches_by_kernel))
    a = IC.slot_arrays(N, 1)
    meta = types.SimpleNamespace(ref_position=torch.as_tensor(a["ref_position"]))
    spec = types.SimpleNamespace(buffer=0.4)
    for step in ("step1", "step2", "step1 with the drift check"):
        if step == "step1 with the drift check":
            got, verdict = m.step1(state, 0.005, 77, 9,
                                   port.md.methods.DriftCheck(meta, spec, torch.tensor(False)))
            want = m._step1_plain(state, 0.005, 77, 9)
            assert torch.equal(verdict, PD._needs_rebin_plain(want, meta, spec))
        else:
            got = getattr(m, step)(state, 0.005, 77, 9)
            want = getattr(m, f"_{step}_plain")(state, 0.005, 77, 9)
        for k in FIELDS:
            assert torch.equal(getattr(got, k).view(torch.int32),
                               getattr(want, k).view(torch.int32)), (step, k)
    assert (IK.launches, IK.launches_by_kernel) == before


def test_cpu_drift_check_takes_the_plain_version():
    a = IC.slot_arrays(N, 2)
    dense, meta = _drift_layout(a)
    before = IK.launches
    spec = types.SimpleNamespace(buffer=0.1)
    got = PD.needs_rebin(dense, meta, spec, torch.tensor(False))
    assert bool(got) == bool(PD._needs_rebin_plain(dense, meta, spec))
    tops = PD.drift_top_two(dense, meta)
    assert torch.equal(tops, PD._drift_top_two_plain(dense, meta))
    assert bool(PD.needs_rebin_of(tops, spec, torch.tensor(False))) == bool(got)
    assert IK.launches == before


def test_meta_tensors_raise():
    a = IC.slot_arrays(64, 3)
    state = _port_state(a, "meta")
    for case in ("nve", "langevin"):
        m = IC.attached(IC.methods(port, case), True)
        for step in (m.step1, m.step2):
            with pytest.raises(ValueError, match="meta"):
                step(state, 0.005, 1, 1)
    dense, meta = _drift_layout(a, "meta")
    spec = types.SimpleNamespace(buffer=0.1)
    with pytest.raises(ValueError, match="meta"):
        PD.needs_rebin(dense, meta, spec, torch.tensor(False))
    with pytest.raises(ValueError, match="meta"):
        m.step1(state, 0.005, 1, 1, port.md.methods.DriftCheck(meta, spec, None))
    with pytest.raises(ValueError, match="meta"):
        PD.drift_top_two(dense, meta)
    with pytest.raises(ValueError, match="CUDA"):
        IK.step1(state.tag, None, state.position, state.velocity, state.acceleration, 0.005)
    cpu = _port_state(a)
    with pytest.raises(ValueError, match="CUDA"):
        IK.step1_drift(cpu.tag, None, cpu.position, cpu.velocity, cpu.acceleration, 0.005,
                       cpu.position, 0.4, torch.tensor(False))


# -- the drift check against the reference ------------------------------------
def _drift_layout(a, device="cpu"):
    pos, refp, tag = (torch.as_tensor(a[k]).to(device) for k in
                      ("position", "ref_position", "tag"))
    return (types.SimpleNamespace(position=pos, tag=tag, device=pos.device),
            types.SimpleNamespace(ref_position=refp))


@pytest.mark.parametrize("viol", [False, True])
@pytest.mark.parametrize("buffer", [0.05, 0.5, 0.7])
@pytest.mark.parametrize("kind", IC.DRIFT_KINDS)
def test_plain_drift_check_matches_reference(kind, buffer, viol):
    a = IC.drift_arrays(kind, N, 5)
    dense, meta = _drift_layout(a)
    rdense = types.SimpleNamespace(position=jnp.asarray(a["position"]),
                                   tag=jnp.asarray(a["tag"]))
    rmeta = types.SimpleNamespace(ref_position=jnp.asarray(a["ref_position"]))
    spec = types.SimpleNamespace(buffer=buffer)
    want = bool(RD.needs_rebin(rdense, rmeta, spec))
    got = PD.needs_rebin(dense, meta, spec, torch.tensor(viol))
    assert got.dtype == torch.bool and bool(got) == (viol or want)
    if kind == "nan":
        assert not want
    if kind == "tie":  # sqrt(m1) + sqrt(m2) = 2 |(0.3, 0.1, 0)| ~ 0.632
        assert want == (buffer < 0.63)
    if kind == "single":  # the second drift is 0
        assert want == (buffer < 0.31)
    # the shards' route: each quarter's top two, then the combine
    tops = []
    for c in np.array_split(np.arange(N), 4):
        c = torch.as_tensor(c)
        tops.append(PD.drift_top_two(
            types.SimpleNamespace(position=dense.position[c], tag=dense.tag[c],
                                  device=dense.device),
            types.SimpleNamespace(ref_position=meta.ref_position[c])))
    assert bool(PD.needs_rebin_of(torch.cat(tops), spec, torch.tensor(viol))) == (viol or want)


def test_plain_top_two_counts_ties_and_empty_slots():
    v = torch.tensor([0.0, 3.0, 1.0, 3.0])
    assert PD._top_two(v)[1].item() == 3.0
    v = torch.tensor([0.0, 3.0, 1.0, 2.0])
    assert PD._top_two(v)[1].item() == 2.0
    m1, m2 = PD._top_two(torch.zeros(5))
    assert m1.item() == 0.0 and m2.item() == 0.0


# -- one step against the reference ------------------------------------------
@pytest.mark.parametrize("rotational", [False, True])
@pytest.mark.parametrize("case", IC.CASES)
def test_plain_step_matches_reference(case, rotational):
    """step1, then step2 (fresh forces and torques between them), from the
    same numpy inputs in both packages; masked slots keep their bits."""
    out = {}
    for az, state_of, host in ((ref, _ref_state, np.asarray),
                               (port, _port_state, lambda t: t.numpy())):
        s = IREF.one_step(az, case, rotational, state_of)
        out[az] = {k: host(getattr(s, k)) for k in FIELDS}
    for k in FIELDS:
        IREF.assert_close(out[port][k], out[ref][k], k, f"{case} {k}")
    a = IC.slot_arrays(IREF.N, IREF.STATE_SEED)
    acts = a["tag"] >= 0
    if case == "type_b":
        acts &= a["typeid"] == 1
    for k in ("position", "velocity", "orientation"):
        assert np.array_equal(out[port][k][~acts].view(np.int32), a[k][~acts].view(np.int32)), k
    if not rotational:
        for k in ("orientation", "angmom"):
            assert np.array_equal(out[port][k].view(np.int32), a[k].view(np.int32)), k


# -- step1 with the drift check against the reference ------------------------
def _met_buffers(position, ref_position, tag) -> list:
    """0.4, the buffer the two largest drifts of ``position`` just meet as
    the plain check forms sqrt(m1) + sqrt(m2) (its verdict false), and the
    float32 below it (true)."""
    d = types.SimpleNamespace(position=position, tag=tag)
    m1, m2 = PD._top_two(PD._drift_sq(d, types.SimpleNamespace(ref_position=ref_position)))
    met = np.float32((sqrt(m1) + sqrt(torch.clamp_min(m2, 0.0))).item())
    return [0.4, float(met), float(np.nextafter(met, np.float32(0)))]


def _ref_verdict(rstate, ref_position, buffer) -> bool:
    meta = types.SimpleNamespace(ref_position=jnp.asarray(ref_position))
    return bool(RD.needs_rebin(rstate, meta, types.SimpleNamespace(buffer=buffer)))


@pytest.mark.parametrize("rotational", [False, True])
@pytest.mark.parametrize("case", IC.CASES)
def test_step1_with_drift_check_matches_reference(case, rotational):
    """``Method.step1`` with a drift check on the CPU (the plain step1,
    then the plain check) against the reference's ``m.step1`` then
    ``needs_rebin`` on the same numpy inputs: positions and velocities bit
    for bit, the verdict equal at buffer 0.4, at the buffer the drift just
    meets and at the float32 below it, with the flag clear and set; the
    rotational fields are the port's step1 without the check, bit for
    bit."""
    a = IC.slot_arrays(N, 13)
    rm = IC.attached(IC.methods(ref, case), rotational)
    rs = rm.step1(_ref_state(a), IREF.DT, IREF.TIMESTEP, IREF.SEED)
    m = IC.attached(IC.methods(port, case), rotational)
    state = _port_state(a)
    meta = types.SimpleNamespace(ref_position=torch.as_tensor(a["ref_position"]))
    alone = m.step1(state, IREF.DT, IREF.TIMESTEP, IREF.SEED)
    buffers = _met_buffers(alone.position, meta.ref_position, alone.tag)
    wants = [_ref_verdict(rs, a["ref_position"], b) for b in buffers]
    assert wants[1:] == [False, True]  # the drift just meets, then exceeds
    for buffer, want in zip(buffers, wants):
        spec = types.SimpleNamespace(buffer=buffer)
        for viol in (False, True):
            got, verdict = m.step1(state, IREF.DT, IREF.TIMESTEP, IREF.SEED,
                                   port.md.methods.DriftCheck(meta, spec, torch.tensor(viol)))
            assert verdict.dtype == torch.bool and bool(verdict) == (viol or want), (buffer, viol)
            for k in ("position", "velocity"):
                assert np.array_equal(getattr(got, k).numpy().view(np.int32),
                                      np.asarray(getattr(rs, k)).view(np.int32)), k
            for k in FIELDS:
                assert torch.equal(getattr(got, k).view(torch.int32),
                                   getattr(alone, k).view(torch.int32)), k


def test_step1_drift_top_two_on_two_shards_matches_reference():
    """On a two-shard layout (``make_mesh(2, device="cpu", sharded=True)``)
    each shard's step1 with the top-two drift check, combined by
    ``needs_rebin_of``, against the reference's ``m.step1`` then
    ``needs_rebin`` on the shards' slots joined: positions and velocities
    bit for bit, the verdict equal at 0.4, the met buffer and below it."""
    snap = port.Snapshot(N=216)
    snap.configuration.box = [7.2, 7.2, 7.2, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(6) + 0.5) * 1.2 - 3.6
    g = np.random.default_rng(21)
    snap.particles.position[:] = (np.stack(np.meshgrid(x, x, x, indexing="ij"), -1)
                                  .reshape(-1, 3) + g.uniform(-0.05, 0.05, (216, 3)))
    sim = port.Simulation(device="cpu", seed=3)
    sim.create_state_from_snapshot(snap)
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=1.2)], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.2)
    sim.enable_spatial_decomposition(port.parallel.make_mesh(2, device="cpu", sharded=True))
    sim.run(12)
    shards, metas = sim._dense, sim._meta
    assert isinstance(shards, tuple) and len(shards) == 2
    m = sim.operations.integrator.methods[-1]
    dt, t, seed = sim.dt_ref(), sim.timestep, sim.seed
    joined = {k: np.concatenate([getattr(s, k).numpy() for s in shards])
              for k in ("position", "tag", "typeid", "velocity", "acceleration", "net_force",
                        "mass", "orientation", "angmom", "moment_inertia", "net_torque", "image",
                        "diameter", "charge")}
    joined.update(bond_typeid=np.zeros(0, np.int32), bond_group=np.zeros((0, 2), np.int32))
    refp = np.concatenate([mt.ref_position.numpy() for mt in metas])
    rm = IC.attached(ref.md.methods.Langevin(kT=1.2), False)
    rs = rm.step1(IC.state_of(ref, joined, jnp.asarray), dt, t, seed)
    alone = [m.step1(s, dt, t, seed) for s in shards]
    buffers = _met_buffers(torch.cat([s.position for s in alone]), torch.as_tensor(refp),
                           torch.cat([s.tag for s in alone]))
    wants = [_ref_verdict(rs, refp, b) for b in buffers]
    assert wants[1:] == [False, True]
    for buffer, want in zip(buffers, wants):
        spec = sim._grid_spec.replace(buffer=buffer)
        stepped = [m.step1(s, dt, t, seed, port.md.methods.DriftCheck(mt, spec, None))
                   for s, mt in zip(shards, metas)]
        tops = torch.cat([top for _, top in stepped])
        assert tops.shape == (4,)
        for viol in (False, True):
            verdict = PD.needs_rebin_of(tops, spec, torch.tensor(viol))
            assert bool(verdict) == (viol or want), (buffer, viol)
        for k in ("position", "velocity"):
            got = torch.cat([getattr(s, k) for s, _ in stepped]).numpy()
            assert np.array_equal(got.view(np.int32), np.asarray(getattr(rs, k)).view(np.int32)), k


# the per-type gamma of 300 types, each its own (K8 stages a table of more
# types than its block has threads in rounds)
MANY_TYPES = [f"T{k}" for k in range(300)]


@pytest.mark.parametrize("case", ["langevin", "noiseless", "flow"])
def test_plain_step2_with_many_types_matches_reference(case):
    """step2 of a Langevin method over 300 types, each with its own gamma,
    from the same numpy inputs in both packages, at the one-step bars."""
    a = IC.slot_arrays(N, 8)
    g = np.random.default_rng(9)
    a["typeid"] = np.where(a["tag"] >= 0, g.integers(0, len(MANY_TYPES), N), -1).astype(np.int32)
    gammas = g.uniform(0.1, 3.0, len(MANY_TYPES))
    out = {}
    for az, state_of, host in ((ref, _ref_state, np.asarray),
                               (port, _port_state, lambda t: t.numpy())):
        if case == "flow":
            m = az.md.methods.LangevinFlow(kT=1.3, flow_field=az.flow.ParabolicFlow(2.0, IC.L / 2))
        else:
            m = az.md.methods.Langevin(kT=1.3, noiseless=case == "noiseless")
        for name, gamma in zip(MANY_TYPES, gammas):
            m.gamma[name] = float(gamma)
        m = IC.attached(m, False, particle_types=MANY_TYPES)
        s = m.step2(state_of(a), IREF.DT, IREF.TIMESTEP, IREF.SEED)
        out[az] = {k: host(getattr(s, k)) for k in ("velocity", "acceleration")}
    for k in ("velocity", "acceleration"):
        IREF.assert_close(out[port][k], out[ref][k], k, f"{case} {k}")


def test_integrate_reference_file_is_what_the_reference_computes():
    """tests/torch_integrate_reference.npz, which holds the port's
    integrator kernels to the reference on a GPU machine without JAX
    (tests/test_torch_kernels.py), is what the JAX package computes now,
    bit for bit."""
    kept, computed = IREF.load(), IREF.compute_reference()
    assert sorted(kept) == sorted(computed)
    for k in kept:
        assert kept[k].dtype == computed[k].dtype and kept[k].shape == computed[k].shape, k
        np.testing.assert_array_equal(kept[k], computed[k], err_msg=k)


@pytest.mark.parametrize("case", IC.CASES)
def test_methods_never_write_the_state_they_were_given(case):
    state = _port_state(IC.slot_arrays(N, 4))
    kept = {k: getattr(state, k).clone() for k in FIELDS}
    m = IC.attached(IC.methods(port, case), True)
    s1 = m.step1(state, 0.005, 5, 1)
    s2 = m.step2(s1, 0.005, 5, 1)
    for k, v in kept.items():
        assert torch.equal(getattr(state, k), v), k
    assert s1.position.data_ptr() != state.position.data_ptr()
    assert s2.velocity.data_ptr() != s1.velocity.data_ptr()


def test_simulation_counts_the_steps_its_loop_runs():
    """``Simulation.steps_run`` counts the loop's steps (what K7 and K8
    launch once a method a step on the card), not the force evaluations
    (the run's preparation evaluates the forces once more)."""
    snap = port.Snapshot(N=64)
    snap.configuration.box = [6.0, 6.0, 6.0, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(4) + 0.5) * 1.5 - 3.0
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim = port.Simulation(device="cpu", seed=3)
    sim.create_state_from_snapshot(snap)
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.005, methods=[port.md.methods.Langevin(kT=1.0)], forces=[lj])
    sim.run(7)
    sim.run(5)
    assert sim.viol_replays == 0 and sim.steps_run == 12
    assert sim.force_evaluations == 13


# -- BrownianFlow: K11 and K8's acceleration-only instance on the card ---------
# On CPU tensors BrownianFlow's step1 (alone and with the drift check) and
# step2 run their plain versions, which the kernels are held to bitwise on
# the card (test_torch_kernels.py), and which are held here to the reference.
@pytest.mark.parametrize("case", IC.BROWNIAN_CASES)
def test_cpu_brownian_steps_take_the_plain_versions(case):
    a = IC.slot_arrays(N, 21)
    state = _port_state(a)
    m = IC.attached(IC.brownian_methods(port, case), False)
    meta = types.SimpleNamespace(ref_position=torch.as_tensor(a["ref_position"]))
    spec = types.SimpleNamespace(buffer=0.4)
    before = (IK.launches, dict(IK.launches_by_kernel))
    want = m._step1_brownian(state, 0.005, 77, 9)
    got = m.step1(state, 0.005, 77, 9)
    assert torch.equal(got.position.view(torch.int32), want.position.view(torch.int32))
    for viol in (None, False, True):
        check = port.md.methods.DriftCheck(meta, spec, None if viol is None else
                                           torch.tensor(viol))
        got, found = m.step1(state, 0.005, 77, 9, check)
        assert torch.equal(got.position.view(torch.int32), want.position.view(torch.int32))
        assert torch.equal(found, check.of(want))
    got = m.step2(want, 0.005, 77, 9)
    assert torch.equal(got.acceleration, m._step2_plain(want, 0.005, 77, 9).acceleration)
    assert got.velocity is want.velocity
    assert (IK.launches, IK.launches_by_kernel) == before


def test_brownian_wrappers_refuse_cpu_tensors():
    """K11 (alone and with the drift check) and K8's acceleration-only
    instance take CUDA tensors only: a CPU tensor raises, never falls back."""
    s = _port_state(IC.slot_arrays(64, 3))
    noise = IK.Noise(torch.ones(2), port.core.rng.Stream.BROWNIAN, 1, 0, 1.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        IK.brownian_step(s.tag, None, s.typeid, s.position, s.net_force, 0.005, noise)
    with pytest.raises(ValueError, match="CUDA"):
        IK.brownian_step_drift(s.tag, None, s.typeid, s.position, s.net_force, 0.005, noise,
                               None, s.position, 0.4, torch.tensor(False))
    with pytest.raises(ValueError, match="CUDA"):
        IK.step2_accel(s.tag, None, s.acceleration, s.net_force, s.mass)


@pytest.mark.parametrize("case", IC.BROWNIAN_CASES)
def test_plain_brownian_step_matches_reference(case):
    """BrownianFlow's step1, fresh forces, then step2, from the same numpy
    inputs in both packages, at the one-step bars; slots the method does not
    move keep their bits, and the velocities are never written."""
    a = IC.slot_arrays(N, 17)
    force = np.random.default_rng(IREF.FORCE_SEED).normal(0, 3, (N, 3)).astype(np.float32)
    out = {}
    for az, asarray, host in ((ref, jnp.asarray, np.asarray),
                              (port, torch.as_tensor, lambda t: t.numpy())):
        m = IC.attached(IC.brownian_methods(az, case), False)
        s = m.step1(IC.state_of(az, a, asarray), IREF.DT, IREF.TIMESTEP, IREF.SEED)
        s = m.step2(s.replace(net_force=asarray(force)), IREF.DT, IREF.TIMESTEP, IREF.SEED)
        out[az] = {k: host(getattr(s, k)) for k in ("position", "velocity", "acceleration")}
    for k in ("position", "acceleration"):
        IREF.assert_close(out[port][k], out[ref][k], k, f"{case} {k}")
    acts = a["tag"] >= 0
    if case == "type_b":
        acts &= a["typeid"] == 1
    for k in ("position", "acceleration"):
        assert np.array_equal(out[port][k][~acts].view(np.int32), a[k][~acts].view(np.int32)), k
    assert np.array_equal(out[port]["velocity"].view(np.int32), a["velocity"].view(np.int32))


@pytest.mark.parametrize("flow", [False, True], ids=["no_flow", "flow_of_minus_zero"])
def test_plain_noiseless_brownian_step_keeps_the_sign_of_zero(flow):
    """The plain noiseless step still multiplies its 0 coefficient by the
    uniforms, so the random force is -0 where a uniform is below 0: a slot
    at -0 under a force of -0 in a flow of -0 stays at -0 exactly there
    (+0 elsewhere); without a flow the zeros_like flow it adds makes every
    such slot +0. K11 is held to these bits on the card."""
    a = IC.signed_zeros(IC.slot_arrays(N, 23))
    state = _port_state(a)
    if flow:
        m = port.md.methods.BrownianFlow(kT=1.3, flow_field=port.flow.ConstantFlow((-0.0,) * 3),
                                         noiseless=True)
    else:
        m = port.md.methods.Brownian(kT=1.3, noiseless=True)
    m = IC.attached(m, False)
    x = m.step1(state, 0.005, 77, 9).position[::3]
    live = state.tag[::3] >= 0
    u = port.core.rng.particle_uniform3(m._rng_stream, 9, 77, state.tag[::3])
    assert bool((x[live] == 0).all()) and bool((u[live] < 0).any())
    if flow:
        assert torch.equal(torch.signbit(x[live]), u[live] < 0)
    else:
        assert not bool(torch.signbit(x[live]).any())
