"""The port's substrate against the JAX reference: variants, triggers,
filters, the Brownian methods and ``Operations.add``.

Tolerances: variants are float32 operations in the reference's order,
evaluated on the host, so every value is the reference's bit for bit,
except ``Power``, whose ``frac ** power`` goes through another ``powf``
(held within 1 ulp). Triggers and filters are integer logic: equal.
Brownian noise is a Threefry draw scaled by float32 operations in the same
order: from the origin, a step moves every particle by the reference's
bits. Away from the origin the reference's compiled step fuses
``position + velocity * dt`` into one fused multiply-add (XLA on the CPU
contracts them) where the port rounds twice, so three steps without forces
are held within 1e-6 and one step with pair forces at the bar of
tests/test_torch_simulation.py (positions within 2e-6; the forces are
also summed in another order).
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402

torch.set_num_threads(1)

TIMESTEPS = (0, 1, 199, 200, 10**4, 10**6, 2**24 + 1)


def _variants(az):
    return {
        "constant": az.variant.Constant(2.7),
        "ramp": az.variant.Ramp(A=0.3, B=5.1, t_start=100, t_ramp=9_000),
        "ramp_down": az.variant.Ramp(A=4.0, B=-1.7, t_start=0, t_ramp=333),
        "cycle": az.variant.Cycle(A=0.1, B=2.3, t_start=50, t_A=100, t_AB=300, t_B=77,
                                  t_BA=1_000),
        "power": az.variant.Power(A=1.0, B=7.5, power=1.7, t_start=10, t_ramp=123_457),
        "power_frac": az.variant.Power(A=9.0, B=0.5, power=0.31, t_start=0, t_ramp=2_000_000),
        "sphere_area": az.variant.SphereArea(R0=20.0, alpha=0.05),
        "sphere_area_grow": az.variant.SphereArea(R0=3.3, alpha=-0.7),
    }


@pytest.mark.parametrize("name", sorted(_variants(port)))
def test_variants_are_the_references_float32(name):
    rv, pv = _variants(ref)[name], _variants(port)[name]
    for t in TIMESTEPS:
        want = np.float32(rv(t))
        got = pv(t)
        assert isinstance(got, float)
        assert np.float32(got) == got  # an exact float32 value
        ulps = abs(int(np.float32(got).view(np.int32)) - int(want.view(np.int32)))
        assert ulps <= (1 if name.startswith("power") else 0), (t, got, float(want))
    assert tuple(map(float, pv.range())) == tuple(map(float, rv.range()))


class _Custom(port.variant.Variant):
    """A variant of its own: ``values`` is the base class's loop."""

    def __call__(self, timestep):
        return float(np.float32(0.5) + np.float32(timestep % 7) * np.float32(0.25))


STRETCHES = ((0, 1000), (199, 3), (2**24 - 5, 11), (2**31 - 2, 5), (2**32 + 3, 9))


@pytest.mark.parametrize("name", sorted(_variants(port)) + ["custom"])
def test_variant_values_are_the_calls_bitwise(name):
    """``values(t0, n)``, the float32 a stretch of steps reads on the device,
    holds exactly the bits ``__call__`` gives at each of its timesteps."""
    v = _Custom() if name == "custom" else _variants(port)[name]
    for t0, n in STRETCHES:
        got = v.values(t0, n)
        want = np.array([v(t) for t in range(t0, t0 + n)], dtype=np.float32)
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=str(t0))


def test_value_at_reads_the_schedule():
    """Inside ``scheduled`` a variant's value at a step is the rows' 0-d
    float32 (a view, the same bits); a Constant, and every variant outside,
    is its host float, as is a by-value argument (``host_form``) on the
    eager loop, but not inside a graph; an unscheduled variant or a step
    outside the rows raises."""
    V = port.variant
    ramp, area, const = V.Ramp(1.0, 2.0, 0, 10), V.SphereArea(5.0, 0.05), V.Constant(1.5)
    rows = torch.from_numpy(np.stack([ramp.values(40, 6), area.values(40, 6)]))
    with V.scheduled((ramp, area), rows, 40):
        for k, v in enumerate((ramp, area)):
            for t in range(40, 46):
                got = V.value_at(v, t, torch.device("cpu"))
                assert got.dim() == 0 and got.dtype == torch.float32
                assert got.data_ptr() == rows[k, t - 40].data_ptr()
                assert np.float32(v(t)).view(np.int32) == got.numpy().view(np.int32)
        assert V.value_at(const, 41) == 1.5
        assert isinstance(V.value_at(ramp, 41, host_form=True), torch.Tensor)  # a graph's
        with pytest.raises(ValueError):
            V.value_at(ramp, 46)
        with pytest.raises(ValueError):
            V.value_at(V.Ramp(1.0, 2.0, 0, 10), 41)
    assert V.value_at(ramp, 41) == ramp(41)
    with V.scheduled((ramp, area), rows, 40, host_form=True):  # the eager loop's
        got = V.value_at(area, 43, host_form=True)
        assert isinstance(got, float) and got == area(43)
        assert isinstance(V.value_at(area, 43), torch.Tensor)
    with pytest.raises(ValueError):
        with V.scheduled((ramp,), rows, 40):  # two rows for one variant
            pass


class _Every3(port.trigger.Trigger):
    """A trigger of its own: ``mask`` is the base class's loop."""

    def __call__(self, timestep):
        return timestep % 3 == 1


def test_trigger_masks_are_the_calls():
    """``mask(t0, n)``, the triggers a chunk carries to the card, is
    ``__call__`` at each timestep."""
    for trig in (*_triggers(port), _Every3(), port.trigger.Periodic(5, phase=-2)):
        for t0, n in ((0, 500), (-7, 20), (2**32 - 4, 9)):
            got = trig.mask(t0, n)
            assert got.dtype == bool and got.shape == (n,)
            np.testing.assert_array_equal(got, [bool(trig(t)) for t in range(t0, t0 + n)],
                                          err_msg=type(trig).__name__)


def test_as_variant():
    assert port.variant.as_variant(3).range() == (3.0, 3.0)
    v = port.variant.SphereArea(R0=2.0, alpha=1.0)
    assert port.variant.as_variant(v) is v
    with pytest.raises(TypeError):
        port.variant.as_variant("x")
    with pytest.raises(ValueError):
        port.variant.SphereArea(R0=-1.0, alpha=1.0)


def _triggers(az):
    T = az.trigger
    return [T.Periodic(25), T.Periodic(7, phase=3), T.Periodic(1), T.After(120), T.Before(42),
            T.On(0), T.On(317), T.as_trigger(13)]


def test_triggers_equal_the_reference():
    t = np.arange(500)
    for rt, pt in zip(_triggers(ref), _triggers(port)):
        want = np.asarray(rt(jnp.asarray(t, jnp.int32)))
        got = np.array([pt(int(i)) for i in t])
        np.testing.assert_array_equal(got, want, err_msg=type(pt).__name__)
    with pytest.raises(ValueError):
        port.trigger.Periodic(0)
    with pytest.raises(TypeError):
        port.trigger.as_trigger(2.5)


TYPES = ["A", "B", "C"]


def _filters(az):
    F = az.filter
    return [
        F.All(), F.Null(), F.Type("B"), F.Type(["C", "A"]), F.Tags([0, 5, 17, 39]),
        F.Intersection(F.Type(["A", "B"]), F.Tags(range(0, 40, 3))),
        F.Union(F.Type("C"), F.Tags([1, 2])),
    ]


def _dense_like(seed=4, N=40, S=64):
    """Tags and typeids of a slot layout: N particles in S slots, shuffled,
    the empty slots with tag and typeid -1."""
    rng = np.random.default_rng(seed)
    typeid = rng.integers(0, 3, N).astype(np.int32)
    slots = rng.permutation(S)[:N]
    tag = np.full(S, -1, np.int32)
    tid = np.full(S, -1, np.int32)
    tag[slots] = np.arange(N)
    tid[slots] = typeid
    return typeid, tag, tid


def test_filters_mask_and_select_like_the_reference():
    typeid, tag, tid = _dense_like()
    rstate = types.SimpleNamespace(tag=jnp.asarray(tag), typeid=jnp.asarray(tid))
    pstate = types.SimpleNamespace(tag=torch.as_tensor(tag), typeid=torch.as_tensor(tid))
    for rf, pf in zip(_filters(ref), _filters(port)):
        np.testing.assert_array_equal(pf.mask(typeid, TYPES), rf.mask(typeid, TYPES),
                                      err_msg=repr(pf))
        want = np.asarray(rf.bind(TYPES)(rstate))
        got = pf.bind(TYPES)(pstate).numpy()
        np.testing.assert_array_equal(got, want, err_msg=repr(pf))
        assert repr(pf) == repr(rf)
    F = port.filter
    assert F.Type(["B", "A"]) == F.Type(["A", "B"])
    assert len({F.Type("A"), F.Type(["A"]), F.Null(), F.Null()}) == 2
    with pytest.raises(ValueError):
        F.Type("Z").mask(typeid, TYPES)
    with pytest.raises(ValueError):
        F.Type("Z").bind(TYPES)


def _brownian_sim(az, method, n=6, a=1.3, with_pair=False, seed=5):
    rng = np.random.default_rng(seed)
    N = n**3
    L = n * a
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A", "B"]
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-0.1, 0.1, pos.shape)
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=31, **kw)
    sim.create_state_from_snapshot(snap)
    if method == "brownian":
        m = az.md.methods.Brownian(kT=1.3, default_gamma=2.0)
    elif method == "brownian_constant_flow":
        m = az.md.methods.BrownianFlow(kT=0.7, flow_field=az.flow.ConstantFlow((0.4, -0.2, 0.1)))
    else:
        m = az.md.methods.BrownianFlow(kT=1.1, flow_field=az.flow.ParabolicFlow(0.5, L - 1.0),
                                       filter=az.filter.Type("B"))
    m.gamma["B"] = 0.7
    forces = []
    if with_pair:
        lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4),
                                           default_r_cut=2.5, mode="shift")
        lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
        lj.params[("A", "B")] = dict(epsilon=0.8, sigma=1.0, attraction_scale_factor=1.0)
        lj.params[("B", "B")] = dict(epsilon=1.2, sigma=0.9, attraction_scale_factor=0.0)
        forces.append(lj)
    sim.operations.integrator = az.md.Integrator(dt=0.002, methods=[m], forces=forces)
    if az is ref:
        sim.auto_tune_after = None
    return sim


METHODS = ["brownian", "brownian_constant_flow", "brownian_parabolic_flow"]


@pytest.mark.parametrize("method", METHODS)
def test_brownian_noise_is_bitwise(method):
    """step1 from the origin without forces: the displacement is the noise
    (and the flow) times dt, the reference's bits at every timestep."""
    rsim, psim = _brownian_sim(ref, method), _brownian_sim(port, method)
    rsim.run(0)
    psim.run(0)
    rm = rsim.operations.integrator.methods[0]
    pm = psim.operations.integrator.methods[0]
    rstate = rsim._dense.replace(position=jnp.zeros_like(rsim._dense.position))
    pstate = psim._dense.replace(position=torch.zeros_like(psim._dense.position))
    for t in (0, 7, 10**6):
        want = np.asarray(rm.step1(rstate, 0.002, t, rsim.seed).position)
        got = pm.step1(pstate, 0.002, t, psim.seed).position.numpy()
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() > 0


@pytest.mark.parametrize("method", METHODS)
def test_brownian_steps_without_forces_match_reference(method):
    rsim, psim = _brownian_sim(ref, method), _brownian_sim(port, method)
    rsim.run(3)
    psim.run(3)
    r, p = rsim.state.get_snapshot().particles, psim.state.get_snapshot().particles
    np.testing.assert_array_equal(p.image, r.image)
    np.testing.assert_allclose(p.position, r.position, rtol=0, atol=1e-6)


def test_brownian_step_with_forces_matches_reference():
    rsim = _brownian_sim(ref, "brownian", with_pair=True)
    psim = _brownian_sim(port, "brownian", with_pair=True)
    rsim.run(1)
    psim.run(1)
    r, p = rsim.state.get_snapshot().particles, psim.state.get_snapshot().particles
    np.testing.assert_array_equal(p.image, r.image)
    np.testing.assert_allclose(p.position, r.position, rtol=0, atol=2e-6)


def test_operations_add_routes_like_the_reference():
    ops = port.Operations()
    lj = port.pair.LJ(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    with pytest.raises(RuntimeError):
        ops.add(lj)
    ops.integrator = port.md.Integrator(dt=0.01)
    ops += lj
    barrier = port.external.PlanarHarmonicBarrier(location=1.0)
    ops.add(barrier)
    assert ops.integrator.forces == [lj, barrier]
    up = port.update.TypeUpdater(trigger=5, inside_type="A", outside_type="B", lo=0.0, hi=1.0)
    ops += up
    assert ops.updaters == [up] and isinstance(up.trigger, port.trigger.Periodic)
    thermo = port.compute.ThermodynamicQuantities()
    ops.add(thermo)
    assert ops.computes == [thermo]

    logger = port.write.Logger()
    table = port.write.Table(trigger=5, logger=logger)
    ops.add(table)
    table2 = port.write.Table(trigger=7, logger=logger)
    ops += table2
    assert ops.writers == [table, table2] and isinstance(table2.trigger, port.trigger.Periodic)
    with pytest.raises(TypeError):
        ops.add(object())


def test_state_view_types_and_set_snapshot():
    psim = _brownian_sim(port, "brownian")
    assert psim.state.particle_types == ["A", "B"]
    assert psim.state.bond_types == []
    psim.run(2)
    snap = psim.state.get_snapshot()
    snap.particles.position[:] *= 0.5
    psim.state.set_snapshot(snap)
    np.testing.assert_array_equal(psim.state.get_snapshot().particles.position,
                                  snap.particles.position)
    psim.run(1)
    assert psim.timestep == 3
