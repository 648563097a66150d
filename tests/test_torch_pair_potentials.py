"""Every isotropic pair potential of the port against the JAX reference.

Each potential of ops/evaluators/pair.py that the CUDA pair kernel serves
goes through the port's plain ``dense_pair_force`` and the reference's
``dense_pair_force`` on the same dense state (the reference's densify,
carried over bitwise) with the same numpy-seeded tables, in modes
none/shift/xplor, at one type (orthorhombic box) and three types (tilted
box, per-pair cutoffs, one pair with r_on >= r_cut where xplor falls back
to a plain shift). The reference runs its XLA path (AZTPU_PALLAS=0) in
every case, and its Pallas kernel in interpret mode (AZTPU_PALLAS=1) for
the polymer melt's ExpandedYukawa at one type (interpret mode costs 5-25 s
a call on the CPU, so not for all 48), each time with ``want="all"``; the
port's force-only path is held against the same forces. Per-slot force,
energy and virial agree within atol = 2e-5 * max|ref| and rtol = 2e-5: the
pair terms are the same float32 formulas and only the order of the
per-slot sums differs.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu.ops.evaluators.pair import PAIR_POTENTIALS as REF_POT  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402
from azplugins_tpu_torch.ops import pair_kernel as PK  # noqa: E402
from azplugins_tpu_torch.ops.evaluators.pair import PAIR_POTENTIALS as PORT_POT  # noqa: E402
from test_torch_kernels import potential_params  # noqa: E402

torch.set_num_threads(1)

BAR = 2e-5
R_CUT = 1.5


def _system(T: int):
    """One type: orthorhombic 6^3 lattice; three types: tilted 7x6x6."""
    rng = np.random.default_rng(20 + T)
    counts, tilt = ((6, 6, 6), (0.0, 0.0, 0.0)) if T == 1 else ((7, 6, 6), (0.2, 0.0, -0.1))
    N = int(np.prod(counts))
    a = (1.0 / 0.85) ** (1.0 / 3.0)
    Ls = [c * a for c in counts]
    snap = ref.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = ["A", "B", "C"][:T]
    f = (np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / np.asarray(counts)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0, Ls[1], tilt[2] * Ls[2]], [0, 0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0, 0.06, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, T, N)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    spec = RD.GridSpec.create(rs.box, N, R_CUT, 0.4)
    rd, meta = RD.densify(rs, spec, fields=())
    assert not bool(meta.overflow) and spec.newton_ok
    rcut = np.full((T, T), R_CUT, np.float32)
    r_on = (0.75 * rcut).astype(np.float32)
    if T > 1:
        rcut[0, -1] = rcut[-1, 0] = R_CUT * 0.8
        r_on[1, 1] = np.float32(1.1 * R_CUT)  # r_on >= r_cut: xplor shifts plainly
    return rd, spec, rcut, r_on, rng


def _close(got, exp, what):
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    np.testing.assert_allclose(got, exp, rtol=BAR, atol=BAR * np.abs(exp).max(), err_msg=what)


CASES = [(name, mode, T, "0") for name in PK.KERNEL_POTENTIALS
         for mode in ("none", "shift", "xplor") for T in (1, 3)]
CASES += [("ExpandedYukawa", mode, 1, "1") for mode in ("none", "shift", "xplor")]


@pytest.mark.parametrize(
    "name,mode,T,pallas", CASES,
    ids=[f"{n}-{m}-T{t}-{'pallas_interpret' if p == '1' else 'xla'}" for n, m, t, p in CASES],
)
def test_potential_matches_reference(monkeypatch, name, mode, T, pallas):
    rd, spec, rcut, r_on, rng = _system(T)
    host = REF_POT[name].precompute(potential_params(name, T, rng))
    tabs = {k: np.asarray(v, np.float32) for k, v in host.items()}
    monkeypatch.setenv("AZTPU_PALLAS", pallas)
    jb = RD.make_jblocks(rd, spec, half=True, need_typeid=True)
    r = RD.dense_pair_force(
        REF_POT[name].energy_force, rd, jb, spec, {k: jnp.asarray(v) for k, v in tabs.items()},
        jnp.asarray(rcut), jnp.asarray(r_on), mode, "all", True,
    )
    pd = interop.state_from_reference(rd, "cpu")
    pspec = interop.grid_spec_from_reference(spec)
    tbl = interop.pair_tables_from_reference({"params": tabs, "r_cut": rcut, "r_on": r_on}, "cpu")
    pjb = PD.make_jblocks(pd, pspec, half=True)
    fn = PORT_POT[name].energy_force
    p = PD.dense_pair_force(fn, pd, pjb, pspec, tbl["params"], tbl["r_cut"], tbl["r_on"], mode,
                            "all")
    assert np.isfinite(np.asarray(r.force)).all()
    assert np.abs(np.asarray(r.force)).max() > 0.1  # a real test: forces are not ~0
    _close(p.force.numpy(), r.force, "force")
    _close(p.energy.numpy(), r.energy, "energy")
    _close(p.virial.numpy(), r.virial, "virial")
    pf = PD.dense_pair_force(fn, pd, pjb, pspec, tbl["params"], tbl["r_cut"], tbl["r_on"], mode,
                             "force")
    _close(pf.force.numpy(), r.force, "force-only path")
