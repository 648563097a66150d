"""The port's plain pair force against the JAX reference's dense_pair_force.

The same dense state (the reference's densify, carried over bitwise) and
the same per-type tables go to both. The reference runs its XLA path
(AZTPU_PALLAS=0) and its Pallas kernel in interpret mode (AZTPU_PALLAS=1,
as tests/test_pallas_pair.py runs it). Per-slot force, energy and virial
must agree within atol = 2e-5 * max|ref| and rtol = 2e-5: both sides form
the same float32 pair terms, and only the order of the per-slot sums
differs.

The CUDA kernel is held against this plain version in
tests/test_torch_kernels.py (which needs no JAX), and against the
reference here, in the test marked ``cuda``, where JAX and a GPU meet.
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
from azplugins_tpu_torch.ops.evaluators.pair import PAIR_POTENTIALS as PORT_POT  # noqa: E402

torch.set_num_threads(1)

BAR = 2e-5

# name: (lattice counts, number density, tilt, types, r_cut)
SYSTEMS = {
    "half_T1": ((7, 7, 7), 0.85, (0.0, 0.0, 0.0), 1, 2.0),
    "half_tilted_T2": ((8, 7, 7), 0.8, (0.3, -0.2, 0.15), 2, 1.5),
    "half_T3": ((7, 7, 7), 0.85, (0.0, 0.0, 0.0), 3, 1.5),
    "full_T3": ((4, 7, 7), 0.85, (0.1, 0.0, 0.0), 3, 2.5),
}


def _system(name, device="cpu"):
    counts, rho, tilt, T, r_cut = SYSTEMS[name]
    rng = np.random.default_rng(list(SYSTEMS).index(name))
    N = int(np.prod(counts))
    a = (1.0 / rho) ** (1.0 / 3.0)
    Ls = [c * a for c in counts]
    snap = ref.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = ["A", "B", "C"][:T]
    f = (np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / np.asarray(counts)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0, Ls[1], tilt[2] * Ls[2]], [0, 0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0, 0.07, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, T, N)
    rs, _, _ = ref.core.state_from_snapshot(snap)
    spec = RD.GridSpec.create(rs.box, N, r_cut, 0.4)
    rd, meta = RD.densify(rs, spec, fields=())
    if bool(meta.overflow):  # size the capacity to the lattice's fullest cell
        spec = spec.replace(cap=int(np.ceil(int(meta.max_occ) / 8.0) * 8))
        rd, meta = RD.densify(rs, spec, fields=())
    assert not bool(meta.overflow)

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return (m + m.T) / 2

    host = REF_POT["PerturbedLennardJones"].precompute(
        {"epsilon": sym(0.5, 1.5), "sigma": sym(0.85, 1.05),
         "attraction_scale_factor": sym(0.0, 1.0)}
    )
    tabs = {k: np.asarray(v, np.float32) for k, v in host.items()}
    rcut = np.full((T, T), r_cut, np.float32)
    rcut[0, -1] = rcut[-1, 0] = r_cut * 0.8  # a per-pair cutoff where T > 1
    return rd, spec, tabs, rcut


def _reference(rd, spec, tabs, rcut, mode, want):
    T = rcut.shape[0]
    tilted = bool(np.any(np.asarray(rd.box.tilt) != 0))
    masked = tilted or not spec.newton_ok  # the reference Simulation's choice
    jb = RD.make_jblocks(rd, spec, half=spec.newton_ok, need_typeid=masked or T > 1)
    return RD.dense_pair_force(
        REF_POT["PerturbedLennardJones"].energy_force, rd, jb, spec,
        {k: jnp.asarray(v) for k, v in tabs.items()}, jnp.asarray(rcut),
        jnp.zeros_like(jnp.asarray(rcut)), mode, want, masked,
    )


def _plain(rd, spec, tabs, rcut, mode, want, device="cpu"):
    pd = interop.state_from_reference(rd, device)
    pspec = interop.grid_spec_from_reference(spec)
    tbl = interop.pair_tables_from_reference(
        {"params": tabs, "r_cut": rcut, "r_on": np.zeros_like(rcut)}, device
    )
    jb = PD.make_jblocks(pd, pspec, half=pspec.newton_ok)
    out = PD.dense_pair_force(
        PORT_POT["PerturbedLennardJones"].energy_force, pd, jb, pspec,
        tbl["params"], tbl["r_cut"], tbl["r_on"], mode, want,
    )
    return out, pd, pspec, tbl


def _close(got, want_arr, what):
    got = np.asarray(got, np.float64)
    exp = np.asarray(want_arr, np.float64)
    np.testing.assert_allclose(got, exp, rtol=BAR, atol=BAR * np.abs(exp).max(), err_msg=what)


@pytest.mark.parametrize("pallas", ["0", "1"], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("mode", ["none", "shift"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_plain_matches_reference(monkeypatch, name, mode, want, pallas):
    rd, spec, tabs, rcut = _system(name)
    assert spec.newton_ok == name.startswith("half")
    monkeypatch.setenv("AZTPU_PALLAS", pallas)
    r = _reference(rd, spec, tabs, rcut, mode, want)
    p, *_ = _plain(rd, spec, tabs, rcut, mode, want)
    _close(p.force.numpy(), r.force, "force")
    assert np.abs(np.asarray(r.force)).max() > 1.0  # a real test: forces are not ~0
    if want == "all":
        _close(p.energy.numpy(), r.energy, "energy")
        _close(p.virial.numpy(), r.virial, "virial")
    else:
        assert p.energy is None and p.virial is None


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_plain_xplor_matches_reference(monkeypatch, name):
    """xplor smoothing between r_on and r_cut (the plain version only; the
    CUDA kernel refuses xplor until ROADMAP B2)."""
    rd, spec, tabs, rcut = _system(name)
    r_on = (0.75 * rcut).astype(np.float32)
    monkeypatch.setenv("AZTPU_PALLAS", "0")
    T = rcut.shape[0]
    masked = bool(np.any(np.asarray(rd.box.tilt) != 0)) or not spec.newton_ok
    jb = RD.make_jblocks(rd, spec, half=spec.newton_ok, need_typeid=masked or T > 1)
    r = RD.dense_pair_force(
        REF_POT["PerturbedLennardJones"].energy_force, rd, jb, spec,
        {k: jnp.asarray(v) for k, v in tabs.items()}, jnp.asarray(rcut), jnp.asarray(r_on),
        "xplor", "all", masked,
    )
    pd = interop.state_from_reference(rd, "cpu")
    pspec = interop.grid_spec_from_reference(spec)
    tbl = interop.pair_tables_from_reference({"params": tabs, "r_cut": rcut, "r_on": r_on}, "cpu")
    p = PD.dense_pair_force(
        PORT_POT["PerturbedLennardJones"].energy_force, pd,
        PD.make_jblocks(pd, pspec, half=pspec.newton_ok), pspec,
        tbl["params"], tbl["r_cut"], tbl["r_on"], "xplor", "all",
    )
    _close(p.force.numpy(), r.force, "force")
    _close(p.energy.numpy(), r.energy, "energy")
    _close(p.virial.numpy(), r.virial, "virial")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_kernel_matches_reference(cuda_device, name):
    """Where JAX and a GPU meet: the CUDA kernel against the reference."""
    from azplugins_tpu_torch.ops import pair_kernel as PK

    rd, spec, tabs, rcut = _system(name)
    r = _reference(rd, spec, tabs, rcut, "shift", "all")
    _, pd, pspec, tbl = _plain(rd, spec, tabs, rcut, "shift", "all", device=cuda_device)
    tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"], tbl["r_on"],
                              "shift")
    k = PK.cell_pair_force(pd, pspec, tables, "PerturbedLennardJones", "shift", "all")
    _close(k.force.cpu().numpy(), r.force, "force")
    _close(k.energy.cpu().numpy(), r.energy, "energy")
    _close(k.virial.cpu().numpy(), r.virial, "virial")
