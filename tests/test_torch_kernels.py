"""The port's CUDA pair kernel against its plain PyTorch version.

Needs no JAX, so it also runs on a GPU machine without the reference:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider

Tests marked ``cuda`` skip without a GPU; the rest check, on the CPU, the
dispatch and the wrapper's argument handling. Kernel and plain version must
agree per slot within atol = 2e-5 * max|plain| and rtol = 2e-5: they form
bitwise the same separations and cutoff decisions, and differ in the order
of the per-slot sums and in fused multiply-adds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import azplugins_tpu_torch as az  # noqa: E402
from azplugins_tpu_torch.ops import dense as D  # noqa: E402
from azplugins_tpu_torch.ops import pair_kernel as PK  # noqa: E402
from azplugins_tpu_torch.ops.evaluators.pair import PAIR_POTENTIALS  # noqa: E402

torch.set_num_threads(1)

BAR = 2e-5
PLJ = PAIR_POTENTIALS["PerturbedLennardJones"]

# name: (lattice counts, number density, tilt, types, r_cut, start cap)
SYSTEMS = {
    "orthorhombic": ((12, 12, 12), 0.85, (0.0, 0.0, 0.0), 1, 2.5, None),
    "tilted": ((12, 11, 11), 0.8, (0.35, -0.2, 0.15), 1, 2.0, None),
    "two_types": ((10, 10, 10), 0.85, (0.0, 0.0, 0.0), 2, 2.0, None),
    "three_types_overfull": ((10, 10, 10), 0.85, (0.0, 0.0, 0.0), 3, 1.8, 8),
    "axis_under_3": ((4, 10, 10), 0.85, (0.1, 0.0, 0.0), 2, 2.5, None),
}


def _system(name, device):
    counts, rho, tilt, T, r_cut, cap = SYSTEMS[name]
    rng = np.random.default_rng(list(SYSTEMS).index(name))
    N = int(np.prod(counts))
    a = (1.0 / rho) ** (1.0 / 3.0)
    Ls = [c * a for c in counts]
    snap = az.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = ["A", "B", "C"][:T]
    f = (np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / np.asarray(counts)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0, Ls[1], tilt[2] * Ls[2]], [0, 0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0, 0.07, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, T, N)
    state, _, _ = az.core.state_from_snapshot(snap, device)
    spec = D.GridSpec.create(state.box, N, r_cut, 0.4)
    if cap is not None:
        spec = spec.replace(cap=cap)
    dense, meta = D.densify(state, spec, fields=())
    while bool(meta.overflow):  # grow as the simulation does
        spec = spec.replace(cap=int(np.ceil((int(meta.max_occ) + 1) / 8.0) * 8))
        dense, meta = D.densify(state, spec, fields=())

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return (m + m.T) / 2

    host = PLJ.precompute({"epsilon": sym(0.5, 1.5), "sigma": sym(0.85, 1.05),
                           "attraction_scale_factor": sym(0.0, 1.0)})
    rc = np.full((T, T), r_cut, np.float32)
    rc[0, -1] = rc[-1, 0] = r_cut * 0.8
    tbl = {
        "params": {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                   for k, v in host.items()},
        "r_cut": torch.as_tensor(rc, device=device),
        "r_on": torch.zeros((T, T), device=device),
    }
    return dense, spec, tbl


def _plain(dense, spec, tbl, mode, want):
    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    return D.dense_pair_force(PLJ.energy_force, dense, jb, spec, tbl["params"], tbl["r_cut"],
                              tbl["r_on"], mode, want)


def _close(got, exp, what):
    got = got.detach().cpu().double().numpy()
    exp = exp.detach().cpu().double().numpy()
    np.testing.assert_allclose(got, exp, rtol=BAR, atol=BAR * np.abs(exp).max(), err_msg=what)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("mode", ["none", "shift"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_kernel_matches_plain(cuda_device, name, mode, want):
    dense, spec, tbl = _system(name, cuda_device)
    assert spec.newton_ok == (name != "axis_under_3")
    ref = _plain(dense, spec, tbl, mode, want)
    before = PK.launches
    got = PK.cell_pair_force(dense, spec, PK.plj_kernel_tables(tbl["params"], tbl["r_cut"]),
                             mode, want)
    torch.cuda.synchronize()
    assert PK.launches == before + 1
    _close(got.force, ref.force, "force")
    if want == "all":
        _close(got.energy, ref.energy, "energy")
        _close(got.virial, ref.virial, "virial")
    # empty slots get exactly zero
    empty = (dense.tag < 0).cpu().numpy()
    assert not got.force.cpu().numpy()[empty].any()


@pytest.mark.cuda
def test_simulation_on_cuda_runs_every_force_through_the_kernel(cuda_device):
    n = 10
    snap = az.Snapshot(N=n**3)
    L = n * 1.1
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * 1.1 - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim = az.Simulation(device=cuda_device, seed=3)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=1.0)], forces=[lj]
    )
    sim.state.thermalize_particle_momenta(kT=1.0)
    before, evals = PK.launches, sim.force_evaluations
    sim.run(200)
    assert PK.launches - before == sim.force_evaluations - evals >= 200
    assert np.isfinite(lj.energy)
    assert np.all(np.isfinite(sim.state.get_snapshot().particles.position))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_cover(cuda_device):
    dense, spec, tbl = _system("orthorhombic", cuda_device)
    tables = PK.plj_kernel_tables(tbl["params"], tbl["r_cut"])
    with pytest.raises(NotImplementedError, match="B2"):
        PK.cell_pair_force(dense, spec, tables, "xplor", "all")
    with pytest.raises(NotImplementedError, match="B2"):
        PK.pair_force(PLJ.energy_force, dense, spec, tbl, "none", "force")  # no kernel tables
    with pytest.raises(TypeError):
        PK.cell_pair_force(dense, spec, tables.double())


def test_cpu_dispatch_takes_the_plain_version():
    dense, spec, tbl = _system("two_types", "cpu")
    ref = _plain(dense, spec, tbl, "shift", "all")
    before = PK.launches
    got = PK.pair_force(PLJ.energy_force, dense, spec, tbl, "shift", "all")
    assert PK.launches == before
    for k in ("force", "energy", "virial"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(ref, k).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        PK.cell_pair_force(dense, spec, PK.plj_kernel_tables(tbl["params"], tbl["r_cut"]))


def test_kernel_tables_layout():
    _, _, tbl = _system("three_types_overfull", "cpu")
    params, rc = tbl["params"], tbl["r_cut"]
    kt = PK.plj_kernel_tables(params, rc)
    assert tuple(kt.shape) == (7, 3, 3) and kt.is_contiguous()
    for i, k in enumerate(("lj1", "lj2", "lam", "rwcasq", "wca_shift")):
        np.testing.assert_array_equal(kt[i].numpy(), params[k].numpy())
    np.testing.assert_array_equal(kt[5].numpy(), (rc * rc).numpy())
    # ecut: the pair energy at the cutoff, which shift mode subtracts
    e, _ = PLJ.energy_force(kt[5], kt[5], params)
    np.testing.assert_array_equal(kt[6].numpy(), e.numpy())


def test_overfull_start_grows_to_fit():
    dense, spec, _ = _system("three_types_overfull", "cpu")
    occ = (dense.tag >= 0).reshape(spec.n_cells, spec.cap).sum(dim=1)
    assert spec.cap > 8 and int(occ.max()) <= spec.cap
    assert int((dense.tag >= 0).sum()) == 1000
