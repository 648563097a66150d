"""The port's CUDA kernels against their plain PyTorch versions.

Needs no JAX, so it also runs on a GPU machine without the reference:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider

Tests marked ``cuda`` skip without a GPU; the rest check, on the CPU, the
dispatch, the table layouts, the wrappers' argument handling and the build
cache key. Kernel and plain version must agree per slot within atol =
2e-5 * max|plain| and rtol = 2e-5: they form bitwise the same separations,
cutoff decisions and (for DPD) random numbers, and differ in the order of
the per-slot sums, in fused multiply-adds and in the last ulp of exp, log
and pow. The anisotropic kernel is held to the same bar per output (force,
torque, energy, virial), each against its own max|plain|.

The kernels' packed schedule (csrc/cell_stencil.cuh) has systems of its
own: every cell filled to exactly its capacity, a cluster that leaves most
cells empty, a capacity above 256 whose stencils are staged in rounds, two
axes under 3 cells, and 41 types, whose tables are read from global
memory; the anisotropic kernel, whose block takes a group of cells along z
and is sized for sparse cells, also a capacity forced to 64 whose stencils
are staged in rounds and a cluster whose groups hold more particles than
the block has threads (ANISO_SYSTEMS). The kernels sum in an order fixed
by the input, so two launches give the same bits.

The random-draw kernels (csrc/threefry.cu) are held to their plain
versions in core/rng.py: the per-particle words and uniforms (K4) bit for
bit, as integer hashing and explicitly rounded float32 steps; K5 (the
MPCD collision's unit axes, with the virtual fill's normals under a second
key) within 1 ulp, the one step left to the card's libraries being CUDA's
log1pf against PyTorch's CUDA log1p, and its axes bitwise the plain
normalisation of its own normals. The evaporator's pick on a whole layout
(K4 at the pick, csrc/pick.cu; update.py's ParticleEvaporator._pick) is
held to the plain pick bit for bit, the trigger's flag set, unset and
absent.

BrownianFlow's step on the card (K11, csrc/integrate.cu: its draw, the
update and the drift check in one launch, or the step alone) is held to
the plain step and check bit for bit, the signs of zeros included, in
every case the chip's [brownian] phase holds; its step2 (K8's
acceleration-only instance) likewise.

The run loop's CUDA graphs read the timestep on the card: K2, K4, K8 and
K9 in their clock forms (core/rng.py's device_clock) are held bitwise to
their host forms, past 2**32 too, and a small headline's captured rebuild
segment, replayed, to the eager segments (every slot field and the
launch counts). So is K5's clock form (the SRD collision's keys and grid
shift derived on the card, what the SRD advance's graphs run) to its
host-key form and the host's shift, and a small SRD stream's graphed
advance to its eager advance.

The MPCD collision's cell sums (K10, csrc/cell_sums.cu) are held to the
plain ordered sum (mpcd.py's _cell_sums_plain) bit for bit: every cell's
rows added in ascending row order, as the CPU's index_add_ adds them. So
are the two other sums K10 takes: the velocity computes' bins (two calls
the same bits, the Cartesian bins bitwise the CPU's) and the bond force's
scatter on branched molecules (two runs the same bits). Small colloid
hydrodynamics with its joint collision inside the segment graphs is held
bitwise to the eager loop, solvent and anchor included.
"""

import importlib
import re
import shutil
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import azplugins_tpu_torch as az  # noqa: E402
from azplugins_tpu_torch.core import rng as RNG  # noqa: E402
from azplugins_tpu_torch.ops import aniso_kernel as AK  # noqa: E402
from azplugins_tpu_torch.ops import cellsum_kernel as CK  # noqa: E402
from azplugins_tpu_torch.ops import cuda_build  # noqa: E402
from azplugins_tpu_torch.ops import dense as D  # noqa: E402
from azplugins_tpu_torch.ops import dpd_kernel as DK  # noqa: E402
from azplugins_tpu_torch.ops import integrate_kernel as IK  # noqa: E402
from azplugins_tpu_torch.ops import pair_kernel as PK  # noqa: E402
from azplugins_tpu_torch.ops import pick_kernel as XK  # noqa: E402
from azplugins_tpu_torch.ops import rng_kernel as RK  # noqa: E402
from azplugins_tpu_torch.ops.evaluators.aniso import ANISO_PAIR_POTENTIALS  # noqa: E402
from azplugins_tpu_torch.ops.evaluators.pair import PAIR_POTENTIALS  # noqa: E402

torch.set_num_threads(1)

BAR = 2e-5
PLJ = PAIR_POTENTIALS["PerturbedLennardJones"]
MODES = ("none", "shift", "xplor")

# name: (lattice counts, number density, tilt, types, r_cut, start cap,
# span: the fraction of each box edge the lattice fills, from the corner)
SYSTEMS = {
    "orthorhombic": ((12, 12, 12), 0.85, (0.0, 0.0, 0.0), 1, 2.5, None, 1.0),
    "tilted": ((12, 11, 11), 0.8, (0.35, -0.2, 0.15), 1, 2.0, None, 1.0),
    "two_types": ((10, 10, 10), 0.85, (0.0, 0.0, 0.0), 2, 2.0, None, 1.0),
    "three_types_overfull": ((10, 10, 10), 0.85, (0.0, 0.0, 0.0), 3, 1.8, 8, 1.0),
    "axis_under_3": ((4, 10, 10), 0.85, (0.1, 0.0, 0.0), 2, 2.5, None, 1.0),
    # 6^3 cells of exactly 2^3 lattice sites each, at cap 8
    "full_cell": ((12, 12, 12), 0.85, (0.0, 0.0, 0.0), 2, 1.6, 8, 1.0),
    # a lattice in 0.4 of each edge: ~1/8 of the 8^3 cells occupied, across the boundary
    "clustered": ((8, 8, 8), 0.85, (0.0, 0.0, 0.0), 2, 2.0, None, 0.4),
    # 3^3 cells of ~254 particles: cap 304, more candidates than one staging round holds
    "cap_256_rounds": ((19, 19, 19), 0.85, (0.0, 0.0, 0.0), 2, 6.0, None, 1.0),
    # grid (2, 2, 6)
    "axis_under_3_slab": ((5, 5, 14), 0.85, (0.0, 0.0, 0.0), 2, 2.0, None, 1.0),
    # [T, T] tables too large for shared memory
    "many_types": ((10, 10, 10), 0.85, (0.0, 0.0, 0.0), 41, 2.0, None, 1.0),
}
# the packed schedule's systems, which the DPD cases run on their own grid
PACKED_SYSTEMS = ("full_cell", "clustered", "cap_256_rounds", "axis_under_3_slab", "many_types")


def potential_params(name: str, T: int, rng) -> dict:
    """User parameters per type pair (symmetric [T, T] float64 tables) at
    which lattice pairs (r ~ 0.8-2.5) give finite, non-trivial forces.

    Colloid radii by type are (0, 0.15, 0.25) for three or more types, so
    they reach all three of its branches; with fewer types every radius is
    0 (solvent-solvent): the colloid-colloid energy at small radii is a
    difference of terms 1e3 times larger, which float32 cannot resolve to
    2e-5 alone.
    """

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return (m + m.T) / 2

    if name == "Colloid":
        rad = np.zeros(T) if T < 3 else np.array([0.0, 0.15, 0.25] + [0.0] * (T - 3))
        ii, jj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
        return {"A": sym(1.0, 3.0), "a_1": rad[np.minimum(ii, jj)],
                "a_2": rad[np.maximum(ii, jj)], "sigma": sym(0.8, 1.0)}
    ranges = {
        "PerturbedLennardJones": {"epsilon": (0.5, 1.5), "sigma": (0.85, 1.05),
                                  "attraction_scale_factor": (0.0, 1.0)},
        "LJ": {"epsilon": (0.5, 1.5), "sigma": (0.85, 1.0)},
        "ExpandedYukawa": {"epsilon": (1.0, 2.0), "kappa": (1.0, 2.0), "delta": (0.3, 0.5)},
        "Hertz": {"epsilon": (1.0, 5.0)},
        "Morse": {"D0": (0.5, 1.5), "alpha": (1.5, 2.5), "r0": (0.9, 1.2)},
        "Gaussian": {"epsilon": (1.0, 2.0), "sigma": (0.4, 0.8)},
        "Yukawa": {"epsilon": (1.0, 2.0), "kappa": (0.5, 1.5)},
    }[name]
    return {k: sym(*lohi) for k, lohi in ranges.items()}


def _system(name, device, potential="PerturbedLennardJones", velocities=False):
    counts, rho, tilt, T, r_cut, cap, span = SYSTEMS[name]
    rng = np.random.default_rng(list(SYSTEMS).index(name))
    N = int(np.prod(counts))
    a = (1.0 / rho) ** (1.0 / 3.0)
    Ls = [c * a / span for c in counts]
    snap = az.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = (["A", "B", "C"] + [f"t{i}" for i in range(3, T)])[:T]
    f = span * (np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
                .reshape(-1, 3) + 0.5) / np.asarray(counts)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0, Ls[1], tilt[2] * Ls[2]], [0, 0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0, 0.07, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, T, N)
    if velocities:
        snap.particles.velocity[:] = rng.normal(0, 1.0, (N, 3))
    state, _, _ = az.core.state_from_snapshot(snap, device)
    spec = D.GridSpec.create(state.box, N, r_cut, 0.4)
    if cap is not None:
        spec = spec.replace(cap=cap)
    dense, meta = D.densify(state, spec, fields=())
    while bool(meta.overflow):  # grow as the simulation does
        spec = spec.replace(cap=int(np.ceil((int(meta.max_occ) + 1) / 8.0) * 8))
        dense, meta = D.densify(state, spec, fields=())

    host = PAIR_POTENTIALS[potential].precompute(potential_params(potential, T, rng))
    rc = np.full((T, T), r_cut, np.float32)
    rc[0, -1] = rc[-1, 0] = r_cut * 0.8
    r_on = 0.75 * rc
    if T > 1:
        r_on[1, 1] = 1.1 * rc[1, 1]  # r_on >= r_cut: xplor shifts plainly
    tbl = {
        "params": {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                   for k, v in host.items()},
        "r_cut": torch.as_tensor(rc, device=device),
        "r_on": torch.as_tensor(r_on, device=device),
    }
    return dense, spec, tbl


def _plain(dense, spec, tbl, mode, want, potential="PerturbedLennardJones"):
    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    return D.dense_pair_force(PAIR_POTENTIALS[potential].energy_force, dense, jb, spec,
                              tbl["params"], tbl["r_cut"], tbl["r_on"], mode, want)


def _dpd_tables(T, device, seed=0, r_cut=1.0):
    rng = np.random.default_rng(seed)

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return torch.as_tensor(((m + m.T) / 2).astype(np.float32), device=device)

    rc = torch.full((T, T), r_cut, device=device)
    rc[0, -1] = rc[-1, 0] = 0.85 * r_cut
    return {"params": {"A": sym(15.0, 30.0), "gamma": sym(3.0, 6.0), "s": sym(0.3, 2.0)},
            "r_cut": rc}


def _close(got, exp, what):
    got = got.detach().cpu().double().numpy()
    exp = exp.detach().cpu().double().numpy()
    np.testing.assert_allclose(got, exp, rtol=BAR, atol=BAR * np.abs(exp).max(), err_msg=what)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_kernel_matches_plain(cuda_device, name, mode, want):
    dense, spec, tbl = _system(name, cuda_device)
    assert spec.newton_ok == (not name.startswith("axis_under_3"))
    ref = _plain(dense, spec, tbl, mode, want)
    before = PK.launches
    tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"], tbl["r_on"],
                              mode)
    got = PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", mode, want)
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
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("system", ["tilted", "three_types_overfull", "axis_under_3", "many_types"])
@pytest.mark.parametrize("potential", list(PK.KERNEL_POTENTIALS))
def test_every_potential_kernel_matches_plain(cuda_device, potential, system, mode):
    dense, spec, tbl = _system(system, cuda_device, potential)
    ref = _plain(dense, spec, tbl, mode, "all", potential)
    tables = PK.kernel_tables(potential, tbl["params"], tbl["r_cut"], tbl["r_on"], mode)
    got = PK.cell_pair_force(dense, spec, tables, potential, mode, "all")
    force_only = PK.cell_pair_force(dense, spec, tables, potential, mode, "force")
    torch.cuda.synchronize()
    _close(got.force, ref.force, "force")
    _close(force_only.force, ref.force, "force-only path")
    _close(got.energy, ref.energy, "energy")
    _close(got.virial, ref.virial, "virial")


def _dpd_case(name, device):
    """A test system with velocities for the DPD kernel: regridded at DPD's
    cutoff 1.0, or on its own grid with the system's cutoff in the tables
    (the packed schedule's systems, whose grid is their point)."""
    dense, spec, _ = _system(name, device, velocities=True)
    if name in PACKED_SYSTEMS:
        return dense, spec, _dpd_tables(SYSTEMS[name][3], device, r_cut=SYSTEMS[name][4])
    # DPD's cutoff is 1.0: regrid the same particles at its spacing
    spec = D.GridSpec.create(dense.box, int((dense.tag >= 0).sum()), 1.0, 0.4)
    state = D.undensify(dense, int((dense.tag >= 0).sum()), fields=())
    dense, meta = D.densify(state, spec, fields=())
    assert not bool(meta.overflow)
    return dense, spec, _dpd_tables(int(dense.typeid.max()) + 1, device)


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("name", ["orthorhombic", "tilted", "two_types", "axis_under_3",
                                  *PACKED_SYSTEMS])
def test_dpd_kernel_matches_plain(cuda_device, name, want):
    dense, spec, tbl = _dpd_case(name, cuda_device)
    jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_velocity=True, need_tag=True)
    ref = D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], 1.3, 0.01, 77,
                            2**24 + 5, want)
    before = DK.launches
    got = DK.dpd_force(dense, spec, tbl, 1.3, 0.01, 77, 2**24 + 5, want)
    torch.cuda.synchronize()
    assert DK.launches == before + 1
    _close(got.force, ref.force, "force")
    if want == "all":
        _close(got.energy, ref.energy, "energy")
        _close(got.virial, ref.virial, "virial")
    # Newton's third law term by term: the total force vanishes to round-off
    assert float(got.force.double().sum(0).abs().max()) < 1e-3 * float(got.force.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tilted", "clustered", "cap_256_rounds", "axis_under_3_slab"])
@pytest.mark.parametrize("kernel", ["pair", "dpd", "aniso"])
def test_kernel_repeats_bitwise(cuda_device, kernel, name):
    """Two launches on the same input give the same bits: every sum's order
    depends on the input alone."""
    if kernel == "aniso":
        dense, spec, tbl = _aniso_case(name if name in ANISO_SYSTEMS else "cap_64_rounds",
                                       cuda_device)
        tables = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "shift")
        runs = [AK.cell_aniso_force(dense, spec, tables, "all") for _ in range(2)]
    elif kernel == "pair":
        dense, spec, tbl = _system(name, cuda_device)
        tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"],
                                  tbl["r_on"], "xplor")
        runs = [PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "xplor", "all")
                for _ in range(2)]
    else:
        dense, spec, tbl = _dpd_case(name, cuda_device)
        runs = [DK.dpd_force(dense, spec, tbl, 1.3, 0.01, 77, 777, "all") for _ in range(2)]
    torch.cuda.synchronize()
    for k in ("force", "energy", "virial") + (("torque",) if kernel == "aniso" else ()):
        a, b = (getattr(r, k) for r in runs)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k


# The anisotropic kernel's systems. name: (the SYSTEMS entry whose particles
# it takes, start cap, the factor its box and positions are scaled by)
ANISO_SYSTEMS = {
    "orthorhombic": ("orthorhombic", None, 1.0),
    "tilted": ("tilted", None, 1.0),
    "two_types": ("two_types", None, 1.0),
    "axis_under_3": ("axis_under_3", None, 1.0),
    # 6^3 cells of exactly 2^3 lattice sites each, at cap 8
    "full_cell": ("full_cell", 8, 1.0),
    # ~1/20 of the 11^3 cells occupied
    "clustered": ("clustered", None, 1.0),
    # the same cluster at 4.6 times the density: cells of ~37 particles, more
    # than the kernel's block has threads, on a 6^3 grid (groups of cells)
    "clustered_dense": ("clustered", None, 0.6),
    # denser still, on a 5^3 grid: too few cells along z for a group, so a
    # block takes one cell, of ~64 particles
    "clustered_dense_one_cell": ("clustered", None, 0.5),
    # grid (2, 2, 7)
    "axis_under_3_slab": ("axis_under_3_slab", None, 1.0),
    # [8, T, T] tables too large for shared memory
    "many_types": ("many_types", None, 1.0),
    # 6^3 cells of 8 at cap 64: the 288 or 432 candidates of a group's
    # stencil exceed one staging round
    "cap_64_rounds": ("orthorhombic", 64, 1.0),
}


def _aniso_case(name, device):
    """A pair-potential test system (ANISO_SYSTEMS) regridded at the
    TwoPatchMorse cutoff (1.6, buffer 0.3), with random unit quaternions,
    stiff tables (M_r down to 0.05, omega up to 20) and one flat-bottom,
    shorter-cutoff pair where T > 1."""
    system, cap, scale = ANISO_SYSTEMS[name]
    dense, spec, _ = _system(system, device)
    n = int((dense.tag >= 0).sum())
    state = D.undensify(dense, n, fields=())
    rng = np.random.default_rng(60 + list(ANISO_SYSTEMS).index(name))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = state.replace(orientation=torch.as_tensor(q.astype(np.float32), device=device))
    if scale != 1.0:
        state = state.replace(position=state.position * scale,
                              box=state.box.replace(L=state.box.L * np.float32(scale)))
    spec = D.GridSpec.create(state.box, n, 1.6, 0.3)
    if cap is not None:
        spec = spec.replace(cap=cap)
    dense, meta = D.densify(state, spec, fields=("quat",))
    while bool(meta.overflow):
        spec = spec.replace(cap=int(np.ceil((int(meta.max_occ) + 1) / 8.0) * 8))
        dense, meta = D.densify(state, spec, fields=("quat",))
    T = int(dense.typeid.max()) + 1

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return (m + m.T) / 2

    host = {"M_d": sym(1.0, 2.0), "M_r": sym(0.05, 0.15), "r_eq": sym(0.95, 1.1),
            "omega": sym(5.0, 20.0), "alpha": sym(0.3, 0.5), "repulsion": np.ones((T, T))}
    if T > 1:
        host["repulsion"][-1, -1] = 0.0
    pre = ANISO_PAIR_POTENTIALS["TwoPatchMorse"].precompute(host)
    rc = np.full((T, T), 1.6, np.float32)
    if T > 1:
        rc[0, -1] = rc[-1, 0] = 1.4
    tbl = {"params": {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                      for k, v in pre.items()},
           "r_cut": torch.as_tensor(rc, device=device)}
    return dense, spec, tbl


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("mode", ["none", "shift"])
@pytest.mark.parametrize("name", list(ANISO_SYSTEMS))
def test_aniso_kernel_matches_plain(cuda_device, name, mode, want):
    dense, spec, tbl = _aniso_case(name, cuda_device)
    assert spec.newton_ok == (not name.startswith("axis_under_3"))
    tpm = ANISO_PAIR_POTENTIALS["TwoPatchMorse"].energy_force_torque
    jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_quat=True)
    ref = D.dense_aniso_force(tpm, dense, jb, spec, tbl["params"], tbl["r_cut"], mode, want)
    tbl["kernel"] = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], mode)
    tbl["kernel_mode"] = mode
    before = AK.launches
    got = AK.aniso_force(tpm, dense, spec, tbl, mode, want)
    other = "none" if mode == "shift" else "shift"
    with pytest.raises(ValueError, match="built for mode"):  # tables of the other mode
        AK.aniso_force(tpm, dense, spec, tbl, other, want)
    torch.cuda.synchronize()
    assert AK.launches == before + 1
    _close(got.force, ref.force, "force")
    _close(got.torque, ref.torque, "torque")
    if want == "all":
        _close(got.energy, ref.energy, "energy")
        _close(got.virial, ref.virial, "virial")
    if spec.newton_ok:  # Newton's third law bit for bit: the total force is 0 to round-off
        total = got.force.double().sum(0).abs().max()
        assert float(total) < 1e-5 * float(got.force.abs().max()) * spec.S**0.5
    empty = (dense.tag < 0).cpu().numpy()
    assert not got.force.cpu().numpy()[empty].any()
    assert not got.torque.cpu().numpy()[empty].any()


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
@pytest.mark.parametrize("method", ["Langevin", "BrownianFlow", "SRD with plates"])
def test_simulation_on_cuda_draws_through_the_rng_kernels(cuda_device, method):
    """Thermalize draws through K4, Langevin's noise inside K8 and Brownian's
    inside K11 (csrc/integrate.cu), an SRD collision (with plates: the
    virtual fill and the axes) through K5."""
    rng = np.random.default_rng(4)
    n, L = 8, 8.0
    snap = az.Snapshot(N=n**3, mpcd_N=4096 if method.startswith("SRD") else 0)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    if method.startswith("SRD"):
        snap.mpcd.position[:] = (rng.random((4096, 3)) - 0.5) * [L, L, 0.9 * L]
        snap.mpcd.velocity[:] = rng.normal(0, 1.0, (4096, 3))
    sim = az.Simulation(device=cuda_device, seed=3)
    sim.create_state_from_snapshot(snap)
    methods = {"Langevin": az.md.methods.Langevin(kT=1.0, default_gamma=1.0),
               "BrownianFlow": az.md.methods.BrownianFlow(kT=1.0, default_gamma=1.0)}
    sim.operations.integrator = az.md.Integrator(
        dt=0.001, methods=[methods.get(method, az.md.methods.ConstantVolume())], forces=[])
    if method.startswith("SRD"):
        sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, period=1, cell_size=1.0, kT=1.0,
                                        plates=("z", L))
    before, summed = dict(RK.launches_by_kernel), CK.launches
    stepped = IK.launches_by_kernel.get("step2", 0)
    browned = dict(IK.launches_by_kernel)
    sim.state.thermalize_particle_momenta(kT=1.0)
    sim.run(10)
    drawn = {k: v - before.get(k, 0) for k, v in RK.launches_by_kernel.items()}
    assert CK.launches - summed == (10 if method.startswith("SRD") else 0)  # K10 a collision
    if method.startswith("SRD"):
        # one K5 launch a collision (the axes and the fill): the advance's
        # graphs launch its clock form
        assert drawn.get("jax_normal_axis", 0) == 0
        assert drawn.get("jax_normal_axis_clock", 0) == 10
    elif method == "Langevin":
        assert drawn.get("particle_bits", 0) == 1  # thermalize
        assert IK.launches_by_kernel.get("step2", 0) - stepped >= 10
    else:
        # thermalize; BrownianFlow draws inside K11 (no grid here: K11 alone)
        assert drawn.get("particle_bits", 0) == 1
        assert sum(IK.launches_by_kernel.get(k, 0) - browned.get(k, 0)
                   for k in ("brownian_step", "brownian_step_drift")) >= 10
    assert np.all(np.isfinite(sim.state.get_snapshot().particles.position))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_cover(cuda_device):
    dense, spec, tbl = _system("orthorhombic", cuda_device)
    tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"])
    with pytest.raises(NotImplementedError, match="cell_aniso_force"):
        PK.cell_pair_force(dense, spec, tables, "TwoPatchMorse", "none", "all")
    with pytest.raises(NotImplementedError, match="no CUDA pair kernel"):  # no kernel
        PK.pair_force(lambda rsq, rcutsq, p: (rsq, rsq), dense, spec, tbl, "none", "force")
    with pytest.raises(ValueError, match="kernel_tables"):
        PK.pair_force(PLJ.energy_force, dense, spec, tbl, "none", "force")  # no kernel tables
    with pytest.raises(TypeError):
        PK.cell_pair_force(dense, spec, tables.double(), "PerturbedLennardJones", "none")
    with pytest.raises(ValueError, match="shape"):  # tables of another potential
        PK.cell_pair_force(dense, spec, tables, "LJ", "none")


# Windows (parallel/spatial.py::halo_window): each shard's launch reads its
# halo window and writes its own slots, which must equal the whole grid's
# launch there bit for bit (the same candidates in the same order). kernel:
# (system, potential); the layouts: one x plane a shard (slabs), two z
# columns a shard (three on a grid of an odd number of columns: strips)
WINDOWED = {
    "K1": ("orthorhombic", "PerturbedLennardJones"),
    "K1_tilted": ("tilted", "PerturbedLennardJones"),
    "K1'": ("two_types", "Hertz"),
    "K1'_axis_under_3": ("axis_under_3_slab", "Yukawa"),
    "K2": ("orthorhombic", "dpd"),
    "K3": ("orthorhombic", "aniso"),
    "K3_groups": ("clustered_dense", "aniso"),
}


def _windowed_case(kernel, device):
    """(dense, spec, launch(dense, want, window=None))."""
    system, potential = WINDOWED[kernel]
    if potential == "dpd":
        dense, spec, tbl = _dpd_case(system, device)
        tables = DK.dpd_kernel_tables(tbl["params"], tbl["r_cut"], 1.3, 0.01)

        def launch(d, want, window=None):
            return DK.cell_dpd_force(d, spec, tables, 77, 2**24 + 5, want, window=window)
    elif potential == "aniso":
        dense, spec, tbl = _aniso_case(system, device)
        tables = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "shift")

        def launch(d, want, window=None):
            return AK.cell_aniso_force(d, spec, tables, want, window=window)
    else:
        dense, spec, tbl = _system(system, device, potential)
        tables = PK.kernel_tables(potential, tbl["params"], tbl["r_cut"], tbl["r_on"], "shift")

        def launch(d, want, window=None):
            return PK.cell_pair_force(d, spec, tables, potential, "shift", want, window=window)
    return dense, spec, launch


def _mesh_size(spec, layout):
    Dx, Dy, _ = spec.dims
    cols = Dx * Dy
    return Dx if layout == "slabs" else cols // (2 if cols % 2 == 0 else 3)


def _shard_windows(dense, spec, n):
    from azplugins_tpu_torch.parallel import halo_window, make_mesh, shard_dense

    shards = shard_dense(dense, make_mesh(n, device=dense.device, sharded=True))
    fields = ("position", "typeid", "tag", "velocity", "orientation")
    return shards, [halo_window(shards, d, spec, fields) for d in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("layout", ["slabs", "strips"])
@pytest.mark.parametrize("kernel", list(WINDOWED))
def test_windowed_kernel_equals_whole_grid_launch(cuda_device, kernel, layout, want):
    dense, spec, launch = _windowed_case(kernel, cuda_device)
    whole = launch(dense, want)
    n = _mesh_size(spec, layout)
    shards, windows = _shard_windows(dense, spec, n)
    S_loc = spec.S // n
    got = [launch(shards[d], want, window=windows[d]) for d in range(n)]
    torch.cuda.synchronize()
    assert any(w.n_cols < spec.dims[0] * spec.dims[1] for w in windows) or spec.dims[0] <= 3
    for k in ("force", "torque", "energy", "virial"):
        if getattr(whole, k) is None:
            continue
        joined = torch.cat([getattr(g, k) for g in got])
        assert torch.equal(joined.view(torch.int32), getattr(whole, k).view(torch.int32)), k
    assert all(g.force.shape[0] == S_loc for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_whole_grid_window_and_bad_windows(cuda_device, kernel):
    """The whole grid as a window gives the unwindowed launch's bits; a
    window short of a halo plane poisons the cells whose stencil leaves it
    (NaN), and own columns outside the window are refused at launch."""
    dense, spec, launch = _windowed_case(kernel, cuda_device)
    cols, per_col = spec.dims[0] * spec.dims[1], spec.dims[2] * spec.cap
    whole = launch(dense, "all")
    same = launch(dense, "all", window=D.Window(state=dense, w0=0, n_cols=cols, c0=0, n_own=cols))
    for k in ("force", "energy", "virial"):
        assert torch.equal(getattr(same, k).view(torch.int32), getattr(whole, k).view(torch.int32))
    n = spec.dims[0]
    _, windows = _shard_windows(dense, spec, n)
    w = windows[1]
    Dy = spec.dims[1]
    short = D.Window(state=w.state.replace(
        position=w.state.position[Dy * per_col:], typeid=w.state.typeid[Dy * per_col:],
        tag=w.state.tag[Dy * per_col:], velocity=w.state.velocity[Dy * per_col:],
        orientation=w.state.orientation[Dy * per_col:]),
        w0=(w.w0 + Dy) % cols, n_cols=w.n_cols - Dy, c0=w.c0, n_own=w.n_own)
    got = launch(None, "force", window=short)
    torch.cuda.synchronize()
    occupied = (dense.tag[spec.S // n:2 * spec.S // n] >= 0).cpu().numpy()
    nan = torch.isnan(got.force).any(dim=1).cpu().numpy()
    assert nan[occupied].all()  # every own cell's stencil reaches the missing plane
    with pytest.raises(RuntimeError, match="launch failed"):
        launch(None, "force", window=D.Window(state=short.state, w0=short.w0,
                                               n_cols=short.n_cols, c0=(w.c0 + cols // 2) % cols,
                                               n_own=w.n_own))


def test_cpu_dispatch_takes_the_plain_version():
    dense, spec, tbl = _system("two_types", "cpu")
    ref = _plain(dense, spec, tbl, "shift", "all")
    before = PK.launches
    got = PK.pair_force(PLJ.energy_force, dense, spec, tbl, "shift", "all")
    assert PK.launches == before
    for k in ("force", "energy", "virial"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(ref, k).numpy())
    tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"])
    with pytest.raises(ValueError, match="CUDA"):
        PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "none")
    before = DK.launches
    dtbl = _dpd_tables(2, "cpu")
    got = DK.dpd_force(dense, spec, dtbl, 1.0, 0.01, 3, 7, "force")
    assert DK.launches == before and tuple(got.force.shape) == (spec.S, 3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("potential", list(PK.KERNEL_POTENTIALS))
def test_kernel_tables_layout(potential, mode):
    _, _, tbl = _system("three_types_overfull", "cpu", potential)
    params, rc, r_on = tbl["params"], tbl["r_cut"], tbl["r_on"]
    kt = PK.kernel_tables(potential, params, rc, r_on, mode)
    keys = PK.KERNEL_POTENTIALS[potential]
    assert tuple(kt.shape) == (3 + len(keys), 3, 3) and kt.is_contiguous()
    assert set(keys) == set(params)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(kt[3 + i].numpy(), params[k].numpy())
    np.testing.assert_array_equal(kt[0].numpy(), (rc * rc).numpy())
    # ecut: the pair energy at the cutoff, which shift (and xplor where
    # r_on >= r_cut) subtracts; ronsq: where xplor smoothing starts
    e, _ = PAIR_POTENTIALS[potential].energy_force(kt[0], kt[0], params)
    smooth = (r_on < rc).numpy()
    assert smooth.any() and not smooth.all()
    inf = np.full((3, 3), np.inf, np.float32)
    expect_ecut = {"none": np.zeros((3, 3), np.float32), "shift": e.numpy(),
                   "xplor": np.where(smooth, 0.0, e.numpy())}[mode]
    expect_ronsq = np.where(smooth, (r_on * r_on).numpy(), inf) if mode == "xplor" else inf
    np.testing.assert_array_equal(kt[1].numpy(), expect_ecut)
    np.testing.assert_array_equal(kt[2].numpy(), expect_ronsq)


def _shuffled(dense, spec, seed=3):
    """The same dense state with each cell's slots in a random order: not
    the layout ops/dense.py builds (occupied slots first), the kernels'
    precondition."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand(spec.n_cells, spec.cap, generator=g), dim=1)
    idx = (perm + torch.arange(spec.n_cells)[:, None] * spec.cap).reshape(-1).to(dense.device)
    return dense.replace(**{k: getattr(dense, k)[idx].contiguous()
                            for k in ("position", "typeid", "tag", "velocity", "orientation")})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two_types", "axis_under_3_slab", "cap_256_rounds"])
@pytest.mark.parametrize("kernel", ["pair", "dpd", "aniso"])
def test_kernel_refuses_another_slot_order(cuda_device, kernel, name):
    """A cell whose stencil holds an occupied slot past its count reads NaN
    (the torque too); a slot that reads finite has its plain value: no pair
    is dropped."""
    outputs = ("force", "energy", "virial")
    if kernel == "aniso":
        dense, spec, tbl = _aniso_case(name if name in ANISO_SYSTEMS else "cap_64_rounds",
                                       cuda_device)
        dense = _shuffled(dense, spec)
        jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_quat=True)
        ref = D.dense_aniso_force(ANISO_PAIR_POTENTIALS["TwoPatchMorse"].energy_force_torque,
                                  dense, jb, spec, tbl["params"], tbl["r_cut"], "shift", "all")
        tables = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "shift")
        got = AK.cell_aniso_force(dense, spec, tables, "all")
        outputs += ("torque",)
    elif kernel == "pair":
        dense, spec, tbl = _system(name, cuda_device)
        dense = _shuffled(dense, spec)
        ref = _plain(dense, spec, tbl, "shift", "all")
        tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"],
                                  tbl["r_on"], "shift")
        got = PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "shift", "all")
    else:
        dense, spec, tbl = _dpd_case(name, cuda_device)
        dense = _shuffled(dense, spec)
        jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_velocity=True, need_tag=True)
        ref = D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], 1.3, 0.01, 77, 777,
                                "all")
        got = DK.dpd_force(dense, spec, tbl, 1.3, 0.01, 77, 777, "all")
    torch.cuda.synchronize()
    refused = torch.isnan(got.force).all(dim=1)
    assert bool(refused.any())
    for what in outputs:
        value, plain = getattr(got, what), getattr(ref, what)
        assert bool(torch.isnan(value[refused]).all()), what
        if not bool(refused.all()):
            _close(value[~refused], plain[~refused], what)


def test_shuffled_layout_moves_occupied_slots():
    dense, spec, _ = _system("two_types", "cpu")
    mixed = _shuffled(dense, spec)
    occ = (mixed.tag >= 0).reshape(spec.n_cells, spec.cap)
    n = occ.sum(dim=1, keepdim=True)
    # some cell has an occupied slot past its count: not a prefix
    assert bool((occ & (torch.arange(spec.cap)[None, :] >= n)).any())
    assert torch.equal(torch.sort(mixed.tag).values, torch.sort(dense.tag).values)


def test_shuffled_layout_moves_quaternions_with_their_slots():
    dense, spec, _ = _aniso_case("two_types", "cpu")
    mixed = _shuffled(dense, spec)
    assert not torch.equal(mixed.tag, dense.tag)
    for state in (dense, mixed):
        assert tuple(state.orientation.shape) == (spec.S, 4)
    occupied, was = mixed.tag >= 0, dense.tag >= 0
    # each particle (tag) keeps its position and its quaternion
    order, order_was = torch.argsort(mixed.tag[occupied]), torch.argsort(dense.tag[was])
    for field in ("orientation", "position"):
        now, before = getattr(mixed, field)[occupied], getattr(dense, field)[was]
        assert torch.equal(now[order], before[order_was]), field


@pytest.mark.parametrize("dims", [(3, 3, 3), (4, 7, 5), (23, 23, 23)])
def test_newton_stencil_order_is_the_kernels_home_rule(dims):
    """On a grid with >= 3 cells on every axis the stencil lists 27 offsets
    in lexicographic order with the cell itself in the middle, and the half
    stencil (the neighbours a cell is the home side of) is exactly the
    offsets after it. The anisotropic kernel decides who is home from the
    class of a candidate's column (ox, oy) and, in the cell's own column,
    from the candidate's number, which rises with oz: the same rule."""
    spec = D.GridSpec(dims=dims, cap=8, r_cut=1.6, buffer=0.3)
    assert spec.newton_ok
    offsets = [tuple(int(x) for x in o) for o in spec.stencil()]
    assert len(offsets) == 27 and offsets == sorted(offsets)
    assert offsets.index((0, 0, 0)) == 13
    half = [tuple(int(x) for x in o) for o in spec.half_stencil()]
    assert half == offsets[14:]
    source = (cuda_build.CSRC / AK._SOURCE).read_text()
    assert "enum Column { kBefore = 0, kOwn, kAfter };" in source
    for ox, oy, oz in offsets:
        column = "after" if (ox, oy) > (0, 0) else "own" if (ox, oy) == (0, 0) else "before"
        home = column == "after" or (column == "own" and oz > 0)
        assert home == ((ox, oy, oz) in half)


def _source_constant(source, name):
    """A ``constexpr int name = n;`` of one kernel source under csrc/."""
    text = (cuda_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("name", list(ANISO_SYSTEMS))
def test_aniso_systems_have_their_shape(name):
    """Each system of the anisotropic kernel is the case it is named for:
    the CUDA cases above rely on it."""
    dense, spec, tbl = _aniso_case(name, "cpu")
    system, cap, scale = ANISO_SYSTEMS[name]
    occ = (dense.tag >= 0).reshape(spec.dims + (spec.cap,)).sum(dim=-1)
    assert int(occ.sum()) == int(np.prod(SYSTEMS[system][0]))
    # occupied slots first: the kernels' precondition
    filled = (dense.tag >= 0).reshape(spec.n_cells, spec.cap)
    assert bool((filled == (torch.arange(spec.cap)[None, :] < filled.sum(1, keepdim=True))).all())
    norm = dense.orientation[dense.tag >= 0].norm(dim=1)
    assert float((norm - 1.0).abs().max()) < 1e-6
    around = sum(torch.roll(occ, shifts=tuple(-int(o) for o in off), dims=(0, 1, 2))
                 for off in spec.stencil())
    threads = _source_constant(AK._SOURCE, "kThreads")
    stage_entries = _source_constant(AK._SOURCE, "kStageEntries")
    group = _source_constant(AK._SOURCE, "kGroup")
    assert spec.newton_ok == (not name.startswith("axis_under_3"))
    if name == "full_cell":
        assert spec.dims == (6, 6, 6) and spec.cap == 8 and bool((occ == spec.cap).all())
    elif name == "clustered":
        assert float((occ == 0).double().mean()) > 0.75
    elif name == "clustered_dense":
        # a block takes a group of cells, whose particles go in rounds of its threads
        assert spec.dims[2] >= group + 2 and int(occ.max()) > threads
    elif name == "axis_under_3_slab":
        assert spec.dims == (2, 2, 7)
    elif name == "many_types":
        T = tbl["r_cut"].shape[0]
        assert T == 41 and len(AK.KERNEL_TABLES) * T * T * 4 > _header_bytes("kTableSmemBytes")
    elif name == "clustered_dense_one_cell":
        assert spec.dims[2] < group + 2 and int(occ.max()) > threads
        assert int(around.max()) > stage_entries
    elif name == "cap_64_rounds":
        # more candidates in the stencil of any group of cells than one staging round holds
        assert spec.cap == 64 and spec.dims == (6, 6, 6) and spec.dims[2] >= group + 2
        assert int(occ.min()) * 9 * (spec.dims[2] % group + 2) > stage_entries
    if name in ("two_types", "many_types"):  # per-pair cutoffs and a flat-bottom pair
        assert float(tbl["r_cut"].min()) < float(tbl["r_cut"].max())
        assert float(tbl["params"]["repulsion"].min()) == 0.0


@pytest.mark.parametrize("name", PACKED_SYSTEMS)
def test_packed_systems_have_their_shape(name):
    """Each packed-schedule system is the case it is named for: the CUDA
    cases above rely on it."""
    dense, spec, _ = _system(name, "cpu")
    occ = (dense.tag >= 0).reshape(spec.dims + (spec.cap,)).sum(dim=-1)
    assert int(occ.sum()) == int(np.prod(SYSTEMS[name][0]))
    if name == "full_cell":
        assert spec.dims == (6, 6, 6) and spec.cap == 8 and bool((occ == spec.cap).all())
    elif name == "clustered":
        assert spec.newton_ok and float((occ == 0).double().mean()) > 0.75
    elif name == "cap_256_rounds":
        # the largest stencil's candidates exceed one staging round of both kernels
        assert spec.dims == (3, 3, 3) and spec.cap >= 256
        assert int(occ.sum()) > _header_bytes("kStageBytes") // 16
    elif name == "axis_under_3_slab":
        assert spec.dims == (2, 2, 6) and not spec.newton_ok
    else:  # many_types: tables above the kernels' shared-memory table budget
        T = SYSTEMS[name][3]
        assert int(dense.typeid.max()) + 1 == T
        n_rows = 3 + len(PK.KERNEL_POTENTIALS["PerturbedLennardJones"])
        assert min(n_rows, 5) * T * T * 4 > _header_bytes("kTableSmemBytes")  # 5: DPD's tables


def _header_bytes(name):
    """A ``constexpr int name = n * 1024;`` of csrc/cell_stencil.cuh, in bytes."""
    header = (cuda_build.CSRC / "cell_stencil.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+) \* 1024;", header).group(1)) * 1024


def test_overfull_start_grows_to_fit():
    dense, spec, _ = _system("three_types_overfull", "cpu")
    occ = (dense.tag >= 0).reshape(spec.n_cells, spec.cap).sum(dim=1)
    assert spec.cap > 8 and int(occ.max()) <= spec.cap
    assert int((dense.tag >= 0).sum()) == 1000


def test_library_digest_covers_shared_headers(tmp_path):
    """An edited csrc/*.cuh header changes every source's build key, so a
    stale library is never loaded; the digest needs no nvcc."""
    for f in ("a.cu", "b.cu", "common.cuh"):
        (tmp_path / f).write_text(f"// {f}\n")
    before = {s: cuda_build.source_digest(s, tmp_path) for s in ("a.cu", "b.cu")}
    assert before["a.cu"] != before["b.cu"]
    (tmp_path / "common.cuh").write_text("// common.cuh, edited\n")
    after = {s: cuda_build.source_digest(s, tmp_path) for s in ("a.cu", "b.cu")}
    assert all(after[s] != before[s] for s in before)
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert cuda_build.source_digest("a.cu", tmp_path) != after["a.cu"]
    # the port's own sources include their shared header
    assert '#include "cell_stencil.cuh"' in (cuda_build.CSRC / "cell_dpd_force.cu").read_text()
    assert '#include "cell_stencil.cuh"' in (cuda_build.CSRC / "cell_pair_force.cu").read_text()
    assert '#include "cell_stencil.cuh"' in (cuda_build.CSRC / "cell_aniso_force.cu").read_text()


def test_sources_routes_the_kernels_to_another_directory(tmp_path):
    """Inside cuda_build.sources the wrappers' libraries come from its
    directory (here an empty one, so the build finds no source), and from
    csrc/ again after it."""
    with cuda_build.sources(tmp_path):
        with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path.resolve()))):
            cuda_build.load_library(PK._SOURCE)
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path.resolve()))):
        cuda_build.load_library(PK._SOURCE, tmp_path)
    assert cuda_build.source_digest(PK._SOURCE) == cuda_build.source_digest(PK._SOURCE,
                                                                             cuda_build.CSRC)


def _kernel_variants(monkeypatch):
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    return importlib.import_module("kernel_variants")


def test_every_kernel_variant_changes_its_sources(monkeypatch):
    kv = _kernel_variants(monkeypatch)
    base = kv.variant_sources("base", cuda_build.CSRC)
    assert set(base) >= {"cell_stencil.cuh", *kv.SOURCES}
    assert "cell_aniso_force.cu" in kv.SOURCES
    assert "case kLJ:" not in base["cell_pair_force.cu"]  # two instantiations only
    for variant in kv.CHANGES:
        texts = kv.variant_sources(variant, cuda_build.CSRC)
        assert (texts == base) == (variant == "base"), variant


def test_kernel_variant_raises_where_its_change_matches_nothing(monkeypatch, tmp_path):
    kv = _kernel_variants(monkeypatch)
    for src in (*cuda_build.CSRC.glob("*.cuh"), *(cuda_build.CSRC / s for s in kv.SOURCES)):
        shutil.copy(src, tmp_path / src.name)
    header = tmp_path / "cell_stencil.cuh"
    header.write_text(header.read_text().replace("constexpr int kUnroll = 4;",
                                                 "constexpr int kUnroll=4;"))  # reworded
    with pytest.raises(ValueError, match="no \\*.cuh holds"):
        kv.variant_sources("unroll2", tmp_path)
    kv.variant_sources("list16", tmp_path)  # the other changes still apply
    monkeypatch.setitem(kv.CHANGES, "same", [(".cuh", "kListLen", "kListLen")])
    with pytest.raises(ValueError, match="sources are base's"):
        kv.variant_sources("same", tmp_path)


# -- the random-draw kernels (csrc/threefry.cu) ------------------------------
RNG_CASES = [(210, 12345, 777), (202, 0xFFFF, 2**32 + 5), (203, 7, 0)]  # stream, seed, timestep
RNG_SIZES = [64000, 82944, 1001]  # the paths' tag counts and one that is not a multiple of the block
NORMAL_ULP = 1


def _rng_tags(n, device):
    """Tags as a slot array holds them: random ones, empty slots (-1) and
    tags near 2**31 - 1."""
    g = np.random.default_rng(n)
    tags = g.integers(0, 2**31 - 1, n).astype(np.int32)
    tags[g.random(n) < 0.2] = -1
    tags[:4] = [2**31 - 1, 2**31 - 2, -1, 0]
    return torch.as_tensor(tags, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RNG_SIZES)
@pytest.mark.parametrize("n_words", [1, 2, 3, 4, 8])
def test_particle_bits_kernel_bitwise(cuda_device, n_words, n):
    tags = _rng_tags(n, cuda_device)
    for stream, seed, t in RNG_CASES:
        before = RK.launches_by_kernel.get("particle_bits", 0)
        got = RNG.particle_bits(stream, seed, t, tags, n_words)
        assert RK.launches_by_kernel["particle_bits"] == before + 1
        want = RNG._particle_bits_plain(stream, seed, t, tags, n_words)
        assert len(got) == n_words
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and g.device == tags.device
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RNG_SIZES)
@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (0.0, 1.0), (-3.5, 0.25)])
def test_particle_uniform3_kernel_bitwise(cuda_device, low, high, n):
    tags = _rng_tags(n, cuda_device)
    for stream, seed, t in RNG_CASES:
        before = RK.launches_by_kernel.get("particle_bits", 0)
        got = RNG.particle_uniform3(stream, seed, t, tags, low, high)
        assert RK.launches_by_kernel["particle_bits"] == before + 1
        want = RNG._particle_uniform3_plain(stream, seed, t, tags, low, high)
        assert got.shape == want.shape == (n, 3) and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9261, 3), (1001, 3), (0, 3)])
def test_jax_normal_kernel_within_bar(cuda_device, shape):
    """K5's normals (the two-key form's second key) within the 1-ulp bar of
    the plain draw, in one launch."""
    for key in [(0, 42), RNG.jax_fold_in(RNG.jax_key(11), 40)]:
        before = RK.launches_by_kernel.get("jax_normal_axis", 0)
        _, got = RNG.jax_normal_axis((5, 6), shape[0], cuda_device, key)
        assert RK.launches_by_kernel.get("jax_normal_axis", 0) == before + (shape[0] > 0)
        want = RNG._jax_normal_plain(key, shape, cuda_device)
        assert got.shape == want.shape and got.dtype == torch.float32
        ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
        assert ulps.numel() == 0 or int(ulps.max()) <= NORMAL_ULP


@pytest.mark.cuda
def test_rng_kernels_launch_nothing_for_no_tags_and_refuse_other_tags(cuda_device):
    before = RK.launches
    (w,) = RNG.particle_bits(210, 1, 2, torch.zeros(0, dtype=torch.int32, device=cuda_device), 1)
    u = RNG.particle_uniform3(210, 1, 2, torch.zeros(0, dtype=torch.int32, device=cuda_device))
    assert tuple(w.shape) == (0,) and tuple(u.shape) == (0, 3) and RK.launches == before
    with pytest.raises(TypeError, match="int32"):
        RNG.particle_bits(210, 1, 2, torch.zeros(8, dtype=torch.int64, device=cuda_device), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [9261, 4352, 1001, 0])
def test_jax_normal_axis_kernel_within_bar(cuda_device, rows):
    """K5's axis form: one launch; the axes within the normals' 1-ulp bar of
    the plain version and bitwise the plain normalisation of K5's own
    normals (drawn as another launch's second key: the card's torch.sum
    order over 3); with a second key, its normals bitwise those of another
    launch under another first key, and the axes the one-key form's."""
    for key, second in (((0, 42), (3, 4)), (RNG.jax_fold_in(RNG.jax_key(11), 40), None)):
        before = RK.launches_by_kernel.get("jax_normal_axis", 0)
        axis, normals = RNG.jax_normal_axis(key, rows, cuda_device, second)
        assert RK.launches_by_kernel.get("jax_normal_axis", 0) == before + (rows > 0)
        p_axis, p_normals = RNG._jax_normal_axis_plain(key, rows, cuda_device, second)
        assert axis.shape == (rows, 3) and axis.dtype == torch.float32
        assert (normals is None) == (second is None)
        _, raw = RNG.jax_normal_axis((7, 9), rows, cuda_device, key)
        own = raw / torch.clamp_min(torch.sqrt(torch.sum(raw * raw, dim=1, keepdim=True)), 1e-12)
        assert torch.equal(axis.view(torch.int32), own.view(torch.int32))
        pairs = [(axis, p_axis)]
        if second is not None:
            _, single = RNG.jax_normal_axis((7, 9), rows, cuda_device, second)
            assert torch.equal(normals.view(torch.int32), single.view(torch.int32))
            one, _ = RNG.jax_normal_axis(key, rows, cuda_device)
            assert torch.equal(one.view(torch.int32), axis.view(torch.int32))
            pairs.append((normals, p_normals))
        for got, want in pairs:
            ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
            assert ulps.numel() == 0 or int(ulps.max()) <= NORMAL_ULP


def _pick_state(device, R0=8.0, a=1.1, n_empty=300, seed=4):
    """A droplet-like slot layout on ``device`` (bench.py's droplet lattice
    at radius R0, a fifth evaporated, ``n_empty`` empty slots shuffled in,
    some particles a box length off) and an evaporator on its slab
    [R0/2, L/2), attached to a simulation of its box."""
    from azplugins_tpu_torch.core.state import state_from_snapshot

    rng = np.random.default_rng(seed)
    L = 2 * R0 + 4.0
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    pts[::7, 2] += L
    n = len(pts) + n_empty
    order = rng.permutation(n)
    pos = np.full((n, 3), 3.0 * L, np.float32)
    pos[order[:len(pts)]] = pts
    typeid = np.full(n, -1, np.int32)
    typeid[order[:len(pts)]] = (rng.random(len(pts)) < 0.2).astype(np.int32)
    tag = np.full(n, -1, np.int32)
    tag[order[:len(pts)]] = np.arange(len(pts), dtype=np.int32)
    snap = az.Snapshot(N=n)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pos
    state, _, _ = state_from_snapshot(snap, device)
    state = state.replace(tag=torch.as_tensor(tag, device=device),
                          typeid=torch.as_tensor(typeid, device=device))
    evap = az.update.ParticleEvaporator(trigger=1, solvent_type="solvent",
                                        evaporated_type="evaporated", lo=R0 / 2, hi=L / 2,
                                        N_evap_max=10)
    sim = az.Simulation(device=device, seed=3)
    sim.create_state_from_snapshot(snap)
    evap._attach(sim)
    return state, evap


@pytest.mark.cuda
@pytest.mark.parametrize("k", ["1", "10", "2049", "n_marked - 1", "n_marked", "slots"])
def test_evaporator_pick_kernel_bitwise(cuda_device, k):
    """K4 at the pick flips what the plain pick flips, bit for bit, in two
    launches a pick: fired, with the flag set, and with the flag
    unset (typeid keeps its bits); at timesteps past 2**32 too. k = 2049,
    above the select's 2048 radix bins, on a slab holding the whole
    droplet, so more candidates than k."""
    wide = k == "2049"
    state, evap = _pick_state(cuda_device, R0=11.0 if wide else 8.0)
    if wide:
        evap.lo = -0.5 * float(state.box.L[2])
    m = int(evap._candidates(state).sum())
    assert 20 < m < state.N and (m > 2049 or not wide)
    evap._k = {"1": 1, "10": 10, "2049": 2049, "n_marked - 1": m - 1, "n_marked": m,
               "slots": state.N}[k]
    for t in (0, 25, 777, 2**32 + 25):
        want = state.typeid.clone()
        evap._pick_plain(want, state, None, t, 3)
        assert int((want != state.typeid).sum()) == min(evap._k, m)
        for fire in (None, True, False):
            got = state.typeid.clone()
            before = XK.launches
            evap._pick(got, state, None if fire is None else torch.tensor(fire, device=cuda_device),
                       t, 3)
            assert XK.launches == before + 2
            assert torch.equal(got, state.typeid if fire is False else want)


# a (seed, timestep, tag) whose evaporator word is 0xFFFFFFFF: a real tie
PICK_TIE = (7, 3, 1853371083)


@pytest.mark.cuda
def test_evaporator_pick_kernel_ties_as_the_plain_pick(cuda_device):
    """PICK_TIE's tag on candidates at slots 0 and 1: its word ties the
    non-candidates' priority, and with k one past the candidates below it
    the kernel's rank among the tying slots flips slot 0 alone, as the
    plain pick's top-k over every slot does."""
    seed, t, tag = PICK_TIE
    state, evap = _pick_state(cuda_device)
    first = torch.arange(2, device=cuda_device)
    pos = state.position.clone()
    pos[first] = torch.tensor([[0.0, 0.0, 0.5 * (evap.lo + evap.hi)]] * 2, device=cuda_device)
    state = state.replace(position=pos, typeid=state.typeid.index_fill(0, first, 0),
                          tag=state.tag.index_fill(0, first, tag))
    (word,) = RNG.particle_bits(RNG.Stream.PARTICLE_EVAPORATOR, seed, t, state.tag[:1], 1)
    assert int(word[0]) == 0xFFFFFFFF
    m = int(evap._candidates(state).sum())
    for k, flipped in ((m - 2, [0, 0]), (m - 1, [1, 0]), (m, [1, 1])):
        evap._k = k
        want = state.typeid.clone()
        evap._pick_plain(want, state, None, t, seed)
        got = state.typeid.clone()
        evap._pick(got, state, None, t, seed)
        assert torch.equal(got, want) and got[:2].tolist() == flipped


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k", ["1", "10", "n_marked", "slots"])
def test_evaporator_pick_across_shards_bitwise(cuda_device, k, n):
    """K4 at the pick over n shards of one card (one scan launch over every
    shard, keys on global slots into one scratch; one select flipping each
    shard's typeid through its table of pointers) flips what the plain
    pick (``_flips`` over the shards, then ``& fire``) flips, bit for bit,
    in two launches a pick: fired, with the flag set and unset."""
    from azplugins_tpu_torch.parallel import make_mesh
    from azplugins_tpu_torch.parallel.spatial import shard_dense

    state, evap = _pick_state(cuda_device)
    shards = shard_dense(state, make_mesh(n, device=cuda_device, sharded=True))
    m = sum(int(evap._candidates(s).sum()) for s in shards)
    slots = sum(s.N for s in shards)
    assert 20 < m < slots
    evap._k = {"1": 1, "10": 10, "n_marked": m, "slots": slots}[k]
    for t in (0, 25, 2**32 + 25):
        want = tuple(s.typeid.clone() for s in shards)
        evap._pick_plain(want, shards, None, t, 3)
        flipped = sum(int((w != s.typeid).sum()) for w, s in zip(want, shards))
        assert flipped == min(evap._k, m)
        for fire in (None, True, False):
            got = tuple(s.typeid.clone() for s in shards)
            before = XK.launches
            flag = None if fire is None else torch.tensor(fire, device=cuda_device)
            evap._pick(got, shards, flag, t, 3)
            assert XK.launches == before + 2
            for g, w, s in zip(got, want, shards):
                assert torch.equal(g, s.typeid if fire is False else w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_captured_sharded_segments_are_eager_segments(cuda_device, n):
    """The scheduled PLJ liquid (a Ramp kT, a TypeUpdater) with an
    evaporator, on n shards of the card: its segments captured as CUDA
    graphs (the updaters masked on every shard, the pick over every shard
    in a replay) are bitwise the eager loop on the same shards, shard by
    shard, with the same kernel launches."""
    from azplugins_tpu_torch.parallel import make_mesh

    runs = {}
    for eager in (True, False):
        sim = _graph_lj(cuda_device, eager, scheduled=True)
        sim.operations.updaters.append(az.update.ParticleEvaporator(
            trigger=az.trigger.Periodic(3), solvent_type="A", evaporated_type="B", lo=-2.0,
            hi=3.0, N_evap_max=5))
        sim.enable_spatial_decomposition(make_mesh(n, device=cuda_device, sharded=True))
        sim.run(5)
        before = (dict(IK.launches_by_kernel), PK.launches, XK.launches, sim.steps_run)
        sim.run(60)
        torch.cuda.synchronize()
        launched = ({k: c - before[0].get(k, 0) for k, c in IK.launches_by_kernel.items()},
                    PK.launches - before[1], XK.launches - before[2], sim.steps_run - before[3])
        runs[eager] = (sim, launched)
    (eager, e_launched), (graphs, g_launched) = runs[True], runs[False]
    assert eager._runner is None and graphs._runner.captures >= 1
    assert graphs._runner.replays >= 10 and len(graphs._runner.shards) == n
    assert g_launched[:2] == e_launched[:2] and g_launched[3] == e_launched[3] >= 60
    assert g_launched[1] == n * e_launched[3]  # K1 once a shard a step
    assert g_launched[2] == 2 * g_launched[3] and e_launched[2] == 2 * 20  # a step / a fire
    for g, e in zip(graphs._dense, eager._dense, strict=True):
        for name in ("position", "velocity", "acceleration", "net_force", "tag", "image",
                     "typeid"):
            assert torch.equal(getattr(g, name), getattr(e, name)), name
    for g, e in zip(graphs._meta, eager._meta, strict=True):
        for name in ("ref_position", "overflow", "n_builds", "max_occ"):
            assert torch.equal(getattr(g, name), getattr(e, name)), name


@pytest.mark.cuda
def test_evaporator_pick_kernel_refuses_what_it_does_not_take(cuda_device):
    state, evap = _pick_state(cuda_device, n_empty=10)
    before = XK.launches
    evap._k = 0
    got = state.typeid.clone()
    evap._pick(got, state, None, 5, 3)  # no budget: nothing flips, nothing launches
    assert torch.equal(got, state.typeid) and XK.launches == before
    with pytest.raises(TypeError, match="int32"):
        XK.evaporator_pick(state.typeid.long(), state.position, state.tag, 10, 0, 1, 0.0, 1.0,
                           float(state.box.L[2]), 203, 3, 5)
    with pytest.raises(ValueError, match="CUDA"):
        XK.evaporator_pick(state.typeid.cpu(), state.position.cpu(), state.tag.cpu(), 10, 0, 1,
                           0.0, 1.0, float(state.box.L[2]), 203, 3, 5)


# -- the SRD collision: K5's clock form and K10 --------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [9261, 4352, 1001])
def test_collision_draws_kernel_is_the_host_key_form(cuda_device, rows):
    """K5's clock form, the keys derived on the card from the clock (3
    steps behind at offset 3) or the host's timestep word, bitwise K5's
    host-key form under the host's keys and the host's shift and quotient,
    past 2**32 and at a cell size whose reciprocal is not a float32; one
    launch a call."""
    from azplugins_tpu_torch import mpcd as M

    for t in (0, 7, 2**31 + 5, 2**32 + 5):
        kshift, kaxis, kvirt = M._collision_keys(11, t)
        for cell_size, shift_on, second in ((1.0, True, True), (0.75, True, False),
                                            (0.75, False, True)):
            a = np.float32(cell_size)
            shift = RNG.jax_uniform_host(kshift, 3) * a if shift_on else np.zeros(3, np.float32)
            axis, normals = RNG.jax_normal_axis(kaxis, rows, cuda_device,
                                                kvirt if second else None)
            clock = torch.tensor(t - 3, dtype=torch.int64, device=cuda_device)
            for on_clock in (True, False):
                before = RK.launches_by_kernel.get("jax_normal_axis_clock", 0)
                if on_clock:
                    with RNG.device_clock(clock, 1000):
                        got = RNG.collision_draws(M._inner_key(11), 1003, rows, cuda_device,
                                                  cell_size, shift_on, second)
                else:
                    got = RNG.collision_draws(M._inner_key(11), t, rows, cuda_device, cell_size,
                                              shift_on, second)
                assert RK.launches_by_kernel["jax_normal_axis_clock"] == before + 1
                assert torch.equal(got[0].view(torch.int32), axis.view(torch.int32))
                assert (got[1] is None) == (not second)
                if second:
                    assert torch.equal(got[1].view(torch.int32), normals.view(torch.int32))
                for g, w in ((got[2], shift), (got[3], shift / a)):
                    np.testing.assert_array_equal(g.cpu().numpy().view(np.uint32),
                                                  w.view(np.uint32))


CELL_SUM_CASES = ["srd", "colloid", "deep", "empty", "bucket32", "bucket33", "bucket1024",
                  "bucket5012", "one_cell", "trash_only", "sparse", "poiseuille",
                  "colloid_full"]


def _cell_sum_case(case, device):
    """(cid, vel, mass, cells) of a collision's cell sums: pure SRD's shape
    at a small size (a row a cell on average, unit masses), the colloids'
    (a solvent of 5 a cell and dense slots of mass 5, most of them empty and
    binned to the trash cell), one deep cell, no row; one cell of exactly
    32, 33, 1,024 or 5,012 rows among shallow ones; every row in one cell;
    only trash rows; most cells empty; and the Poiseuille slit's and the
    colloids' full shapes (40,000 rows into 4,352 cells; 163,840 solvent
    rows and 74,088 slots into 32,768 cells)."""
    g = np.random.default_rng(CELL_SUM_CASES.index(case) + 1)
    cells, n = {"srd": (9261, 9261), "colloid": (4096, 28_672), "deep": (64, 6000),
                "empty": (100, 0), "one_cell": (300, 20_000), "trash_only": (500, 3000),
                "sparse": (40_000, 2000), "poiseuille": (4352, 40_000),
                "colloid_full": (32_768, 163_840 + 74_088)}.get(case, (2000, 6000))
    cid = g.integers(0, cells, n)
    vel = g.normal(0, 1.0, (n, 3)).astype(np.float32)
    mass = None
    if case.startswith("colloid"):
        solvent = 5 * cells if case == "colloid" else 163_840
        invalid = np.zeros(n, bool)
        invalid[solvent:] = g.random(n - solvent) < 0.9
        cid[invalid] = cells
        vel[invalid] = 0.0
        mass = np.where(np.arange(n) < solvent, 1.0, np.where(invalid, 0.0, 5.0))
        mass = torch.as_tensor(mass.astype(np.float32), device=device)
    if case == "deep":
        cid[: n // 2] = 17
    if case.startswith("bucket"):
        cid[cid == 17] = 18
        cid[g.choice(n, int(case[6:]), replace=False)] = 17
    if case == "one_cell":
        cid[:] = 123
    if case == "trash_only":
        cid[:] = cells
    return (torch.as_tensor(cid, device=device), torch.as_tensor(vel, device=device), mass, cells)


def _cell_sums_match(cid, vel, mass, cells):
    from azplugins_tpu_torch import mpcd as M

    before = CK.launches
    got = M._cell_sums(cid, vel, mass, cells)
    again = CK.cell_sums(cid, vel, mass, cells)
    assert CK.launches == before + 2 and got.shape == (cells, 6)
    want = M._cell_sums_plain(cid, M._payload(vel, mass), cells)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CELL_SUM_CASES)
def test_cell_sums_kernel_bitwise(cuda_device, case):
    """K10 bitwise the plain ordered cell sum on the card (its payload the
    card's PyTorch operations), in one call, and two calls the same bits."""
    _cell_sums_match(*_cell_sum_case(case, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("group", CK.GROUPS)
@pytest.mark.parametrize("case", ["srd", "colloid", "bucket33", "bucket5012", "poiseuille"])
def test_cell_sums_kernel_group_widths(cuda_device, monkeypatch, case, group):
    """Every lane group K10 is built for gives the plain ordered sum's bits,
    whatever the cells' depth against it."""
    monkeypatch.setattr(CK, "group_width", lambda n, cells: group)
    _cell_sums_match(*_cell_sum_case(case, cuda_device))


def test_cell_sums_group_width():
    """The lanes a cell follow the mean rows a cell: a lone lane at pure
    SRD's one, 16 at the colloids' 7.3, a warp at the Poiseuille slit's 9.2
    and beyond; the buckets hold at least twice the mean, from 8 to 4,096
    slots."""
    assert CK.group_width(64**3, 64**3) == 1
    assert CK.group_width(237_928, 32_768) == 16
    assert CK.group_width(40_000, 4352) == 32
    assert CK.group_width(0, 100) == 1 and CK.group_width(10**6, 10) == 32
    assert all(CK.group_width(n, 1000) in CK.GROUPS for n in range(0, 40_000, 997))
    assert [CK.bucket_cap(n, 1000) for n in (0, 1000, 8000, 8001, 10**5, 10**7)] == [
        8, 8, 16, 32, 256, 4096]
    assert CK.bucket_cap(64**3, 64**3) == 8 and CK.bucket_cap(40_000, 4352) == 32


def test_cell_sums_dispatch_and_refusals():
    """On the CPU the cell sums take index_add_ and launch nothing; the
    kernel's wrapper refuses CPU tensors and wrong dtypes."""
    from azplugins_tpu_torch import mpcd as M

    cid, vel, mass, cells = _cell_sum_case("colloid", "cpu")
    before = CK.launches
    got = M._cell_sums(cid, vel, mass, cells)
    want = torch.zeros((cells + 1, 6)).index_add_(0, cid, M._payload(vel, mass))[:cells]
    assert CK.launches == before and torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        CK.cell_sums(cid, vel, mass, cells)
    if torch.cuda.is_available():
        with pytest.raises(TypeError, match="int64"):
            CK.cell_sums(cid.int().cuda(), vel.cuda(), None, cells)


@pytest.mark.cuda
@pytest.mark.parametrize("plates", [False, True], ids=["periodic", "plates"])
def test_advance_graphs_are_the_eager_advance_on_the_card(cuda_device, plates):
    """A small SRD stream's advance as CUDA graphs (K5's clock form and K10
    inside) bitwise its eager advance (K5's host-key form, K10), over two
    chunkings; one K5 and one K10 launch a collision under replay."""
    runs = []
    for eager, chunks in ((True, (17, 6, 23)), (False, (9, 14, 5, 18))):
        g = np.random.default_rng(3)
        L, N = 8.0, 4096
        snap = az.Snapshot(N=2, mpcd_N=N)
        snap.configuration.box = [L, L, L, 0, 0, 0]
        snap.particles.types = ["A"]
        snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
        snap.mpcd.position[:] = (g.random((N, 3)) - 0.5) * [L, L, 0.95 * L]
        snap.mpcd.velocity[:] = g.normal(0, 1.0, (N, 3))
        sim = az.Simulation(device=cuda_device, seed=3)
        sim.create_state_from_snapshot(snap)
        sim.operations.integrator = az.md.Integrator(
            dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
        sim.mpcd_dynamics = az.mpcd.SRD(
            dt=0.02, period=2, cell_size=1.0, kT=1.0, body_force=(0.05, 0.0, 0.0),
            **({"plates": ("z", L)} if plates else {}))
        sim._eager = eager
        before = (dict(RK.launches_by_kernel), CK.launches)
        for n in chunks:
            sim.run(n)
        torch.cuda.synchronize()
        k5 = sum(RK.launches_by_kernel.get(k, 0) - before[0].get(k, 0)
                 for k in ("jax_normal_axis", "jax_normal_axis_clock"))
        assert k5 == CK.launches - before[1] == 23  # 46 steps, period 2
        runs.append(sim)
    eager, graphs = runs
    assert eager._advance_graphs is None and graphs._advance_graphs.replays >= 10
    for key in ("position", "velocity"):
        assert torch.equal(torch.cat(graphs._mpcd[key]).view(torch.int32),
                           torch.cat(eager._mpcd[key]).view(torch.int32)), key


def test_threefry_rounds_are_one_header():
    """The DPD kernel, the random-draw kernels and the pick share
    csrc/threefry.cuh's rounds; none keeps a copy of its own."""
    for source in (DK._SOURCE, RK._SOURCE, XK._SOURCE):
        text = (cuda_build.CSRC / source).read_text()
        assert '#include "threefry.cuh"' in text
        assert "rotl32(" not in text and "0x1BD11BDA" not in text
    header = (cuda_build.CSRC / "threefry.cuh").read_text()
    assert "template <int ROUNDS>" in header and "0x1BD11BDAu" in header


# -- the random draws against the JAX package --------------------------------
# tests/torch_rng_reference.npz holds what azplugins_tpu.core.rng and
# jax.random.normal draw at the paths' shapes (made on the CPU by
# tests/torch_rng_reference.py; tests/test_torch_rng.py checks it is
# current), so the kernels are held to the reference on a GPU machine with
# no JAX: K4 bit for bit, K5 within the port's 4-ulp bar for normals
# (tests/test_torch_mpcd.py). The CPU case holds the plain versions alike.
import torch_rng_reference as REF  # noqa: E402

REFERENCE_NORMAL_ULP = 4


@pytest.fixture(scope="module")
def reference_draws():
    return REF.load()


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def draw_device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device(request.param)


def _launched(name, before, device, n=1):
    """The draw launched its kernel n times on CUDA and nothing on the CPU."""
    return RK.launches_by_kernel.get(name, 0) - before == (n if device.type == "cuda" else 0)


@pytest.mark.parametrize("case", range(len(REF.BIT_CASES)))
def test_particle_bits_are_the_references(draw_device, reference_draws, case):
    stream, seed, t, n, n_words = REF.BIT_CASES[case]
    before = RK.launches_by_kernel.get("particle_bits", 0)
    words = RNG.particle_bits(stream, seed, t, torch.as_tensor(REF.tags(n), device=draw_device),
                              n_words)
    assert _launched("particle_bits", before, draw_device)
    assert REF.digest([w.cpu().numpy() for w in words]) == reference_draws["bits"][case]


@pytest.mark.parametrize("case", range(len(REF.UNIFORM_CASES)))
def test_particle_uniform3_is_the_references(draw_device, reference_draws, case):
    stream, seed, t, n, low, high = REF.UNIFORM_CASES[case]
    before = RK.launches_by_kernel.get("particle_bits", 0)
    u = RNG.particle_uniform3(stream, seed, t, torch.as_tensor(REF.tags(n), device=draw_device),
                              low, high)
    assert _launched("particle_bits", before, draw_device)
    assert REF.digest([u.cpu().numpy()]) == reference_draws["uniform"][case]


@pytest.mark.parametrize("case", range(len(REF.NORMAL_CASES)))
def test_jax_normal_is_the_references_within_bar(draw_device, reference_draws, case):
    """K5's normals (the two-key form's second key) and their plain version
    within the 4-ulp bar of jax.random.normal."""
    name, seed, fold, shape = REF.NORMAL_CASES[case]
    before = RK.launches_by_kernel.get("jax_normal_axis", 0)
    _, x = RNG.jax_normal_axis((0, 42), shape[0], draw_device,
                               RNG.jax_fold_in(RNG.jax_key(seed), fold))
    assert _launched("jax_normal_axis", before, draw_device)
    assert tuple(x.shape) == shape and x.dtype == torch.float32
    got = x.cpu().numpy().reshape(-1)[REF.normal_sample(x.numel())]
    want = reference_draws[f"normal_{name}"]
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    print(f"jax_normal {name} {shape} on {draw_device.type}: max {int(ulps.max())} ulp from "
          f"jax.random.normal, {int((ulps > 0).sum())} of {ulps.size} sampled values differ")
    assert ulps.max() <= REFERENCE_NORMAL_ULP


# -- the integrator and the drift check (csrc/integrate.cu) -------------------
# K6-K9, and K7+K6 in one launch (step1 with a drift check) also against K7
# then K6, against their plain versions on the card, bitwise: the same float32
# operations, each rounded on its own, in the same order (K9's sums of 4 in
# the card's torch.sum order, its cos and sin the same libm), the same
# draws. Shapes: ragged tails around K6's and K8's blocks (1 to 4,097
# slots), the headline's 82,944 slots, the patchy colloids' 194,672 and
# 300,001, past K6's 1,024 blocks (kDriftMaxBlocks) of 256 slots: its grid
# stride.
import torch_integrate_cases as IC  # noqa: E402

INTEGRATE_SIZES = [1, 31, 255, 257, 1001, 1025, 4097, 82944, 194672, 300001]
STATE_FIELDS = ("position", "velocity", "acceleration", "orientation", "angmom", "net_torque")


def _slot_state(n, seed, device):
    arrays = IC.slot_arrays(n, seed)
    return IC.state_of(az, arrays, lambda a: torch.as_tensor(a, device=device)), arrays


def _same_bits(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{what}: {int((got.view(torch.int32) != want.view(torch.int32)).sum())} values differ")


@pytest.mark.cuda
@pytest.mark.parametrize("n", INTEGRATE_SIZES)
@pytest.mark.parametrize("rotational", [False, True])
@pytest.mark.parametrize("case", IC.CASES)
def test_step_kernels_bitwise_plain(cuda_device, case, rotational, n):
    """step1 (K7, K9 mode 0) and step2 (K8, K9 mode 1 or 2) against the
    plain versions on the same state, every field bit for bit; the state
    given is never written."""
    state, _ = _slot_state(n, n + len(case), cuda_device)
    kept = {k: getattr(state, k).clone() for k in STATE_FIELDS}
    m = IC.attached(IC.methods(az, case), rotational, cuda_device)
    for step, dt, t in (("step1", 0.005, 777), ("step2", 0.005, 2**32 + 9), ("step2", 0.0, 3)):
        before = dict(IK.launches_by_kernel)
        got = getattr(m, step)(state, dt, t, 12345)
        want = getattr(m, f"_{step}_plain")(state, dt, t, 12345)
        for k in ("step1", "step2", "no_squish"):
            n_want = (k == step) + (k == "no_squish" and rotational)
            assert IK.launches_by_kernel.get(k, 0) - before.get(k, 0) == n_want, k
        for k in STATE_FIELDS:
            _same_bits(getattr(got, k), getattr(want, k), f"{case} {step} dt={dt} {k}")
    for k, v in kept.items():
        assert torch.equal(getattr(state, k), v), f"{k} was written"


def _drift_inputs(n, seed, kind, device, offset=0):
    """Positions, reference positions and tags of ``kind``; with ``offset``
    each a view ``x[offset:]`` of a larger contiguous tensor."""
    a = IC.slot_arrays(n + offset, seed)
    pos, ref, tag = (a[k][offset:] for k in ("position", "ref_position", "tag"))
    if not (tag >= 0).any():
        tag[0] = 0
    live = np.flatnonzero(tag >= 0)
    if kind == "tie":
        pos[live[:2]] = ref[live[:2]] + np.float32([0.3, 0.1, 0.0])
    elif kind == "nan":
        pos[live[len(live) // 2], 1] = np.nan
    elif kind == "nan_empty":  # an empty slot's position NaN: the verdict ignores it
        if live.size == n:
            tag[-1] = -1
        pos[np.flatnonzero(tag < 0)[0], 1] = np.nan
    elif kind == "empty":
        tag[:] = -1
    elif kind == "exact":  # the drift equals the buffer's half on two slots
        pos[:] = ref
        pos[live[:2], 0] = ref[live[:2], 0] + np.float32(0.25)
    return [torch.as_tensor(a[k], device=device)[offset:]
            for k in ("position", "ref_position", "tag")]


DRIFT_KINDS = ("random", "tie", "nan", "nan_empty", "empty", "exact")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", INTEGRATE_SIZES)
@pytest.mark.parametrize("kind", DRIFT_KINDS)
def test_drift_check_kernel_bitwise_plain(cuda_device, kind, n, offset):
    """K6 on a whole layout (the verdict ORed into viol) and on 4 shards
    (each shard's top two, then the combine) against the plain versions;
    also on slot views one row into larger tensors (offset 1)."""
    pos, ref, tag = _drift_inputs(n, n, kind, cuda_device, offset)
    if offset:
        assert pos.storage_offset() == 3 and tag.storage_offset() == 1
    if kind == "nan_empty":
        d = types.SimpleNamespace(position=pos, tag=tag, device=pos.device)
        top = D._drift_top_two_plain(d, types.SimpleNamespace(ref_position=ref))
        assert not torch.isnan(top).any()
    dense = types.SimpleNamespace(position=pos, tag=tag, device=pos.device)
    meta = types.SimpleNamespace(ref_position=ref)
    for buffer in (0.5, 0.05, 0.6):
        spec = types.SimpleNamespace(buffer=buffer)
        want = D._needs_rebin_plain(dense, meta, spec)
        for viol0 in (False, True):
            viol = torch.tensor(viol0, device=cuda_device)
            before = IK.launches_by_kernel.get("drift_check", 0)
            got = D.needs_rebin(dense, meta, spec, viol)
            assert IK.launches_by_kernel["drift_check"] == before + 1
            assert got.dtype == torch.bool and bool(got) == (viol0 or bool(want))
            assert not bool(viol) or viol0
        cuts = np.array_split(np.arange(n), 4) if n >= 4 else [np.arange(n)]
        tops, plain = [], []
        for c in cuts:
            c = torch.as_tensor(c, device=cuda_device)
            d = types.SimpleNamespace(position=pos[c], tag=tag[c], device=pos.device)
            m = types.SimpleNamespace(ref_position=ref[c])
            tops.append(D.drift_top_two(d, m))
            plain.append(D._drift_top_two_plain(d, m))
        got, want2 = torch.cat(tops), torch.cat(plain)
        assert torch.equal(torch.isnan(got), torch.isnan(want2))
        fin = ~torch.isnan(want2)
        assert torch.equal(got[fin].view(torch.int32), want2[fin].view(torch.int32))
        verdict = D.needs_rebin_of(got, spec, torch.tensor(False, device=cuda_device))
        assert bool(verdict) == bool(D._needs_rebin_of_plain(want2, spec)) == bool(want)


_SLOT_FIELDS = ("position", "tag", "velocity", "typeid", "image", "orientation", "mass",
                "diameter", "charge", "net_force", "acceleration", "angmom", "moment_inertia",
                "net_torque")


def _slots(state, c):
    """``state`` on the slots ``c`` (an index tensor)."""
    return state.replace(**{k: getattr(state, k)[c] for k in _SLOT_FIELDS})


def _step1_drift_case(n, seed, kind, device, offset=0):
    """A slot state whose positions, reference positions and tags are
    ``_drift_inputs``' of ``kind`` (every field a view ``x[offset:]`` of a
    larger tensor) and its meta. The two slots "tie" and "exact" place
    keep no velocity and no acceleration, so the half step keeps their
    drift."""
    pos, ref, tag = _drift_inputs(n, seed, kind, device, offset)
    a = IC.slot_arrays(n + offset, seed)
    state = IC.state_of(az, a, lambda x: torch.as_tensor(x, device=device)[offset:])
    state = state.replace(position=pos, tag=tag)
    if kind in ("tie", "exact"):
        live = torch.nonzero(tag >= 0).flatten()[:2]
        state.velocity[live] = 0.0
        state.acceleration[live] = 0.0
    return state, types.SimpleNamespace(ref_position=ref)


def _launched_integrate(before):
    return {k: IK.launches_by_kernel.get(k, 0) - before.get(k, 0)
            for k in ("step1", "step1_drift", "drift_check")}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", INTEGRATE_SIZES)
@pytest.mark.parametrize("kind", DRIFT_KINDS)
def test_step1_drift_kernel_bitwise(cuda_device, kind, n, offset):
    """K7+K6 in one launch (``Method.step1`` with a drift check) against
    K7 then K6 and against the plain step1 then the plain check, bit for
    bit: every drift kind, with and without a filter's sel, the verdict
    (three buffers, the flag clear and set) and the top two (whole and on 4
    cuts, then the combine); one ``step1_drift`` launch a call and no other
    integrator launch."""
    state, meta = _step1_drift_case(n, n + 3, kind, cuda_device, offset)
    if offset:
        assert state.velocity.storage_offset() == 3 and state.tag.storage_offset() == 1
    dt, t, seed = 0.005, 777, 12345
    DriftCheck = az.md.methods.DriftCheck
    for filt in (None, ["B"]):
        kw = {"filter": az.md.filter.Type(filt)} if filt else {}
        m = IC.attached(az.md.methods.ConstantVolume(**kw), False, cuda_device)
        k7 = m.step1(state, dt, t, seed)
        plain = m._step1_plain(state, dt, t, seed)
        what = f"{kind} n={n} offset={offset} filter={filt}"
        for buffer in (0.5, 0.05, 0.6):
            spec = types.SimpleNamespace(buffer=buffer)
            for viol0 in (False, True):
                viol = torch.tensor(viol0, device=cuda_device)
                before = dict(IK.launches_by_kernel)
                got, verdict = m.step1(state, dt, t, seed, DriftCheck(meta, spec, viol))
                assert _launched_integrate(before) == {"step1": 0, "step1_drift": 1,
                                                       "drift_check": 0}, what
                for k in ("position", "velocity"):
                    _same_bits(getattr(got, k), getattr(k7, k), f"{what} {k} against K7")
                    _same_bits(getattr(got, k), getattr(plain, k), f"{what} {k} against plain")
                k6 = D.needs_rebin(k7, meta, spec, viol)
                want = viol | D._needs_rebin_plain(plain, meta, spec)
                assert verdict.dtype == torch.bool and verdict.shape == ()
                assert bool(verdict) == bool(k6) == bool(want), (what, buffer, viol0)
                assert not bool(viol) or viol0
        # the top two: whole, then each of 4 cuts and their combine
        cuts = np.array_split(np.arange(n), 4) if n >= 4 else [np.arange(n)]
        whole = [(state, meta, plain)]
        parts = []
        for c in cuts:
            c = torch.as_tensor(c, device=cuda_device)
            cut = types.SimpleNamespace(ref_position=meta.ref_position[c])
            parts.append((_slots(state, c), cut, _slots(plain, c)))
        for which, layouts in (("whole", whole), ("cuts", parts)):
            tops, plains = [], []
            for st, mt, pl in layouts:
                before = dict(IK.launches_by_kernel)
                got, top = m.step1(st, dt, t, seed, DriftCheck(mt, spec, None))
                assert _launched_integrate(before)["step1_drift"] == 1
                assert top.shape == (2,) and top.dtype == torch.float32
                _same_bits(got.position, pl.position, f"{what} {which} position")
                k6 = D.drift_top_two(m.step1(st, dt, t, seed), mt)
                want = D._drift_top_two_plain(pl, mt)
                for other, name in ((k6, "K6"), (want, "plain")):
                    assert torch.equal(torch.isnan(top), torch.isnan(other)), (what, which, name)
                    fin = ~torch.isnan(other)
                    assert torch.equal(top[fin].view(torch.int32), other[fin].view(torch.int32)), (
                        what, which, name)
                tops.append(top)
                plains.append(want)
            got = D.needs_rebin_of(torch.cat(tops), spec, torch.tensor(False, device=cuda_device))
            want = D._needs_rebin_of_plain(torch.cat(plains), spec)
            assert bool(got) == bool(want) == bool(D._needs_rebin_plain(plain, meta, spec)), (
                what, which)


# K8's instantiations: (mode, flow field); each with and without a filter
STEP2_MODES = [("nve", False), ("noiseless", False), ("noiseless", True), ("noisy", False),
               ("noisy", True)]


def _step2_method(mode, flow, sel, device):
    kw = {"filter": az.md.filter.Type(["B"])} if sel else {}
    if mode == "nve":
        return IC.attached(az.md.methods.ConstantVolume(**kw), False, device)
    if flow:
        m = az.md.methods.LangevinFlow(kT=1.3, flow_field=az.flow.ParabolicFlow(2.0, IC.L / 2),
                                       default_gamma=0.7, noiseless=mode == "noiseless", **kw)
    else:
        m = az.md.methods.Langevin(kT=1.3, default_gamma=0.7, noiseless=mode == "noiseless", **kw)
    m.gamma["B"] = 1.9
    return IC.attached(m, False, device)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("sel", [False, True])
@pytest.mark.parametrize("mode,flow", STEP2_MODES)
@pytest.mark.parametrize("n", [257, 82944])
def test_step2_kernel_every_instantiation(cuda_device, n, mode, flow, sel, offset):
    """Each of K8's ten instantiations (NVE, noiseless and noisy Langevin,
    the Langevin ones with and without a flow field; each with and without
    a filter's sel) against the plain step2, bit for bit, one launch; also
    on a state whose fields are views one row into larger tensors."""
    a = IC.slot_arrays(n + offset, n + 5)
    state = IC.state_of(az, a, lambda x: torch.as_tensor(x, device=cuda_device)[offset:])
    assert state.velocity.storage_offset() == 3 * offset
    m = _step2_method(mode, flow, sel, cuda_device)
    before = IK.launches_by_kernel.get("step2", 0)
    got = m.step2(state, 0.005, 2**32 + 9, 12345)
    assert IK.launches_by_kernel["step2"] == before + 1
    want = m._step2_plain(state, 0.005, 2**32 + 9, 12345)
    for k in ("velocity", "acceleration"):
        _same_bits(getattr(got, k), getattr(want, k), f"{mode} flow={flow} sel={sel} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("flow", [False, True])
def test_step2_kernel_many_types(cuda_device, flow):
    """K8 with more gamma types than its block has threads (300, each
    with its own gamma: the table is staged in shared memory in rounds)
    against the plain step2, bit for bit."""
    n, names = 4097, [f"T{k}" for k in range(300)]
    a = IC.slot_arrays(n, 31)
    g = np.random.default_rng(32)
    a["typeid"] = np.where(a["tag"] >= 0, g.integers(0, len(names), n), -1).astype(np.int32)
    state = IC.state_of(az, a, lambda x: torch.as_tensor(x, device=cuda_device))
    if flow:
        m = az.md.methods.LangevinFlow(kT=1.3, flow_field=az.flow.ParabolicFlow(2.0, IC.L / 2))
    else:
        m = az.md.methods.Langevin(kT=1.3)
    for name in names:
        m.gamma[name] = float(g.uniform(0.1, 3.0))
    m = IC.attached(m, False, cuda_device, names)
    assert m._gamma_table.unique().numel() == len(names)
    got = m.step2(state, 0.005, 77, 12345)
    want = m._step2_plain(state, 0.005, 77, 12345)
    for k in ("velocity", "acceleration"):
        _same_bits(getattr(got, k), getattr(want, k), f"flow={flow} {k}")


@pytest.mark.cuda
def test_integrate_kernels_refuse_what_they_cannot_take(cuda_device):
    state, _ = _slot_state(64, 0, cuda_device)
    # K8 stages at most 8,192 gamma types (kStep2MaxTypes) in shared memory
    big = IK.Noise(torch.ones(8193, device=cuda_device), RNG.Stream.LANGEVIN, 1, 0, 1.0, True)
    with pytest.raises(RuntimeError, match="az_step2"):
        IK.step2(state.tag, None, state.typeid, state.velocity, state.acceleration,
                 state.net_force, state.mass, 0.005, big)
    with pytest.raises(TypeError, match="float32"):
        IK.step1(state.tag, None, state.position.double(), state.velocity, state.acceleration,
                 0.005)
    with pytest.raises(ValueError, match="shape"):
        IK.step1(state.tag[:10], None, state.position, state.velocity, state.acceleration,
                 0.005)
    with pytest.raises(ValueError, match="mode"):
        IK.no_squish(2, state.tag, None, state.typeid, state.orientation, state.angmom,
                     state.moment_inertia, state.net_torque, 0.005)
    with pytest.raises(ValueError, match="shape"):
        IK.step1_drift(state.tag, None, state.position, state.velocity, state.acceleration,
                       0.005, state.position[:10], 0.4, torch.tensor(False, device=cuda_device))
    with pytest.raises(ValueError, match="viol"):
        IK.step1_drift(state.tag, None, state.position, state.velocity, state.acceleration,
                       0.005, state.position, 0.4, torch.tensor([False], device=cuda_device))
    before = IK.launches
    empty = torch.zeros((0, 3), device=cuda_device)
    x, v = IK.step1(state.tag[:0], None, empty, empty, empty, 0.005)
    assert x.shape == (0, 3) and IK.launches == before
    with pytest.raises(ValueError, match="at least one slot"):
        IK.step1_drift(state.tag[:0], None, empty, empty, empty, 0.005, empty, 0.4)
    assert IK.launches == before


# -- the integrator and the drift check against the JAX package ---------------
# tests/torch_integrate_reference.npz holds the reference's one step1 +
# step2 of every method case and its drift verdicts on the numpy states of
# torch_integrate_cases.py (made on the CPU by
# tests/torch_integrate_reference.py; tests/test_torch_integrate.py checks
# it is current), so K6-K9 are held to the reference on a GPU machine with
# no JAX: the step at the one-step bars of test_torch_simulation.py, the
# verdicts exactly. The CPU case holds the plain versions alike.
import torch_integrate_reference as IREF  # noqa: E402


@pytest.fixture(scope="module")
def reference_integration():
    return IREF.load()


@pytest.mark.parametrize("rotational", [False, True])
@pytest.mark.parametrize("case", IC.CASES)
def test_step_is_the_references(draw_device, reference_integration, case, rotational):
    """step1 + step2 through K7, K8 (and K9) on the card, the plain
    versions on the CPU, against the reference's step on the same inputs;
    a field the step does not write keeps its input's bits."""
    before = dict(IK.launches_by_kernel)
    s = IREF.one_step(az, case, rotational,
                      lambda a: IC.state_of(az, a, lambda x: torch.as_tensor(x, device=draw_device)),
                      draw_device)
    card = int(draw_device.type == "cuda")
    launched = {k: IK.launches_by_kernel.get(k, 0) - before.get(k, 0)
                for k in ("step1", "step2", "no_squish")}
    assert launched == {"step1": card, "step2": card, "no_squish": 2 * card * rotational}
    for k in IREF.written(rotational):
        IREF.assert_close(getattr(s, k).cpu().numpy(),
                          reference_integration[IREF.key(case, rotational, k)], k,
                          f"{case} rotational={rotational} {k} on {draw_device.type}")
    if not rotational:
        a = IC.slot_arrays(IREF.N, IREF.STATE_SEED)
        for k in ("orientation", "angmom"):
            assert np.array_equal(getattr(s, k).cpu().numpy().view(np.int32),
                                  a[k].view(np.int32)), k


@pytest.mark.parametrize("kind", IC.DRIFT_KINDS)
def test_drift_check_is_the_references(draw_device, reference_integration, kind):
    """K6 on the card, the plain version on the CPU: the reference's
    verdict at each buffer, whole and from 4 shards' top twos, and the
    violation flag ORed in."""
    a = IC.drift_arrays(kind, IREF.N, IREF.DRIFT_SEED)
    pos, ref, tag = (torch.as_tensor(a[k], device=draw_device)
                     for k in ("position", "ref_position", "tag"))
    dense = types.SimpleNamespace(position=pos, tag=tag, device=pos.device)
    meta = types.SimpleNamespace(ref_position=ref)
    cuts = [torch.as_tensor(c, device=draw_device) for c in np.array_split(np.arange(IREF.N), 4)]
    want = reference_integration["drift"][IC.DRIFT_KINDS.index(kind)]
    before = IK.launches_by_kernel.get("drift_check", 0)
    for buffer, verdict in zip(IREF.BUFFERS, want):
        spec = types.SimpleNamespace(buffer=buffer)
        for viol in (False, True):
            got = D.needs_rebin(dense, meta, spec, torch.tensor(viol, device=draw_device))
            assert bool(got) == (viol or bool(verdict)), (buffer, viol)
        tops = torch.cat([D.drift_top_two(
            types.SimpleNamespace(position=pos[c], tag=tag[c], device=pos.device),
            types.SimpleNamespace(ref_position=ref[c])) for c in cuts])
        got = D.needs_rebin_of(tops, spec, torch.tensor(False, device=draw_device))
        assert bool(got) == bool(verdict), (buffer, "4 shards")
    card = int(draw_device.type == "cuda")
    assert IK.launches_by_kernel.get("drift_check", 0) - before == card * len(IREF.BUFFERS) * 7


@pytest.mark.parametrize("case", IC.CASES)
def test_step1_drift_is_the_references(draw_device, reference_integration, case):
    """``Method.step1`` with the drift check (K7+K6 in one launch on the
    card, the plain step and check on the CPU) against the reference's
    step1 and its ``needs_rebin`` on the new positions: positions and
    velocities bit for bit, the verdict at each buffer (the one the drift
    just meets and the float32 below it among them) with the flag clear
    and set, and from 4 cuts' top twos."""
    a = IC.slot_arrays(IREF.N, IREF.STATE_SEED)
    state = IC.state_of(az, a, lambda x: torch.as_tensor(x, device=draw_device))
    meta = types.SimpleNamespace(ref_position=torch.as_tensor(a["ref_position"],
                                                              device=draw_device))
    m = IC.attached(IC.methods(az, case), False, draw_device)
    row = IC.CASES.index(case)
    buffers = reference_integration["step1_buffers"][row]
    verdicts = reference_integration["step1_drift"][row]
    assert list(verdicts[-2:]) == [False, True]  # just met, then exceeded
    cuts = [torch.as_tensor(c, device=draw_device) for c in np.array_split(np.arange(IREF.N), 4)]
    DriftCheck = az.md.methods.DriftCheck
    before = dict(IK.launches_by_kernel)
    for buffer, verdict in zip(buffers, verdicts):
        spec = types.SimpleNamespace(buffer=float(buffer))
        for viol in (False, True):
            s, got = m.step1(state, IREF.DT, IREF.TIMESTEP, IREF.SEED,
                             DriftCheck(meta, spec, torch.tensor(viol, device=draw_device)))
            assert bool(got) == (viol or bool(verdict)), (buffer, viol)
            for k in ("position", "velocity"):
                want = reference_integration[IREF.key(case, False, f"step1_{k}")]
                assert np.array_equal(getattr(s, k).cpu().numpy().view(np.int32),
                                      want.view(np.int32)), (k, buffer)
        tops = [m.step1(_slots(state, c), IREF.DT, IREF.TIMESTEP, IREF.SEED,
                        DriftCheck(types.SimpleNamespace(ref_position=meta.ref_position[c]),
                                   spec, None))[1] for c in cuts]
        got = D.needs_rebin_of(torch.cat(tops), spec, torch.tensor(False, device=draw_device))
        assert bool(got) == bool(verdict), (buffer, "4 cuts")
    card = int(draw_device.type == "cuda")
    assert _launched_integrate(before) == {"step1": 0, "step1_drift": card * len(buffers) * 6,
                                           "drift_check": card * len(buffers)}


# -- the clock forms: the draws of a CUDA graph ---------------------------------
# Under core/rng.py's device_clock, K2, K4, K8 and K9 read their key's
# timestep word from a clock on the card ((uint32)(clock + offset)) instead
# of the host's int, so a graph's replays draw at the clock's timestep. The
# clock here lies 3 steps behind the host's and the draws are made 3 steps
# after its base: the same bits as the host form, past 2**32 too.
CLOCK_STEPS = [0, 7, 2**32 - 1, 2**32 + 5]


def _clock_and_host(device, t, draw):
    """``draw(timestep)`` keyed on the host's ``t``, then on a device clock
    holding ``t - 3`` at offset 3: (clock form, host form)."""
    want = draw(t)
    clock = torch.tensor(t - 3, dtype=torch.int64, device=device)
    with RNG.device_clock(clock, 1000):
        got = draw(1003)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("t", CLOCK_STEPS)
def test_clock_forms_are_the_host_forms(cuda_device, t):
    tag = torch.arange(-1, 20238, dtype=torch.int32, device=cuda_device)
    before = dict(RK.launches_by_kernel)
    for draw in (lambda s: RNG.particle_uniform3(RNG.Stream.LANGEVIN, 42, s, tag),
                 lambda s: torch.stack(RNG.particle_bits(RNG.Stream.THERMALIZE, 42, s, tag, 5))):
        got, want = _clock_and_host(cuda_device, t, draw)
        assert got.dtype == want.dtype and torch.equal(got, want), f"K4 at {t}"
    assert RK.launches_by_kernel["particle_bits"] - before.get("particle_bits", 0) == 4
    dense, spec, tbl = _dpd_case("orthorhombic", cuda_device)
    got, want = _clock_and_host(cuda_device, t,
                                lambda s: DK.dpd_force(dense, spec, tbl, 1.3, 0.01, 77, s, "all"))
    for k in ("force", "energy", "virial"):
        _same_bits(getattr(got, k), getattr(want, k), f"K2 {k} at {t}")
    state, _ = _slot_state(4097, 5, cuda_device)
    m = IC.attached(IC.methods(az, "langevin"), True, cuda_device)
    before = dict(IK.launches_by_kernel)
    got, want = _clock_and_host(cuda_device, t, lambda s: m.step2(state, 0.005, s, 12345))
    assert IK.launches_by_kernel["step2"] - before.get("step2", 0) == 2
    assert IK.launches_by_kernel["no_squish"] - before.get("no_squish", 0) == 2
    for k in ("velocity", "acceleration", "angmom", "net_torque"):
        _same_bits(getattr(got, k), getattr(want, k), f"K8/K9 {k} at {t}")


# -- the device-kT forms: a variant kT inside a CUDA graph --------------------
# In a run, a variant kT reaches K8 and K9 as a 0-d float32 on the card (the
# chunk's schedule, core/variant.py::value_at), read through a pointer
# instead of the host's float32 argument: the same bits.
DEVICE_KTS = [0.3, 1.0, 1.2345678, 7.5]


@pytest.mark.cuda
@pytest.mark.parametrize("t", CLOCK_STEPS)
@pytest.mark.parametrize("case", ["langevin", "noiseless", "flow", "rotation"])
def test_device_kT_forms_are_the_host_forms(cuda_device, case, t):
    """K8 (noisy Langevin, noiseless, with a flow field) and K9 mode 2
    (Langevin's rotational step2) with kT read from a 0-d float32 on the
    card against the host-kT form, bit for bit, at several kT and at
    timesteps past 2**32; one launch each."""
    state, _ = _slot_state(4097, 5, cuda_device)
    sel = None
    gamma = torch.tensor([0.7, 1.9], dtype=torch.float32, device=cuda_device)
    flow = None
    if case == "flow":
        g = np.random.default_rng(8)
        flow = torch.as_tensor(g.normal(size=(4097, 3)).astype(np.float32), device=cuda_device)
    noisy = case != "noiseless"
    for kT in DEVICE_KTS:
        out = []
        for form in (kT, torch.tensor(np.float32(kT), device=cuda_device)):
            before = dict(IK.launches_by_kernel)
            if case == "rotation":
                noise = IK.Noise(gamma, RNG.Stream.LANGEVIN_ANGULAR, 12345, t, form, noisy)
                got = IK.no_squish(2, state.tag, sel, state.typeid, state.orientation,
                                   state.angmom, state.moment_inertia, state.net_torque, 0.005,
                                   noise)
                kernel = "no_squish"
            else:
                noise = IK.Noise(gamma, RNG.Stream.LANGEVIN, 12345, t, form, noisy)
                got = IK.step2(state.tag, sel, state.typeid, state.velocity, state.acceleration,
                               state.net_force, state.mass, 0.005, noise, flow)
                kernel = "step2"
            assert IK.launches_by_kernel[kernel] == before.get(kernel, 0) + 1
            out.append(got)
        for a, b in zip(*out, strict=True):
            _same_bits(a, b, f"{case}: device kT {kT} at {t}")


@pytest.mark.cuda
def test_device_kT_form_refuses_another_kT_tensor(cuda_device):
    """The device-kT form takes a 0-d float32 on the slots' card: a kT on the
    CPU, of another dtype or shape raises before any launch."""
    state, _ = _slot_state(257, 5, cuda_device)
    gamma = torch.ones(2, dtype=torch.float32, device=cuda_device)
    for bad in (torch.tensor(1.0), torch.tensor(1.0, dtype=torch.float64, device=cuda_device),
                torch.ones(1, dtype=torch.float32, device=cuda_device)):
        noise = IK.Noise(gamma, RNG.Stream.LANGEVIN, 1, 0, bad, True)
        before = IK.launches
        with pytest.raises((ValueError, TypeError)):
            IK.step2(state.tag, None, state.typeid, state.velocity, state.acceleration,
                     state.net_force, state.mass, 0.005, noise)
        assert IK.launches == before


# -- K11: BrownianFlow's step, its draw and the drift check in one launch -----
# BrownianFlow.step1 on the card: K11 alone ("brownian_step") and with the
# drift check ("brownian_step_drift"), against the plain step (then the
# plain check) on the same state, bit for bit: every case the chip's
# [brownian] phase holds, at small sizes, the headline's 82,944 slots among
# them. "zeros" and "zeros_in_a_flow" put a third of the slots at -0 under a
# force of -0 with no noise (IC.signed_zeros): there the plain version's 0
# coefficient times a uniform below 0 is -0, which a flow of -0 keeps and a
# step without a flow (adding its zeros_like flow) makes +0.
BROWNIAN_KERNEL_CASES = [*IC.BROWNIAN_CASES, "zeros", "zeros_in_a_flow"]


def _brownian_case(case, n, device):
    a = IC.slot_arrays(n, n + 7)
    if case.startswith("zeros"):
        a = IC.signed_zeros(a)
        flow = az.flow.ConstantFlow((-0.0,) * 3) if case == "zeros_in_a_flow" else None
        m = az.md.methods.BrownianFlow(kT=1.3, flow_field=flow, noiseless=True)
    else:
        m = IC.brownian_methods(az, case)
    state = IC.state_of(az, a, lambda x: torch.as_tensor(x, device=device))
    meta = types.SimpleNamespace(ref_position=torch.as_tensor(a["ref_position"], device=device))
    return IC.attached(m, False, device), state, meta


def _launched_brownian(before):
    return {k: IK.launches_by_kernel.get(k, 0) - before.get(k, 0)
            for k in ("brownian_step", "brownian_step_drift", "drift_check")}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 4097, 82944])
@pytest.mark.parametrize("case", BROWNIAN_KERNEL_CASES)
def test_brownian_step_kernel_bitwise(cuda_device, case, n):
    """K11 alone and with the drift check against the plain step and check,
    bit for bit, one launch each: positions; the verdict with the flag clear
    and set; the top two, whole and of 4 cuts (a shard's); at timesteps past
    2**32 and at dt = 0 (no noise); kT in its device form (a 0-d float32 on
    the card) and the draws in their clock form (CLOCK_STEPS) the host
    forms' bits."""
    m, state, meta = _brownian_case(case, n, cuda_device)
    spec = types.SimpleNamespace(buffer=0.4)
    DriftCheck = az.md.methods.DriftCheck
    cuts = torch.tensor_split(torch.arange(n, device=cuda_device), 4)
    for dt, t in ((0.005, 777), (0.005, 2**32 + 9), (0.0, 3)):
        what = f"{case} {n} dt={dt} t={t}"
        want = m._step1_brownian(state, dt, t, 12345)
        before = dict(IK.launches_by_kernel)
        _same_bits(m.step1(state, dt, t, 12345).position, want.position, what)
        for viol in (False, True):
            got, verdict = m.step1(state, dt, t, 12345,
                                   DriftCheck(meta, spec, torch.tensor(viol, device=cuda_device)))
            _same_bits(got.position, want.position, f"{what} viol={viol}")
            assert bool(verdict) == (viol or bool(D._needs_rebin_plain(want, meta, spec))), what
        got, top = m.step1(state, dt, t, 12345, DriftCheck(meta, spec, None))
        _same_bits(got.position, want.position, f"{what} top two")
        _same_bits(top, D._drift_top_two_plain(want, meta), f"{what} top two")
        for c in cuts:
            cm = types.SimpleNamespace(ref_position=meta.ref_position[c])
            got, top = m.step1(_slots(state, c), dt, t, 12345, DriftCheck(cm, spec, None))
            _same_bits(got.position, want.position[c], f"{what} cut")
            _same_bits(top, D._drift_top_two_plain(_slots(want, c), cm), f"{what} cut top two")
        assert _launched_brownian(before) == {"brownian_step": 1, "brownian_step_drift": 7,
                                              "drift_check": 0}, what
    table = m._gamma_table.to(cuda_device)
    flow = None if m.flow_field is None else m.flow_field(state.box.wrap(state.position)[0])
    sel = m._selection(state)
    for kT in DEVICE_KTS:
        out = []
        for form in (kT, torch.tensor(np.float32(kT), device=cuda_device)):
            noise = IK.Noise(table, m._rng_stream, 12345, 2**32 + 9, form, not m.noiseless)
            out.append(IK.brownian_step_drift(state.tag, sel, state.typeid, state.position,
                                              state.net_force, 0.005, noise, flow,
                                              meta.ref_position, 0.4, None))
        for a, b in zip(*out, strict=True):
            _same_bits(a, b, f"{case}: device kT {kT}")
    for t in CLOCK_STEPS:
        got, want = _clock_and_host(cuda_device, t,
                                    lambda s: m.step1(state, 0.005, s, 12345).position)
        _same_bits(got, want, f"{case}: clock form at {t}")
        (got, top), (want, want_top) = _clock_and_host(
            cuda_device, t, lambda s: m.step1(state, 0.005, s, 12345, DriftCheck(meta, spec, None)))
        _same_bits(got.position, want.position, f"{case}: clock form at {t}, with the check")
        _same_bits(top, want_top, f"{case}: clock form at {t}, the top two")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("sel", [False, True])
@pytest.mark.parametrize("n", [257, 82944])
def test_brownian_accel_step2_bitwise(cuda_device, n, sel, offset):
    """BrownianFlow.step2 on the card, K8's acceleration-only instance, against
    the plain step2 bit for bit, one launch; the velocities are the state's
    own tensor; also on a state whose fields are views one row into larger
    tensors."""
    a = IC.slot_arrays(n + offset, n + 9)
    state = IC.state_of(az, a, lambda x: torch.as_tensor(x, device=cuda_device)[offset:])
    kw = {"filter": az.md.filter.Type(["B"])} if sel else {}
    m = IC.attached(az.md.methods.Brownian(kT=1.0, **kw), False, cuda_device)
    before = dict(IK.launches_by_kernel)
    got = m.step2(state, 0.005, 77, 12345)
    assert IK.launches_by_kernel["step2"] == before.get("step2", 0) + 1
    want = m._step2_plain(state, 0.005, 77, 12345)
    _same_bits(got.acceleration, want.acceleration, f"sel={sel} offset={offset}")
    assert got.velocity is state.velocity


def _graph_lj(device, eager, scheduled=False):
    """A small PLJ liquid under Langevin (the headline's path), its rebuild
    interval pinned at 5 steps. ``scheduled``: two types, a Ramp kT and a
    TypeUpdater on Periodic(4), so its steps read the chunk's schedule."""
    n, a = 10, 1.15
    rng = np.random.default_rng(3)
    snap = az.Snapshot(N=n**3)
    L = n * a
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A", "B"] if scheduled else ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    pos = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = pos + rng.uniform(-0.05, 0.05, pos.shape)
    if scheduled:
        snap.particles.typeid[:] = np.arange(n**3) % 2
    sim = az.Simulation(device=device, seed=42)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5,
                                       mode="shift")
    for pair in ((("A", "A"), ("A", "B"), ("B", "B")) if scheduled else (("A", "A"),)):
        lj.params[pair] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.7)
    kT = az.variant.Ramp(1.2, 0.9, 0, 40) if scheduled else 1.2
    if scheduled:
        sim.operations.updaters.append(az.update.TypeUpdater(
            trigger=az.trigger.Periodic(4), inside_type="A", outside_type="B", lo=-1.0, hi=2.0))
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.Langevin(kT=kT, default_gamma=0.5)], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.2)
    sim.auto_tune_after = None
    sim._seg_adapt, sim._seg_len = False, 5
    sim._eager = eager
    return sim


@pytest.mark.cuda
def test_captured_segments_are_eager_segments(cuda_device):
    """A first segment of 5 steps, run eagerly by the graph runner, then 12
    more: the second captured and replayed, then replayed 11 times; every
    slot field, the grid bookkeeping and the kernels' launch counts equal
    the eager loop's, bit for bit."""
    _captured_against_eager(cuda_device, False)


@pytest.mark.cuda
def test_captured_segments_with_a_schedule_are_eager_segments(cuda_device):
    """As above with a Ramp kT (K8's device-kT form, the chunk's values on
    the card) and a TypeUpdater (masked every step under the graphs, fired
    from the host's trigger on the eager loop): bit for bit, typeid too."""
    _captured_against_eager(cuda_device, True)


def _captured_against_eager(cuda_device, scheduled):
    runs = {}
    for eager in (True, False):
        sim = _graph_lj(cuda_device, eager, scheduled)
        sim.run(5)
        before = (dict(IK.launches_by_kernel), PK.launches, sim.steps_run)
        sim.run(60)
        torch.cuda.synchronize()
        launched = ({k: n - before[0].get(k, 0) for k, n in IK.launches_by_kernel.items()},
                    PK.launches - before[1], sim.steps_run - before[2])
        runs[eager] = (sim, launched)
    (eager, e_launched), (graphs, g_launched) = runs[True], runs[False]
    assert eager._runner is None and graphs._runner.captures == 1
    assert graphs._runner.replays >= 10 and eager.viol_replays == graphs.viol_replays
    assert g_launched == e_launched and e_launched[2] >= 60
    for name in ("position", "velocity", "acceleration", "net_force", "tag", "image", "typeid"):
        assert torch.equal(getattr(graphs._dense, name), getattr(eager._dense, name)), name
    for name in ("ref_position", "overflow", "n_builds", "max_occ"):
        assert torch.equal(getattr(graphs._meta, name), getattr(eager._meta, name)), name


# -- the velocity bins and the bond scatter through K10 ----------------------
def _bins_case(device, n=20_000, seed=6):
    g = np.random.default_rng(seed)
    coords = torch.as_tensor(((g.random((n, 3)) - 0.5) * 24.0).astype(np.float32), device=device)
    vel = torch.as_tensor(g.normal(size=(n, 3)).astype(np.float32), device=device)
    mass = torch.as_tensor((g.random(n) + 0.5).astype(np.float32), device=device)
    select = torch.as_tensor(g.random(n) < 0.8, device=device)
    return coords, vel, mass, select


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cartesian", "cylindrical"])
def test_velocity_bins_on_the_card_are_bitwise(cuda_device, kind):
    """The velocity computes' bins on the card (K10's mass and momentum
    columns) are the same bits in two calls and bitwise the plain ordered
    sum on the card; the Cartesian bins, whose ids the card and the CPU
    form alike, bitwise the CPU's index_add_ too."""
    from azplugins_tpu_torch import mpcd as M
    from azplugins_tpu_torch.ops import binning as B

    coords, vel, mass, select = _bins_case(cuda_device)
    bins, lo, hi = (16, 12, 10), (-10.0, -10.0, -10.0), (10.0, 10.0, 10.0)
    if kind == "cylindrical":
        coords, vel = B.cylindrical_coords(coords, vel)
        bins, lo, hi = (12, 16, 10), (0.0, 0.0, -10.0), (12.0, 2 * np.pi, 10.0)
    before = CK.launches
    first = B.bin_particles(coords, vel, mass, select, bins, lo, hi)
    again = B.bin_particles(coords, vel, mass, select, bins, lo, hi)
    assert CK.launches == before + 2
    idx, total = B.bin_ids(coords, select, bins, lo, hi)
    plain = M._cell_sums_plain(idx, M._payload(vel, mass), total)[:, 1:5]
    for got, want, what in ((first, again, "two calls"),
                            (first, (plain[:, 0], plain[:, 1:]), "the plain ordered sum")):
        for x, y in zip(got, want, strict=True):
            _same_bits(x.contiguous(), y.contiguous(), f"{kind}: {what}")
    if kind == "cartesian":
        cpu = B.bin_particles(coords.cpu(), vel.cpu(), mass.cpu(), select.cpu(), bins, lo, hi)
        for x, y in zip(first, cpu, strict=True):
            _same_bits(x.contiguous().cpu(), y, "cartesian: the CPU")
    assert float(first[0].sum()) > 0


def _branched(device, n_stars=64, L=16.0, seed=5):
    """Branched molecules (stars of a centre and four arms, each centre the
    first member of three bonds and the second of one) under Harmonic bonds
    and a WCA pair force, Langevin."""
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


@pytest.mark.cuda
def test_branched_bonds_on_the_card_repeat_bitwise(cuda_device, monkeypatch):
    """Branched molecules run twice on the card (the bond force's scatter
    through K10, once a step) end in the same bits; their bond forces,
    energies and virials in two calls too, and bitwise the scatter with
    K10's plain ordered form."""
    from azplugins_tpu_torch import mpcd as M

    runs = []
    for _ in range(2):
        sim, bonds = _branched(cuda_device)
        before = CK.launches
        sim.run(60)
        torch.cuda.synchronize()
        assert CK.launches - before >= 60
        runs.append((sim, bonds))
    (a, _), (b, bonds) = runs
    for name in ("position", "velocity", "net_force"):
        _same_bits(getattr(a._dense, name), getattr(b._dense, name), name)
    first, again = (b._compute_single_force(bonds) for _ in range(2))
    monkeypatch.setattr(CK, "cell_sums", lambda cid, vel, mass, cells: M._cell_sums_plain(
        cid, M._payload(vel, mass), cells))
    plain = b._compute_single_force(bonds)
    for name in ("force", "energy", "virial"):
        _same_bits(getattr(first, name), getattr(again, name), f"{name}: two calls")
        _same_bits(getattr(first, name), getattr(plain, name), f"{name}: the plain order")
    assert float(first.force.abs().max()) > 1.0


def _graph_colloid(device, eager):
    """Small colloid hydrodynamics (27 WCA colloids of mass 5 in 2,000 SRD
    solvent, coupled every 10 steps, a body force), its joint collision on
    the segment graphs unless ``eager``."""
    g = np.random.default_rng(9)
    L, n, N_s = 8.0, 3, 2000
    snap = az.Snapshot(N=n**3, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["C"]
    x = (np.arange(n) + 0.5) * (L / n) - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.mass[:] = 5.0
    snap.mpcd.position[:] = (g.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = g.normal(0, 1.0, (N_s, 3))
    sim = az.Simulation(device=device, seed=11)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0 ** (1 / 6),
                    mode="shift")
    lj.params[("C", "C")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.ConstantVolume()], forces=[lj])
    srd = az.mpcd.SRD(dt=0.005, period=10, angle=130.0, cell_size=1.0, kT=1.0,
                      body_force=(0.02, 0.0, 0.0))
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    sim.auto_tune_after = None
    sim._eager = eager
    return sim


@pytest.mark.cuda
def test_captured_coupled_segments_are_eager_segments(cuda_device):
    """The joint collision inside the segment graphs (K5's clock form and
    K10 in a replay) bitwise the eager loop (K5's host-key form) over
    uneven chunks: the colloids, the solvent and its anchor; one K5 and one
    K10 launch a collision either way, and the same force kernels."""
    runs = {}
    for eager in (True, False):
        sim = _graph_colloid(cuda_device, eager)
        before = (dict(RK.launches_by_kernel), CK.launches, PK.launches)
        for n in (7, 23, 40, 30):
            sim.run(n)
        torch.cuda.synchronize()
        k5 = {k: RK.launches_by_kernel.get(k, 0) - before[0].get(k, 0)
              for k in ("jax_normal_axis", "jax_normal_axis_clock")}
        runs[eager] = (sim, k5, CK.launches - before[1], PK.launches - before[2])
    (eager, e_k5, e_k10, e_pk), (graphs, g_k5, g_k10, g_pk) = runs[True], runs[False]
    assert eager._runner is None and graphs._runner.replays >= 5
    assert e_k5 == {"jax_normal_axis": 10, "jax_normal_axis_clock": 0}
    assert g_k5 == {"jax_normal_axis": 0, "jax_normal_axis_clock": 10}
    assert e_k10 == g_k10 == 10 and e_pk == g_pk
    for name in ("position", "velocity", "net_force", "tag"):
        _same_bits(getattr(graphs._dense, name), getattr(eager._dense, name), name)
    for key in ("position", "velocity"):
        _same_bits(torch.cat(graphs._mpcd[key]), torch.cat(eager._mpcd[key]), key)
    for k in (0, 1):
        _same_bits(graphs._mpcd["_srd_anchor"][k][0], eager._mpcd["_srd_anchor"][k][0],
                   f"anchor {k}")
