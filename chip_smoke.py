#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU, end to end.

    python3 chip_smoke.py        # from the repository root; needs one GPU

1. checks for a CUDA device and prints its name and power limit;
2. builds the CUDA kernels from azplugins_tpu_torch/csrc/, one nvcc per
   source, all at once, and prints each build's time and ptxas registers
   and spills;
3. holds the pair kernel, for every isotropic potential in modes
   none/shift/xplor, the DPD kernel and the anisotropic (TwoPatchMorse
   force and torque) kernel in modes none/shift against their plain
   PyTorch versions on the card: small orthorhombic, tilted,
   axis-under-3-cells and two-type shapes, the polymer melt (32,000), DPD
   fluid (21,952) and patchy colloids (27,000) at full size, and the 64k
   headline; the packed schedule's own shapes too: cells filled to exactly
   their capacity, mostly empty cells, a capacity whose stencils are staged
   in rounds (above 256; forced to 64 for TwoPatchMorse), two axes under 3
   cells, 41 types (tables in global memory) and, for TwoPatchMorse, cells
   of more particles than its block has threads; checks that two launches
   give the same bits; prints the candidate pairs per call beside the
   pairs inside r_cut; times each
   kernel against its plain version and computes its bound (the larger of
   its bytes over the memory rate and its operations over the float32
   rate, for this run's inputs);
4. checks that Threefry and the Langevin noise are bitwise the same on the
   GPU and the CPU;
5. runs, through the public API, each with the launch counts set to 0 just
   before it and read just after:
   - the 64k perturbed-LJ Langevin headline (the JAX package's bench
     headline, BASELINE config 1);
   - the DPD fluid (BASELINE config 3, 21,952 particles, ConstantVolume);
   - the polymer melt (BASELINE config 2, 1,280 chains of 25, Quartic
     bonds + ExpandedYukawa, Langevin);
   - the patchy colloids (BASELINE config 4, 27,000 TwoPatchMorse
     particles, Langevin with NO_SQUISH rotation);
   - the evaporating droplet (BASELINE config 5, 20,239 particles: a
     two-type PLJ liquid inside a shrinking SphereArea barrier, an LJ93
     wall, a ParticleEvaporator firing every 25 steps, Langevin in a
     parabolic flow);
   - a short run of every other isotropic potential;
   - colloid hydrodynamics (the JAX package's bench, bench.py:510-569):
     2,744 WCA colloids of mass 5 in a 163,840-particle SRD solvent driven
     by a body force, coupled through the joint collision every 20 steps,
     warmed for 260 steps (the tune at step 150), then 400 timed steps;
   - the SRD Poiseuille slit (examples/mpcd_poiseuille.py at full size:
     40,000 solvent between no-slip plates, 3,000 steps, the profile read
     with CartesianVelocityFieldCompute over 16 bins);
   - pure SRD throughput (bench.py:470-507): 262,144 solvent, a collision
     every step, 500 steps;
   and checks that every pair-force evaluation went through a kernel and
   that the result is physical; on each full-size path the capacity tune
   fires at step 200, and the path prints the capacity and rebuild
   interval before and after it and the device-busy time a step in the 20
   steps before it and after the timed steps; after the headline, the DPD
   fluid, the patchy colloids and the droplet, times their kernel on the
   path's state at two capacities, in two turns (72 and 48; 40 and the
   smallest that fits; 16 and 32; the droplet's before and after the
   tune), and K1 at the droplet's state (K1' at the colloids') against its
   plain version and bound; the colloid path also times one joint collision
   and prints whether two identical colloid runs agree bitwise;
6. prints the kernel summary and, last, the contract line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the result lines.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# kernel bar: per-slot values within atol = BAR * max|ref| and rtol = BAR
BAR = 2e-5
HEADLINE = dict(N_side=40, rho=0.85, seed=12345)
MODES = ("none", "shift", "xplor")
PAIR_REPLACES = "azplugins_tpu/ops/dense.py:1384"  # _pallas_half_pair_force
DPD_REPLACES = "azplugins_tpu/ops/dense.py:1552"  # _pallas_half_dpd_force
ANISO_REPLACES = "azplugins_tpu/ops/dense.py:1914"  # _pallas_half_aniso_force
PATCHY = dict(M_d=1.5, M_r=0.05, r_eq=1.0, omega=20.0, alpha=0.4, repulsion=True)
# the patchy path's warm-up steps and its kT band (PERF.md: the kT curve)
PATCHY_WARM = 8000
PATCHY_KT_BAND = 0.01
# the step at which every path's capacity tune fires (Simulation's default)
TUNE_AT = 200
# the droplet (bench.py build_droplet): 20,239 particles; an evaporator
# firing after steps 0, 25, 50, ... retypes 10 each time, so after 3,000
# steps exactly 1,200 are of type "evaporated"; their kinetic temperature
# relative to the flow must read 1.0 within DROPLET_KT_BAND (4 sigma of a
# 5-sample mean over 1,200 x 3 degrees of freedom); no solvent particle
# lies more than DROPLET_OVERSHOOT beyond the barrier (thermal overshoot
# sqrt(kT / k) = 0.14)
DROPLET_N = 20_239
DROPLET_EVAP_PER_FIRING = 10
DROPLET_PERIOD = 25
DROPLET_KT_BAND = 0.1
DROPLET_OVERSHOOT = 1.0
# colloid hydrodynamics (bench.py bench_mpcd_coupled): the tune fires at
# step 150, 260 warm-up steps (13 collisions), 400 timed; the solvent's kT
# relative to its mean velocity within COLLOID_KT_BAND of 1 (the thermostat
# sets each cell's relative kinetic energy); total momentum within
# COLLOID_P_BAND * m_s N_s of the body force's impulse
COLLOID_TUNE_AT = 150
COLLOID_WARM = 260
COLLOID_STEPS = 400
COLLOID_KT_BAND = 0.03
COLLOID_P_BAND = 1e-4
# the Poiseuille slit (examples/mpcd_poiseuille.py) and pure SRD (bench.py
# bench_mpcd): steps and limits
POISEUILLE_STEPS = 3000
POISEUILLE_BINS = 16
SRD_WARM = 50
SRD_STEPS = 430
SRD_KT_BAND = 0.02

# The least time the card could take for a kernel's work, for the bound:
# H100 SXM HBM3 at 3.35 TB/s, and its float32 rate outside the tensor cores,
# 67 TFLOP/s (NVIDIA's data sheet, at the 700 W limit).
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of one pair evaluation on the force path (want="force"),
# counted from the plain version's formulas with each exp, sqrt, divide,
# pow and log as one: the evaluator, plus the geometry and the
# accumulation that every pair needs (3 subtractions and 5 operations for
# the separation and its square, the cutoff compare, 3 products for the
# force and 3 additions into each member's sums: 18). DPD adds its 13-round
# Threefry (~76 int32 operations, counted at the float32 rate) and the drag;
# TwoPatchMorse its two patch rotations, three exps and the torques, and 6
# more additions for them.
OPS_PER_PAIR = {
    "PerturbedLennardJones": 29, "LJ": 27, "Colloid": 33, "ExpandedYukawa": 31,
    "Hertz": 31, "Morse": 32, "Gaussian": 23, "Yukawa": 28, "DPD": 130, "TwoPatchMorse": 170,
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _import_port():
    sys.path.insert(0, str(HERE))
    import azplugins_tpu_torch as az

    if not Path(az.__file__).resolve().is_relative_to(HERE):
        raise RuntimeError(f"azplugins_tpu_torch imported from {az.__file__}, not this checkout")
    return az


def _cuda_time_ms(fn, reps: int, warm: int = 2) -> float:
    """Device ms per call: CUDA events around ``reps`` calls, queued while
    the stream spins (torch.cuda._sleep), so the calls run back to back and
    the host's launch overhead (tens of us a call) is not timed."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of the card's clock, longer than the queueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _lattice_snapshot(az, counts, rho, jitter, seed, tilt=(0.0, 0.0, 0.0), n_types=1,
                      clustered=False, quats=False, span=1.0):
    """A jittered simple-cubic lattice of counts[0] x counts[1] x counts[2]
    sites at number density rho, filling ``span`` of each edge of a box of
    that shape from its corner (optionally tilted, optionally squeezed along
    x into uneven cell occupancies), with normal(0, 1) velocities (and, with
    ``quats``, random unit orientations)."""
    rng = np.random.default_rng(seed)
    N = int(np.prod(counts))
    a = (1.0 / rho) ** (1.0 / 3.0)
    Ls = [c * a / span for c in counts]
    snap = az.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = (["A", "B", "C", "D"] + [f"t{i}" for i in range(4, n_types)])[:n_types]
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
    f = span * (grid.reshape(-1, 3) + 0.5) / np.asarray(counts)
    if clustered:
        # periodic squeeze: sites crowd (spacing x0.7) around x = -L/2
        f[:, 0] = f[:, 0] - 0.3 * np.sin(2.0 * np.pi * f[:, 0]) / (2.0 * np.pi)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0.0, Ls[1], tilt[2] * Ls[2]],
                  [0.0, 0.0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0.0, jitter, (N, 3))
    snap.particles.velocity[:] = rng.normal(0.0, 1.0, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, n_types, N)
    if quats:
        q = rng.normal(size=(N, 4))
        snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return snap


def _dense_case(az, D, snap, r_cut, buffer, device, cap=None, fields=()):
    """Densify, growing the capacity from ``cap`` (default: the grid's own)
    until the configuration fits, as the simulation does on overflow."""
    state, types, _ = az.core.state_from_snapshot(snap, device)
    spec = D.GridSpec.create(state.box, state.N, r_cut, buffer)
    if cap is not None:
        spec = spec.replace(cap=cap)
    dense, meta = D.densify(state, spec, fields=fields)
    while bool(meta.overflow):
        spec = spec.replace(cap=int(np.ceil((int(meta.max_occ) + 1) / 8.0) * 8))
        dense, meta = D.densify(state, spec, fields=fields)
    return dense, spec, len(types)


def _pairs_inside(D, dense, spec, r_cut):
    """Unordered pairs within ``r_cut`` on this dense state (one type pair),
    counted by the plain stencil loop: the pair work a kernel must do."""

    def count(dx, dy, dz, rsq, mask, j, newton):
        inside = (mask & (rsq > 0) & (rsq < r_cut * r_cut)).to(torch.float32)
        return [inside], [torch.zeros_like(inside)]

    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    (n,) = D._stencil_drive(dense, jb, spec, 1, count)
    total = float(n.double().sum())
    return int(round(total if spec.newton_ok else total / 2))


def _stencil_occupancy(dense, spec):
    """([Dx, Dy, Dz] occupied slots of each cell, of each cell's stencil)."""
    occ = (dense.tag >= 0).reshape(*spec.dims, spec.cap).sum(dim=-1).double()
    around = sum(torch.roll(occ, shifts=tuple(-int(o) for o in off), dims=(0, 1, 2))
                 for off in spec.stencil())
    return occ, around


def _candidates(dense, spec):
    """Candidate pairs a packed-schedule call tests: the sum over cells of
    n_i times the occupied slots of the cell's stencil (its own included)."""
    occ, around = _stencil_occupancy(dense, spec)
    return int((occ * around).sum())


def _check_packed_shapes(stage_entries, cases, threads=0):
    """Each packed-schedule shape is the case it is named for. stage_entries:
    the candidates one staging round of the kernel holds; threads: its
    block's threads."""
    for label, dense, spec, T, *_ in cases:
        occ, around = _stencil_occupancy(dense, spec)
        ok = {
            "full cells": lambda: bool((occ == spec.cap).all()),
            "mostly empty": lambda: float((occ == 0).double().mean()) > 0.75,
            "cap >= 256 in rounds": lambda: spec.cap >= 256 and float(around.max()) > stage_entries,
            "cap 64 in rounds": lambda: spec.cap == 64 and float(around.max()) > stage_entries,
            "cells above kThreads": lambda: spec.newton_ok and float(occ.max()) > threads > 0,
            "two axes under 3": lambda: sorted(spec.dims)[1] < 3,
            "41 types": lambda: T == 41,
        }.get(label, lambda: True)()
        if not ok:
            raise AssertionError(f"{label}: dims {spec.dims}, cap {spec.cap}, T {T} is not the "
                                 "shape it is named for")


def _stage_bytes() -> int:
    """The packed schedule's staging buffer per block (cell_stencil.cuh's
    kStageBytes): a stencil with more candidates is staged in rounds."""
    header = (HERE / "azplugins_tpu_torch" / "csrc" / "cell_stencil.cuh").read_text()
    return int(re.search(r"kStageBytes = (\d+) \* 1024;", header).group(1)) * 1024


def _source_constant(source: str, name: str) -> int:
    """A ``constexpr int name = n;`` of one kernel source under csrc/."""
    text = (HERE / "azplugins_tpu_torch" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _same_bits(name, first, second):
    """Two launches' outputs (ForceResult) bit for bit."""
    for what in ("force", "torque", "energy", "virial"):
        a, b = getattr(first, what), getattr(second, what)
        if a is None and b is None:
            continue
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name}: two launches on the same input differ in {what}")


def _bound(dense, in_bytes, out_bytes, table_bytes, pairs, ops_per_pair):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the pair operations over the float32 rate. The bytes are what the
    function must move: ``in_bytes`` of inputs for each occupied slot only
    (an empty slot's position, type or orientation is never read), the
    4-byte tag of every slot (which marks the occupied ones), ``out_bytes``
    of outputs for every slot, and the tables, each once."""
    S, N = dense.tag.numel(), int((dense.tag >= 0).sum())
    t_bytes = (N * in_bytes + S * (4 + out_bytes) + table_bytes) / MEM_BYTES_PER_S
    t_ops = pairs * ops_per_pair / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def potential_params(name: str, T: int, rng) -> dict:
    """User parameters per type pair at which lattice pairs (r ~ 0.7-3)
    give finite, non-trivial forces (the same ranges as
    tests/test_torch_kernels.py). Colloid radii are 0 under three types."""

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


def _pair_tables(az, potential, T, seed, r_cut, device):
    """Device tables of one potential: params, r_cut (one pair at 0.8 r_cut
    where T > 1) and r_on (0.75 r_cut; one pair at 1.1 r_cut, where xplor
    shifts plainly)."""
    rng = np.random.default_rng(seed)
    if potential == "PerturbedLennardJones" and T == 1:
        host = {"epsilon": np.ones((1, 1)), "sigma": np.ones((1, 1)),
                "attraction_scale_factor": np.full((1, 1), 0.5)}
    else:
        host = potential_params(potential, T, rng)
    pre = az.ops.evaluators.PAIR_POTENTIALS[potential].precompute(host)
    rc = np.full((T, T), r_cut, np.float32)
    rc[0, -1] = rc[-1, 0] = r_cut * 0.8 if T > 1 else r_cut
    r_on = (0.75 * rc).astype(np.float32)
    if T > 1:
        r_on[-1, -1] = 1.1 * rc[-1, -1]

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"params": {k: dev(v) for k, v in pre.items()}, "r_cut": dev(rc), "r_on": dev(r_on)}


def _compare(name, got, ref):
    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    bound = BAR * scale + BAR * ref.abs()
    worst = float((err - bound).max())
    max_err = float(err.max())
    if not torch.isfinite(got).all() or worst > 0:
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {max_err:.3e}, scale {scale:.3e})")
    return max_err, scale


def _compare_result(tag, got, ref, want):
    """Force (and energy and virial for want="all") within the bar. Returns
    the force's max abs error and the worst error relative to its output's
    max |value| over the outputs compared."""
    outputs = [("force", got.force, ref.force)]
    if want == "all":
        outputs += [("energy", got.energy, ref.energy), ("virial", got.virial, ref.virial)]
    errs = [_compare(f"{tag} {what}", g, r) for what, g, r in outputs]
    return errs[0][0], max(err / max(scale, 1e-30) for err, scale in errs)


# ---------------------------------------------------------------------------
# The full-size configurations, through the public API
# ---------------------------------------------------------------------------
def build_headline(az, device):
    """BASELINE config 1, the bench headline: 64k PLJ under Langevin."""
    N_side, rho, seed = HEADLINE["N_side"], HEADLINE["rho"], HEADLINE["seed"]
    N = N_side**3
    L = (N / rho) ** (1.0 / 3.0)
    a = L / N_side
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(N_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=3.0, mode="none"
    )
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    lang = az.md.methods.Langevin(kT=1.0, default_gamma=0.1)
    sim.operations.integrator = az.md.Integrator(dt=0.005, methods=[lang], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, [lj]


def build_dpd(az, device, n_side=28, rho=3.0, seed=5):
    """BASELINE config 3 (bench.py build_dpd_fluid): 28^3 DPD fluid at rho 3,
    A 25, gamma 4.5, s 0.5, r_cut 1, kT 1, ConstantVolume, dt 0.01, from a
    lattice at rest."""
    N = n_side**3
    L = (N / rho) ** (1.0 / 3.0)
    a = L / n_side
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    dpd = az.pair.DPDGeneralWeight(nlist=az.md.nlist.Cell(buffer=0.4), kT=1.0,
                                   default_r_cut=1.0)
    dpd.params[("A", "A")] = dict(A=25.0, gamma=4.5, s=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.01, methods=[az.md.methods.ConstantVolume()], forces=[dpd])
    return sim, [dpd]


def build_polymer(az, device, n_chains=1280, chain_len=25, rho=0.5, seed=14):
    """BASELINE config 2 (bench.py build_polymer_melt): 1,280 straight rods
    of 25 beads at rho 0.5, Quartic scissile bonds + ExpandedYukawa pairs
    (epsilon 2, kappa 1.5, delta 0.5, r_cut 2.5), Langevin kT 1, gamma 0.5,
    dt 0.002."""
    N = n_chains * chain_len
    L = (N / rho) ** (1.0 / 3.0)
    snap = az.Snapshot(N=N, bond_N=n_chains * (chain_len - 1))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.bonds.types = ["backbone"]
    gy = int(np.floor(np.sqrt(n_chains)))
    gz = (n_chains + gy - 1) // gy
    c = np.arange(n_chains)
    y = ((c % gy) + 0.5) * L / gy - L / 2
    z = ((c // gy) + 0.5) * L / gz - L / 2
    x = -0.97 * (chain_len - 1) / 2 + 0.97 * np.arange(chain_len)
    pos = np.zeros((n_chains, chain_len, 3))
    pos[:, :, 0] = x[None, :]
    pos[:, :, 1] = y[:, None]
    pos[:, :, 2] = z[:, None]
    snap.particles.position[:] = pos.reshape(-1, 3)
    first = (c[:, None] * chain_len + np.arange(chain_len - 1)[None, :]).reshape(-1)
    snap.bonds.typeid[:] = 0
    snap.bonds.group[:] = np.stack([first, first + 1], axis=-1)
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    bonds = az.bond.Quartic()
    bonds.params["backbone"] = dict(k=1434.3, r_0=1.5, b_1=-0.7589, b_2=0.0, U_0=67.2234,
                                    sigma=1.0, epsilon=1.0, delta=0.0)
    pairs = az.pair.ExpandedYukawa(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    pairs.params[("A", "A")] = dict(epsilon=2.0, kappa=1.5, delta=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[bonds, pairs])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, [bonds, pairs]


def build_patchy(az, device, n_side=30, a=1.5, seed=2):
    """BASELINE config 4 (bench.py build_patchy): 30^3 patchy colloids on a
    lattice of spacing 1.5 with random unit quaternions, moment of inertia
    0.4, TwoPatchMorse (M_d 1.5, M_r 0.05, r_eq 1, omega 20, alpha 0.4,
    repulsion, r_cut 1.6, mode shift, buffer 0.3), Langevin kT 0.3, gamma 1
    (gamma_r 1), dt 0.002, rotational DOF integrated."""
    N = n_side**3
    L = n_side * a
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["P"]
    x = (np.arange(n_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.moment_inertia[:] = [0.4, 0.4, 0.4]
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    patchy = az.pair.TwoPatchMorse(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.6,
                                   mode="shift")
    patchy.params[("P", "P")] = dict(PATCHY)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=0.3, default_gamma=1.0)], forces=[patchy],
        integrate_rotational_dof=True)
    sim.state.thermalize_particle_momenta(kT=0.3)
    return sim, [patchy]


def build_droplet(az, device, R0=20.0, a=1.1, seed=7):
    """BASELINE config 5 (bench.py build_droplet): a lattice droplet of
    radius 0.93 R0 in a box of 2 R0 + 4; PLJ solvent (epsilon 1, sigma 1,
    lambda 1, r_cut 2.5, buffer 0.4), an "evaporated" type that interacts
    with nothing (epsilon 0); a SphericalHarmonicBarrier (k 50) at
    SphereArea(R0, alpha 0.05); an LJ93 plane wall 0.5 above the box floor;
    a ParticleEvaporator retyping up to 10 solvent particles of the slab
    z in [R0/2, L/2) every 25 steps; LangevinFlow kT 1, gamma 1, in a
    parabolic flow of mean 0.5 across L - 2; dt 0.002."""
    L = 2 * R0 + 4.0
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    snap = az.Snapshot(N=len(pts))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pts
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("solvent", "solvent")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0)
    lj.params[("solvent", "evaporated")] = dict(epsilon=0.0, sigma=1.0,
                                                attraction_scale_factor=0.0)
    lj.params[("evaporated", "evaporated")] = dict(epsilon=0.0, sigma=1.0,
                                                   attraction_scale_factor=0.0)
    barrier = az.external.SphericalHarmonicBarrier(
        location=az.variant.SphereArea(R0=R0, alpha=0.05))
    barrier.params["solvent"] = dict(k=50.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    wall = az.external.wall.LJ93(
        walls=[az.external.wall.Plane(origin=(0, 0, -L / 2 + 0.5), normal=(0, 0, 1))])
    wall.params["solvent"] = dict(epsilon=1.0, sigma=1.0, r_cut=3.0)
    wall.params["evaporated"] = dict(epsilon=0.0, sigma=1.0, r_cut=3.0)
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(DROPLET_PERIOD), solvent_type="solvent",
        evaporated_type="evaporated", lo=R0 / 2, hi=L / 2, N_evap_max=DROPLET_EVAP_PER_FIRING))
    flow = az.flow.ParabolicFlow(mean_velocity=0.5, separation=L - 2.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.LangevinFlow(kT=1.0, flow_field=flow, default_gamma=1.0)],
        forces=[lj, barrier, wall])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, [lj, barrier, wall]


def build_colloid(az, device, L=32.0, n=14):
    """Colloid hydrodynamics (bench.py bench_mpcd_coupled): n^3 = 2,744 LJ
    WCA colloids (epsilon 1, sigma 1, r_cut 2^(1/6), shift, buffer 0.4) of
    mass 5 on a lattice, at rest, in 5 L^3 = 163,840 SRD solvent particles
    (period 20, angle 130, kT 1, body force (0.02, 0, 0)) coupled through
    the joint collision; ConstantVolume, dt 0.005; rng seed 9, sim seed 11."""
    rng = np.random.default_rng(9)
    N_s = int(5 * L**3)
    N_c = n**3
    snap = az.Snapshot(N=N_c, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["colloid"]
    x = (np.arange(n) + 0.5) * (L / n) - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.mass[:] = 5.0
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    sim = az.Simulation(device=device, seed=11)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0 ** (1 / 6),
                    mode="shift")
    lj.params[("colloid", "colloid")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.ConstantVolume()], forces=[lj])
    srd = az.mpcd.SRD(dt=0.005, period=20, angle=130.0, cell_size=1.0, kT=1.0,
                      body_force=(0.02, 0.0, 0.0))
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    sim.auto_tune_after = COLLOID_TUNE_AT
    return sim, [lj]


def build_poiseuille(az, device, N=40_000, L=16.0):
    """examples/mpcd_poiseuille.py at full size: an SRD solvent between
    no-slip plates at z = +-L/2 (period 5, angle 130, kT 1, body force
    (0.03, 0, 0)), two idle MD particles, ConstantVolume, dt 0.02."""
    rng = np.random.default_rng(12)
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray([L, L, 0.98 * L])
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = az.Simulation(device=device, seed=4)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
    sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0,
                                    body_force=(0.03, 0.0, 0.0), plates=("z", L))
    return sim


def build_srd(az, device, n=64):
    """Pure SRD throughput (bench.py bench_mpcd): n^3 = 262,144 solvent at
    one particle a cell, a collision every step (period 1, kT 1), two idle
    MD particles, dt 0.02."""
    rng = np.random.default_rng(3)
    N, L = n**3, float(n)
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = az.Simulation(device=device, seed=5)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
    sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, period=1, cell_size=1.0, kT=1.0)
    return sim


def _prepared_dense(sim):
    """The main path's dense state and grid, as its first step sees them."""
    sim.run(0)
    torch.cuda.synchronize()
    return sim._dense, sim._grid_spec


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------
def check_pair_kernel(az, D, PK, record):
    """Every potential, mode and want at every listed shape; times each
    potential at the polymer melt's full size (the 64k headline for PLJ)."""
    dev = torch.device("cuda")
    shapes = [
        ("small orthorhombic", dict(counts=(14, 14, 14), rho=0.85, jitter=0.06, seed=1), 2.5),
        ("tilted", dict(counts=(14, 14, 14), rho=0.8, jitter=0.06, seed=2,
                        tilt=(0.35, -0.2, 0.15)), 2.5),
        ("axis under 3 cells", dict(counts=(5, 16, 16), rho=0.85, jitter=0.06, seed=5), 2.5),
        ("two types", dict(counts=(12, 12, 12), rho=0.85, jitter=0.06, seed=4, n_types=2),
         2.0),
        ("three types uneven", dict(counts=(16, 14, 14), rho=0.6, jitter=0.03, seed=3,
                                     n_types=3, clustered=True), 2.0, 16),
        # the packed schedule's own shapes: 12^3 cells of exactly 8 at cap 8;
        # a cluster in 0.4 of each edge (most cells empty); 4^3 cells of
        # ~244 at cap ~296, staged in rounds; two axes under 3 cells; 41
        # types, whose tables are read from global memory
        ("full cells", dict(counts=(24, 24, 24), rho=0.85, jitter=0.04, seed=7, n_types=2),
         1.6, 8),
        ("mostly empty", dict(counts=(12, 12, 12), rho=0.85, jitter=0.06, seed=8, n_types=2,
                              span=0.4), 2.0),
        ("cap >= 256 in rounds", dict(counts=(25, 25, 25), rho=0.85, jitter=0.06, seed=9,
                                      n_types=2), 6.0),
        ("two axes under 3", dict(counts=(5, 5, 20), rho=0.85, jitter=0.06, seed=12,
                                  n_types=2), 2.0),
        ("41 types", dict(counts=(14, 14, 14), rho=0.85, jitter=0.06, seed=13, n_types=41), 2.0),
    ]
    cases = []
    for label, kw, r_cut, *cap in shapes:
        dense, spec, T = _dense_case(az, D, _lattice_snapshot(az, **kw), r_cut, 0.4, dev, *cap)
        cases.append((label, dense, spec, T, r_cut))
    _check_packed_shapes(_stage_bytes() // 16, cases)
    poly_dense, poly_spec = _prepared_dense(build_polymer(az, dev)[0])
    cases.append(("polymer melt 32k", poly_dense, poly_spec, 1, 2.5))
    poly_pairs = _pairs_inside(D, poly_dense, poly_spec, 2.5)
    poly_candidates = _candidates(poly_dense, poly_spec)
    print(f"[kernel] polymer melt 32k cap {poly_spec.cap}: {poly_candidates} "
          f"candidate pairs per call, {poly_pairs} unordered pairs inside r_cut (each "
          f"evaluated from both sides)", flush=True)
    ef = az.ops.evaluators.PAIR_POTENTIALS

    timing = {}
    for pot in PK.KERNEL_POTENTIALS:
        n_checks, worst = 0, 0.0
        for label, dense, spec, T, r_cut in cases:
            tbl = _pair_tables(az, pot, T, 10 + T, r_cut, dev)
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
            for mode in MODES:
                tables = PK.kernel_tables(pot, tbl["params"], tbl["r_cut"], tbl["r_on"], mode)
                for want in ("force", "all"):
                    got = PK.cell_pair_force(dense, spec, tables, pot, mode, want)
                    ref = D.dense_pair_force(ef[pot].energy_force, dense, jb, spec,
                                             tbl["params"], tbl["r_cut"], tbl["r_on"], mode,
                                             want)
                    torch.cuda.synchronize()
                    tag = f"{pot} {label} dims={spec.dims} cap={spec.cap} T={T} {mode} {want}"
                    ferr, rel = _compare_result(tag, got, ref, want)
                    record(f"cell_pair_force[{pot}]", ferr)
                    n_checks, worst = n_checks + 1, max(worst, rel)
            if label.startswith("polymer"):
                tables = PK.kernel_tables(pot, tbl["params"], tbl["r_cut"], tbl["r_on"], "none")
                ms = _cuda_time_ms(lambda: PK.cell_pair_force(dense, spec, tables, pot, "none"), 30)
                plain_ms = _cuda_time_ms(
                    lambda: D.dense_pair_force(ef[pot].energy_force, dense, jb, spec,
                                               tbl["params"], tbl["r_cut"], None, "none",
                                               "force"), 3)
                # inputs: position 12 B, type 4 B; outputs: force 12 B
                bound = _bound(dense, 16, 12, 4 * tables.numel(), poly_pairs, OPS_PER_PAIR[pot])
                timing[pot] = (ms, plain_ms, f"polymer melt 32k, cap {spec.cap}", bound,
                               poly_candidates)
        print(f"[kernel] cell_pair_force[{pot}]: {n_checks} checks ({len(cases)} shapes: "
              f"{', '.join(c[0] for c in cases)}; modes {'/'.join(MODES)}; force/all), worst "
              f"error {worst:.3e} of max|value| (bar {BAR})", flush=True)

    # the 64k headline, the PLJ instantiation's own main-path shape
    dense, spec, _ = _dense_case(
        az, D, _lattice_snapshot(az, counts=(40, 40, 40), rho=0.85, jitter=0.05, seed=6), 3.0,
        0.4, dev)
    tbl = _pair_tables(az, "PerturbedLennardJones", 1, 11, 3.0, dev)
    jb = D.make_jblocks(dense, spec, half=True)
    tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"])
    for want in ("force", "all"):
        got = PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "none", want)
        ref = D.dense_pair_force(ef["PerturbedLennardJones"].energy_force, dense, jb, spec,
                                 tbl["params"], tbl["r_cut"], None, "none", want)
        torch.cuda.synchronize()
        tag = f"PerturbedLennardJones 64k headline cap={spec.cap} none {want}"
        ferr, rel = _compare_result(tag, got, ref, want)
        record("cell_pair_force[PerturbedLennardJones]", ferr)
        print(f"[kernel] {tag}: force max_abs_err {ferr:.3e}, worst error {rel:.3e} of "
              f"max|value|", flush=True)
    _same_bits("cell_pair_force[PerturbedLennardJones] 64k headline",
               *[PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "none", "all")
                 for _ in range(2)])
    ms = _cuda_time_ms(
        lambda: PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "none"), 50)
    plain_ms = _cuda_time_ms(
        lambda: D.dense_pair_force(ef["PerturbedLennardJones"].energy_force, dense, jb, spec,
                                   tbl["params"], tbl["r_cut"], None, "none", "force"), 5)
    pairs = _pairs_inside(D, dense, spec, 3.0)
    candidates = _candidates(dense, spec)
    print(f"[kernel] PerturbedLennardJones 64k headline cap {spec.cap}: two launches give the "
          f"same bits; {candidates} candidate pairs per call, {pairs} unordered "
          f"pairs inside r_cut (each evaluated from both sides)", flush=True)
    bound = _bound(dense, 16, 12, 4 * tables.numel(), pairs,
                   OPS_PER_PAIR["PerturbedLennardJones"])
    timing["PerturbedLennardJones"] = (ms, plain_ms, f"64k headline, cap {spec.cap}", bound,
                                       candidates)
    for pot, (ms, plain_ms, where, (bound_ms, by), _) in timing.items():
        print(f"[kernel] cell_pair_force[{pot}] at {where}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms per call (force, mode none); bound {bound_ms:.5f} ms "
              f"({by})", flush=True)
    return timing


def check_dpd_kernel(az, D, DK, record):
    """The DPD kernel at every listed shape, force and all, with velocities
    and tags at and above 2**24 in the Threefry key; timed at full size."""
    dev = torch.device("cuda")
    shapes = [
        ("small orthorhombic", dict(counts=(18, 18, 18), rho=3.0, jitter=0.1, seed=21)),
        ("tilted", dict(counts=(18, 16, 16), rho=3.0, jitter=0.1, seed=22,
                        tilt=(0.3, -0.2, 0.15))),
        ("axis under 3 cells", dict(counts=(5, 20, 20), rho=3.0, jitter=0.1, seed=23)),
        ("two types", dict(counts=(16, 16, 16), rho=3.0, jitter=0.1, seed=24, n_types=2)),
        # the packed schedule's own shapes (see check_pair_kernel); the
        # rounds need a cutoff of 4 at rho 3: 3^3 cells of ~296
        ("full cells", dict(counts=(24, 24, 24), rho=2.9, jitter=0.03, seed=27, n_types=2), 1.0,
         8),
        ("mostly empty", dict(counts=(12, 12, 12), rho=3.0, jitter=0.1, seed=28, n_types=2,
                              span=0.4)),
        ("cap >= 256 in rounds", dict(counts=(20, 20, 20), rho=3.0, jitter=0.1, seed=29,
                                      n_types=2), 4.0),
        ("two axes under 3", dict(counts=(5, 5, 20), rho=3.0, jitter=0.1, seed=30, n_types=2)),
        ("41 types", dict(counts=(16, 16, 16), rho=3.0, jitter=0.1, seed=31, n_types=41)),
    ]
    cases = []
    for label, kw, *grid in shapes:
        r_cut, *cap = grid or [1.0]
        dense, spec, T = _dense_case(az, D, _lattice_snapshot(az, **kw), r_cut, 0.4, dev, *cap)
        cases.append((label, dense, spec, T, r_cut))
    _check_packed_shapes(_stage_bytes() // 32, cases)
    sim, _ = build_dpd(az, dev)
    dense, spec = _prepared_dense(sim)
    g = torch.Generator(device=dev).manual_seed(25)
    vel = torch.randn(dense.velocity.shape, generator=g, device=dev)
    dense = dense.replace(velocity=torch.where(dense.tag[:, None] >= 0, vel, 0.0))
    cases.append(("DPD fluid 22k", dense, spec, 1, 1.0))

    rng = np.random.default_rng(26)
    timing = None
    for label, dense, spec, T, r_cut in cases:
        A = rng.uniform(15.0, 30.0, (T, T))
        gamma = rng.uniform(3.0, 6.0, (T, T))
        s = rng.uniform(0.3, 2.0, (T, T))
        if label.startswith("DPD"):
            A, gamma, s = np.full((1, 1), 25.0), np.full((1, 1), 4.5), np.full((1, 1), 0.5)

        def dev_t(a):
            return torch.as_tensor(np.asarray((a + a.T) / 2, np.float32), device=dev)

        rc = np.full((T, T), r_cut)
        rc[0, -1] = rc[-1, 0] = 0.85 * r_cut if T > 1 else r_cut
        tbl = {"params": {"A": dev_t(A), "gamma": dev_t(gamma), "s": dev_t(s)},
               "r_cut": dev_t(rc)}
        jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_velocity=True, need_tag=True)
        worst = max_abs = 0.0
        for timestep in (777, 2**24 + 5):
            for want in ("force", "all"):
                got = DK.dpd_force(dense, spec, tbl, 1.0, 0.01, 5, timestep, want)
                ref = D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], 1.0, 0.01,
                                        5, timestep, want)
                torch.cuda.synchronize()
                tag = f"DPD {label} dims={spec.dims} cap={spec.cap} T={T} t={timestep} {want}"
                ferr, rel = _compare_result(tag, got, ref, want)
                record("cell_dpd_force", ferr)
                worst, max_abs = max(worst, rel), max(max_abs, ferr)
        print(f"[kernel] cell_dpd_force {label} dims={spec.dims} cap={spec.cap} T={T} "
              f"(timesteps 777 and 2**24+5, force/all): force max_abs_err {max_abs:.3e}, worst "
              f"error {worst:.3e} of max|value| (bar {BAR})", flush=True)
        if label.startswith("DPD"):
            tables = DK.dpd_kernel_tables(tbl["params"], tbl["r_cut"], 1.0, 0.01)
            _same_bits("cell_dpd_force DPD fluid 22k",
                       *[DK.cell_dpd_force(dense, spec, tables, 5, 777, "all") for _ in range(2)])
            ms = _cuda_time_ms(lambda: DK.cell_dpd_force(dense, spec, tables, 5, 777), 30)
            plain_ms = _cuda_time_ms(
                lambda: D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], 1.0,
                                          0.01, 5, 777, "force"), 3)
            # inputs: position and velocity 24 B, type 4 B; outputs: force 12 B
            pairs = _pairs_inside(D, dense, spec, 1.0)
            bound_ms, by = _bound(dense, 28, 12, 4 * tables.numel(), pairs, OPS_PER_PAIR["DPD"])
            candidates = _candidates(dense, spec)
            timing = (ms, plain_ms, f"DPD fluid 22k, cap {spec.cap}", (bound_ms, by), candidates)
            print(f"[kernel] cell_dpd_force at DPD fluid 22k cap {spec.cap}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms per call (force); bound {bound_ms:.5f} ms ({by}); "
                  f"two launches give the same bits; {candidates} candidate pairs "
                  f"per call, {pairs} unordered pairs inside r_cut (each evaluated from both "
                  f"sides)", flush=True)
    return timing


def _aniso_tables(az, T, seed, device):
    """TwoPatchMorse device tables: the patchy path's parameters for one
    type; for two, stiff random ones (M_r down to 0.05, omega up to 20) with
    a flat-bottom pair and a shorter per-pair cutoff."""
    if T == 1:
        host = {k: np.full((1, 1), float(v)) for k, v in PATCHY.items()}
        rc = np.full((1, 1), 1.6, np.float32)
    else:
        rng = np.random.default_rng(seed)

        def sym(lo, hi):
            m = rng.uniform(lo, hi, (T, T))
            return (m + m.T) / 2

        host = {"M_d": sym(1.0, 2.0), "M_r": sym(0.05, 0.15), "r_eq": sym(0.95, 1.1),
                "omega": sym(5.0, 20.0), "alpha": sym(0.3, 0.5), "repulsion": np.ones((T, T))}
        host["repulsion"][-1, -1] = 0.0
        rc = np.full((T, T), 1.6, np.float32)
        rc[0, -1] = rc[-1, 0] = 1.4
    pre = az.ops.evaluators.ANISO_PAIR_POTENTIALS["TwoPatchMorse"].precompute(host)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"params": {k: dev(v) for k, v in pre.items()}, "r_cut": dev(rc)}


def _newton_residual(force):
    """|sum of the per-slot forces| over their summed magnitudes: 0 up to
    the round-off of the per-slot sums when each pair's two contributions
    are exact negations."""
    f = force.double()
    return float(f.sum(0).abs().max() / f.abs().sum(0).max().clamp_min(1e-300))


def _compare_aniso(tag, got, ref, want):
    """Force, torque (and energy and virial for want="all"), each against
    the bar relative to its own max |value|. Returns the force's max abs
    error and the worst relative error over the outputs compared."""
    outputs = [("force", got.force, ref.force), ("torque", got.torque, ref.torque)]
    if want == "all":
        outputs += [("energy", got.energy, ref.energy), ("virial", got.virial, ref.virial)]
    errs = [_compare(f"{tag} {what}", g, r) for what, g, r in outputs]
    return errs[0][0], max(err / max(scale, 1e-30) for err, scale in errs)


def check_aniso_kernel(az, D, AK, record):
    """The TwoPatchMorse kernel at every listed shape, modes none/shift and
    force/all, with the summed force checked at round-off on Newton grids
    and two launches held bit for bit; timed at the patchy path's full
    size."""
    dev = torch.device("cuda")
    tpm = az.ops.evaluators.ANISO_PAIR_POTENTIALS["TwoPatchMorse"].energy_force_torque
    shapes = [
        ("small orthorhombic", dict(counts=(16, 16, 16), rho=0.6, jitter=0.06, seed=31)),
        ("tilted", dict(counts=(16, 15, 15), rho=0.6, jitter=0.06, seed=32,
                        tilt=(0.3, -0.2, 0.15))),
        ("axis under 3 cells", dict(counts=(3, 18, 18), rho=0.6, jitter=0.06, seed=33)),
        ("two types", dict(counts=(14, 14, 14), rho=0.6, jitter=0.06, seed=34, n_types=2)),
        # the packed schedule's own shapes: 12^3 cells of exactly 8 at cap
        # 8; a cluster in 0.4 of each edge (most cells empty); cap forced to
        # 64 with more candidates in a stencil than one staging round holds;
        # two axes under 3 cells; 4^3 cells of 64, more than the block has
        # threads, so the slots go in rounds; 41 types with per-pair
        # cutoffs, whose tables are read from global memory
        ("full cells", dict(counts=(24, 24, 24), rho=1.0, jitter=0.03, seed=36, n_types=2), 8),
        ("mostly empty", dict(counts=(12, 12, 12), rho=0.6, jitter=0.06, seed=37, n_types=2,
                              span=0.4)),
        ("cap 64 in rounds", dict(counts=(18, 18, 18), rho=1.2, jitter=0.05, seed=38,
                                  n_types=2), 64),
        ("two axes under 3", dict(counts=(3, 3, 24), rho=0.6, jitter=0.06, seed=39, n_types=2)),
        ("cells above kThreads", dict(counts=(16, 16, 16), rho=8.0, jitter=0.02, seed=40,
                                      n_types=2)),
        ("41 types", dict(counts=(14, 14, 14), rho=0.6, jitter=0.06, seed=41, n_types=41)),
    ]
    cases = []
    for label, kw, *cap in shapes:
        dense, spec, T = _dense_case(az, D, _lattice_snapshot(az, quats=True, **kw), 1.6, 0.3,
                                     dev, *cap, fields=("quat",))
        cases.append((label, dense, spec, T))
    _check_packed_shapes(_source_constant(AK._SOURCE, "kStageEntries"), cases,
                         _source_constant(AK._SOURCE, "kThreads"))
    dense, spec = _prepared_dense(build_patchy(az, dev)[0])
    cases.append(("patchy colloids 27k", dense, spec, 1))

    timing = None
    for label, dense, spec, T in cases:
        tbl = _aniso_tables(az, T, 35, dev)
        jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_quat=True)
        worst = max_abs = resid = 0.0
        for mode in ("none", "shift"):
            tables = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], mode)
            for want in ("force", "all"):
                got = AK.cell_aniso_force(dense, spec, tables, want)
                ref = D.dense_aniso_force(tpm, dense, jb, spec, tbl["params"], tbl["r_cut"],
                                          mode, want)
                torch.cuda.synchronize()
                tag = f"TwoPatchMorse {label} dims={spec.dims} cap={spec.cap} T={T} {mode} {want}"
                ferr, rel = _compare_aniso(tag, got, ref, want)
                record("cell_aniso_force", ferr)
                worst, max_abs = max(worst, rel), max(max_abs, ferr)
                if spec.newton_ok:
                    resid = max(resid, _newton_residual(got.force))
                _same_bits(tag, got, AK.cell_aniso_force(dense, spec, tables, want))
        if resid > 1e-5:
            raise AssertionError(f"TwoPatchMorse {label}: summed kernel force {resid:.3e} of the "
                                 "summed magnitudes, not round-off")
        print(f"[kernel] cell_aniso_force {label} dims={spec.dims} cap={spec.cap} T={T} "
              f"(modes none/shift, force/all): force max_abs_err {max_abs:.3e}, worst error "
              f"{worst:.3e} of max|value| (bar {BAR}); summed force "
              f"{resid if spec.newton_ok else float('nan'):.2e} of the summed magnitudes; two "
              f"launches give the same bits", flush=True)
        if label.startswith("patchy"):
            tables = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "shift")
            ms = _cuda_time_ms(lambda: AK.cell_aniso_force(dense, spec, tables), 50)
            plain_ms = _cuda_time_ms(
                lambda: D.dense_aniso_force(tpm, dense, jb, spec, tbl["params"], tbl["r_cut"],
                                            "shift", "force"), 3)
            pairs = _pairs_inside(D, dense, spec, 1.6)
            # inputs: position 12 B, quaternion 16 B, type 4 B; outputs:
            # force and torque 24 B
            bound_ms, by = _bound(dense, 32, 24, 4 * tables.numel(), pairs,
                                  OPS_PER_PAIR["TwoPatchMorse"])
            candidates = _candidates(dense, spec)
            timing = (ms, plain_ms, f"patchy colloids 27k, cap {spec.cap}", (bound_ms, by),
                      candidates)
            print(f"[kernel] cell_aniso_force at patchy colloids 27k cap {spec.cap} "
                  f"({int((dense.tag >= 0).sum())} of {spec.S} slots occupied): kernel {ms:.4f} "
                  f"ms, plain {plain_ms:.4f} ms per call (force, mode shift); bound "
                  f"{bound_ms:.5f} ms ({by}); {candidates} candidate pairs per call, {pairs} "
                  f"unordered pairs inside r_cut (each evaluated from both sides)", flush=True)
    return timing


def check_rng(az):
    """Threefry words and the Langevin noise: bitwise equal on GPU and CPU."""
    from azplugins_tpu_torch.core import rng

    g = np.random.default_rng(7)
    tags = torch.as_tensor(g.integers(-1, 2**31 - 1, 64000).astype(np.int32))
    ctr = torch.as_tensor(g.integers(0, 2**32, 64000, dtype=np.uint64).astype(np.int64))
    for rounds in (rng.FAST_ROUNDS, 20):
        cpu = rng.threefry2x32(0x00D20000 ^ 42, 1234, tags, ctr, rounds=rounds)
        gpu = rng.threefry2x32(0x00D20000 ^ 42, 1234, tags.cuda(), ctr.cuda(), rounds=rounds)
        for a, b in zip(cpu, gpu):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"threefry2x32 ({rounds} rounds) differs on the GPU")
    gamma = torch.full((64000,), 0.1)
    for dev in ("cpu", "cuda"):
        u = rng.particle_uniform3(rng.Stream.LANGEVIN, 12345, 777, tags.to(dev))
        noise = torch.sqrt(6.0 * gamma.to(dev) * 1.0 / 0.005)[:, None] * u
        if dev == "cpu":
            ref = noise
        elif not torch.equal(noise.cpu().view(torch.int32), ref.view(torch.int32)):
            raise AssertionError("Langevin noise differs between the GPU and the CPU")
    print("[rng] threefry (13 and 20 rounds) and Langevin noise: GPU == CPU bitwise",
          flush=True)


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------
def _reset_counts(K):
    K.PK.launches = 0
    K.PK.launches_by_potential.clear()
    K.DK.launches = 0
    K.AK.launches = 0


def _timed_run(sim, steps):
    """sim.run(steps) between CUDA events: (ms per step, host seconds)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    sim.run(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, time.perf_counter() - t0


def _check_wrapped(sim, what):
    pos = sim.state.get_snapshot().particles.position
    L = np.asarray(sim.state.box.L)
    if not (np.isfinite(pos).all() and (np.abs(pos) <= L / 2 + 1e-3).all()):
        raise AssertionError(f"{what}: positions non-finite or outside the box")
    return pos


def _temperatures(thermo):
    """(translational, rotational or None) kinetic temperature."""
    trans = 2.0 * thermo.kinetic_energy / thermo.translational_degrees_of_freedom
    rdof = thermo.rotational_degrees_of_freedom
    return trans, (2.0 * thermo.rotational_kinetic_energy / rdof if rdof > 0 else None)


def _mean_kT(sim, thermo, n=5, gap=20):
    """Mean translational and rotational (None without rotation) kT over
    ``n`` samples ``gap`` steps apart."""
    temps = []
    for _ in range(n):
        sim.run(gap)
        temps.append(_temperatures(thermo))
    rot = [r for _, r in temps if r is not None]
    return float(np.mean([t for t, _ in temps])), (float(np.mean(rot)) if rot else None)


def _profile(sim, steps=20):
    """Per step over a short profiled window: device operations,
    device-busy milliseconds, host-to-device copies, and the calls that made
    the host wait for the device (torch.cuda's sync debug mode; the run
    reads its flags once per chunk by design). torch.profiler's own host
    overhead makes this a breakdown, not a timer."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sim.run(steps)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    ops, busy_ms = _device_work(prof)
    htod = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy HtoD"))
    return ops / steps, busy_ms / steps, htod / steps, syncs / steps


def _device_work(prof):
    """(device operations, device-busy ms) in a torch.profiler trace."""
    ops = busy_us = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            ops += e.count
            busy_us += us
    return ops, busy_us / 1000.0


def _kernels_on_state(az, D, K, sim, forces, record):
    """Each pair kernel against its plain version on the path's own state
    after the run (want="all")."""
    dense, spec, dev = sim._dense, sim._grid_spec, sim.device
    errs = []
    for f in forces:
        if not f._needs_nlist:
            continue
        tbl = f._device_tables(dev)
        if isinstance(f, az.pair.DPDGeneralWeight):
            kT, dt, t = f.kT(sim.timestep), sim.dt_ref(), sim.timestep
            got = K.DK.dpd_force(dense, spec, tbl, kT, dt, sim.seed, t, "all")
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_velocity=True,
                                need_tag=True)
            ref = D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], kT, dt,
                                    sim.seed, t, "all")
            name = "cell_dpd_force"
        elif isinstance(f, az.pair.TwoPatchMorse):
            got = K.AK.cell_aniso_force(dense, spec, tbl["kernel"], "all")
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_quat=True)
            ref = D.dense_aniso_force(f._def.energy_force_torque, dense, jb, spec,
                                      tbl["params"], tbl["r_cut"], f.mode, "all")
            name = "cell_aniso_force"
        else:
            pot = f._evaluator_name
            got = K.PK.cell_pair_force(dense, spec, tbl["kernel"], pot, f.mode, "all")
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
            ref = D.dense_pair_force(f._def.energy_force, dense, jb, spec, tbl["params"],
                                     tbl["r_cut"], tbl["r_on"], f.mode, "all")
            name = f"cell_pair_force[{pot}]"
        torch.cuda.synchronize()
        tag = f"{name} on the path's state"
        if got.torque is not None:
            ferr, _ = _compare_aniso(tag, got, ref, "all")
        else:
            ferr, _ = _compare_result(tag, got, ref, "all")
        record(name, ferr)
        errs.append(f"{name} {ferr:.3e}")
    return ", ".join(errs)


def _time_at_caps(az, D, K, sim, forces, caps):
    """The path's pair kernel on the path's own state, densified anew at
    each cap (grown by 8 until the state fits): ms per call in two turns
    (the caps in order, then in reverse) and candidate pairs, to show
    whether the time still follows cap. Returns the caps timed, their ms
    per turn and their candidates."""
    dense, spec, dev = sim._dense, sim._grid_spec, sim.device
    f = next(f for f in forces if f._needs_nlist)
    fields = ("quat",) if isinstance(f, az.pair.TwoPatchMorse) else ()
    state = D.undensify(dense, sim.state.N_particles, fields=fields)
    tbl = f._device_tables(dev)
    max_occ = int((dense.tag >= 0).reshape(spec.n_cells, spec.cap).sum(dim=1).max())
    if isinstance(f, az.pair.TwoPatchMorse):

        def call(d, sp):
            return K.AK.cell_aniso_force(d, sp, tbl["kernel"])
    elif isinstance(f, az.pair.DPDGeneralWeight):
        tables = K.DK.dpd_kernel_tables(tbl["params"], tbl["r_cut"], f.kT(sim.timestep),
                                        sim.dt_ref())

        def call(d, sp):
            return K.DK.cell_dpd_force(d, sp, tables, sim.seed, sim.timestep)
    else:

        def call(d, sp):
            return K.PK.cell_pair_force(d, sp, tbl["kernel"], f._evaluator_name, f.mode)

    grids = []
    for cap in caps:
        while True:
            sp = spec.replace(cap=cap)
            d, meta = D.densify(state, sp, fields=fields)
            if not bool(meta.overflow):
                break
            cap += 8
        grids.append((cap, d, sp))
    ms = {cap: [] for cap, _, _ in grids}
    for cap, d, sp in (*grids, *reversed(grids)):
        ms[cap].append(_cuda_time_ms(lambda: call(d, sp), 50))
    timed = [(cap, ms[cap], _candidates(d, sp)) for cap, d, sp in grids]
    print(f"[caps] kernel on the path's state (max occupancy {max_occ}), two turns: " + "; ".join(
        f"cap {c}: {' and '.join(f'{t:.4f}' for t in turns)} ms, {n} candidate pairs"
        for c, turns, n in timed), flush=True)
    return timed


def _record_tune(sim):
    """Record the capacity and rebuild interval before and after the
    capacity tune when the run fires it."""
    seen = {}
    tune = sim.tune_cell_capacity

    def recorded(*args, **kwargs):
        seen.update(t=sim.timestep, cap0=sim._grid_spec.cap, seg0=sim._seg_len,
                    ceiling0=sim._seg_ceiling)
        tune(*args, **kwargs)
        seen.update(cap=sim._grid_spec.cap, seg=sim._seg_len, ceiling=sim._seg_ceiling)

    sim.tune_cell_capacity = recorded
    return seen


def run_path(az, D, K, card, record, label, build, warm_steps, steps, counts,
             extra_check=None, kT=1.0, kT_band=0.05, caps=()):
    """One main path at full size: warm up (printing the temperatures five
    times on the way), then ``steps`` timed steps with the launch counts set
    to 0 just before and read just after. The warm-up profiles the 20 steps
    before the capacity tune at step TUNE_AT and records the capacity and
    interval on both sides of it. ``counts`` maps each kernel name the path
    must run to a function that reads its count. The translational (and
    rotational) kinetic temperature must read ``kT`` within ``kT_band``
    after the timed steps (``kT=None``: the path checks its own). Afterwards
    the pair kernel is timed at each of ``caps`` on the path's state
    (``"tune"``: the capacities before and after the tune). Returns the
    counts and the simulation."""
    sim, forces = build(az, "cuda")
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    tuned = _record_tune(sim)
    t0 = time.perf_counter()
    sim.run(TUNE_AT - 20)
    pre_ops, pre_busy, _, _ = _profile(sim)
    curve = []
    chunk = (warm_steps - TUNE_AT) // 5
    for _ in range(5):
        sim.run(chunk)
        curve.append("/".join(f"{x:.4f}" for x in _temperatures(thermo) if x is not None))
    torch.cuda.synchronize()
    if tuned.get("t") != TUNE_AT:
        raise AssertionError(f"{label}: the capacity tune did not fire at step {TUNE_AT}")
    print(f"[{label}] N={sim.state.N_particles} grid {sim._grid_spec}: {sim.timestep} warm-up "
          f"steps in {time.perf_counter() - t0:.1f} s; kT (translational"
          f"{'/rotational' if '/' in curve[0] else ''}) every {chunk} steps after step "
          f"{TUNE_AT}: {', '.join(curve)}", flush=True)
    print(f"[{label}] tune at step {tuned['t']}: cap {tuned['cap0']} -> {tuned['cap']}, "
          f"rebuild interval {tuned['seg0']} -> {tuned['seg']} (ceiling {tuned['ceiling0']} -> "
          f"{tuned['ceiling']}); the 20 steps before it: {pre_ops:.1f} device operations and "
          f"{pre_busy:.4f} ms device-busy per step", flush=True)
    before = extra_check(sim, "before") if extra_check else None

    builds0, replays0, evals0 = sim.n_builds, sim.viol_replays, sim.force_evaluations
    n_pair_forces = sum(1 for f in forces if f._needs_nlist)
    _reset_counts(K)
    ms_step, wall = _timed_run(sim, steps)
    launched = {name: read() for name, read in counts.items()}
    evals = sim.force_evaluations - evals0
    builds = sim.n_builds - builds0
    replays = sim.viol_replays - replays0
    pair_evals = evals * n_pair_forces // len(forces)
    if sum(launched.values()) != pair_evals or min(launched.values()) < steps:
        raise AssertionError(f"{label}: kernel launches {launched} for {pair_evals} pair-force "
                             f"evaluations in {steps} steps")
    _check_wrapped(sim, label)
    after = extra_check(sim, "after", before) if extra_check else ""
    kT_trans, kT_rot = _mean_kT(sim, thermo)
    for what, value in (("translational", kT_trans), ("rotational", kT_rot)):
        if kT is not None and value is not None and abs(value - kT) > kT_band:
            raise AssertionError(f"{label}: {what} kinetic temperature {value:.4f} outside "
                                 f"{kT} +- {kT_band}")
    if not 0 < builds < steps:
        raise AssertionError(f"{label}: {builds} grid builds in {steps} steps")
    # observables through the kernels' energy/virial path
    energies = [f.energy for f in forces]
    p = thermo.pressure
    if not (np.all(np.isfinite(energies)) and np.isfinite(p)):
        raise AssertionError(f"{label}: non-finite energy or pressure")
    on_state = _kernels_on_state(az, D, K, sim, forces, record)
    ops, busy, htod, syncs = _profile(sim)
    print(f"[{label}] {steps} steps: {ms_step:.4f} ms/step, {1000.0 / ms_step:.1f} TPS "
          f"(host wall {wall:.3f} s) on {card}", flush=True)
    print(f"[{label}] launches {launched} for {evals} force evaluations "
          f"({sum(launched.values()) / steps:.3f} kernel launches per step); {builds} grid "
          f"builds ({steps / max(builds, 1):.1f} steps each), {replays} violation replays; "
          f"cap {sim._grid_spec.cap}, rebuild interval {sim._seg_len}", flush=True)
    print(f"[{label}] profile: {ops:.1f} device operations and {busy:.4f} ms device-busy "
          f"per step; {htod:.2f} host-to-device copies and {syncs:.2f} synchronising calls "
          f"per step", flush=True)
    rot = f", rotational {kT_rot:.4f}" if kT_rot is not None else ""
    target = f"target {kT} +- {kT_band}" if kT is not None else "lab frame, not checked"
    print(f"[{label}] kinetic temperature: translational {kT_trans:.4f}{rot} ({target}), "
          f"energies per particle "
          f"{[round(e / sim.state.N_particles, 5) for e in energies]}, pressure {p:.4f}"
          f"{after}; kernel vs plain on this state: {on_state}", flush=True)
    _busy_at_caps(sim, label, tuned["cap0"])
    if caps == "tune":
        caps = (tuned["cap"], tuned["cap0"])
    if caps:
        _time_at_caps(az, D, K, sim, forces, caps)
    return launched, sim


def _busy_at_caps(sim, label, untuned):
    """Device-busy ms a step at the path's capacity and at the one it had
    before the tune, on the path's state after its checks, in two turns
    (tuned, untuned, untuned, tuned): what the tune is worth on the card."""
    tuned = sim._grid_spec.cap
    if tuned == untuned:
        return
    busy = {tuned: [], untuned: []}
    for cap in (tuned, untuned, untuned, tuned):
        sim._synced_state()
        sim._grid_spec = sim._grid_spec.replace(cap=cap)
        sim._drop_dense()
        busy[cap].append(_profile(sim)[:2])
    print(f"[{label}] device-busy per step, two turns of 20 steps on the path's state: " +
          "; ".join(f"cap {c} ({'tuned' if c == tuned else 'before the tune'}): "
                    f"{' and '.join(f'{b:.4f} ms ({o:.1f} operations)' for o, b in busy[c])}"
                    for c in (tuned, untuned)), flush=True)


def _evaporated_after(t: int) -> int:
    """Particles the droplet's evaporator has retyped after t steps: one
    firing after each step divisible by the period, 10 each."""
    return DROPLET_EVAP_PER_FIRING * ((t + DROPLET_PERIOD - 1) // DROPLET_PERIOD)


def _droplet_check(sim, when, before=None):
    """N and the types unchanged but for the evaporated count, exact; no
    solvent particle beyond the barrier by more than DROPLET_OVERSHOOT;
    after the timed steps, the evaporated particles' kinetic temperature
    relative to the flow, m <|v - u(r)|^2> / 3, over 5 samples 100 steps
    apart."""
    integ = sim.operations.integrator
    barrier, method = integ.forces[1], integ.methods[0]

    def read():
        p = sim.state.get_snapshot().particles
        if p.N != DROPLET_N or not np.isin(p.typeid, (0, 1)).all():
            raise AssertionError(f"droplet: N {p.N} or typeids {np.unique(p.typeid)} changed")
        return p

    p = read()
    evaporated = int((p.typeid == 1).sum())
    if evaporated != _evaporated_after(sim.timestep):
        raise AssertionError(f"droplet: {evaporated} evaporated after {sim.timestep} steps, "
                             f"not {_evaporated_after(sim.timestep)}")
    R = barrier.location(sim.timestep)
    overshoot = float((np.linalg.norm(p.position[p.typeid == 0], axis=1) - R).max())
    if overshoot > DROPLET_OVERSHOOT:
        raise AssertionError(f"droplet: a solvent particle lies {overshoot:.3f} beyond the "
                             f"barrier at R = {R:.4f}")
    if when == "before":
        return evaporated, overshoot
    temps = []
    for _ in range(5):
        sim.run(100)
        p = read()
        evap = p.typeid == 1
        u = method.flow_field(torch.as_tensor(p.position[evap])).numpy()
        rel = p.velocity[evap] - u
        temps.append(float((p.mass[evap] * (rel * rel).sum(axis=1)).mean() / 3.0))
    kT_rel = float(np.mean(temps))
    if abs(kT_rel - 1.0) > DROPLET_KT_BAND:
        raise AssertionError(f"droplet: evaporated kT relative to the flow {kT_rel:.4f} outside "
                             f"1.0 +- {DROPLET_KT_BAND}")
    return (f", evaporated {before[0]} -> {evaporated} (exact), solvent beyond the barrier by "
            f"at most {before[1]:.4f} -> {overshoot:.4f} (R = {R:.4f}), evaporated kT relative "
            f"to the flow {kT_rel:.4f} over {int(evap.sum())} particles (samples "
            f"{', '.join(f'{t:.4f}' for t in temps)})")


def _dpd_momentum(sim, when, before=None):
    """|total momentum| / N; DPD conserves it, so it stays at its start
    value (0: the fluid starts at rest) up to float32 round-off."""
    snap = sim.state.get_snapshot()
    p = np.abs((snap.particles.velocity * snap.particles.mass[:, None]).sum(axis=0)).max()
    p_per = float(p) / snap.particles.N
    if p_per > 1e-5:
        raise AssertionError(f"DPD: |total momentum|/N = {p_per:.3e} {when} the timed steps")
    return p_per if when == "before" else f", |P|/N {before:.3e} -> {p_per:.3e}"


def _bond_lengths(sim, when, before=None):
    """Bond lengths (minimum image) of the chains of 25: finite."""
    snap = sim.state.get_snapshot()
    d = np.diff(snap.particles.position.reshape(-1, 25, 3), axis=1)
    L = np.asarray(snap.configuration.box[:3])
    r = np.linalg.norm(d - L * np.round(d / L), axis=-1)
    if not np.isfinite(r).all():
        raise AssertionError(f"polymer: non-finite bond lengths {when} the timed steps")
    return f", bond lengths {r.min():.4f}-{r.max():.4f} (mean {r.mean():.4f})"


def _unit_quaternions(sim, when, before=None):
    """|q| = 1 within 1e-4 on every particle."""
    q = sim.state.get_snapshot().particles.orientation
    dev = float(np.abs(np.linalg.norm(q, axis=1) - 1.0).max())
    if not np.isfinite(q).all() or dev > 1e-4:
        raise AssertionError(f"patchy: max ||q| - 1| = {dev:.3e} {when} the timed steps")
    return dev if when == "before" else f", max ||q| - 1| {before:.2e} -> {dev:.2e}"


def run_potential_sweep(az, K):
    """Every other isotropic potential through the public API: 200 Langevin
    steps of a 16^3 lattice fluid each, in turn with modes none/shift/xplor;
    counts set to 0 just before each and read just after."""
    launched = {}
    PK = K.PK
    others = [p for p in PK.KERNEL_POTENTIALS
              if p not in ("PerturbedLennardJones", "ExpandedYukawa")]
    for i, pot in enumerate(others):
        snap = _lattice_snapshot(az, counts=(16, 16, 16), rho=0.85, jitter=0.02, seed=40 + i)
        snap.particles.velocity[:] = 0.0
        sim = az.Simulation(device="cuda", seed=40 + i)
        sim.create_state_from_snapshot(snap)
        mode = MODES[i % 3]
        force = getattr(az.pair, pot)(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0,
                    default_r_on=1.5, mode=mode)
        params = potential_params(pot, 1, np.random.default_rng(50 + i))
        force.params[("A", "A")] = {k: float(v[0, 0]) for k, v in params.items()}
        sim.operations.integrator = az.md.Integrator(
            dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=1.0)],
            forces=[force])
        sim.state.thermalize_particle_momenta(kT=1.0)
        sim.run(0)
        _reset_counts(K)
        evals0 = sim.force_evaluations
        sim.run(200)
        torch.cuda.synchronize()
        n = PK.launches_by_potential.get(pot, 0)
        evals = sim.force_evaluations - evals0
        if n != evals or n < 200 or PK.launches != n:
            raise AssertionError(f"{pot}: {n} kernel launches for {evals} force evaluations")
        _check_wrapped(sim, pot)
        if not np.isfinite(force.energy):
            raise AssertionError(f"{pot}: non-finite energy")
        print(f"[sweep] {pot} (mode {mode}): {n} launches for {evals} force evaluations, "
              f"U/N {force.energy / sim.state.N_particles:.4f}", flush=True)
        launched[pot] = n
    return launched


def _solvent_kT(sim):
    """The solvent's kinetic temperature relative to its mean velocity,
    m_s <|v - <v>|^2> / 3, and its mean velocity."""
    v = sim._mpcd["velocity"].double()
    mean = v.mean(dim=0)
    kT = float(sim._mpcd["mass"] * ((v - mean) ** 2).sum(dim=1).mean() / 3.0)
    return kT, mean.cpu().numpy()


def _profile_call(fn, reps):
    """(device operations, device-busy ms) per call of ``fn``, over ``reps``
    calls under torch.profiler (a breakdown, not a timer)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops, busy_ms = _device_work(prof)
    return ops / reps, busy_ms / reps


def time_pair_on_state(az, D, PK, sim, f, label):
    """K1 or K1' at a path's own state after its run: kernel and plain ms
    per call (force only), bound, candidate pairs and pairs inside r_cut."""
    dense, spec = sim._dense, sim._grid_spec
    tbl = f._device_tables(sim.device)
    pot, tables = f._evaluator_name, tbl["kernel"]
    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    ef = az.ops.evaluators.PAIR_POTENTIALS[pot].energy_force
    ms = _cuda_time_ms(lambda: PK.cell_pair_force(dense, spec, tables, pot, f.mode), 50)
    plain_ms = _cuda_time_ms(
        lambda: D.dense_pair_force(ef, dense, jb, spec, tbl["params"], tbl["r_cut"],
                                   tbl.get("r_on"), f.mode, "force"), 5)
    pairs = _pairs_inside(D, dense, spec, f._max_r_cut())
    candidates = _candidates(dense, spec)
    bound_ms, by = _bound(dense, 16, 12, 4 * tables.numel(), pairs, OPS_PER_PAIR[pot])
    print(f"[{label}] cell_pair_force[{pot}] at the {label}'s state (mode {f.mode}, cap "
          f"{spec.cap}, dims {spec.dims}, {int((dense.tag >= 0).sum())} particles): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms per call (force); bound {bound_ms:.5f} ms "
          f"({by}); {candidates} candidate pairs per call, {pairs} unordered pairs inside "
          f"r_cut", flush=True)


def _colloid_bits(az):
    """Whether two identical colloid runs of 60 steps (three joint
    collisions) agree bitwise: a reading, not a check (CUDA's index_add_
    adds the cell sums with atomics, in an order that may vary)."""
    out = []
    for _ in range(2):
        sim, _ = build_colloid(az, "cuda")
        sim.run(60)
        out.append((sim._mpcd["velocity"].clone(), sim._synced_state().velocity.clone()))
        del sim
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(out[0], out[1]))
    diff = max(float((a - b).abs().max()) for a, b in zip(out[0], out[1]))
    return same, diff


def run_colloid(az, D, K, card, record):
    """Colloid hydrodynamics at full size through the public API: warm-up
    with the tune at step 150, then COLLOID_STEPS timed steps with the
    launch counts set to 0 just before and read just after; every LJ
    evaluation through K1'; momentum, solvent kT and advection checked.
    Returns the counts."""
    sim, forces = build_colloid(az, "cuda")
    lj = forces[0]
    coupling = sim.operations.updaters[0]
    tuned = _record_tune(sim)
    t0 = time.perf_counter()
    sim.run(COLLOID_WARM - 20)
    pre_ops, pre_busy, _, _ = _profile(sim)
    torch.cuda.synchronize()
    if tuned.get("t") != COLLOID_TUNE_AT:
        raise AssertionError(f"colloid: the capacity tune did not fire at step {COLLOID_TUNE_AT}")
    if not coupling._ingraph:
        raise AssertionError("colloid: the joint collision is not on its default schedule")
    N_c, N_s = sim.state.N_particles, sim._mpcd["position"].shape[0]
    print(f"[colloid] N_c={N_c} N_s={N_s} grid {sim._grid_spec}: {sim.timestep} warm-up steps "
          f"in {time.perf_counter() - t0:.1f} s; collisions in the step loop: "
          f"{coupling._ingraph}", flush=True)
    print(f"[colloid] tune at step {tuned['t']}: cap {tuned['cap0']} -> {tuned['cap']}, "
          f"rebuild interval {tuned['seg0']} -> {tuned['seg']} (ceiling {tuned['ceiling0']} -> "
          f"{tuned['ceiling']}); steps {COLLOID_WARM - 20}-{COLLOID_WARM}: {pre_ops:.1f} device "
          f"operations and {pre_busy:.4f} ms device-busy per step", flush=True)

    name = "cell_pair_force[LJ]"
    builds0, replays0, evals0 = sim.n_builds, sim.viol_replays, sim.force_evaluations
    _reset_counts(K)
    ms_step, wall = _timed_run(sim, COLLOID_STEPS)
    launched = {name: K.PK.launches_by_potential.get("LJ", 0)}
    evals = sim.force_evaluations - evals0
    if launched[name] != evals or evals < COLLOID_STEPS or K.PK.launches != evals:
        raise AssertionError(f"colloid: {launched} LJ kernel launches for {evals} force "
                             f"evaluations in {COLLOID_STEPS} steps")
    builds, replays = sim.n_builds - builds0, sim.viol_replays - replays0
    _check_wrapped(sim, "colloid")

    # total momentum: the body force's impulse on the solvent, shared with
    # the colloids by the collisions and conserved by the pair force
    m_s, f_x = sim._mpcd["mass"], sim.mpcd_dynamics.body_force[0]
    v_s = sim._mpcd["velocity"].double()
    state = sim._synced_state()
    P = (m_s * v_s.sum(dim=0) + (state.mass.double()[:, None]
                                 * state.velocity.double()).sum(dim=0)).cpu().numpy()
    P_want = np.array([m_s * N_s * f_x * sim.timestep * sim.dt_ref(), 0.0, 0.0])
    if not (np.abs(P - P_want) <= COLLOID_P_BAND * m_s * N_s).all():
        raise AssertionError(f"colloid: total momentum {P} against {P_want} "
                             f"(band {COLLOID_P_BAND * m_s * N_s:.3f})")
    kT_s, mean_s = _solvent_kT(sim)
    if abs(kT_s - 1.0) > COLLOID_KT_BAND:
        raise AssertionError(f"colloid: solvent kT relative to its mean velocity {kT_s:.4f} "
                             f"outside 1.0 +- {COLLOID_KT_BAND}")
    v_c = state.velocity.double()
    vx_c = float(v_c[:, 0].mean())
    if not 0.0 < vx_c < 1.1 * mean_s[0]:
        raise AssertionError(f"colloid: colloids' mean vx {vx_c:.4f} not in (0, 1.1 x the "
                             f"solvent's {mean_s[0]:.4f})")
    kT_c = float((state.mass.double()[:, None] * (v_c - v_c.mean(dim=0)) ** 2).sum()
                 / (3.0 * (N_c - 1)))
    on_state = _kernels_on_state(az, D, K, sim, forces, record)
    ops, busy, htod, syncs = _profile(sim)

    # one joint collision alone at this state: device time and operations
    dense, seed = sim._dense, sim.seed
    solv = sim._mpcd["_srd_anchor"]
    t_col = solv[2] + sim.mpcd_dynamics.period

    def collide():
        return coupling._collide(dense, solv, t_col, seed, m_s)

    collide()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        collide()
    end.record()
    torch.cuda.synchronize()
    col_ms = start.elapsed_time(end) / 10
    col_ops, col_busy = _profile_call(collide, 5)
    print(f"[colloid] {COLLOID_STEPS} steps: {ms_step:.4f} ms/step, {1000.0 / ms_step:.1f} TPS "
          f"(host wall {wall:.3f} s) on {card}", flush=True)
    print(f"[colloid] launches {launched} for {evals} force evaluations "
          f"({launched[name] / COLLOID_STEPS:.3f} kernel launches per step); {builds} grid "
          f"builds, {replays} violation replays; cap {sim._grid_spec.cap}, rebuild interval "
          f"{sim._seg_len}", flush=True)
    print(f"[colloid] profile: {ops:.1f} device operations and {busy:.4f} ms device-busy per "
          f"step; {htod:.2f} host-to-device copies and {syncs:.2f} synchronising calls per "
          f"step", flush=True)
    print(f"[colloid] one joint collision ({N_s + sim._dense.tag.numel()} rows, "
          f"{sim.mpcd_dynamics._grid_dims()} cells): {col_ms:.4f} ms a call (CUDA events over 10 "
          f"calls issued after a synchronize, host launches included), "
          f"{col_ops:.1f} device operations and {col_busy:.4f} ms device-busy", flush=True)
    print(f"[colloid] total momentum {P.round(4).tolist()} against {P_want.round(4).tolist()} "
          f"(band {COLLOID_P_BAND * m_s * N_s:.3f}); solvent kT relative to its mean "
          f"{kT_s:.4f} (1.0 +- {COLLOID_KT_BAND}), solvent mean vx {mean_s[0]:.4f}, colloids' "
          f"mean vx {vx_c:.4f}, colloids' kT {kT_c:.4f} (a reading); kernel vs plain on this "
          f"state: {on_state}", flush=True)
    time_pair_on_state(az, D, K.PK, sim, lj, "colloid")
    del sim
    same, diff = _colloid_bits(az)
    print(f"[colloid] two identical 60-step runs agree bitwise: {same} (max |dv| {diff:.3e}; "
          f"a reading: the cell sums are atomic adds on CUDA)", flush=True)
    return launched


def run_poiseuille(az, card):
    """The SRD Poiseuille slit at full size: POISEUILLE_STEPS steps, then the
    profile over 16 bins of the velocity field compute (the example reads it
    after 50 more steps). The fitted parabola R^2 > 0.95, its peak > 0.03,
    and no solvent particle beyond the plates."""
    sim = build_poiseuille(az, "cuda")
    L = float(sim.state.box.L[2])
    sim.run(TUNE_AT)
    ms_step, wall = _timed_run(sim, POISEUILLE_STEPS - TUNE_AT)
    field = az.compute.CartesianVelocityFieldCompute(
        num_bins=(0, 0, POISEUILLE_BINS), lower_bounds=(0, 0, -L / 2),
        upper_bounds=(0, 0, L / 2), include_mpcd_particles=True)
    sim.operations.computes.append(field)
    ops, busy, htod, syncs = _profile(sim, steps=50)
    prof = field.velocities[:, 0]
    z = (np.arange(POISEUILLE_BINS) + 0.5) / POISEUILLE_BINS - 0.5
    A = np.stack([0.25 - z**2, np.ones(POISEUILLE_BINS)], 1)
    coef, *_ = np.linalg.lstsq(A, prof, rcond=None)
    r2 = 1 - ((prof - A @ coef) ** 2).sum() / max(((prof - prof.mean()) ** 2).sum(), 1e-12)
    beyond = float(sim._mpcd["position"][:, 2].abs().max()) - L / 2
    print(f"[poiseuille] N={sim._mpcd['position'].shape[0]} L={L}: steps {TUNE_AT}-"
          f"{POISEUILLE_STEPS}: {ms_step:.4f} ms/step (host wall {wall:.3f} s) on {card}; "
          f"profile: {ops:.1f} device operations and {busy:.4f} ms device-busy per step, "
          f"{htod:.2f} host-to-device copies and {syncs:.2f} synchronising calls per step",
          flush=True)
    print(f"[poiseuille] v_x(z) over {POISEUILLE_BINS} bins: {np.round(prof, 4).tolist()}; "
          f"parabola R^2 {r2:.4f} (> 0.95), peak {prof.max():.4f} (> 0.03), furthest solvent "
          f"{beyond:+.2e} beyond the plates", flush=True)
    if not (r2 > 0.95 and prof.max() > 0.03 and beyond <= 1e-4):
        raise AssertionError(f"poiseuille: R^2 {r2:.4f}, peak {prof.max():.4f}, solvent "
                             f"{beyond:.3e} beyond the plates")


def run_srd(az, card):
    """Pure SRD throughput: SRD_WARM steps, a 20-step profile, then SRD_STEPS
    timed steps, each with one collision; the solvent's kT relative to its
    mean within SRD_KT_BAND of 1."""
    sim = build_srd(az, "cuda")
    sim.run(SRD_WARM)
    ops, busy, htod, syncs = _profile(sim)
    ms_step, wall = _timed_run(sim, SRD_STEPS)
    kT, _ = _solvent_kT(sim)
    print(f"[srd] N={sim._mpcd['position'].shape[0]}, {SRD_STEPS} steps of one collision each: "
          f"{ms_step:.4f} ms per collision (host wall {wall:.3f} s) on {card}; profile: "
          f"{ops:.1f} device operations and {busy:.4f} ms device-busy per step, {htod:.2f} "
          f"host-to-device copies and {syncs:.2f} synchronising calls per step; solvent kT "
          f"relative to its mean {kT:.4f} (1.0 +- {SRD_KT_BAND})", flush=True)
    if abs(kT - 1.0) > SRD_KT_BAND:
        raise AssertionError(f"srd: solvent kT {kT:.4f} outside 1.0 +- {SRD_KT_BAND}")


def _build_report(cuda_build, sources):
    for src in sources:
        info = cuda_build.build_info[cuda_build.CSRC / src]
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(a) + int(b) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info["log"])]
        print(f"[build] {src}: nvcc {info['seconds']:.2f} s; ptxas: {len(regs)} kernels, "
              f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
              f"max spill {max(spills, default=0)} bytes", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    az = _import_port()
    from azplugins_tpu_torch.ops import aniso_kernel as AK
    from azplugins_tpu_torch.ops import cuda_build
    from azplugins_tpu_torch.ops import dense as D
    from azplugins_tpu_torch.ops import dpd_kernel as DK
    from azplugins_tpu_torch.ops import pair_kernel as PK

    K = types.SimpleNamespace(PK=PK, DK=DK, AK=AK)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    sources = (PK._SOURCE, DK._SOURCE, AK._SOURCE)
    cuda_build.load_libraries(*sources)
    for k in (PK, DK, AK):
        k._library()
    print(f"[build] {len(sources)} kernels in {time.perf_counter() - t0:.2f} s (parallel nvcc)",
          flush=True)
    _build_report(cuda_build, sources)

    max_err: dict[str, float] = {}

    def record(name, err):
        max_err[name] = max(max_err.get(name, 0.0), err)

    pair_timing = check_pair_kernel(az, D, PK, record)
    dpd_timing = check_dpd_kernel(az, D, DK, record)
    aniso_timing = check_aniso_kernel(az, D, AK, record)
    check_rng(az)

    launches = {}

    def count(path):
        launched, sim = path
        for name, n in launched.items():
            launches[name] = launches.get(name, 0) + n
        return sim

    # caps: the headline's own 72 and its tuned 48; the DPD fluid's own 40
    # and the capacity its occupancy asks for (8 here: grown to the smallest
    # multiple of 8 that fits); the patchy colloids' own 16 and twice that;
    # the droplet's before and after its tune
    plj = {"cell_pair_force[PerturbedLennardJones]":
           lambda: PK.launches_by_potential.get("PerturbedLennardJones", 0)}
    count(run_path(az, D, K, card, record, "headline", build_headline, 2000, 1000, plj,
                   caps=(48, 72)))
    count(run_path(az, D, K, card, record, "dpd", build_dpd, 2000, 1000,
                   {"cell_dpd_force": lambda: DK.launches}, extra_check=_dpd_momentum,
                   caps=(8, 40)))
    # the rods melt over ~8,000 steps, releasing pair energy faster than the
    # thermostat removes it (kT peaked at 1.24 near step 5,000 on an H100;
    # PERF.md), so the polymer warms up for 10,000
    count(run_path(az, D, K, card, record, "polymer", build_polymer, 10000, 1000,
                   {"cell_pair_force[ExpandedYukawa]":
                    lambda: PK.launches_by_potential.get("ExpandedYukawa", 0)},
                   extra_check=_bond_lengths))
    count(run_path(az, D, K, card, record, "patchy", build_patchy, PATCHY_WARM, 1000,
                   {"cell_aniso_force": lambda: AK.launches}, extra_check=_unit_quaternions,
                   kT=0.3, kT_band=PATCHY_KT_BAND, caps=(16, 32)))
    # the droplet's lab-frame temperature contains the flow: its own check
    # reads the evaporated particles' temperature relative to it
    droplet = count(run_path(az, D, K, card, record, "droplet", build_droplet, 2000, 1000, plj,
                             extra_check=_droplet_check, kT=None, caps="tune"))
    time_pair_on_state(az, D, PK, droplet, droplet.operations.integrator.forces[0], "droplet")
    del droplet
    for pot, n in run_potential_sweep(az, K).items():
        launches[f"cell_pair_force[{pot}]"] = n
    count((run_colloid(az, D, K, card, record), None))
    run_poiseuille(az, card)
    run_srd(az, card)

    def entry(name, source, replaces, timing):
        ms, plain_ms, _, (bound_ms, bound_by), candidates = timing
        return {
            "name": name, "route": "cuda", "source": f"azplugins_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a cell-stencil pair force
            "library_ms": None,
            # candidate pairs a call tests at the shape it was timed at
            "candidates": candidates,
        }

    kernels = [entry(f"cell_pair_force[{pot}]", PK._SOURCE, PAIR_REPLACES, pair_timing[pot])
               for pot in PK.KERNEL_POTENTIALS]
    kernels.append(entry("cell_dpd_force", DK._SOURCE, DPD_REPLACES, dpd_timing))
    kernels.append(entry("cell_aniso_force", AK._SOURCE, ANISO_REPLACES, aniso_timing))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
