#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU, end to end.

    python3 chip_smoke.py        # from the repository root; needs one GPU

1. checks for a CUDA device and prints its name and power limit;
2. builds the CUDA kernels from azplugins_tpu_torch/csrc/;
3. holds the pair-force kernel against its plain PyTorch version on the
   card, at small, tilted, uneven, two-type, small-grid and 64k shapes;
4. checks that Threefry and the Langevin noise are bitwise the same on the
   GPU and the CPU;
5. runs the 64k perturbed-LJ Langevin main path (the JAX package's bench
   headline) through the public API, times it, and checks that every force
   evaluation went through the kernel and that the result is physical;
6. prints the kernel summary and, last, the contract line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the result lines.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# kernel bar: per-slot values within atol = BAR * max|ref| and rtol = BAR
BAR = 2e-5
HEADLINE = dict(N_side=40, rho=0.85, seed=12345)


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
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _lattice_snapshot(az, counts, rho, jitter, seed, tilt=(0.0, 0.0, 0.0), n_types=1,
                      clustered=False):
    """A jittered simple-cubic lattice of counts[0] x counts[1] x counts[2]
    sites at number density rho, in a box of that shape (optionally tilted,
    optionally squeezed along x into uneven cell occupancies)."""
    rng = np.random.default_rng(seed)
    N = int(np.prod(counts))
    a = (1.0 / rho) ** (1.0 / 3.0)
    Ls = [c * a for c in counts]
    snap = az.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = ["A", "B", "C", "D"][:n_types]
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
    f = (grid.reshape(-1, 3) + 0.5) / np.asarray(counts)
    if clustered:
        # periodic squeeze: sites crowd (spacing x0.7) around x = -L/2
        f[:, 0] = f[:, 0] - 0.3 * np.sin(2.0 * np.pi * f[:, 0]) / (2.0 * np.pi)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0.0, Ls[1], tilt[2] * Ls[2]],
                  [0.0, 0.0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0.0, jitter, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, n_types, N)
    return snap


def _dense_case(az, D, snap, r_cut, buffer, device, cap=None):
    """Densify, growing the capacity from ``cap`` (default: the grid's own)
    until the configuration fits, as the simulation does on overflow."""
    state, types, _ = az.core.state_from_snapshot(snap, device)
    spec = D.GridSpec.create(state.box, state.N, r_cut, buffer)
    if cap is not None:
        spec = spec.replace(cap=cap)
    dense, meta = D.densify(state, spec, fields=())
    while bool(meta.overflow):
        spec = spec.replace(cap=int(np.ceil((int(meta.max_occ) + 1) / 8.0) * 8))
        dense, meta = D.densify(state, spec, fields=())
    return dense, spec, len(types)


def _plj_tables(az, T, seed, r_cut, device):
    rng = np.random.default_rng(seed)

    def sym(lo, hi):
        a = rng.uniform(lo, hi, (T, T))
        return (a + a.T) / 2

    host = {"epsilon": sym(0.5, 1.5), "sigma": sym(0.9, 1.1),
            "attraction_scale_factor": sym(0.0, 1.0)}
    if T == 1:
        host = {"epsilon": np.ones((1, 1)), "sigma": np.ones((1, 1)),
                "attraction_scale_factor": np.full((1, 1), 0.5)}
    pre = az.ops.evaluators.PAIR_POTENTIALS["PerturbedLennardJones"].precompute(host)
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in pre.items()}
    rc = torch.full((T, T), float(r_cut), dtype=torch.float32, device=device)
    return params, rc


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


def check_kernel(az, D, PK):
    """Kernel against the plain version on the card, at every listed shape."""
    dev = torch.device("cuda")
    ef = az.ops.evaluators.perturbed_lennard_jones
    cases = [
        ("small orthorhombic", dict(counts=(14, 14, 14), rho=0.85, jitter=0.06, seed=1), 2.5,
         ("none",)),
        ("tilted triclinic", dict(counts=(14, 14, 14), rho=0.8, jitter=0.06, seed=2,
                                  tilt=(0.35, -0.2, 0.15)), 2.5, ("none", "shift")),
        ("uneven overfull", dict(counts=(16, 14, 14), rho=0.6, jitter=0.03, seed=3,
                                 clustered=True), 2.5, ("none",), 16),
        ("two types", dict(counts=(12, 12, 12), rho=0.85, jitter=0.06, seed=4, n_types=2),
         2.5, ("none", "shift")),
        ("axis under 3 cells", dict(counts=(5, 16, 16), rho=0.85, jitter=0.06, seed=5), 2.5,
         ("none", "shift")),
        ("64k headline", dict(counts=(40, 40, 40), rho=0.85, jitter=0.05, seed=6), 3.0,
         ("none",)),
    ]
    headline = None
    for label, kw, r_cut, modes, *cap in cases:
        dense, spec, T = _dense_case(az, D, _lattice_snapshot(az, **kw), r_cut, 0.4, dev, *cap)
        params, rc = _plj_tables(az, T, 10 + T, r_cut, dev)
        kern = PK.plj_kernel_tables(params, rc)
        jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
        for mode in modes:
            for want in ("force", "all"):
                got = PK.cell_pair_force(dense, spec, kern, mode, want)
                ref = D.dense_pair_force(ef, dense, jb, spec, params, rc, None, mode, want)
                torch.cuda.synchronize()
                tag = f"{label} dims={spec.dims} cap={spec.cap} T={T} {mode} {want}"
                ferr, fscale = _compare(tag + " force", got.force, ref.force)
                line = f"[kernel] {tag}: force max_abs_err {ferr:.3e} (max|f| {fscale:.3e})"
                if want == "all":
                    eerr, _ = _compare(tag + " energy", got.energy, ref.energy)
                    verr, _ = _compare(tag + " virial", got.virial, ref.virial)
                    line += f", energy {eerr:.3e}, virial {verr:.3e}"
                print(line, flush=True)
                if label == "64k headline" and want == "force":
                    headline = (dense, spec, kern, jb, params, rc, ferr)
    dense, spec, kern, jb, params, rc, ferr = headline
    ms = _cuda_time_ms(lambda: PK.cell_pair_force(dense, spec, kern, "none", "force"), 50)
    plain_ms = _cuda_time_ms(
        lambda: D.dense_pair_force(ef, dense, jb, spec, params, rc, None, "none", "force"), 5
    )
    print(f"[kernel] 64k headline: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call",
          flush=True)
    return {"max_abs_err": ferr, "ms": ms, "plain_ms": plain_ms}


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


def build_sim(az, device):
    """BASELINE config 1, the bench headline, through the port's public API."""
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
    return sim, lj


def run_main_path(az, D, PK, card, warm_steps=3000, steps=1000):
    sim, lj = build_sim(az, "cuda")
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    t0 = time.perf_counter()
    sim.run(warm_steps)
    torch.cuda.synchronize()
    print(f"[main] N={sim.state.N_particles} grid {sim._grid_spec}: {warm_steps} warm-up "
          f"steps in {time.perf_counter() - t0:.1f} s", flush=True)

    builds0, replays0, evals0 = sim.n_builds, sim.viol_replays, sim.force_evaluations
    PK.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    sim.run(steps)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PK.launches
    evals = sim.force_evaluations - evals0
    builds = sim.n_builds - builds0
    ms_step = start.elapsed_time(end) / steps

    if launches != evals or launches < steps:
        raise AssertionError(f"{launches} kernel launches for {evals} force evaluations")
    dense = sim._dense
    if not bool(torch.isfinite(dense.position).all()):
        raise AssertionError("non-finite positions after the main path")
    kT = thermo.kinetic_temperature
    if abs(kT - 1.0) > 0.05:
        raise AssertionError(f"kinetic temperature {kT:.4f} outside 1.0 +- 0.05")
    if not 0 < builds < steps // 2:
        raise AssertionError(f"{builds} grid builds in {steps} steps")
    pos = sim.state.get_snapshot().particles.position
    L = sim.state.box.Lx
    if not (np.isfinite(pos).all() and np.abs(pos).max() <= L / 2 + 1e-3):
        raise AssertionError("wrapped positions outside the box")

    # observables through the kernel's energy/virial path, and the kernel
    # against the plain version on the run's own (melted) state
    u = lj.energy / sim.state.N_particles
    p = thermo.pressure
    if not (np.isfinite(u) and np.isfinite(p)):
        raise AssertionError("non-finite energy or pressure")
    spec = sim._grid_spec
    tbl = lj._device_tables(sim.device)
    got = PK.cell_pair_force(dense, spec, tbl["kernel"], "none", "all")
    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    ref = D.dense_pair_force(az.ops.evaluators.perturbed_lennard_jones, dense, jb, spec,
                             tbl["params"], tbl["r_cut"], None, "none", "all")
    ferr, _ = _compare("main-path state force", got.force, ref.force)
    _compare("main-path state energy", got.energy, ref.energy)
    _compare("main-path state virial", got.virial, ref.virial)

    rebin_ms = _cuda_time_ms(lambda: D.rebin(dense, sim._meta, spec, sim._state.N, sim._fields,
                                             False), 20)
    kernel_ms = _cuda_time_ms(lambda: PK.cell_pair_force(dense, spec, tbl["kernel"]), 50)
    print(f"[main] {steps} steps: {ms_step:.4f} ms/step, {1000.0 / ms_step:.1f} TPS "
          f"(host wall {wall:.3f} s) on {card}", flush=True)
    print(f"[main] kernel {kernel_ms:.4f} ms/call, rebin {rebin_ms:.4f} ms/rebuild at "
          f"cap {spec.cap}, on {card}", flush=True)
    print(f"[main] {builds} grid builds ({steps / max(builds, 1):.1f} steps each), "
          f"{sim.viol_replays - replays0} violation replays, kinetic temperature {kT:.4f}, "
          f"U/N {u:.4f}, pressure {p:.4f}, kernel vs plain on this state {ferr:.3e}",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    az = _import_port()
    from azplugins_tpu_torch.ops import cuda_build
    from azplugins_tpu_torch.ops import dense as D
    from azplugins_tpu_torch.ops import pair_kernel as PK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    PK._library()
    info = cuda_build.build_info[PK._SOURCE]
    print(f"[build] {PK._SOURCE}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s)", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    kern = check_kernel(az, D, PK)
    check_rng(az)
    launches = run_main_path(az, D, PK, card)

    summary = {"kernels": [{
        "name": "cell_pair_force",
        "route": "cuda",
        "source": "azplugins_tpu_torch/csrc/cell_pair_force.cu",
        "replaces": "azplugins_tpu/ops/pallas_pair.py:334",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
