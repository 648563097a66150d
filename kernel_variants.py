#!/usr/bin/env python3
"""Time copies of the force kernels and of K6/K8, each with one change, on one GPU.

    python3 kernel_variants.py                 # every variant
    python3 kernel_variants.py base,noflush    # some of them
    python3 kernel_variants.py base,planonly,nosweep,noflush --pair-side 64
                                               # K1 alone, headline of 64^3

Each variant is a copy of azplugins_tpu_torch/csrc/ with one text change
(PHASES, DESIGN, INTEGRATE; a change that matches nothing, or a variant
whose sources come out the same as base's, raises), in
azplugins_tpu_torch/_build/variants/
(the pair kernel with its PerturbedLennardJones and ExpandedYukawa
instantiations only). The wrappers build and launch it inside
cuda_build.sources. Each is timed, device time per call as chip_smoke.py
times it, on the 64k headline's lattice start and after 500 steps (liquid),
the polymer melt, the DPD fluid, the patchy colloids' lattice start (mean
occupancy 2.2 at cap 16) and a dense TwoPatchMorse state (24^3 cells of
exactly 8 at cap 8), in two turns. The phase copies split a call:

- empty: the block returns at once (the launch alone);
- planonly: the block returns after step 1 (the stencil plan);
- nosweep: no candidate is tested (plan, staging and the reduction);
- noflush: no listed candidate is evaluated (all but the evaluation);
- for the TwoPatchMorse kernel also anisoNoRuns (planonly without the
  members' runs), anisoNoStage, anisoNoReduce, anisoNoZero (nosweep without
  the staging, the reduction, the zeroing of empty slots) and
  anisoLanesOnly (nosweep without all three: the plan and the lanes' own
  loads).

With ``--pair-side n`` only the pair kernel is built and timed: K1 on the
headline of n^3 particles (64: the 262,144 of ``plj_langevin.n262k``)
after 500 steps, in two turns; where the source has K1's pair lists, also
their build from the last rebuild's positions and the sweep of the first
variant's lists at the current positions (a segment's step), each in
every variant, and the lists' lengths.

The others change one constant of the design. Each variant also times
the drift check K6 (``needs_rebin``) at the headline's liquid state (82,944
slots) and the patchy colloids' (194,672: the grid stride past
kDriftMaxBlocks blocks), K7+K6 in one launch (``step1`` with a drift
check, K6's kernel with its step1 prologue) at the headline, and the
Langevin kick K8 (``step2``) at the headline, noisy, with a flow field
(random velocities) and NVE; the INTEGRATE copies change K6's (and so
K7+K6's) or K8's design:

- driftCluster8: K6's blocks merged in thread block clusters of 8
  (``__cluster_dims__``) through distributed shared memory before their
  partials, so one block in 8 writes a partial and takes a ticket;
- driftB128: 128 threads a block (648 blocks at the headline);
- driftThreadfence: the ticket relaxed between two sequentially
  consistent fences (__threadfence), as K6's first version took it,
  instead of one acquire-release atomic;
- phase copies (wrong results, timing only): driftEmpty, every block
  returns at once (the launch); driftNoMerge, after its loads; driftNoTicket,
  after its block's merge (no partial, no ticket, no last block);
  driftNoLastLoads, the last ticket loads no partial; driftRelaxed, the
  ticket without its ordering;
- step2B64, step2B256: K8's block of 64 and 256 threads;
- step2Gamma128: K8 stages only the gamma table's first 128 types (one a
  thread) and loads a higher type's gamma from global memory.
"""

from __future__ import annotations

import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs

# variant -> (source-name suffix, old text, new text) changes; a change
# applies to each copied source whose name ends with the suffix
_K1 = "cell_pair_force.cu"
PHASES = {
    "base": [],
    "empty": [(".cu", "  constexpr int B = kThreads;\n",
               "  constexpr int B = kThreads;\n  if (cap > 0) return;\n")],
    "planonly": [(_K1, "const int n_i = P.prefix ?",
                  "if (cap > 0) return;\n  const int n_i = P.prefix ?"),
                 ("cell_dpd_force.cu",
                  "const int n_i = P.start[P.self_seg + 1] - P.start[P.self_seg];",
                  "if (cap > 0) return;\n"
                  "  const int n_i = P.start[P.self_seg + 1] - P.start[P.self_seg];"),
                 ("cell_aniso_force.cu", "const int n_tot = P.first[n_members];",
                  "if (cap > 0) return;\n  const int n_tot = P.first[n_members];")],
    "nosweep": [(".cu", "az::sweep_round<B, MIN_IMAGE>(",
                 "if (cap < 0) az::sweep_round<B, MIN_IMAGE>("),
                (_K1, "az::sweep_list<B, MIN_IMAGE>(",
                 "if (cap < 0) az::sweep_list<B, MIN_IMAGE>("),
                ("cell_aniso_force.cu", "sweep_group<B, MIN_IMAGE>(P, stage,",
                 "if (cap < 0) sweep_group<B, MIN_IMAGE>(P, stage,")],
    "noflush": [(".cu", "auto flush = [&](float xs, float ys, float zs, int n) {",
                 "auto flush = [&](float xs, float ys, float zs, int n) {\n"
                 "      if (n >= 0) return;"),
                (_K1, "auto flush_listed = [&](int n) {",
                 "auto flush_listed = [&](int n) {\n      if (n >= 0) return;")],
}
# finer copies of the TwoPatchMorse kernel's start, each on top of a phase copy
_A = "cell_aniso_force.cu"
_NO_STAGE = (_A, "        stage_group<B>(\n", "        if (cap < 0) stage_group<B>(\n")
_NO_REDUCE = (_A, "    reduce_group<B, N_ACC>(part, acc, K, p0, np,",
              "    if (cap < 0) reduce_group<B, N_ACC>(part, acc, K, p0, np,")
_NO_ZERO = (_A, "  for (int j = 0; j < n_members; ++j) {\n    // empty slots sum",
            "  for (int j = 0; j < n_members && cap < 0; ++j) {\n    // empty slots sum")
PHASES.update({
    "anisoNoRuns": PHASES["planonly"] + [
        (_A, "    for (int j = 0; j < n_members; ++j) {\n      // lane = segment of member j;",
         "    for (int j = 0; j < n_members && cap < 0; ++j) {\n"
         "      // lane = segment of member j;")],
    "anisoNoStage": PHASES["nosweep"] + [_NO_STAGE],
    "anisoNoReduce": PHASES["nosweep"] + [_NO_REDUCE],
    "anisoNoZero": PHASES["nosweep"] + [_NO_ZERO],
    "anisoLanesOnly": PHASES["nosweep"] + [_NO_STAGE, _NO_REDUCE, _NO_ZERO],
})
DESIGN = {
    "unroll2": [(".cuh", "constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "list16": [(".cuh", "constexpr int kListLen = 32;", "constexpr int kListLen = 16;")],
    "batch8": [(".cuh", "constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "pairB128": [("cell_pair_force.cu", "constexpr int kThreads = 256;",
                  "constexpr int kThreads = 128;")],
    "pairMin3": [(_K1, "__global__ void __launch_bounds__(kThreads)\n    cell_pair_force_kernel(",
                  "__global__ void __launch_bounds__(kThreads, 3)\n    cell_pair_force_kernel(")],
    "dpdB256": [("cell_dpd_force.cu", "constexpr int kThreads = 128;",
                 "constexpr int kThreads = 256;")],
    "stage16": [(".cuh", "constexpr int kStageBytes = 24 * 1024;",
                 "constexpr int kStageBytes = 16 * 1024;")],
    "stage48": [(".cuh", "constexpr int kStageBytes = 24 * 1024;",
                 "constexpr int kStageBytes = 48 * 1024;")],
    "anisoB64": [("cell_aniso_force.cu", "constexpr int kThreads = 32;",
                  "constexpr int kThreads = 64;")],
    "anisoB128": [("cell_aniso_force.cu", "constexpr int kThreads = 32;",
                   "constexpr int kThreads = 128;")],
    "anisoG1": [("cell_aniso_force.cu", "constexpr int kGroup = 4;", "constexpr int kGroup = 1;")],
    "anisoG2": [("cell_aniso_force.cu", "constexpr int kGroup = 4;", "constexpr int kGroup = 2;")],
    "anisoG8": [("cell_aniso_force.cu", "constexpr int kGroup = 4;", "constexpr int kGroup = 8;")],
    "anisoBatch2": [("cell_aniso_force.cu", "constexpr int kStageBatch = 4;",
                     "constexpr int kStageBatch = 2;")],
    "anisoStage128": [("cell_aniso_force.cu", "constexpr int kStageEntries = 256;",
                       "constexpr int kStageEntries = 128;")],
    "anisoStage768": [("cell_aniso_force.cu", "constexpr int kStageEntries = 256;",
                       "constexpr int kStageEntries = 768;")],
}
_I = "integrate.cu"
# K6's cluster merge: a cluster's blocks send their top twos to its first
# block through distributed shared memory; that block holds the partial
_CLUSTER_MERGE = """  top = block_top2<B>(top);
  {
    namespace cg = cooperative_groups;
    __shared__ Top2 s_cluster[8];
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    if (t == 0) *cluster.map_shared_rank(s_cluster + rank, 0) = top;
    cluster.sync();
    if (rank != 0) return;
    if (t < 32) top = warp_top2(t < 8 ? s_cluster[t] : Top2{0u, 0u});
  }
"""
INTEGRATE = {
    "driftCluster8": [
        (_I, "#include <cuda_runtime.h>\n",
         "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
        (_I, "__global__ void __launch_bounds__(kDriftThreads)\n    drift_kernel(",
         "__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kDriftThreads)\n"
         "    drift_kernel("),
        (_I, "  top = block_top2<B>(top);\n", _CLUSTER_MERGE),
        (_I, "const int parts = gridDim.x;", "const int parts = gridDim.x / 8;"),
        (_I, "partials[blockIdx.x] =", "partials[blockIdx.x / 8] ="),
        (_I, "  return (unsigned)(grid < kDriftMaxBlocks ? grid : kDriftMaxBlocks);\n",
         "  return (unsigned)((grid < kDriftMaxBlocks ? grid : kDriftMaxBlocks) + 7) / 8 * 8;\n"),
    ],
    "driftB128": [(_I, "constexpr int kDriftThreads = 256;", "constexpr int kDriftThreads = 128;")],
    "driftThreadfence": [(_I, 'asm volatile("atom.acq_rel.gpu.global.add.u32',
                          '__threadfence();\n  asm volatile("atom.relaxed.gpu.global.add.u32'),
                         (_I, "  __syncwarp();  // lane 0's acquire before every lane's loads",
                          "  __threadfence();")],
    # phase copies of K6 (timing only: their results are wrong): no
    # partial and no ticket; the last ticket merging no partial
    "driftNoTicket": [(_I, "  if (t >= 32) return;\n  // warp 0 of a block",
                       "  if (n > 0) return;\n  // warp 0 of a block")],
    "driftNoLastLoads": [(_I, "q[k] = 2 * j < parts ? __ldcg(quads + j)",
                          "q[k] = 2 * j < 0 ? __ldcg(quads + j)")],
    "driftEmpty": [(_I, "  // the flag the verdict ORs, read now",
                    "  if (n > 0) return;\n  // the flag the verdict ORs, read now")],
    "driftNoMerge": [(_I, "  top = block_top2<B>(top);\n",
                      "  if (n > 0) return;\n  top = block_top2<B>(top);\n")],
    "driftRelaxed": [(_I, "atom.acq_rel.gpu.global.add.u32", "atom.relaxed.gpu.global.add.u32")],
    "step2B64": [(_I, "constexpr int kStep2Threads = 128;", "constexpr int kStep2Threads = 64;")],
    "step2B256": [(_I, "constexpr int kStep2Threads = 128;", "constexpr int kStep2Threads = 256;")],
    "step2Gamma128": [
        (_I, "    for (int k = t + B; k < nz.n_types; k += B) s_gamma[k] = __ldg(nz.table + k);\n",
         ""),
        (_I, "    g = s_gamma[min(max(ty, 0), nz.n_types - 1)];",
         "    const int ty_c = min(max(ty, 0), nz.n_types - 1);\n"
         "    g = ty_c < B ? s_gamma[ty_c] : __ldg(nz.table + ty_c);"),
    ],
}
CHANGES = {**PHASES, **DESIGN, **INTEGRATE}
SOURCES = ("cell_pair_force.cu", "cell_dpd_force.cu", "cell_aniso_force.cu", _I)


def variant_sources(variant: str, csrc: Path) -> dict[str, str]:
    """The variant's text of every ``csrc/*.cuh`` and of SOURCES. Raises
    when one of its changes matches no file, or when a variant other than
    base leaves every file as base has it."""

    def texts(changes):
        out, applied = {}, [0] * len(changes)
        for src in (*sorted(csrc.glob("*.cuh")), *(csrc / s for s in SOURCES)):
            text = src.read_text()
            for n, (where, old, new) in enumerate(changes):
                if src.name.endswith(where) and old in text:
                    applied[n] += text.count(old)
                    text = text.replace(old, new)
            if src.name == "cell_pair_force.cu":
                text = re.sub(r"    case k(LJ|Colloid|Hertz|Morse|Gaussian|Yukawa):.*\n", "",
                              text)
            out[src.name] = text
        return out, applied

    out, applied = texts(CHANGES[variant])
    for (where, old, _), n in zip(CHANGES[variant], applied):
        if n == 0:
            raise ValueError(f"variant {variant}: no *{where} holds {old!r}")
    if variant != "base" and out == texts([])[0]:
        raise ValueError(f"variant {variant}: its sources are base's")
    return out


def write_variant(variant: str, csrc: Path, root: Path) -> Path:
    """Write the variant's sources under ``root/variant``; returns the directory."""
    out = root / variant
    out.mkdir(parents=True, exist_ok=True)
    for name, text in variant_sources(variant, csrc).items():
        (out / name).write_text(text)
    return out


def pair_split(names: list[str], side: int) -> int:
    """K1 of every variant in ``names`` on the headline of ``side``^3
    particles after 500 steps (the liquid), device ms a call, two turns."""
    az = cs._import_port()
    from azplugins_tpu_torch.ops import cuda_build
    from azplugins_tpu_torch.ops import pair_kernel as PK

    src = "cell_pair_force.cu"
    dirs = {n: write_variant(n, cuda_build.CSRC, cuda_build.BUILD_DIR / "variants") for n in names}
    t0 = time.perf_counter()
    # the variants' K1 and every library the simulation loads, one nvcc each, at once
    jobs = {(src, cuda_build.source_digest(src, d)): (src, d) for d in dirs.values()}
    jobs.update({(s.name, ""): (s.name, cuda_build.CSRC) for s in cuda_build.CSRC.glob("*.cu")})
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: cuda_build.load_library(*job), jobs.values()))
    print(f"[build] {len(names)} variants of {src} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = cuda_build.build_info[dirs[names[0]] / src]["log"]
    for m in re.finditer(r"Compiling entry function '\w*cell_pair_force_kernelILi0E((?:Lb[01]E)+)"
                         r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*?(\d+) bytes spill stores[^\n]*\n"
                         r"[^\n]*?Used (\d+) registers", log):
        print(f"[build] {names[0]} PLJ instance {m.group(1)}: {m.group(3)} registers, "
              f"{m.group(2)} bytes spilled", flush=True)
    dev = torch.device("cuda")
    sim, forces = cs.build_headline(az, dev, N_side=side)
    sim.run(500)
    torch.cuda.synchronize()
    plj = forces[0]._device_tables(dev)["kernel"]
    dense, spec, ref = sim._dense, sim._grid_spec, sim._meta.ref_position
    print(f"[shapes] {side}^3 headline after 500 steps: dims {spec.dims}, cap {spec.cap}, "
          f"{cs._candidates(dense, spec)} candidate pairs", flush=True)
    lists = hasattr(PK, "build_pair_list")  # a source with K1's pair lists
    if lists:
        # the lists of the layout's last rebuild, swept at the current positions
        pl = PK.PairList(spec, dev, torch.zeros((), dtype=torch.int64, device=dev))
        with cuda_build.sources(dirs[names[0]]):
            PK.build_pair_list(dense, ref, spec, forces[0]._max_r_cut(), pl)
        torch.cuda.synchronize()
        counts = pl.counts.to(torch.int64)
        lanes = counts[pl.fallback == 0]
        print(f"[lists] {names[0]}'s build: cap_e {pl.cap_e}, {int(pl.n_fallback)} blocks fall "
              f"back; entries a lane: mean {float(lanes[lanes > 0].double().mean()):.2f}, "
              f"max {int(lanes.max())}; {int(counts.sum())} entries", flush=True)
        scratch = PK.PairList(spec, dev, torch.zeros((), dtype=torch.int64, device=dev))
    for turn in range(2):
        for name in names:
            with cuda_build.sources(dirs[name]):
                ms = cs._cuda_time_ms(lambda: PK.cell_pair_force(
                    dense, spec, plj, "PerturbedLennardJones", "none"), 50)
                extra = ""
                if lists:
                    build = cs._cuda_time_ms(lambda: PK.build_pair_list(
                        dense, ref, spec, forces[0]._max_r_cut(), scratch), 50)
                    sweep = cs._cuda_time_ms(lambda: PK.cell_pair_force(
                        dense, spec, plj, "PerturbedLennardJones", "none", pair_list=pl), 50)
                    extra = f", build {build:.4f} ms, sweep {sweep:.4f} ms"
            print(f"[turn {turn}] {name:14s} K1 {ms:.4f} ms{extra}", flush=True)
    print(cs._card())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    az = cs._import_port()
    from azplugins_tpu_torch.ops import aniso_kernel as AK
    from azplugins_tpu_torch.ops import cuda_build
    from azplugins_tpu_torch.ops import dense as D
    from azplugins_tpu_torch.ops import dpd_kernel as DK
    from azplugins_tpu_torch.ops import integrate_kernel as IK
    from azplugins_tpu_torch.ops import pair_kernel as PK

    args = sys.argv[1:]
    side = None
    if "--pair-side" in args:
        k = args.index("--pair-side")
        side = int(args[k + 1])
        del args[k:k + 2]
    names = args[0].split(",") if args else list(CHANGES)
    unknown = set(names) - set(CHANGES)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(CHANGES)}")
    if side is not None:
        return pair_split(names, side)
    dirs = {n: write_variant(n, cuda_build.CSRC, cuda_build.BUILD_DIR / "variants")
            for n in names}
    t0 = time.perf_counter()
    jobs = [(dirs[n], src) for n in names for src in SOURCES]
    # variants that leave a source as another has it share its library: one
    # nvcc per distinct source, all at once, then the rest load what is built
    distinct = {(src, cuda_build.source_digest(src, d)): (d, src) for d, src in jobs}
    with ThreadPoolExecutor(len(distinct)) as pool:
        list(pool.map(lambda job: cuda_build.load_library(job[1], job[0]), distinct.values()))
    for d, src in jobs:
        cuda_build.load_library(src, d)
    for n in names:
        for src in SOURCES:
            log = cuda_build.build_info[dirs[n] / src]["log"]
            for key in ("pair_force_kernelILi0ELb0ELb0ELb0", "dpd_force_kernelILb0ELb0",
                        "aniso_force_kernelILb0ELb0", "drift_kernelILb0ELb0E",
                        "drift_kernelILb1ELb0E",
                        "step2_kernelILi2ELb0ELb0E"):
                m = re.search(key + r".*\n.*?(\d+) bytes spill stores.*\n.*?Used (\d+) registers",
                              log)
                if m:
                    print(f"[build] {n} {key}: {m.group(2)} registers, {m.group(1)} bytes "
                          "spilled", flush=True)
    print(f"[build] {len(names)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    sim, forces = cs.build_headline(az, dev)
    lattice = cs._prepared_dense(sim)
    plj = forces[0]._device_tables(dev)["kernel"]
    sim.run(500)
    torch.cuda.synchronize()
    liquid = (sim._dense, sim._grid_spec)
    hd, hmeta, lang = sim._dense, sim._meta, sim.operations.integrator.methods[0]
    dt, t, seed = sim.dt_ref(), sim.timestep, sim.seed
    noise = IK.Noise(lang._table_on("_gamma_table", dev), lang._rng_stream, seed, t, lang.kT(t),
                     True)
    flow = torch.randn(hd.velocity.shape, generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    viol = torch.tensor(False, device=dev)
    check = az.md.methods.DriftCheck(hmeta, liquid[1], viol)

    def k8(noise, flow=None):
        return lambda: IK.step2(hd.tag, None, hd.typeid, hd.velocity, hd.acceleration,
                                hd.net_force, hd.mass, dt, noise, flow)
    sim, forces = cs.build_polymer(az, dev)
    polymer = cs._prepared_dense(sim)
    eyk = forces[1]._device_tables(dev)["kernel"]
    sim, _ = cs.build_dpd(az, dev)
    dd, ds = cs._prepared_dense(sim)
    g = torch.Generator(device=dev).manual_seed(25)
    vel = torch.randn(dd.velocity.shape, generator=g, device=dev)
    dd = dd.replace(velocity=torch.where(dd.tag[:, None] >= 0, vel, 0.0))
    one = torch.ones((1, 1), device=dev)
    dpd = DK.dpd_kernel_tables({"A": 25.0 * one, "gamma": 4.5 * one, "s": 0.5 * one}, one, 1.0,
                               0.01)
    psim = cs.build_patchy(az, dev)[0]
    patchy = cs._prepared_dense(psim)
    full = cs._dense_case(
        az, D, cs._lattice_snapshot(az, counts=(48, 48, 48), rho=1.1, jitter=0.03, seed=41,
                                    quats=True), 1.6, 0.3, dev, 8, fields=("quat",))[:2]
    tbl = cs._aniso_tables(az, 1, 35, dev)
    tpm = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "shift")
    print(f"[shapes] headline cap {lattice[1].cap}, polymer cap {polymer[1].cap}, DPD fluid cap "
          f"{ds.cap}, patchy cap {patchy[1].cap} ({cs._candidates(*patchy)} candidate pairs), "
          f"dense TwoPatchMorse dims {full[1].dims} cap {full[1].cap} "
          f"({cs._candidates(*full)} candidate pairs)", flush=True)

    for turn in range(2):
        for name in names:
            with cuda_build.sources(dirs[name]):
                ms = [
                    cs._cuda_time_ms(lambda: PK.cell_pair_force(
                        *lattice, plj, "PerturbedLennardJones", "none"), 50),
                    cs._cuda_time_ms(lambda: PK.cell_pair_force(
                        *liquid, plj, "PerturbedLennardJones", "none"), 50),
                    cs._cuda_time_ms(lambda: PK.cell_pair_force(
                        *polymer, eyk, "ExpandedYukawa", "none"), 50),
                    cs._cuda_time_ms(lambda: DK.cell_dpd_force(dd, ds, dpd, 5, 777), 50),
                    cs._cuda_time_ms(lambda: AK.cell_aniso_force(*patchy, tpm), 50),
                    cs._cuda_time_ms(lambda: AK.cell_aniso_force(*full, tpm), 50),
                ]
                step = [
                    cs._cuda_time_ms(lambda: D.needs_rebin(hd, hmeta, liquid[1], viol), 50),
                    cs._cuda_time_ms(lambda: D.needs_rebin(patchy[0], psim._meta, patchy[1],
                                                           viol), 50),
                    cs._cuda_time_ms(lambda: lang.step1(hd, dt, t, seed, check), 50),
                    cs._cuda_time_ms(k8(noise), 50),
                    cs._cuda_time_ms(k8(noise, flow), 50),
                    cs._cuda_time_ms(k8(None), 50),
                ]
            print(f"[turn {turn}] {name:14s} ms: PLJ headline {ms[0]:.4f}, PLJ liquid "
                  f"{ms[1]:.4f}, ExpandedYukawa polymer {ms[2]:.4f}, DPD fluid {ms[3]:.4f}, "
                  f"TwoPatchMorse patchy {ms[4]:.4f}, TwoPatchMorse dense {ms[5]:.4f}; K6 "
                  f"headline {step[0]:.4f}, patchy {step[1]:.4f}; K7+K6 headline {step[2]:.4f}; "
                  f"K8 Langevin {step[3]:.4f}, flow {step[4]:.4f}, NVE {step[5]:.4f}", flush=True)
    print(cs._card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
