#!/usr/bin/env python3
"""Time copies of the pair and DPD kernels, each with one change, on one GPU.

    python3 kernel_variants.py                 # every variant
    python3 kernel_variants.py base,noflush    # some of them

Each variant is a copy of azplugins_tpu_torch/csrc/ with one text change
(PHASES, DESIGN; a change that matches nothing, or a variant whose sources
come out the same as base's, raises), in azplugins_tpu_torch/_build/variants/
(the pair kernel with its PerturbedLennardJones and ExpandedYukawa
instantiations only). The wrappers build and launch it inside
cuda_build.sources. Each is timed, device time per call as chip_smoke.py
times it, on the 64k headline's lattice start and after 500 steps (liquid),
the polymer melt and the DPD fluid, in two turns. The phase copies split a
call:

- planonly: the block returns after step 1 (the stencil plan);
- nosweep: no candidate is tested (plan, staging and the reduction);
- noflush: no listed candidate is evaluated (all but the evaluation).

The others change one constant of the design.
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
PHASES = {
    "base": [],
    "planonly": [(".cu", "const int n_i = P.start[P.self_seg + 1] - P.start[P.self_seg];",
                  "if (cap > 0) return;\n"
                  "  const int n_i = P.start[P.self_seg + 1] - P.start[P.self_seg];")],
    "nosweep": [(".cu", "az::sweep_round<B, MIN_IMAGE>(",
                 "if (cap < 0) az::sweep_round<B, MIN_IMAGE>(")],
    "noflush": [(".cu", "auto flush = [&](float xs, float ys, float zs, int n) {",
                 "auto flush = [&](float xs, float ys, float zs, int n) {\n"
                 "      if (n >= 0) return;")],
}
DESIGN = {
    "unroll2": [(".cuh", "constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "list16": [(".cuh", "constexpr int kListLen = 32;", "constexpr int kListLen = 16;")],
    "batch8": [(".cuh", "constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "pairB128": [("cell_pair_force.cu", "constexpr int kThreads = 256;",
                  "constexpr int kThreads = 128;")],
    "dpdB256": [("cell_dpd_force.cu", "constexpr int kThreads = 128;",
                 "constexpr int kThreads = 256;")],
    "stage16": [(".cuh", "constexpr int kStageBytes = 24 * 1024;",
                 "constexpr int kStageBytes = 16 * 1024;")],
    "stage48": [(".cuh", "constexpr int kStageBytes = 24 * 1024;",
                 "constexpr int kStageBytes = 48 * 1024;")],
}
CHANGES = {**PHASES, **DESIGN}
SOURCES = ("cell_pair_force.cu", "cell_dpd_force.cu")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    az = cs._import_port()
    from azplugins_tpu_torch.ops import cuda_build
    from azplugins_tpu_torch.ops import dpd_kernel as DK
    from azplugins_tpu_torch.ops import pair_kernel as PK

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(CHANGES)
    unknown = set(names) - set(CHANGES)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(CHANGES)}")
    dirs = {n: write_variant(n, cuda_build.CSRC, cuda_build.BUILD_DIR / "variants")
            for n in names}
    t0 = time.perf_counter()
    jobs = [(dirs[n], src) for n in names for src in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc each, all at once
        list(pool.map(lambda job: cuda_build.load_library(job[1], job[0]), jobs))
    for n in names:
        for src in SOURCES:
            log = cuda_build.build_info[dirs[n] / src]["log"]
            for key in ("pair_force_kernelILi0ELb0ELb0ELb0", "dpd_force_kernelILb0ELb0"):
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
    print(f"[shapes] headline cap {lattice[1].cap}, polymer cap {polymer[1].cap}, DPD fluid cap "
          f"{ds.cap}", flush=True)

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
                ]
            print(f"[turn {turn}] {name:9s} ms: PLJ headline {ms[0]:.4f}, PLJ liquid "
                  f"{ms[1]:.4f}, ExpandedYukawa polymer {ms[2]:.4f}, DPD fluid {ms[3]:.4f}",
                  flush=True)
    print(cs._card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
