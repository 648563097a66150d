#!/usr/bin/env python3
"""Time whole steps of two checkouts of the port in one process, on one GPU.

    python3 step_timers.py OTHER_ROOT [PATH ...]    # OTHER_ROOT: another checkout

Imports this checkout's azplugins_tpu_torch and OTHER_ROOT's (under the
name ``azplugins_tpu_torch_other``) into one process, builds both trees'
kernels, and runs chip_smoke.py's full-size paths that both trees have (the
64k headline, the DPD fluid, the polymer melt, the patchy colloids, the
evaporating droplet, colloid hydrodynamics, pure SRD and the SRD
Poiseuille slit; the PATHs named, default all) from the same start in
each: ``WARM`` steps (the droplet ``DROPLET_WARM``, as its main path in
chip_smoke.py), then ``STEPS`` timed steps in
eight turns, (other, this, this, other) twice, each timed with CUDA events
around ``sim.run`` and profiled over 20 steps (device operations and
device-busy ms a step, as chip_smoke.py's profile line). The host clock
moves between processes by up to 73% on one card, so two trees are
compared only inside one process, in turns. Prints one line per path and
turn with the cap and rebuild interval (and the segment graphs' captures
and replays so far, and on the MPCD-only paths of a tree that has them
the SRD advance graphs'), a
line per path with each tree's
median ms/step and device-busy ms and the spread of its turns (max - min),
then the card.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

WARM = 400
DROPLET_WARM = 2000
STEPS = 300
TURNS = ("other", "this", "this", "other") * 2
PATHS = (("headline", cs.build_headline), ("dpd", cs.build_dpd),
         ("polymer", cs.build_polymer), ("patchy", cs.build_patchy),
         ("droplet", cs.build_droplet), ("colloid", cs.build_colloid),
         # the MPCD-only paths (their builders return the simulation alone)
         ("srd", lambda az, dev: (cs.build_srd(az, dev), None)),
         ("poiseuille", lambda az, dev: (cs.build_poiseuille(az, dev), None)))


def _import_other(root: Path):
    """OTHER_ROOT's package under another name (its imports are relative)."""
    pkg = root / "azplugins_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "azplugins_tpu_torch_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _build_kernels(az):
    ops = importlib.import_module(az.__name__ + ".ops")
    kernels = [importlib.import_module(f"{ops.__name__}.{m}")
               for m in ("pair_kernel", "dpd_kernel", "aniso_kernel")]
    cuda_build = importlib.import_module(f"{ops.__name__}.cuda_build")
    cuda_build.load_libraries(*(k._SOURCE for k in kernels))
    for k in kernels:
        k._library()


def main() -> int:
    if not torch.cuda.is_available():
        print("step_timers: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    names = sys.argv[2:] or [label for label, _ in PATHS]
    if len(sys.argv) < 2 or not set(names) <= {label for label, _ in PATHS}:
        print(__doc__, file=sys.stderr)
        return 2
    this = cs._import_port()
    other = _import_other(Path(sys.argv[1]).resolve())
    trees = {"other": other, "this": this}
    t0 = time.perf_counter()
    for az in trees.values():
        _build_kernels(az)
    print(f"[build] both trees' kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for label, build in PATHS:
        if label not in names:
            continue
        sims = {}
        for name, az in trees.items():
            sim, _ = build(az, "cuda")
            sim.run(DROPLET_WARM if label == "droplet" else WARM)
            sims[name] = sim
        read = {name: [] for name in trees}
        for turn, name in enumerate(TURNS):
            sim = sims[name]
            ms, wall = cs._timed_run(sim, STEPS)
            ops, busy, htod, syncs = cs._profile(sim)
            read[name].append((ms, busy))
            advance = getattr(sim, "_advance_totals", None)
            graphs = getattr(sim, "_graph_totals", None)
            print(f"[{label}] turn {turn} {name}: {ms:.4f} ms/step (host wall {wall:.3f} s), "
                  f"{ops:.1f} device operations and {busy:.4f} ms device-busy per step, "
                  f"{htod:.2f} copies and {syncs:.2f} synchronising calls per step; "
                  + (f"cap {sim._grid_spec.cap}, rebuild interval {sim._seg_len}"
                     if sim._grid_spec is not None else "no grid")
                  + (f"; segment graphs so far: {graphs}" if graphs else "")
                  + (f"; SRD advance graphs so far: {advance}" if advance else ""), flush=True)
        print(f"[{label}] " + "; ".join(
            f"{name}: median {np.median([m for m, _ in r]):.4f} ms/step (spread "
            f"{np.ptp([m for m, _ in r]):.4f}), median {np.median([b for _, b in r]):.4f} ms "
            f"device-busy" for name, r in read.items()), flush=True)
        del sims
    print(cs._card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
