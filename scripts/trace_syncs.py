"""Name the calls that make the host wait for the card, by call site.

Builds one or more of chip_smoke.py's full-size paths (droplet, polymer,
colloid) twice from one seed, whole and on ``--shards`` shards of one card
(``make_mesh(n, device="cuda", sharded=True)``; the whole run on the grid
the mesh snaps to, as chip_smoke's [spatial_ops] runs it), runs each for
chip_smoke's stretch, then ``--steps`` more steps under
``torch.cuda.set_sync_debug_mode("warn")`` and counts every synchronising
call by the innermost frames of ``azplugins_tpu_torch`` that made it. This is
the count chip_smoke's ``_profile`` prints as "synchronising calls a step".

    python3 scripts/trace_syncs.py [--path colloid|droplet|polymer|all]
                                   [--shards 4] [--steps 40]

Needs one CUDA card. Prints one line a call site, the calls a step, for
each path and layout.
"""

import argparse
import collections
import os
import sys
import traceback
import warnings

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke as C  # noqa: E402

_PORT = os.sep + "azplugins_tpu_torch" + os.sep


def _sites(sim, steps: int) -> collections.Counter:
    """Synchronising calls over ``steps`` steps, by their two innermost
    frames in the port (file:line function)."""
    counts = collections.Counter()
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return show(message, category, filename, lineno, file, line)
        port = [f for f in traceback.extract_stack()[:-1] if _PORT in f.filename]
        key = " <- ".join(f"{os.path.relpath(f.filename, _ROOT)}:{f.lineno} {f.name}"
                          for f in reversed(port[-2:])) or f"{filename}:{lineno}"
        counts[key] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run(steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = show
    torch.cuda.synchronize()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="colloid", choices=["colloid", "droplet", "polymer", "all"])
    ap.add_argument("--shards", type=int, default=C.SPATIAL_OPS_SHARDS)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_syncs: needs a CUDA card", file=sys.stderr)
        return 2
    az = C._import_port()
    from azplugins_tpu_torch.parallel import make_mesh

    builders = {"droplet": C.build_droplet, "polymer": C.build_polymer,
                "colloid": C.build_colloid}
    paths = list(builders) if args.path == "all" else [args.path]
    print(C._card(), flush=True)
    for label in paths:
        for key in ("whole", "shards"):
            sim, _ = builders[label](az, "cuda")
            sim.enable_spatial_decomposition(make_mesh(args.shards, device="cuda",
                                                       sharded=key == "shards"))
            sim.run(C.SPATIAL_OPS_STRETCH[label])
            t0, b0 = sim.timestep, sim.n_builds
            counts = _sites(sim, args.steps)
            total = sum(counts.values())
            print(f"[trace_syncs] {label} {key} (n = {args.shards}), steps {t0}-{sim.timestep} "
                  f"({sim.n_builds - b0} builds): {total / args.steps:.3f} synchronising "
                  f"calls a step", flush=True)
            for site, c in counts.most_common():
                print(f"  {c / args.steps:.3f} a step ({c}): {site}", flush=True)
            del sim
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
