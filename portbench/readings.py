"""Readings that set a cell's limits: the program's and the control's.

    python3 portbench/readings.py --workload <cell> --seeds <n,n,...> --seconds <s>

runs the cell once a seed in one process (set-up, a window of ``--seconds``,
the check) and judges both the program's states and the control's, the
plain reference computed in bfloat16 in the program's place, on the same
states. Prints one JSON line a seed, then the lower reading of each number
(the largest the program gave) and the upper (the smallest the control
gave). The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, manifest  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(bench, cell, seed, args.seconds, False, torch.device("cuda", 0),
                             time.perf_counter(), control=True)
        program = {k: c["value"] for k, c in r["checked"].items()}
        print(json.dumps({"seed": seed, "program": program, "control": r["control"],
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()}}),
              flush=True)
        for k in program:
            lower[k] = max(lower.get(k, 0), program[k])
        for k, v in r["control"].items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
