"""The benchmark's one command:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on the first CUDA device and
prints the result as the last line of standard output (see
``portbench/harness.py``). Exits with 2, printing no result, without a
CUDA device; with 3 where modules of JAX or of the JAX package are loaded,
and with 4 where a number goes unjudged (a number without a limit, or a
limit without a number).
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
