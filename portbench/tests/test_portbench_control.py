"""On the card, at each cell's own size: the program's runs come out
correct, and the control (the plain reference in bfloat16 in the program's
place, judged on the same states) fails one of the cell's numbers, on
three seeds. Run there with
``python3 -m pytest portbench/tests -m cuda -p no:cacheprovider``."""

import time

import pytest
import torch

from portbench import harness, manifest

BENCH = manifest.load()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_at_the_cells_own_size(card, cell):
    w = manifest.workload(BENCH, cell)
    for seed in (7_000_000_001, 7_000_000_002, 7_000_000_003):
        r = harness.run_cell(BENCH, w, seed, 1.0, False, card, time.perf_counter(),
                             control=True)
        assert r["correct"] is True, r["checked"]
        assert any(r["control"][k] > c["limit"] for k, c in r["checked"].items()), r["control"]
