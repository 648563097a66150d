"""Physics families found by name (``manifest.reference``): the family
``md`` judges both cells bit for bit as the reference did before it was a
family; a family and a configuration kept beside this test, in
``families/``, judge an MPCD solvent through files outside the harness;
and a number without a limit, or a limit without a number, fails the run."""

import time

import pytest
import torch

from azplugins_tpu_torch.mpcd import SRD
from portbench import harness, manifest, port
from portbench.reference import md

from ._small import BENCH, SMALL, SOLVENT

SEED = 987654321987
# Run.check(control=True) at _small.py's sizes and SEED on two threads, the
# time-windowed cell's window fixed at 40 steps, as float.hex: taken under
# torch 2.13.0+cpu from the reference before it became the family md
TORCH = "2.13.0+cpu"
WINDOW = {"plj_langevin.n262k": {"window_steps": 40}, "droplet_evaporation.n20k.late": {}}
BITS = {
    "plj_langevin.n262k": {
        "force_gap": "0x1.a2ca355b6c29cp-21",
        "accel_gap": "0x1.a90cad581bbecp-21",
        "position_gap": "0x1.f3022dfc4169fp-17",
        "velocity_gap": "0x1.56d517f57d16ap-24",
        "type_mismatches": "0x0.0p+0",
        "replay_shortfall": "0x0.0p+0",
        "control": {
            "force_gap": "0x1.9cdb9214c5553p-2",
            "accel_gap": "0x1.9c4a1d2ac3272p-2",
            "position_gap": "0x1.955a2bac7bbdep+0",
            "velocity_gap": "0x1.1cf41630dc76bp-6",
            "type_mismatches": "0x0.0p+0",
        },
    },
    "droplet_evaporation.n20k.late": {
        "force_gap": "0x1.226241ee75638p-20",
        "accel_gap": "0x1.cee544d552f78p-21",
        "position_gap": "0x1.f0ee020404bc8p-16",
        "velocity_gap": "0x1.dd7e756cbbce0p-25",
        "type_mismatches": "0x0.0p+0",
        "replay_shortfall": "0x0.0p+0",
        "control": {
            "force_gap": "0x1.b5f09a316f8e0p-3",
            "accel_gap": "0x1.20b809cd67bd7p-3",
            "position_gap": "0x1.42f9662e8b325p+1",
            "velocity_gap": "0x1.ba8a8fc1336c0p-8",
            "type_mismatches": "0x1.2000000000000p+3",
        },
    },
}


def _hex(numbers: dict) -> dict:
    return {k: _hex(v) if isinstance(v, dict) else float(v).hex() for k, v in numbers.items()}


@pytest.mark.parametrize("cell", list(BITS))
def test_the_family_md_reads_the_bits_of_the_reference_before_it(cell):
    if torch.__version__ != TORCH:
        pytest.skip(f"the bits were taken under torch {TORCH}, not {torch.__version__}")
    w = manifest.workload(BENCH, cell)
    traffic, params = SMALL[w["config"]]
    r = harness.Run(BENCH, w, SEED, torch.device("cpu"), {**traffic, **WINDOW[cell]}, params)
    assert r.family is md is manifest.reference(w)
    r.warm_up()
    r.window(600.0, trace=False)
    assert _hex(r.check(control=True)) == BITS[cell]


@pytest.mark.parametrize("cell", list(BITS))
def test_the_tracer_and_the_marked_stretch_move_no_judged_bit(cell):
    """The same window traced (its second call profiled, the program's
    spans over the first, its counters over both) and the marked stretch
    after the check's reads: the same bits."""
    if torch.__version__ != TORCH:
        pytest.skip(f"the bits were taken under torch {TORCH}, not {torch.__version__}")
    w = manifest.workload(BENCH, cell)
    traffic, params = SMALL[w["config"]]
    r = harness.Run(BENCH, w, SEED, torch.device("cpu"),
                    {**traffic, **WINDOW[cell], "trace_at": [0.5]}, params)
    r.warm_up()
    r.window(600.0, trace=True)
    numbers = r.check(control=True)
    assert [c["profiled"] for c in r.program_calls] == [False, True]
    assert len(r.stretches) == 1 and len(r.phase_stretches) == harness.MARK_PROFILED_CALLS
    assert r.mark_table and r.program_counters["chunk_ends"]
    assert _hex(numbers) == BITS[cell]


class _Graph:
    """A stand-in CUDA graph: a replay runs the captured body again, the
    runner's counters held as a replay holds them."""

    def __init__(self, runner, fn):
        self.runner, self.fn = runner, fn

    def replay(self):
        before = self.runner._counters.read()
        self.fn()
        self.runner._counters.restore(before)


def _capture(runner, fn):
    """A stand-in for a CUDA capture on the CPU: the body's Python runs, its
    buffers are left as they were (the captured work has not run)."""
    saved = [b.clone() for b in runner.buffers()]
    fn()
    for b, v in zip(runner.buffers(), saved, strict=True):
        b.copy_(v)
    return _Graph(runner, fn)


def test_a_judged_step_whose_srd_advance_ran_eagerly_is_no_replay(files, monkeypatch):
    """On stand-in graphs each single step of the check replays its segment
    graph but sees a new observation stream of the SRD advance (``("stream",
    n)``, n steps from the last collision), which runs eagerly: no step is
    judged, and ``replay_shortfall`` reads every step wanted."""
    monkeypatch.setattr(harness, "CHECK_MAX_STEPS", 8)
    r = harness.Run(SOLVENT, SOLVENT["workloads"][0], 2**40 + 5, torch.device("cpu"))
    sim = r.sim
    sim._capture = _capture
    r.warm_up()
    r.window(600.0, trace=False)
    assert port.on_graphs(sim) and port.advance_on_graphs(sim)
    before = port.counters(sim)
    numbers = r.check()
    after = port.counters(sim)
    assert after["replays"] - before["replays"] >= 6
    assert after["advance_eager"] - before["advance_eager"] == 8
    assert numbers["replay_shortfall"] == int(r.traffic["check_steps"]) == 3
    r = r.result(1.0, False, numbers)
    assert r["correct"] is False
    assert r["checked"]["replay_shortfall"] == {"value": 3, "limit": 0}


def _solvent(control: bool = False) -> dict:
    return harness.run_cell(SOLVENT, SOLVENT["workloads"][0], 2**40 + 3, 600.0, False,
                            torch.device("cpu"), time.perf_counter(), control=control)


def test_a_family_beside_the_harness_judges_a_solvent(files):
    r = _solvent(control=True)
    assert r["correct"] is True
    assert list(r["checked"]) == ["solvent_position_gap", "replay_shortfall"]
    gap = r["checked"]["solvent_position_gap"]
    assert 0 < gap["value"] < gap["limit"] < r["control"]["solvent_position_gap"]


def test_a_solvent_left_unmoved_is_not_correct(files, monkeypatch):
    monkeypatch.setattr(SRD, "_advance", lambda self, mpcd, *args, **kwargs: mpcd)
    r = _solvent()
    assert r["correct"] is False
    gap = r["checked"]["solvent_position_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("change", [
    lambda limits: {k: v for k, v in limits.items() if k != "solvent_position_gap"},
    lambda limits: {**limits, "velocity_gap": 5e-5},  # the family md's, not this one's
], ids=["a number without a limit", "a limit without a number"])
def test_a_number_and_its_limit_go_together_or_the_run_fails(files, monkeypatch, change):
    limits = manifest.limits
    monkeypatch.setattr(manifest, "limits", lambda cell: change(limits(cell)))
    with pytest.raises(harness.Unjudged):
        _solvent()


@pytest.mark.parametrize("numbers, limits, ok", [
    ({"force_gap": 1e-6, "replay_shortfall": 0}, {"force_gap": 1e-3, "replay_shortfall": 0}, True),
    # a limit of a number the family knows but this run did not report
    # (table_gap without writers) stands idle, as before
    ({"force_gap": 1e-6, "replay_shortfall": 0},
     {"force_gap": 1e-3, "table_gap": 1e-3, "replay_shortfall": 0}, True),
    ({"force_gap": 1e-6, "replay_shortfall": 0}, {"force_gap": 1e-3}, False),
    ({"force_gap": 1e-6, "replay_shortfall": 0},
     {"force_gap": 1e-3, "replay_shortfall": 0, "pressure_gap": 1.0}, False),
])
def test_judged_pairs_each_number_with_its_limit(numbers, limits, ok):
    if ok:
        checked = harness.judged(numbers, limits, md.NUMBERS)
        assert list(checked) == ["force_gap", "replay_shortfall"]
    else:
        with pytest.raises(harness.Unjudged):
            harness.judged(numbers, limits, md.NUMBERS)


def test_an_unjudged_number_exits_non_zero_with_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def unjudged(*args, **kwargs):
        raise harness.Unjudged(["solvent_position_gap"], [])

    monkeypatch.setattr(harness, "run_cell", unjudged)
    argv = ["--workload", "plj_langevin.n262k", "--seed", "1", "--seconds", "1"]
    assert harness.main(argv, time.perf_counter()) == 4
    assert capsys.readouterr().out == ""
