"""The window's work and the check's steps: a cell that states
``window_steps`` times those steps, capped by the seconds; the traced
stretches carry their own pairs; a judged step that is no CUDA graph
replay, where the program runs graphs, makes the run not correct."""

import pytest
import torch

from portbench import harness, manifest, port

from ._small import BENCH, SMALL, run

DROPLET = "droplet_evaporation.n20k"


@pytest.mark.parametrize("seconds, steps", [(600.0, 75), (1e-9, 25)])
def test_a_fixed_step_window_does_its_steps_unless_the_seconds_cap_it(seconds, steps):
    r = run(DROPLET, seconds=seconds, traffic={"window_steps": 75})
    assert r["attempted"] == steps and r["correct"] is True


def test_the_traced_stretches_count_their_own_pairs():
    w = manifest.workload(BENCH, DROPLET)
    traffic, params = SMALL[w["config"]]
    r = harness.Run(BENCH, w, 12345678901, torch.device("cpu"), {**traffic, "window_steps": 100},
                    params)
    r.warm_up()
    r.window(600.0, trace=True)
    r.check()
    assert len(r.stretches) == 2 and r.steps == 100
    # four calls of 25 steps from timestep 25: the second and the fourth traced
    assert [st.t1 for st in r.stretches] == [75, 125]
    assert all(st.pairs > 0 and st.states is None for st in r.stretches)
    assert all(st.n_occupied == 552 and st.n_slots >= 552 for st in r.stretches)


def test_judged_steps_that_are_no_replays_on_the_graphs_are_not_correct(monkeypatch):
    monkeypatch.setattr(port, "on_graphs", lambda sim: True)
    monkeypatch.setattr(harness, "CHECK_MAX_STEPS", 5)
    r = run(DROPLET)
    assert r["correct"] is False
    # the three steps to judge and the evaporator's fire
    assert r["checked"]["replay_shortfall"] == {"value": 4, "limit": 0}


def test_the_check_runs_on_to_a_step_on_which_the_evaporator_fires(monkeypatch):
    monkeypatch.setattr(harness, "CHECK_MAX_STEPS", 40)
    monkeypatch.setitem(SMALL, "droplet_evaporation", (
        {**SMALL["droplet_evaporation"][0], "run_steps": 20, "window_steps": 40},
        SMALL["droplet_evaporation"][1]))
    judged = []
    inner = harness.check.Judge.judge_step

    def judge_step(self, a, b):
        judged.append(a["t"])
        return inner(self, a, b)

    monkeypatch.setattr(harness.check.Judge, "judge_step", judge_step)
    r = run(DROPLET, seconds=600.0)
    assert r["correct"] is True and r["checked"]["replay_shortfall"]["value"] == 0
    # warm-up and window end at 60: steps 60-62 judged, then the fire after step 75
    assert judged == [60, 61, 62, 75]
