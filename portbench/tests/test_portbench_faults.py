"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (a step that leaves its state unchanged,
half of the particles left out of the step's second half, an answer altered where it is produced).
The cells run on one card, so no exchange between cards can be left out."""

import pytest
import torch

import azplugins_tpu_torch.md.methods as methods
from azplugins_tpu_torch import simulation

from ._small import run

CELLS = ["plj_langevin.n64k", "droplet_evaporation.n20k.late", "plj_langevin.n64k.logged"]


def _unchanged(monkeypatch):
    def run_chunk(self, dense, meta, t0, n_steps, seg_len, tbls, rebin_first, solv=None):
        return dense, meta, torch.tensor(False), solv

    monkeypatch.setattr(simulation.Simulation, "_run_chunk", run_chunk)


def _half_left_out(monkeypatch):
    inner = methods.LangevinFlow._step2_plain

    def step2(self, state, dt, timestep, seed):
        out = inner(self, state, dt, timestep, seed)
        kept = (state.tag % 2 == 0)[:, None]
        return out.replace(velocity=torch.where(kept, out.velocity, state.velocity),
                           acceleration=torch.where(kept, out.acceleration, state.acceleration))

    monkeypatch.setattr(methods.LangevinFlow, "_step2_plain", step2)


def _altered(monkeypatch):
    inner = methods.Method._step1_plain

    def step1(self, state, dt, timestep, seed):
        out = inner(self, state, dt, timestep, seed)
        x = out.position.clone()
        x[torch.nonzero(out.tag == 0)[0, 0], 0] += 1e-3
        return out.replace(position=x)

    monkeypatch.setattr(methods.Method, "_step1_plain", step1)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run(cell)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checked"].values())
