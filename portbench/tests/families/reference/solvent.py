"""A test's physics family: an MPCD solvent judged on steps that only
stream, x' = x + dt v, wrapped into the box. It shows the face a family
has (``portbench/README.md``) with a second species read through
``port.read_solvent``."""

from __future__ import annotations

import torch

from portbench import initial, port
from portbench.reference import physics

NUMBERS = ("solvent_position_gap",)
CONTROL = torch.bfloat16
STRETCH_READS = ("x",)

read_state = port.read_solvent


def snapshot(az, init: dict):
    """The MD particles' Snapshot with the solvent's rows added."""
    snap = initial.snapshot(az, init)
    solvent = init["solvent"]
    snap.mpcd.resize(len(solvent["x"]))
    snap.mpcd.position[:] = solvent["x"]
    snap.mpcd.velocity[:] = solvent["v"]
    return snap


def fires(model: dict, timestep: int) -> bool:
    """No updater acts."""
    return False


def stretch_work(states: list[dict], model: dict, L: torch.Tensor) -> float:
    """The solvent rows streamed a step."""
    return float(states[0]["x"].shape[0])


class Judge:
    def __init__(self, model: dict, L: torch.Tensor):
        self.model, self.L, self.dt = model, L, model["dt"]
        self.where: dict[str, tuple[float, str]] = {}

    def step(self, S: dict, dtype=torch.float64) -> dict:
        """Step ``S["t"]`` in ``dtype``: a stream, as no collision falls on
        a judged step."""
        if (S["t"] + 1) % self.model["srd_period"] == 0:
            raise ValueError(f"step {S['t']} collides; this family judges streaming alone")
        x = S["x"].to(dtype) + self.dt * S["v"].to(dtype)
        return {**S, "t": S["t"] + 1, "x": physics.wrap(x, self.L.to(dtype))}

    def stored(self, S: dict, dtype=torch.float64) -> dict:
        return S

    def outputs(self, S: dict, dtype) -> dict:
        return {}

    def judge_outputs(self, S: dict, table=None, frame=None) -> dict:
        return {}

    def judge_state(self, S: dict) -> dict:
        return {"rows": int(S["x"].shape[0])}

    def judge_step(self, S0: dict, S1: dict) -> dict:
        """``solvent_position_gap``: |x'_program - x'_ref| (minimum image)
        over the largest |dt v|."""
        want = self.step(S0)["x"]
        disp = self.dt * S0["v"].to(torch.float64)
        dx = physics.min_image(S1["x"].to(torch.float64) - want, self.L)
        row = int(dx.abs().amax(dim=1).argmax())
        gap = float(dx[row].abs().max()) / float(disp.abs().max())
        if gap > self.where.get("solvent_position_gap", (-1.0, ""))[0]:
            self.where["solvent_position_gap"] = (gap, f"step to {S1['t']}, row {row}")
        return {"solvent_position_gap": gap}
