"""Judge the states that the program's timed path produced.

MD is chaotic, so the program is judged one step at a time from the state
it reached, never against a replayed trajectory. Each state ``S`` is a dict
of tag-ordered tensors read from the program: ``x`` (float32 positions,
any image), ``v``, ``a`` (the stored acceleration, thermostat forces
included), ``f`` (the conservative net force at ``x``), ``type``, ``tag``
and the timestep ``t``: the state after step ``t - 1``.

For every state the reference works out again, in float64 and with its own
cell list, the conservative force at the program's positions and the
acceleration step ``t - 1`` had to store: (F + R(t - 1) - gamma (v_half -
u(x))) / m with v_half = v - dt a / 2. For every pair of consecutive states
it also redoes the step: x' = x + dt (v + dt a / 2), the second half kick
from the reference's own acceleration, and the evaporator's pick. The
numbers, each a widest gap over particles and components:

- ``force_gap``: |F_program - F_ref| over the largest |F_ref|;
- ``accel_gap``: |a_program - a_ref| over the largest |a_ref|;
- ``position_gap``: |x'_program - x'_ref| (minimum image) over the largest
  step displacement |dt v_half|;
- ``velocity_gap``: |v'_program - v'_ref| over the largest |v'_ref|;
- ``type_mismatches``: particles whose type after a step is not the
  reference pick's (an exact count);
- ``table_gap``: the Table's kinetic temperature and potential energy at
  the window's last step against the reference's, relative;
- ``frame_gap``: the GSD file's last frame against the state at its step:
  positions (minimum image) over the box, velocities over the largest |v|;
- ``replay_shortfall``: judged steps missing (the harness's count): of
  the steps to judge, and a step on which an updater fires, those the
  program did not run as CUDA graph replays (an exact count).

A pair within ``physics.CUTOFF_BAND`` of its cutoff is inside it or not by
float32 rounding alone, and the potential is cut off there (mode none):
each particle's gaps of force, acceleration and velocity are taken less
the summed |force| of such pairs (the force's allowance; dt / 2m of it for
the velocity).
"""

from __future__ import annotations

import numpy as np
import torch

from . import physics

NUMBERS = ("force_gap", "accel_gap", "position_gap", "velocity_gap", "type_mismatches",
           "table_gap", "frame_gap", "replay_shortfall")


def _gap(got: torch.Tensor, want: torch.Tensor, scale: float | None = None, allowance=None):
    """(the widest |got - want| over ``scale``, default the largest |want|,
    less each row's ``allowance``; the row where it lies)."""
    if scale is None:
        scale = float(want.abs().max())
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    diff = diff.reshape(diff.shape[0], -1).amax(dim=1)
    if allowance is not None:
        diff = torch.clamp(diff - allowance, min=0.0)
    row = int(diff.argmax())
    return float(diff[row]) / max(scale, 1e-300), row


class Judge:
    """The reference for one model on one box (``L``: float64 [3])."""

    def __init__(self, model: dict, L: torch.Tensor):
        self.model = model
        self.L = L
        self.dt = model["dt"]
        self.mass = model.get("mass", 1.0)
        # number -> (value, where): the widest reading of each number so far
        self.where: dict[str, tuple[float, str]] = {}

    def _note(self, out: dict, name: str, gap, S: dict, got, want) -> None:
        """Record ``name``'s reading in ``out`` and, where it is the widest so
        far, the particle it lies at."""
        value, row = gap
        out[name] = value
        if value > self.where.get(name, (-1.0, ""))[0]:
            x = physics.wrap(S["x"][row].to(torch.float64), self.L)
            self.where[name] = (value, (
                f"step to {S['t']}, tag {int(S['tag'][row])}, type {int(S['type'][row])}, "
                f"wrapped x {[round(float(c), 4) for c in x]}, program "
                f"{[float(c) for c in got[row].flatten()]}, reference "
                f"{[float(c) for c in want[row].flatten()]}"))

    # -- the reference's computations, in a dtype (float64, or the control's) --
    def force(self, x, types, t, dtype=torch.float64):
        """The conservative force of step ``t`` at ``x``: (force, energy,
        pairs, the cutoff's allowance)."""
        return physics.conservative_force(x.to(torch.float64), types, self.L, self.model, t,
                                          dtype)

    def acceleration(self, f, v_half, x, types, tags, t, dtype=torch.float64):
        """What step ``t``'s second half stores: (F + F_Langevin) / m."""
        fl = physics.langevin_force(v_half, x.to(torch.float64), types, tags, self.L,
                                    self.model, t, dtype)
        return (f.to(dtype) + fl) / self.mass

    def pick(self, x, types, tags, t):
        """The evaporator's pick after step ``t`` at positions ``x``:
        (candidates, priorities, k), or None where it does not fire."""
        if not physics.evaporator_fires(self.model, t):
            return None
        return physics.evaporator_pick(x.to(torch.float64), types, tags, self.L, self.model, t)

    def step(self, S: dict, dtype=torch.float64) -> dict:
        """Step ``S["t"]`` from ``S`` computed in ``dtype`` (the control's
        stand-in for the program): positions, velocities, accelerations,
        forces and types after it."""
        t, dt = S["t"], self.dt
        x, v, a = (S[k].to(dtype) for k in ("x", "v", "a"))
        v_half = v + (0.5 * dt) * a
        x1 = x + dt * v_half
        f1 = self.force(x1, S["type"], t, dtype)[0]
        a1 = self.acceleration(f1, v_half, x1, S["type"], S["tag"], t, dtype)
        v1 = v_half + (0.5 * dt) * a1
        pick = self.pick(x1, S["type"], S["tag"], t)
        types = S["type"] if pick is None else _picked(S["type"], pick, self.model["evaporator"])
        return {"t": t + 1, "x": x1, "v": v1, "a": a1, "f": f1, "type": types, "tag": S["tag"]}

    def stored(self, S: dict, dtype=torch.float64) -> dict:
        """The control's stand-in for a state the window ends at: ``S`` with
        the force and acceleration of step ``t - 1`` computed in ``dtype``."""
        t, dt = S["t"], self.dt
        f = self.force(S["x"], S["type"], t - 1, dtype)[0]
        v_half = S["v"].to(dtype) - (0.5 * dt) * S["a"].to(dtype)
        a = self.acceleration(f, v_half, S["x"], S["type"], S["tag"], t - 1, dtype)
        return {**S, "f": f, "a": a}

    def outputs(self, S: dict, dtype) -> dict:
        """The control's stand-in for the writers' outputs at ``S``'s step:
        the Table's row and the frame computed in ``dtype``."""
        v = S["v"].to(dtype)
        ke = 0.5 * self.mass * (v * v).sum()
        energy = self.force(S["x"], S["type"], S["t"] - 1, dtype)[1]
        table = {"timestep": S["t"], "thermo.kinetic_temperature": float(2.0 * ke / v.numel()),
                 "thermo.potential_energy": float(energy.sum())}
        frame = {"frame": 0, "configuration/step": S["t"],
                 "particles/position": physics.wrap(S["x"].to(torch.float64), self.L).to(dtype),
                 "particles/velocity": v}
        return {"table": table, "frame": frame}

    # -- the judgement ---------------------------------------------------------
    def judge_outputs(self, S: dict, table: dict | None, frame: dict | None) -> dict:
        """``table_gap`` and ``frame_gap`` of the writers' outputs at the
        state ``S``'s step (an output of another step reads infinite)."""
        out = {}
        if table is not None:
            v = S["v"].to(torch.float64)
            kT = float(self.mass * (v * v).sum() / v.numel())
            pe = float(self.force(S["x"], S["type"], S["t"] - 1)[1].sum())
            gaps = [abs(_column(table, "kinetic_temperature") - kT) / abs(kT),
                    abs(_column(table, "potential_energy") - pe) / abs(pe)]
            out["table_gap"] = max(gaps) if int(table["timestep"]) == S["t"] else float("inf")
        if frame is not None:
            dev = S["x"].device
            x, v = (torch.as_tensor(frame[k], device=dev)
                    for k in ("particles/position", "particles/velocity"))
            dx = physics.min_image(x.to(torch.float64) - S["x"].to(torch.float64), self.L)
            gaps = [_gap(dx, torch.zeros_like(dx), float(self.L.max()))[0],
                    _gap(v, S["v"])[0]]
            step = int(np.asarray(frame["configuration/step"]).reshape(-1)[0])
            out["frame_gap"] = max(gaps) if step == S["t"] else float("inf")
        return out

    def judge_state(self, S: dict) -> dict:
        """``force_gap`` and ``accel_gap`` of a state (step ``t - 1``, whose
        updaters must not have fired: its forces saw ``S``'s types), and the
        unordered pairs inside the cutoff."""
        t, dt = S["t"], self.dt
        if physics.evaporator_fires(self.model, t - 1):
            raise ValueError(f"a state after step {t - 1}, whose updaters fired, is not judged")
        f_ref, _, pairs, allow = self.force(S["x"], S["type"], t - 1)
        v_half = S["v"].to(torch.float64) - (0.5 * dt) * S["a"].to(torch.float64)
        a_ref = self.acceleration(f_ref, v_half, S["x"], S["type"], S["tag"], t - 1)
        out = {"pairs": pairs}
        self._note(out, "force_gap", _gap(S["f"], f_ref, allowance=allow), S, S["f"], f_ref)
        self._note(out, "accel_gap", _gap(S["a"], a_ref, allowance=allow / self.mass), S,
                   S["a"], a_ref)
        return out

    def judge_step(self, S0: dict, S1: dict) -> dict:
        """``position_gap``, ``velocity_gap``, ``force_gap``, ``accel_gap``
        and ``type_mismatches`` of the step from ``S0`` to ``S1``."""
        t, dt = S0["t"], self.dt
        if S1["t"] != t + 1:
            raise ValueError(f"states at {t} and {S1['t']} are not one step apart")
        x0, v0, a0 = (S0[k].to(torch.float64) for k in ("x", "v", "a"))
        v_half = v0 + (0.5 * dt) * a0
        disp = dt * v_half
        dx = physics.min_image(S1["x"].to(torch.float64) - (x0 + disp), self.L)
        x1 = S1["x"].to(torch.float64)
        f_ref, _, _, allow = self.force(x1, S0["type"], t)
        a_ref = self.acceleration(f_ref, v_half, x1, S0["type"], S0["tag"], t)
        v_ref = v_half + (0.5 * dt) * a_ref
        out = {}
        self._note(out, "position_gap", _gap(dx, torch.zeros_like(dx), float(disp.abs().max())),
                   S1, S1["x"], x0 + disp)
        self._note(out, "velocity_gap",
                   _gap(S1["v"], v_ref, allowance=0.5 * dt * allow / self.mass), S1, S1["v"], v_ref)
        self._note(out, "force_gap", _gap(S1["f"], f_ref, allowance=allow), S1, S1["f"], f_ref)
        self._note(out, "accel_gap", _gap(S1["a"], a_ref, allowance=allow / self.mass), S1,
                   S1["a"], a_ref)
        pick = self.pick(x1, S0["type"], S0["tag"], t)
        if pick is None:
            out["type_mismatches"] = int((S1["type"] != S0["type"]).sum())
        else:
            out["type_mismatches"] = _pick_mismatches(S0["type"], S1["type"], pick,
                                                      self.model["evaporator"])
        return out


def _column(row: dict, name: str) -> float:
    """A Table column by the quantity's name (the logger prefixes it)."""
    (key,) = [k for k in row if k.rsplit(".", 1)[-1].rsplit("/", 1)[-1] == name]
    return row[key]


def _picked(types, pick, ev):
    """``types`` with the pick's flips made (ties at the k-th priority to the
    lower tag)."""
    cand, prio, k = pick
    out = types.clone()
    idx = torch.nonzero(cand).flatten()
    if idx.numel() > k:
        keys = prio[idx] * (1 << 32) + idx
        idx = idx[torch.topk(keys, k, largest=False).indices]
    out[idx] = ev["evaporated"]
    return out


def _pick_mismatches(before, after, pick, ev) -> int:
    """Particles at odds with the pick: a type change other than a
    candidate's flip to the evaporated type, a candidate below the k-th
    priority left unflipped, and the flips' count off min(k, candidates).
    Candidates tied at the k-th priority may flip either way."""
    cand, prio, k = pick
    flipped = before != after
    bad = int((flipped & ~(cand & (after == ev["evaporated"]))).sum())
    n_cand = int(cand.sum())
    want = min(k, n_cand)
    if n_cand > k:
        kth = torch.topk(prio[cand], k, largest=False).values.max()
        bad += int((cand & (prio < kth) & ~flipped).sum())
    else:
        bad += int((cand & ~flipped).sum())
    return bad + abs(int((flipped & cand).sum()) - want)


def worst(readings: list[dict]) -> dict:
    """The widest reading of each number over several judgements."""
    out = {}
    for r in readings:
        for k in NUMBERS:
            if k in r:
                out[k] = max(out.get(k, 0), r[k])
    return out
