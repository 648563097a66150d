"""The JAX package's integrator and drift check on the numpy states of
``torch_integrate_cases.py``, kept in a file so that the port's integrator
kernels (K6-K9) can be held against the reference on a GPU machine that
has no JAX (tests/test_torch_kernels.py):

    JAX_PLATFORMS=cpu python tests/torch_integrate_reference.py

rewrites ``torch_integrate_reference.npz`` beside this file.
``tests/test_torch_integrate.py`` checks that the file is what the
reference computes now.

A step case is one step1, fresh forces and torques, then one step2 of a
method case (``torch_integrate_cases.CASES``) with or without rotation;
the file keeps every field the step writes. A drift case is the
reference's ``needs_rebin`` verdict on ``drift_arrays(kind, N,
DRIFT_SEED)`` at each of BUFFERS. A step1 case is a method case's step1
alone (positions and velocities) and the reference's ``needs_rebin``
verdict on its new positions at each of ``step1_buffers``: STEP1_BUFFERS,
the buffer the two largest drifts just meet (the verdict false) and the
float32 below it (true).

The bars are those of the one-step test of ``test_torch_simulation.py``:
positions within 2e-6, the other fields within 2e-5 of their largest
value (XLA may fuse a product into a multiply-add; on the card PyTorch
multiplies by 1/dt where the CPU divides by dt).

Only ``compute_reference()`` imports JAX; the rest needs numpy alone.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np

import torch_integrate_cases as IC

FILE = Path(__file__).with_suffix(".npz")

N = 1001
STATE_SEED, FORCE_SEED = 11, 12  # the state; the forces and torques step2 sees
DT, TIMESTEP, SEED = 0.005, 2**31 + 3, 42
DRIFT_SEED = 5
BUFFERS = (0.05, 0.5, 0.7)
STEP1_BUFFERS = (0.05, 0.4, 0.7)
TRANSLATION = ("position", "velocity", "acceleration")
ROTATION = ("orientation", "angmom", "net_torque")
POSITION_ATOL, FIELD_RTOL = 2e-6, 2e-5


def written(rotational: bool) -> tuple:
    """The fields a step writes."""
    return TRANSLATION + (ROTATION if rotational else ())


def key(case: str, rotational: bool, field: str) -> str:
    return f"{case}_{'rot' if rotational else 'trans'}_{field}"


def one_step(az, case: str, rotational: bool, state_of, device="cpu"):
    """``az``'s State after step1, fresh forces and torques, and step2 of
    ``case``; ``state_of`` makes ``az``'s State of numpy arrays."""
    m = IC.attached(IC.methods(az, case), rotational, device)
    s = m.step1(state_of(IC.slot_arrays(N, STATE_SEED)), DT, TIMESTEP, SEED)
    fresh = state_of(IC.slot_arrays(N, FORCE_SEED))
    s = s.replace(net_force=fresh.net_force, net_torque=fresh.net_torque)
    return m.step2(s, DT, TIMESTEP, SEED)


def step1(az, case: str, state_of, device="cpu"):
    """``az``'s State after the step1 of ``case`` (no rotation)."""
    m = IC.attached(IC.methods(az, case), False, device)
    return m.step1(state_of(IC.slot_arrays(N, STATE_SEED)), DT, TIMESTEP, SEED)


def step1_buffers(position) -> tuple:
    """STEP1_BUFFERS, then the float32 buffer that the two largest squared
    drifts of ``position`` (numpy, from the state's reference positions on
    occupied slots) just meet as sqrt(m1) + sqrt(m2), then the float32
    below it."""
    a = IC.slot_arrays(N, STATE_SEED)
    d = (position - a["ref_position"]).astype(np.float32)
    dsq = np.where(a["tag"] >= 0, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2],
                   np.float32(0))
    m2, m1 = np.sort(dsq)[-2:]
    met = np.sqrt(m1) + np.sqrt(m2)
    return STEP1_BUFFERS + (float(met), float(np.nextafter(met, np.float32(0))))


def assert_close(got, want, field: str, what: str) -> None:
    """``got`` against the reference's ``want`` at the one-step bars."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if field == "position":
        np.testing.assert_allclose(got, want, rtol=0, atol=POSITION_ATOL, err_msg=what)
    else:
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=FIELD_RTOL, atol=FIELD_RTOL * scale,
                                   err_msg=what)


def compute_reference() -> dict:
    """Every case, computed by the JAX package on the CPU."""
    import jax.numpy as jnp

    import azplugins_tpu as ref
    from azplugins_tpu.ops import dense as RD

    out = {}
    for case in IC.CASES:
        for rotational in (False, True):
            s = one_step(ref, case, rotational, lambda a: IC.state_of(ref, a, jnp.asarray))
            for field in written(rotational):
                out[key(case, rotational, field)] = np.asarray(getattr(s, field))
    verdicts = []
    for kind in IC.DRIFT_KINDS:
        a = IC.drift_arrays(kind, N, DRIFT_SEED)
        dense = types.SimpleNamespace(position=jnp.asarray(a["position"]),
                                      tag=jnp.asarray(a["tag"]))
        meta = types.SimpleNamespace(ref_position=jnp.asarray(a["ref_position"]))
        verdicts.append([bool(RD.needs_rebin(dense, meta, types.SimpleNamespace(buffer=b)))
                         for b in BUFFERS])
    out["drift"] = np.array(verdicts)
    buffers, verdicts = [], []
    for case in IC.CASES:
        s = step1(ref, case, lambda a: IC.state_of(ref, a, jnp.asarray))
        for field in ("position", "velocity"):
            out[key(case, False, f"step1_{field}")] = np.asarray(getattr(s, field))
        meta = types.SimpleNamespace(
            ref_position=jnp.asarray(IC.slot_arrays(N, STATE_SEED)["ref_position"]))
        buffers.append(step1_buffers(np.asarray(s.position)))
        verdicts.append([bool(RD.needs_rebin(s, meta, types.SimpleNamespace(buffer=b)))
                         for b in buffers[-1]])
    out["step1_buffers"] = np.array(buffers)
    out["step1_drift"] = np.array(verdicts)
    return out


def load() -> dict:
    with np.load(FILE) as f:
        return {k: f[k] for k in f.files}


def write() -> None:
    np.savez_compressed(FILE, **compute_reference())


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo's packages
    write()
    print(f"wrote {FILE}")
