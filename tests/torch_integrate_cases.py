"""Slot-layout states for the integrator and drift-check tests, from a seed.

``slot_arrays`` makes, with numpy, the fields a method and the drift check
read, as a dense slot layout holds them: a fifth of the slots empty (tag
and typeid -1, far sentinel x, as ``ops/dense.py`` lays them out), the
tags of the others a permutation, two types, unit quaternions, moments of
inertia with about a fifth of the axes frozen (0), and reference positions
a small drift away. ``tests/test_torch_integrate.py`` hands them to the JAX
package and the port on the CPU; ``tests/test_torch_kernels.py`` to the
CUDA kernels and their plain versions on the card. Needs no JAX.
"""

from __future__ import annotations

import types

import numpy as np

L = 20.0  # the box edge


def slot_arrays(n: int, seed: int, empty: float = 0.2, frozen: float = 0.2) -> dict:
    g = np.random.default_rng(seed)
    f32 = np.float32
    live = g.random(n) >= empty
    live[0] = True
    tag = np.where(live, g.permutation(n), -1).astype(np.int32)
    typeid = np.where(live, g.integers(0, 2, n), -1).astype(np.int32)
    position = g.uniform(-L / 2, L / 2, (n, 3)).astype(f32)
    position[~live, 0] = (L + (np.flatnonzero(~live) + 1.0) * (L + 3.0)).astype(f32)
    q = g.normal(size=(n, 4))
    inertia = g.uniform(0.2, 2.0, (n, 3)) * (g.random((n, 3)) > frozen)
    return {
        "position": position,
        "ref_position": (position - g.normal(0, 0.05, (n, 3)) * live[:, None]).astype(f32),
        "tag": tag,
        "typeid": typeid,
        "velocity": g.normal(0, 1, (n, 3)).astype(f32),
        "acceleration": g.normal(0, 3, (n, 3)).astype(f32),
        "net_force": g.normal(0, 3, (n, 3)).astype(f32),
        "mass": np.where(live, g.uniform(0.5, 2.0, n), 1.0).astype(f32),
        "orientation": (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(f32),
        "angmom": g.normal(0, 1, (n, 4)).astype(f32),
        "moment_inertia": inertia.astype(f32),
        "net_torque": g.normal(0, 1, (n, 3)).astype(f32),
        "image": np.zeros((n, 3), np.int32),
        "diameter": np.ones(n, f32),
        "charge": np.zeros(n, f32),
        "bond_typeid": np.zeros(0, np.int32),
        "bond_group": np.zeros((0, 2), np.int32),
    }


def state_of(az, arrays: dict, asarray):
    """``az``'s State (the JAX package's or the port's) of ``arrays``, each
    array through ``asarray``."""
    fields = {k: asarray(v) for k, v in arrays.items() if k != "ref_position"}
    return az.core.state.State(box=az.core.box.Box.from_lengths(L, L, L), **fields)


def attached(method, rotational: bool, device="cpu", particle_types=("A", "B")):
    """``method`` attached as a simulation of ``particle_types`` would attach it."""
    integ = types.SimpleNamespace(integrate_rotational_dof=rotational)
    sim = types.SimpleNamespace(_particle_types=list(particle_types), device=device,
                                operations=types.SimpleNamespace(integrator=integ))
    method._attach(sim)
    return method


def methods(az, case: str):
    """The method of ``case`` with per-type gammas: "nve", "langevin",
    "noiseless", "flow" (LangevinFlow in a parabolic flow along x), each
    acting on every particle, or "type_b" (Langevin on type B only)."""
    kw = {}
    if case == "nve":
        return az.md.methods.ConstantVolume()
    if case == "type_b":
        kw["filter"] = az.md.filter.Type(["B"])
    if case == "flow":
        m = az.md.methods.LangevinFlow(kT=1.3, flow_field=az.flow.ParabolicFlow(2.0, L / 2),
                                       default_gamma=0.7)
    else:
        m = az.md.methods.Langevin(kT=1.3, default_gamma=0.7, noiseless=case == "noiseless",
                                   **kw)
    m.gamma["B"] = 1.9
    m.gamma_r["A"] = 0.4
    m.gamma_r["B"] = 2.5
    return m


CASES = ("nve", "langevin", "noiseless", "flow", "type_b")


def brownian_methods(az, case: str):
    """The BrownianFlow of ``case`` with per-type gammas: "brownian"
    (Brownian), "constant_flow" and "parabolic_flow" (BrownianFlow in a
    uniform flow and in a parabolic flow along x), "type_b" (Brownian on
    type B only) or "noiseless"."""
    kw = {"filter": az.md.filter.Type(["B"])} if case == "type_b" else {}
    flows = {"constant_flow": lambda: az.flow.ConstantFlow((0.4, -0.2, 0.1)),
             "parabolic_flow": lambda: az.flow.ParabolicFlow(2.0, L / 2)}
    if case in flows:
        m = az.md.methods.BrownianFlow(kT=1.3, flow_field=flows[case](), default_gamma=0.7)
    else:
        m = az.md.methods.Brownian(kT=1.3, default_gamma=0.7, noiseless=case == "noiseless",
                                   **kw)
    m.gamma["B"] = 1.9
    return m


BROWNIAN_CASES = ("brownian", "constant_flow", "parabolic_flow", "type_b", "noiseless")


def signed_zeros(arrays: dict, every: int = 3) -> dict:
    """``arrays`` with every ``every``-th slot at the origin as -0 under a
    force of -0: where BrownianFlow's plain step keeps the sign of a zero
    (a noiseless step's 0 coefficient times a uniform below 0 is -0, which
    a flow of -0 carries into x', and which the zeros_like flow of a step
    without a flow turns into +0), so that a kernel that skipped either
    operation would differ in its bits."""
    a = {k: v.copy() for k, v in arrays.items()}
    a["position"][::every] = np.float32(-0.0)
    a["net_force"][::every] = np.float32(-0.0)
    return a


def drift_arrays(kind: str, n: int, seed: int) -> dict:
    """``slot_arrays(n, seed)`` with the drift of ``kind``: "random" (as
    made), "nan" (one slot's z NaN), "tie" (two slots share the largest
    drift exactly, the rest none), "single" (one slot drifts, the rest
    none) or "empty" (every slot empty)."""
    a = slot_arrays(n, seed)
    pos, refp, tag = a["position"], a["ref_position"], a["tag"]
    live = np.flatnonzero(tag >= 0)
    if kind == "nan":
        pos[live[7], 2] = np.nan
    elif kind == "tie":
        pos[:] = refp
        pos[live[:2]] = refp[live[:2]] + np.float32([0.3, 0.1, 0.0])
    elif kind == "single":
        pos[:] = refp
        pos[live[3]] = refp[live[3]] + np.float32([0.3, 0.1, 0.0])
    elif kind == "empty":
        tag[:] = -1
    return a


DRIFT_KINDS = ("random", "nan", "tie", "single", "empty")
