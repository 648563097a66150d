"""BASELINE configuration 5: an evaporating droplet in a parabolic flow.

A lattice droplet (spacing 1.1) of radius 0.93 R0, R0 20, in a box of
2 R0 + 4: PerturbedLennardJones for solvent-solvent (lambda 1, r_cut 2.5,
buffer 0.4), an "evaporated" type that interacts with nothing; a
SphericalHarmonicBarrier (k 50) at SphereArea(R0, alpha 0.05); an LJ93
plane wall 0.5 above the floor; a ParticleEvaporator retyping up to 10
solvent particles in z in [R0/2, L/2) every 25 steps; LangevinFlow (kT 1,
gamma 1) in a ParabolicFlow of mean 0.5 across L - 2; dt 0.002.
"""

from __future__ import annotations

import numpy as np

from portbench import initial
from portbench.reference import threefry

SOURCE = ("https://github.com/mphowardlab/azplugins (ParticleEvaporator, "
          "SphericalHarmonicBarrier, wall.LJ93, LangevinFlow, ParabolicFlow: a drying droplet)")
ASSUMED = ["momenta Maxwell-Boltzmann at kT_init from the seed",
           "the evaporated type feels no pair, barrier or wall force"]
REDUCED: list[str] = []


def _box(p: dict) -> float:
    """The box edge, as the program holds it (float32)."""
    return float(np.float32(2 * p["R0"] + p["box_margin"]))


def initial_state(p: dict, traffic: dict, gen) -> dict:
    R0, a = p["R0"], p["lattice_spacing"]
    L = _box(p)
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * p["fill"]]
    n = len(pts)
    if n != int(traffic["n_particles"]):
        raise ValueError(f"the droplet holds {n} particles, the traffic asks for "
                         f"{traffic['n_particles']}")
    return {"L": [L, L, L], "x": pts, "types": p["types"], "type": np.zeros(n, dtype=np.int32),
            "v": initial.momenta(n, p["kT_init"], p["mass"], gen)}


def build(az, sim, p: dict) -> None:
    R0, L = p["R0"], _box(p)
    q = p["pair"]
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=q["buffer"]),
                                       default_r_cut=q["r_cut"], mode=q["mode"])
    lj.params[("solvent", "solvent")] = dict(
        epsilon=q["epsilon"], sigma=q["sigma"],
        attraction_scale_factor=q["attraction_scale_factor"])
    for pair in (("solvent", "evaporated"), ("evaporated", "evaporated")):
        lj.params[pair] = dict(epsilon=q["evaporated_epsilon"], sigma=q["sigma"],
                               attraction_scale_factor=0.0)
    b = p["barrier"]
    barrier = az.external.SphericalHarmonicBarrier(
        location=az.variant.SphereArea(R0=R0, alpha=b["alpha"]))
    barrier.params["solvent"] = dict(k=b["k"], offset=b["offset"])
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    w = p["wall"]
    wall = az.external.wall.LJ93(walls=[az.external.wall.Plane(
        origin=(0, 0, -L / 2 + w["plane_above_floor"]), normal=(0, 0, 1))])
    wall.params["solvent"] = dict(epsilon=w["epsilon"], sigma=w["sigma"], r_cut=w["r_cut"])
    wall.params["evaporated"] = dict(epsilon=0.0, sigma=w["sigma"], r_cut=w["r_cut"])
    e = p["evaporator"]
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(e["period"]), solvent_type="solvent",
        evaporated_type="evaporated", lo=R0 * e["lo_over_R0"], hi=L / 2,
        N_evap_max=e["N_evap_max"]))
    m = p["method"]
    flow = az.flow.ParabolicFlow(mean_velocity=m["flow"]["mean_velocity"],
                                 separation=L - m["flow"]["separation_margin"])
    sim.operations.integrator = az.md.Integrator(
        dt=p["dt"],
        methods=[az.md.methods.LangevinFlow(kT=m["kT"], flow_field=flow, default_gamma=m["gamma"])],
        forces=[lj, barrier, wall])


def model(p: dict, init: dict, sim_seed: int) -> dict:
    R0, L = p["R0"], _box(p)
    q, b, w, e, m = p["pair"], p["barrier"], p["wall"], p["evaporator"], p["method"]
    off = {"epsilon": q["evaporated_epsilon"], "sigma": q["sigma"], "attraction_scale_factor": 0.0}
    return {
        "types": p["types"], "dt": p["dt"], "seed": sim_seed, "mass": p["mass"],
        "pair": {"r_cut": q["r_cut"], "params": {
            (0, 0): {"epsilon": q["epsilon"], "sigma": q["sigma"],
                     "attraction_scale_factor": q["attraction_scale_factor"]},
            (0, 1): off, (1, 1): off}},
        "barrier": {"R0": R0, "alpha": b["alpha"], "k": [b["k"], 0.0],
                    "offset": [b["offset"], 0.0]},
        "walls": [{"origin": (0.0, 0.0, -L / 2 + w["plane_above_floor"]), "normal": (0, 0, 1),
                   "epsilon": [w["epsilon"], 0.0], "sigma": [w["sigma"]] * 2,
                   "r_cut": [w["r_cut"]] * 2}],
        "method": {"kT": m["kT"], "gamma": [m["gamma"]] * 2, "stream": threefry.LANGEVIN_FLOW,
                   "flow": {"mean_velocity": m["flow"]["mean_velocity"],
                            "separation": L - m["flow"]["separation_margin"]}},
        "evaporator": {"period": e["period"], "solvent": 0, "evaporated": 1,
                       "lo": R0 * e["lo_over_R0"], "hi": L / 2, "k": e["N_evap_max"]},
    }
