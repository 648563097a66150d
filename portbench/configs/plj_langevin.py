"""BASELINE configuration 1: a perturbed Lennard-Jones liquid under Langevin.

A simple cubic lattice at rho 0.85 melts under PerturbedLennardJones
(epsilon 1, sigma 1, lambda 0.5, r_cut 3, mode none, a Cell list with
buffer 0.4) and Langevin (kT 1, gamma 0.1), dt 0.005. The problem size,
``n_particles`` (a perfect cube), is the traffic's.
"""

from __future__ import annotations

import numpy as np

from portbench import initial
from portbench.reference import threefry

SOURCE = ("https://github.com/mphowardlab/azplugins (PerturbedLennardJones, Langevin); size "
          "of HOOMD-blue's LJ liquid benchmark, https://github.com/glotzerlab/hoomd-benchmarks")
ASSUMED = ["momenta Maxwell-Boltzmann at kT_init from the seed",
           "n_particles from the traffic, a perfect cube"]
REDUCED: list[str] = []


def initial_state(p: dict, traffic: dict, gen) -> dict:
    n = int(traffic["n_particles"])
    n_side = round(n ** (1.0 / 3.0))
    if n_side**3 != n:
        raise ValueError(f"n_particles {n} is not a perfect cube")
    # the box as the program holds it (float32), so both sides share it exactly
    L = float(np.float32((n / p["rho"]) ** (1.0 / 3.0)))
    return {"L": [L, L, L], "x": initial.cubic_lattice(n_side, L), "types": p["types"],
            "type": np.zeros(n, dtype=np.int32),
            "v": initial.momenta(n, p["kT_init"], p["mass"], gen)}


def build(az, sim, p: dict) -> None:
    """The forces and the method, on a simulation holding the initial state."""
    q = p["pair"]
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=q["buffer"]),
                                       default_r_cut=q["r_cut"], mode=q["mode"])
    lj.params[("A", "A")] = dict(epsilon=q["epsilon"], sigma=q["sigma"],
                                 attraction_scale_factor=q["attraction_scale_factor"])
    m = p["method"]
    lang = az.md.methods.Langevin(kT=m["kT"], default_gamma=m["gamma"])
    sim.operations.integrator = az.md.Integrator(dt=p["dt"], methods=[lang], forces=[lj])


def model(p: dict, init: dict, sim_seed: int) -> dict:
    """The plain reference's description of the same physics."""
    q = p["pair"]
    return {
        "types": p["types"], "dt": p["dt"], "seed": sim_seed, "mass": p["mass"],
        "pair": {"r_cut": q["r_cut"], "params": {(0, 0): {
            "epsilon": q["epsilon"], "sigma": q["sigma"],
            "attraction_scale_factor": q["attraction_scale_factor"]}}},
        "walls": [],
        "method": {"kT": p["method"]["kT"], "gamma": [p["method"]["gamma"]],
                   "stream": threefry.LANGEVIN},
    }
