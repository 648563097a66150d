"""A test's configuration: two idle MD particles and an MPCD solvent of
``n_particles`` rows under SRD with one collision each 1,000 steps, so
that the steps a run judges only stream. Its family is the test's own
``reference/solvent.py``."""

from __future__ import annotations

import numpy as np
import torch

from portbench import initial

REFERENCE = "solvent"
SOURCE = "https://github.com/glotzerlab/hoomd-blue (hoomd.mpcd: an SRD solvent)"
ASSUMED = ["solvent positions uniform in the box and momenta Maxwell-Boltzmann, from the seed"]
REDUCED: list[str] = []
# the CPU tests' size (portbench/tests/_small.py): traffic overrides,
# configuration overrides
SMALL = ({"n_particles": 1000}, {})


def initial_state(p: dict, traffic: dict, gen) -> dict:
    n, L = int(traffic["n_particles"]), p["L"]
    u = torch.rand((n, 3), generator=gen, device=gen.device, dtype=torch.float64)
    return {"L": [L, L, L], "x": np.array([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]),
            "types": p["types"], "type": np.zeros(2, dtype=np.int32),
            "v": torch.zeros((2, 3), dtype=torch.float32),
            "solvent": {"x": ((u - 0.5) * L).cpu().numpy(),
                        "v": initial.momenta(n, p["kT_init"], p["mass"], gen).cpu().numpy()}}


def build(az, sim, p: dict) -> None:
    sim.operations.integrator = az.md.Integrator(
        dt=p["dt"], methods=[az.md.methods.ConstantVolume()], forces=[])
    s = p["srd"]
    sim.mpcd_dynamics = az.mpcd.SRD(dt=p["dt"], period=s["period"], angle=s["angle"],
                                    cell_size=s["cell_size"])


def model(p: dict, init: dict, sim_seed: int) -> dict:
    return {"dt": p["dt"], "srd_period": p["srd"]["period"]}
