"""Small cells for the CPU tests: the harness's run on the program's plain
versions, with the look for a card skipped."""

import time

import torch

from portbench import harness, manifest

BENCH = manifest.load()
# (traffic overrides, configuration overrides) per configuration
SMALL = {
    "plj_langevin": ({"n_particles": 1000, "run_steps": 20, "warmup_calls": 1,
                      "check_steps": 3}, {}),
    # R0 6: 552 particles; warm-up and calls of 25 steps keep the window's
    # end on the evaporator's period, the first check step fires it
    "droplet_evaporation": ({"n_particles": 552, "run_steps": 25, "window_steps": 50,
                             "warmup_calls": 1, "check_steps": 3}, {"R0": 6.0}),
}


# cells whose files are kept while BENCHMARK.json leaves them out (on the
# card the program loses a particle on the box's +L/2 face from its grid at
# this box size): the CPU tests keep their paths, the writers' among them
SHELVED = {name: {"name": name, "config": "plj_langevin", "traffic": name.split(".", 1)[1],
                  "chips": 1} for name in ("plj_langevin.n64k", "plj_langevin.n64k.logged")}


# the logged cell's writers at periods its small calls reach
LOGGED = {"writers": [
    {"kind": "Table", "period": 10, "quantities": ["kinetic_temperature", "potential_energy"]},
    {"kind": "GSD", "period": 20, "dynamic_only": True}]}


def run(cell: str, seed: int = 987654321987, control: bool = False, trace: bool = False,
        seconds: float = 0.2, traffic: dict | None = None) -> dict:
    w = SHELVED.get(cell) or manifest.workload(BENCH, cell)
    small, params = SMALL[w["config"]]
    if w["traffic"].endswith(".logged"):
        small = {**small, **LOGGED}
    traffic = {**small, **(traffic or {})}
    return harness.run_cell(BENCH, w, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), traffic, control=control,
                            params_overrides=params)
