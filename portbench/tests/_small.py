"""Small cells for the CPU tests: the harness's run on the program's plain
versions, with the look for a card skipped. A configuration's CPU-test size
is its builder's ``SMALL`` (``configs/<config>.py``: traffic overrides,
configuration overrides) where it gives one, else this file's."""

import time
from pathlib import Path

import torch

from portbench import harness, manifest

BENCH = manifest.load()
# (traffic overrides, configuration overrides) of the configurations whose
# builder gives no SMALL
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


FAMILIES = Path(__file__).resolve().parent / "families"
# a benchmark of one cell whose files lie in families/ (the tests' fixture
# ``files`` finds them there): configs/idle_srd.* (REFERENCE "solvent"),
# traffic/stream2k.json, limits/idle_srd.stream2k.json and
# reference/solvent.py
SOLVENT = {"configs": [{"name": "idle_srd",
                        "source": "https://github.com/glotzerlab/hoomd-blue "
                                  "(hoomd.mpcd: an SRD solvent)",
                        "file": str((FAMILIES / "configs" / "idle_srd.json")
                                    .relative_to(manifest.ROOT)),
                        "reduced": [], "why": "an MPCD solvent judged by its own family"}],
           "workloads": [{"name": "idle_srd.stream2k", "config": "idle_srd",
                          "traffic": "stream2k", "chips": 1,
                          "why": "2,000 solvent rows streaming between collisions"}],
           "end_to_end": [], "per_layer": []}


def small(config: str) -> tuple[dict, dict]:
    """The CPU-test size of ``config``: (traffic overrides, configuration
    overrides), its builder's ``SMALL`` where it gives one."""
    return getattr(manifest.config_builder(config), "SMALL", None) or SMALL[config]


# the logged cell's writers at periods its small calls reach
LOGGED = {"writers": [
    {"kind": "Table", "period": 10, "quantities": ["kinetic_temperature", "potential_energy"]},
    {"kind": "GSD", "period": 20, "dynamic_only": True}]}


def run(cell: str, seed: int = 987654321987, control: bool = False, trace: bool = False,
        seconds: float = 0.2, traffic: dict | None = None, bench: dict = BENCH) -> dict:
    w = SHELVED.get(cell) or manifest.workload(bench, cell)
    size, params = small(w["config"])
    if w["traffic"].endswith(".logged"):
        size = {**size, **LOGGED}
    traffic = {**size, **(traffic or {})}
    return harness.run_cell(bench, w, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), traffic, control=control,
                            params_overrides=params)
