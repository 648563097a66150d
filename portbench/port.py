"""The benchmark's one door into the program, ``azplugins_tpu_torch``.

The harness takes from the program only the system under test (its public
``Simulation`` API), its state and counters, and the names of its
hand-written kernels. The reads that go through private attributes are
here and nowhere else: the slot layout (``Simulation._dense``, whose
``net_force`` is the conservative force the step computed), the CUDA
graph counters (``Simulation._graph_totals``), whether the graphs apply
(``Simulation._graphs_apply``) and the grid's cell capacity.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

from .manifest import ROOT

PACKAGE = "azplugins_tpu_torch"
CSRC = ROOT / PACKAGE / "csrc"
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(")


def kernel_names(csrc: Path = CSRC) -> list[str]:
    """Every ``__global__`` function of the program's ``csrc/*.cu``: a device
    operation is the program's own when its name is one of these."""
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return sorted(names)


def kernel_pattern(names: list[str]) -> re.Pattern:
    """A device operation's name is the program's when one of ``names`` is in
    it as a whole identifier (a demangled name adds a return type, template
    arguments and parameters)."""
    alt = "|".join(re.escape(n) for n in sorted(names, key=len, reverse=True))
    return re.compile(rf"(?<![A-Za-z0-9_])(?:{alt})(?![A-Za-z0-9_])")


def load(device: torch.device):
    """Import the program from this checkout; on the card, build (first run
    in a checkout: nvcc into the program's own ``_build/``) and load every
    kernel library at once."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import azplugins_tpu_torch as az

    if not Path(az.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"{PACKAGE} imported from {az.__file__}, not from this checkout")
    if device.type == "cuda":
        from azplugins_tpu_torch.ops import cuda_build

        cuda_build.load_libraries(*sorted(p.name for p in CSRC.glob("*.cu")))
    return az


def _layout(sim):
    dense = sim._dense
    if isinstance(dense, tuple):
        raise ValueError("the benchmark reads a whole slot layout, not shards")
    return dense


def read_state(sim) -> dict:
    """The state the last step left, tag-ordered on the simulation's device:
    positions as stored (any image), velocities, accelerations, the
    conservative net force, types, tags and the timestep."""
    d = _layout(sim)
    occ = d.tag >= 0
    order = torch.argsort(d.tag[occ])

    def take(a):
        return a[occ][order].clone()

    return {"t": sim.timestep, "x": take(d.position), "v": take(d.velocity),
            "a": take(d.acceleration), "f": take(d.net_force),
            "type": take(d.typeid).to(torch.int64), "tag": take(d.tag).to(torch.int64)}


def slots(sim) -> tuple[int, int]:
    """(slots of the layout, occupied slots)."""
    d = _layout(sim)
    return int(d.tag.numel()), int((d.tag >= 0).sum())


def counters(sim) -> dict:
    """Grid builds and the CUDA graph cache's captures, replays and segments
    run eagerly, since the layout was made (one host read)."""
    g = sim._graph_totals
    return {"builds": sim.n_builds, "captures": g.get("captures", 0),
            "replays": g.get("replays", 0), "eager_segments": g.get("eager_segments", 0)}


def on_graphs(sim) -> bool:
    """Whether the program runs its rebuild segments as CUDA graphs."""
    return bool(sim._graphs_apply())


def cell_cap(sim) -> int:
    """The neighbour grid's slots a cell."""
    return int(sim._grid_spec.cap)
