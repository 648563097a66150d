"""The benchmark's one door into the program, ``azplugins_tpu_torch``.

The harness takes from the program only the system under test (its public
``Simulation`` API), its state and counters, and the names of its
hand-written kernels. The reads that go through private attributes are
here and nowhere else: the slot layout (``Simulation._dense``, whose
``net_force`` is the conservative force the step computed), the CUDA
graph counters of the segment graphs and of the SRD advance graphs
(``Simulation._graph_totals``, ``Simulation._advance_totals``), whether
each applies (``Simulation._graphs_apply``,
``Simulation._advance_graphs_apply``), the grid's cell capacity and the
MPCD solvent stream (``Simulation._whole_mpcd``). The program's tracer is
public (``Simulation.tracer``): its spans, counters and phase marks.
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


def read_solvent(sim) -> dict:
    """The MPCD solvent the last step left, in row order (solvent rows never
    migrate), whole on the simulation's device: positions and velocities
    as stored, type ids and the timestep."""
    mpcd = sim._whole_mpcd()
    if mpcd is None:
        raise ValueError("the simulation holds no MPCD solvent")
    # joined blocks are copies already; the type ids are widened
    return {"t": sim.timestep, "x": mpcd["position"], "v": mpcd["velocity"],
            "type": mpcd["typeid"].to(torch.int64)}


def slots(sim) -> tuple[int, int]:
    """(slots of the layout, occupied slots)."""
    d = _layout(sim)
    return int(d.tag.numel()), int((d.tag >= 0).sum())


def counters(sim) -> dict:
    """Grid builds and the segment graph cache's captures, replays and
    segments run eagerly, since the layout was made (one host read); and
    the SRD advance graphs' captures, replays and first sights run eagerly
    (``advance_*``; 0 where the program holds no advance graphs)."""
    g, a = sim._graph_totals, sim._advance_totals
    return {"builds": sim.n_builds, "captures": g.get("captures", 0),
            "replays": g.get("replays", 0), "eager_segments": g.get("eager_segments", 0),
            "advance_captures": a.get("captures", 0), "advance_replays": a.get("replays", 0),
            "advance_eager": a.get("eager_segments", 0)}


def on_graphs(sim) -> bool:
    """Whether the program runs its rebuild segments as CUDA graphs."""
    return bool(sim._graphs_apply())


def advance_on_graphs(sim) -> bool:
    """Whether the program advances an uncoupled SRD stream on its advance
    graphs."""
    return bool(sim._advance_graphs_apply())


def tracer(sim):
    """The program's tracer (``Simulation.tracer``): host spans, counters
    and device phase marks, off until enabled."""
    return sim.tracer


def span_names() -> tuple[str, ...]:
    """Every span the program's run loop records: under a profiler each is
    a range, whose device-side copy is no device operation."""
    from azplugins_tpu_torch.trace import SPANS

    return SPANS


def cell_cap(sim) -> int | None:
    """The neighbour grid's slots a cell (None where no pair force needs a
    grid)."""
    spec = sim._grid_spec
    return None if spec is None else int(spec.cap)
