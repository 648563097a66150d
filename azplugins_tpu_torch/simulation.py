"""Simulation: owns the state and operations and drives the step loop.

Port of ``azplugins_tpu/simulation.py`` (state management, attach, the
dense layout, the step loop with its rebuild schedule, transactional
replays, updaters, the capacity tune, the MPCD solvent stream and its
collisional coupling, the writers, ``create_state_from_gsd``, the force
observables, spatial decomposition and the profiler trace). Pair, DPD,
anisotropic and bond forces all take the dense state and the tag->slot
map; a run without pair forces keeps tag order, with the identity map.
With ``integrate_rotational_dof``, ``net_torque`` is set every step, beside
the net force, to the sum of the torques of the forces that produce them.

The simulation runs on the device it is given, and on the GPU
(``"cuda"``) by default: without CUDA the default raises, and the CPU is
used only when asked for (``device="cpu"``).

Each step runs, as the reference's: methods.step1 -> Verlet drift check ->
forces -> methods.step2 -> the updaters whose trigger fires at the step,
in the dense cell-slot layout of ops/dense.py. The tag-ordered State is
rebuilt from the slots only when something reads it. Triggers are
evaluated on the host from the timestep, and an updater is a pure device
function of (state, timestep, seed), so a firing neither splits the chunk
nor waits for the device; a replayed chunk re-applies the same firings.
Variants are read at each step's timestep, from the chunk's float32
values on the device (``core/variant.py::value_at``).

MPCD. ``snapshot.mpcd`` becomes the solvent stream ``_mpcd`` (position
and velocity as tuples of particle blocks, typeid, mass, types, and the
SRD anchor once it streams). With
``mpcd_dynamics`` set, each accepted chunk advances it (``SRD._advance``);
a replayed chunk never does. A ``mpcd.CollisionCoupling`` updater applies
the joint solvent-solute collision inside the chunk, after the step its
trigger names, with the solvent's anchor carried through the chunk and
adopted only when the chunk is accepted, so a replay starts again from the
untouched stream.

Writers. A chunk ends at the next timestep a writer's trigger names, and
the writers whose trigger holds at the new timestep fire after the chunk
is accepted, after the solvent has advanced and the rebuild interval has
adapted: a frame carries the state and the solvent of its own timestep,
and a replayed chunk writes nothing. The split does not change the
trajectory: the rebuild schedule is absolute, a chunk that starts off it
continues the previous chunk's segment, and an overflow grows the
capacity at the rebuild that overflowed (a violation replay excepted,
below).

Rebuild control. The neighbour grid is rebuilt on the absolute schedule
``t % seg_len == 0``; in between, every step only *checks* the Verlet
drift (ops/dense.needs_rebin) and ORs a violation flag that stays on the
device. The host reads that flag and the capacity-overflow flag once per
chunk, in one transfer, so the step loop itself never waits for the
device. A violation replays the chunk from its saved starting state with
a shorter interval (re-derived from the fastest particle); an overflow
replays it with a larger cell capacity from the rebuild that overflowed
(found by replaying the chunk one rebuild a chunk), so the capacity, like
the rebuild schedule, changes at a timestep that does not depend on where
chunks end. States are immutable dataclasses, so the saved state costs
nothing. A violation replay restarts at its chunk's start, so a chunk
split (a writer's, the tune's, a ``run`` call's) moves the steps it
replays; without violations the trajectory is bitwise independent of the
chunking.

Spatial decomposition. ``enable_spatial_decomposition(mesh)`` cuts the
slot axis into the mesh's blocks (slabs of whole x planes, or strips of
whole z cell columns): the grid's (Dx, Dy) snaps to a product the mesh size
divides. On a mesh of views (every block on the simulation's device) the
global rebin's slot layout is already each block's in turn, so the
rebuilds stay global. On a sharded mesh each block is a State of its own
on its device: every phase of the step runs once a shard, the rebuild is
the block-local rebin with migration (parallel/spatial.py), and each
shard's stencil forces read its halo window. Either way the trajectory,
rebuilds and observables are the undecomposed run's on the same grid, bit
for bit. On shards, updaters run once a shard (the evaporator's pick on
global slots), bonds read every shard's positions through the global
tag->slot map, and the MPCD solvent is cut into particle blocks, one a
shard, when the mesh size divides it (mpcd._place_solvent): its collisions
regroup the float32 cell sums across the blocks, the one result that is
not bitwise (within ~1e-7 relative a collision).

Profiling. Inside ``with sim.profile(logdir):`` the step loop marks its
phases as ``torch.profiler.record_function`` ranges named after the
reference's scopes; outside it no range is entered.

The runner. The reference compiles a chunk into one jitted loop
(``run_chunk``, ``steps_span``, ``_bind_tables``); the port's counterpart
runs a chunk as rebuild segments (:meth:`Simulation._run_segment`: the
optional rebuild, then L steps, with no host read). On CUDA, for a whole
layout with any variant and any updater but an MPCD coupling, each segment
is a CUDA graph (graph.py, bound by :meth:`Simulation._build_runner`):
captured the second time its shape is seen, replayed after that, its draws
keyed on a clock on the card. The chunk's schedule goes to the card once a
chunk: each variant's float32 value at each step (``Variant.values``),
which the operations read as 0-d tensors, and each updater's trigger
(``Trigger.mask``), under which every updater runs after every step as
the reference's masked select (``apply_inline_updaters``). The eager loop
reads the same values (K8's and K9's kT by value there, by pointer in a
graph, bitwise) and fires its updaters from the host's triggers.
A sharded mesh, an MPCD coupling, and every run inside
:meth:`Simulation.profile` run the segments eagerly; the choice is made
from the operations, never from a failure. Either way the trajectory is
the same, bit for bit. The SRD advance of an uncoupled solvent in one
block replays graphs of its own (:meth:`Simulation._advance_runner`,
``graph.AdvanceGraphs``: a graph a collision, its keys and grid shift drawn
from a clock on the card), under the same rule but for the coupling and
the solvent's blocks; bitwise the eager advance.

Capacity tune. At the absolute timestep ``auto_tune_after`` (200 by
default) the run right-sizes the cell capacity to the equilibrated
occupancy and resets the rebuild interval from the fastest particle
(:meth:`Simulation.tune_cell_capacity`); the chunk is split there, so the
tune point, and the trajectory after it, do not depend on how ``run`` is
called.
"""

from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch

from .core.snapshot import Snapshot
from .core.state import State, state_from_snapshot, state_to_snapshot, thermalize_momenta, to_host
from .md.force import ForceResult, SimContext
from .md.methods import DriftCheck
from .ops import dense as D

__all__ = ["Simulation", "Operations"]

_NO_RANGE = contextlib.nullcontext()


def _as_shards(x) -> tuple:
    """The dense layout, or its meta, as a tuple of shards: a whole layout
    (a State or a GridMeta) is one shard. Simulation holds the tuple only
    on a sharded mesh (:meth:`Simulation._as_layout`)."""
    return x if isinstance(x, tuple) else (x,)


def _no_range(name: str):
    """The step loop's phase scope outside a profile: enters nothing."""
    return _NO_RANGE

def _host_fingerprint(x):
    """A comparable image of host tables: dicts by key, arrays (and CPU
    tensors) by dtype, shape and bytes, scalars as they are."""
    if isinstance(x, dict):
        return tuple((k, _host_fingerprint(v)) for k, v in sorted(x.items()))
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return x.dtype.str, x.shape, x.tobytes()
    return x


def _tables_fingerprint(force) -> tuple:
    """What a force's device tables are made from: the force itself, its
    mode and its host tables."""
    return (id(force), type(force).__name__, getattr(force, "mode", None),
            _host_fingerprint(getattr(force, "_tbl", None)))


def _segments(n_steps: int, seg_len: int, rebin_first: bool):
    """A chunk's rebuild segments, ``(first step, steps, rebuild)``: with
    ``rebin_first`` one at chunk-relative steps 0, seg_len, 2 seg_len, ...,
    each rebuilding first; else one continuing the previous chunk's
    segment (the reference's ``steps_span``)."""
    if not rebin_first:
        return [(0, n_steps, False)]
    return [(a, min(seg_len, n_steps - a), True) for a in range(0, n_steps, seg_len)]


# absolute-timestep quantum for rebuild-interval adaptation: the interval
# changes only at multiples of this, so the rebuild schedule is a pure
# function of the timestep, whatever the run() chunking
_GROW_QUANTUM = 100


class Operations:
    def __init__(self):
        self.integrator = None
        self.updaters: list = []
        self.computes: list = []
        self.writers: list = []

    def add(self, op):
        """hoomd-style routing: forces go to the integrator, updaters,
        computes and writers to their lists."""
        from .compute import Compute
        from .md.force import Force
        from .update import Updater
        from .write import Writer

        if isinstance(op, Force):
            if self.integrator is None:
                raise RuntimeError("set an integrator before adding forces")
            self.integrator.forces.append(op)
        elif isinstance(op, Updater):
            self.updaters.append(op)
        elif isinstance(op, Compute):
            self.computes.append(op)
        elif isinstance(op, Writer):
            self.writers.append(op)
        else:
            raise TypeError(f"cannot add {op!r}")

    def __iadd__(self, op):
        self.add(op)
        return self


class _StateView:
    """hoomd-like ``sim.state`` accessor (always tag-ordered)."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    @property
    def N_particles(self) -> int:
        return self._sim._synced_state().N

    @property
    def particle_types(self) -> list[str]:
        return list(self._sim._particle_types)

    @property
    def bond_types(self) -> list[str]:
        return list(self._sim._bond_types)

    @property
    def box(self):
        return self._sim._synced_state().box

    def get_snapshot(self) -> Snapshot:
        sim = self._sim
        snap = state_to_snapshot(sim._synced_state(), sim._particle_types, sim._bond_types)
        mpcd = sim._whole_mpcd()
        if mpcd is not None:
            snap.mpcd.resize(mpcd["position"].shape[0])
            snap.mpcd.position[:], snap.mpcd.velocity[:], snap.mpcd.typeid[:] = to_host(
                mpcd["position"], mpcd["velocity"], mpcd["typeid"])
            snap.mpcd.mass = mpcd["mass"]
            snap.mpcd.types = list(mpcd["types"])
        return snap

    def set_snapshot(self, snapshot: Snapshot):
        self._sim._set_snapshot(snapshot)

    def thermalize_particle_momenta(self, filter=None, kT: float = 1.0):
        sim = self._sim
        state = sim._synced_state()
        mask = None
        if filter is not None:
            typeids = state.typeid.cpu().numpy()
            mask = torch.as_tensor(filter.mask(typeids, sim._particle_types), device=sim.device)
        sim._state = thermalize_momenta(state, kT, sim.seed, mask)
        sim._drop_dense()


class Simulation:
    """Owns state and operations on one device and drives the step loop."""

    def __init__(self, device=None, seed: int = 0):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Simulation() runs on the GPU by default and no CUDA device is available; "
                    'pass device="cpu" to run on the CPU'
                )
            device = "cuda"
        self.device = torch.device(device)
        self.seed = int(seed) & 0xFFFF
        self.operations = Operations()
        self._state: State | None = None  # tag order (may be stale vs dense)
        self._particle_types: list[str] = []
        self._bond_types: list[str] = []
        self._timestep = 0
        self._attached = False
        self._prepared = False
        self._grid_spec: D.GridSpec | None = None
        self._dense: State | None = None  # slot order
        self._meta: D.GridMeta | None = None
        self._state_stale = False
        self._fields: tuple = D.ALL_FIELDS  # rebin payload columns
        self._ops_fp = None
        # rebuild interval: the grid rebuilds at every timestep divisible by
        # _seg_len. A violation lowers it and replays; clean quanta grow it
        # back by 1 up to the ceiling, which itself relaxes after 10 quanta
        self._seg_len = 10
        self._seg_ceiling = 50
        self._clean_quanta = 0
        # set by a violation replay: the restored state's rebuild reference
        # belongs to the old schedule, so the unaligned prefix up to the next
        # point of the new schedule rebuilds every step
        self._realign = False
        # set by an overflow in a chunk of several rebuilds to the end of that
        # chunk: until then chunks hold one rebuild each, so the one that
        # overflowed is found (None: not probing)
        self._probe_until: int | None = None
        # longest chunk between host synchronisations
        self.max_chunk = 1000
        # False pins the rebuild interval (violation replays still lower
        # it; quantum regrowth and the chunk splits at quanta stop)
        self._seg_adapt = True
        # the capacity tune fires the first time the absolute timestep
        # reaches auto_tune_after (None: never); a manual
        # tune_cell_capacity() or a timestep set past it cancels it
        self.auto_tune_after: int | None = 200
        self._auto_tuned = False
        # diagnostics: violation replays, force evaluations (one per force
        # per step, replayed steps included) and steps the loop ran
        # (replayed steps included)
        self.viol_replays = 0
        self.force_evaluations = 0
        self.steps_run = 0
        # the MPCD solvent stream (snapshot.mpcd) and its dynamics
        # (mpcd.SRD), which advances it beside the MD trajectory
        self._mpcd: dict | None = None
        self.mpcd_dynamics = None
        self._coupling = None  # the mpcd.CollisionCoupling updater of this run
        self._warned_divisor_collapse = False
        # spatial decomposition: when set, the grid holds whole z cell
        # columns a block of this mesh; on a sharded mesh _dense and _meta
        # are tuples, one State and one GridMeta a block
        self._spatial_mesh = None
        self._spatial_migrate_cap: int | None = None
        # the step loop's phase scope: record_function inside profile()
        self._phase_range = _no_range
        # the segment graphs (graph.SegmentGraphs, _build_runner) where
        # _graphs_apply(); _eager keeps the eager loop on the card (the
        # graphs' plain version, held against them by chip_smoke.py and the
        # CUDA tests); _capture stands in for the CUDA capture (the CPU
        # tests)
        self._runner = None
        self._eager = False
        self._capture = None
        # captures, replays, eager_segments, pool_bytes over every runner
        self._graph_totals: dict = {}
        # the SRD advance's graphs (graph.AdvanceGraphs, _advance_runner)
        # where _advance_graphs_apply(), and their totals
        self._advance_graphs = None
        self._advance_totals: dict = {}
        # (host fingerprint, device tables, the forces): _force_tables' cache
        self._tables = None

    # -- state management ------------------------------------------------
    def create_state_from_snapshot(self, snapshot: Snapshot):
        if self._state is not None:
            raise RuntimeError("state already created")
        self._set_snapshot(snapshot)

    def create_state_from_gsd(self, filename: str, frame: int = -1):
        """Initialize from a hoomd-schema GSD file and restore its step.

        hoomd.Simulation.create_state_from_gsd parity: reads files written
        by HOOMD's gsd package, ``write.GSD`` or ``io.export_gsd``,
        including dynamic frames (omitted chunks fall back to frame 0). The
        timestep restores from configuration/step through the ``timestep``
        setter, so triggers and RNG streams resume on the absolute schedule
        and a step at or past ``auto_tune_after`` does not tune again.
        """
        from .io.gsd import _read_gsd_frame

        snap, step = _read_gsd_frame(filename, frame)
        self.create_state_from_snapshot(snap)
        self.timestep = step

    def _set_snapshot(self, snapshot: Snapshot):
        self._state, self._particle_types, self._bond_types = state_from_snapshot(
            snapshot, self.device
        )
        mpcd = getattr(snapshot, "mpcd", None)
        if mpcd is not None and mpcd.N > 0:
            # position and velocity as blocks (one here; _place_spatial
            # cuts them for a sharded mesh)
            self._mpcd = {
                "position": (torch.as_tensor(np.asarray(mpcd.position, np.float32),
                                             device=self.device),),
                "velocity": (torch.as_tensor(np.asarray(mpcd.velocity, np.float32),
                                             device=self.device),),
                "typeid": torch.as_tensor(np.asarray(mpcd.typeid, np.int32), device=self.device),
                "mass": float(mpcd.mass),
                "types": list(mpcd.types),
            }
        else:
            self._mpcd = None
        self._drop_dense()
        self._invalidate()

    def _drop_dense(self):
        self._dense = None
        self._meta = None
        self._state_stale = False
        self._prepared = False

    def _synced_state(self) -> State:
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        if self._state_stale and self._dense is not None:
            if self._grid_spec is None:
                self._state = self._dense
            else:
                self._state = D.undensify(self._whole_dense(), N=self._state.N,
                                          fields=self._fields)
            self._state_stale = False
        return self._state

    def _whole_dense(self) -> State:
        """The dense layout as one State on the simulation's device (the
        shards joined in block order)."""
        if isinstance(self._dense, tuple):
            from .parallel.spatial import gather_dense

            return gather_dense(self._dense, self.device)
        return self._dense

    def _whole_mpcd(self) -> dict | None:
        """The solvent stream with its position and velocity whole on the
        simulation's device (its blocks joined in particle order)."""
        from .mpcd import _joined

        mpcd = self._mpcd
        if mpcd is None:
            return None
        return {**mpcd, "position": _joined(mpcd["position"], self.device),
                "velocity": _joined(mpcd["velocity"], self.device)}

    def _as_layout(self, shards: tuple):
        """Shards (or their metas) as ``_dense`` (``_meta``) holds them: the
        tuple on a sharded mesh, else its one entry."""
        return shards if self._sharded() else shards[0]

    @property
    def state(self) -> _StateView:
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        return _StateView(self)

    @property
    def timestep(self) -> int:
        return self._timestep

    @timestep.setter
    def timestep(self, value: int):
        self._timestep = int(value)
        # a clock set at or past the tune point (a resume) declares the tune
        # done in the earlier run
        if self.auto_tune_after is not None and self._timestep >= self.auto_tune_after:
            self._auto_tuned = True

    @property
    def n_builds(self) -> int:
        """Neighbour-grid builds since the dense layout was made (a host sync)."""
        meta = _as_shards(self._meta)[0]
        return int(meta.n_builds) if meta is not None else 0

    def _invalidate(self):
        self._attached = False
        self._prepared = False
        self._tables = None
        self._drop_runner()
        self._advance_graphs = None

    def _drop_runner(self):
        """Drop the segment graphs and their buffers: shapes or pointers
        they were captured with may change."""
        self._runner = None

    # -- attach ------------------------------------------------------------
    def _forces(self):
        integ = self.operations.integrator
        return integ.forces if integ is not None else []

    def _attach(self):
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        integ = self.operations.integrator
        if integ is not None:
            integ._attach(self)
        for u in self.operations.updaters:
            u._attach(self)
        for c in self.operations.computes:
            c._attach(self)

        # one grid sized by the largest pair cutoff and the largest buffer
        r_cut = buffer = 0.0
        has_pair = False
        for f in self._forces():
            if f._needs_nlist:
                has_pair = True
                r_cut = max(r_cut, f._max_r_cut())
                buffer = max(buffer, f.nlist.buffer)
        if has_pair:
            state = self._synced_state()
            # spatial blocks hold whole z cell columns: Dx*Dy snaps to a
            # product the mesh size divides (whole x planes when they do)
            mesh = self._spatial_mesh
            new_spec = D.GridSpec.create(state.box, state.N, r_cut, buffer,
                                         strip_devices=mesh.size if mesh is not None else 1)
            # size cap for the actual starting configuration: commensurate
            # lattices concentrate particles far above the mean
            occ_cap = self._max_occupancy_cap(state, new_spec)
            if occ_cap > new_spec.cap:
                new_spec = new_spec.replace(cap=occ_cap)
            old = self._grid_spec
            if old is None or (
                new_spec.dims != old.dims
                or new_spec.r_cut != old.r_cut
                or new_spec.buffer != old.buffer
                or new_spec.cap > old.cap
            ):
                self._grid_spec = new_spec
                self._drop_dense()
        else:
            if self._grid_spec is not None:
                self._synced_state()
                self._drop_dense()
            self._grid_spec = None
        new_fields = self._select_fields()  # syncs the tag-order state
        if new_fields != self._fields:
            self._fields = new_fields
            self._drop_dense()
        self._attached = True
        self._prepared = False

    def _select_fields(self) -> tuple:
        """The optional rebin payload columns this run needs.

        A column rides the rebin if some attached operation reads or moves
        it (quaternions for an anisotropic force; orientations, angular
        momenta, inertia and the stored torque when rotational DOF are
        integrated, even from their defaults; diameters for a force that
        reads them) or the state carries non-default values; dropped
        columns are rebuilt from defaults.
        """
        state = self._synced_state()
        fields = []
        if bool((state.mass != 1.0).any()):
            fields.append("mass")
        quat0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=state.device)
        need_quat = any(f._needs_quat_j for f in self._forces())
        if need_quat or bool((state.orientation != quat0).any()):
            fields.append("quat")
        if (
            self._rotational()
            or bool((state.angmom != 0.0).any())
            or bool((state.moment_inertia != 0.0).any())
        ):
            fields.append("rotation")
            if "quat" not in fields:
                fields.insert(fields.index("rotation"), "quat")
        if bool((state.charge != 0.0).any()):
            fields.append("charge")
        need_diam = any(f._needs_diameter for f in self._forces())
        if need_diam or bool((state.diameter != 1.0).any()):
            fields.append("diameter")
        return tuple(fields)

    def _rotational(self) -> bool:
        integ = self.operations.integrator
        return bool(integ is not None and integ.integrate_rotational_dof)

    def _ctx(self) -> SimContext:
        return SimContext(dt=self.dt_ref(), seed=self.seed)

    def dt_ref(self) -> float:
        integ = self.operations.integrator
        return float(integ.dt) if integ is not None else 0.0

    def _ops_fingerprint(self):
        """Structural identity of the operation set.

        Scalars are compared by value, nested objects (variants, filters,
        flow fields) by identity; replace the object to change it. Forces
        and updaters are compared by identity. Returns ``(fp, refs)``,
        where ``refs`` pins every object whose id() is in ``fp``.
        """
        refs = []

        def obj_fp(o):
            refs.append(o)
            items = []
            for k, v in sorted(vars(o).items()):
                if k.startswith("_") or k == "forces":
                    continue
                if isinstance(v, (int, float, bool, str, type(None))):
                    items.append((k, v))
                else:
                    refs.append(v)
                    items.append((k, type(v).__name__, id(v)))
            return (type(o).__name__, id(o), tuple(items))

        integ = self.operations.integrator
        if integ is None:
            return ("none",), ()
        refs.extend(integ.forces)
        refs.extend(self.operations.updaters)
        fp = (
            self.seed,
            obj_fp(integ),
            tuple(obj_fp(m) for m in integ.methods),
            tuple((type(f).__name__, id(f)) for f in integ.forces),
            tuple((type(u).__name__, id(u)) for u in self.operations.updaters),
        )
        return fp, tuple(refs)

    # -- dense layout management ---------------------------------------------
    def _identity_meta(self, state: State) -> D.GridMeta:
        dev = state.device
        return D.GridMeta(
            ref_position=state.position,
            slot_of=torch.arange(state.N, dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            n_builds=torch.zeros((), dtype=torch.int32, device=dev),
            max_occ=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _densify(self, state: State):
        return D.densify(
            state, self._grid_spec, fields=self._fields, need_slot_of=state.n_bonds > 0
        )

    def _ensure_dense(self):
        if self._dense is not None:
            return
        state = self._synced_state()
        if self._grid_spec is None:
            self._dense = state
            self._meta = self._identity_meta(state)
        else:
            self._dense, self._meta = self._densify(state)
            if bool(self._meta.overflow):
                self._grow_and_rebuild(int(self._meta.max_occ))
        self._place_spatial()

    def _sharded(self) -> bool:
        """Whether the dense layout is held as shards (a sharded mesh and a grid)."""
        mesh = self._spatial_mesh
        return mesh is not None and mesh.sharded and self._grid_spec is not None

    def _place_spatial(self):
        """Lay the dense layout and the solvent out for the current mesh:
        shards and solvent blocks are joined back, and a sharded mesh then
        splits the layout into its blocks and the solvent into particle
        blocks (when the mesh size divides it). The layout and its rebuild
        state are kept as they are, so a mesh enabled, swapped or dropped
        mid-run does not move the trajectory."""
        from .mpcd import _place_solvent
        from .parallel.spatial import gather_meta, shard_dense, shard_meta

        devices = self._spatial_mesh.devices if self._sharded() else None
        self._mpcd = _place_solvent(self._mpcd, self.device, devices)
        if self._dense is None:
            return
        if isinstance(self._dense, tuple):
            self._dense, self._meta = self._whole_dense(), gather_meta(self._meta, self.device)
        if self._sharded():
            self._dense = shard_dense(self._dense, self._spatial_mesh)
            self._meta = shard_meta(self._meta, self._dense)

    @staticmethod
    def _max_occupancy_cap(state: State, spec: D.GridSpec, slack: int = 8) -> int:
        """Host-side max cell occupancy of a configuration -> cap."""
        pos = state.position.cpu().numpy()
        frac = pos / state.box.L + 0.5
        frac -= np.floor(frac)
        idx = [
            np.clip((frac[:, k] * spec.dims[k]).astype(np.int64), 0, spec.dims[k] - 1)
            for k in range(3)
        ]
        cid = (idx[0] * spec.dims[1] + idx[1]) * spec.dims[2] + idx[2]
        max_occ = int(np.bincount(cid, minlength=spec.n_cells).max())
        return int(math.ceil((max_occ + slack) / 8.0) * 8)

    def _interval_from_vmax(self, dense, safety: float = 1.0) -> int | None:
        """Rebuild interval from the fastest particle of ``dense`` (a State
        or its shards): the pairwise drift criterion leaves each particle
        half the buffer, consumed at up to vmax * dt per step. None when no
        estimate exists."""
        if self._grid_spec is None:
            return None
        shards = _as_shards(dense)
        vsq = [torch.sum(s.velocity * s.velocity, dim=-1).max() for s in shards]
        vsq = vsq[0] if len(vsq) == 1 else torch.stack([v.to(self.device) for v in vsq]).max()
        vmax = float(torch.sqrt(vsq))
        dt = self.dt_ref()
        if vmax <= 0 or dt <= 0:
            return None
        margin = 0.5 * self._grid_spec.buffer
        return max(1, min(50, int(margin / (vmax * dt * safety))))

    def tune_cell_capacity(self, slack: int = 0, safety: float = 1.0):
        """Right-size the cell capacity and the rebuild interval.

        A melt transient (a commensurate start concentrating particles in a
        few cells, a lattice heating up) leaves both sized for the
        transient. After warm-up this sets the interval, and its ceiling,
        from the fastest particle, and the capacity to the 8-multiple
        ``slack`` above the measured max cell occupancy; a capacity change
        drops the dense layout, which the next run rebuilds. An overflow
        after the tune grows the capacity by one 8-slot quantum
        (:meth:`_grow_and_rebuild`). A manual call cancels the scheduled
        tune; trajectories are chunking-reproducible between tunes, not
        across an explicit one.
        """
        self._auto_tuned = True
        self._drop_runner()
        if self._grid_spec is None or self._state is None:
            return
        state = self._synced_state()
        spec = self._grid_spec
        est = self._interval_from_vmax(state, safety)
        if est is not None:
            # the vmax estimate is also the ceiling: growing past it would
            # only buy a violation replay
            self._seg_len = est
            self._seg_ceiling = est
            self._clean_quanta = 0
        cap = self._max_occupancy_cap(state, spec, slack)
        if cap != spec.cap:
            self._grid_spec = spec.replace(cap=cap)
            self._drop_dense()

    def _grow_and_rebuild(self, needed: int = 0):
        """Grow the slot capacity until the current configuration fits.

        ``needed`` is the failed chunk's recorded max cell occupancy. Before
        the tune the capacity jumps straight past it (plus one 8-slot
        quantum of melt headroom) before any 1.25x steps; after the tune the
        capacity sits one quantum above the equilibrated occupancy, so it
        grows by one quantum at a time.
        """
        self._drop_runner()
        state = self._synced_state()
        if not self._auto_tuned and needed > self._grid_spec.cap:
            cap = int(math.ceil((needed + 8) / 8.0) * 8)
            self._grid_spec = self._grid_spec.replace(cap=cap)
            self._dense, self._meta = self._densify(state)
            if not bool(self._meta.overflow):
                self._place_spatial()
                return
        for _ in range(8):
            self._grid_spec = self._grid_spec.grow(gentle=self._auto_tuned)
            self._dense, self._meta = self._densify(state)
            if not bool(self._meta.overflow):
                self._place_spatial()
                return
        raise RuntimeError("cell capacity growth did not converge")

    def _force_tables(self) -> tuple:
        """Each force's device tables, one such tuple a shard (one for a
        whole layout), on the shard's device.

        The host tables are rebuilt from the parameters at every call; the
        device tables are made anew only when their host fingerprint (the
        forces, their modes and table bytes, the devices) changes, so
        successive runs reuse the same tensors (and the segment graphs the
        pointers they baked in) and copy nothing to the device. New tables
        drop the segment graphs."""
        from .parallel.mesh import _key

        forces = tuple(self._forces())
        for f in forces:
            f._build_tables(self)
        devices = self._spatial_mesh.devices if self._sharded() else (self.device,)
        fp = (tuple(_key(d) for d in devices), tuple(_tables_fingerprint(f) for f in forces))
        if self._tables is None or self._tables[0] != fp:
            by_device = {}
            for d in devices:
                # once a device: each copy of a host table waits for the stream
                if _key(d) not in by_device:
                    by_device[_key(d)] = tuple(f._device_tables(d) for f in forces)
            # the forces ride along: their id()s are in fp
            self._tables = (fp, tuple(by_device[_key(d)] for d in devices), forces)
            self._drop_runner()
        return self._tables[1]

    def _compute_net(self, dense: State, meta: D.GridMeta, t: int, tbls, window=None,
                     partners=None):
        """The net force, and, when rotational DOF are integrated, the net
        torque summed over the forces that produce one (zeros if none does;
        else None). Resetting it every step matters even without a torque
        force: Langevin stores its effective torque there, which must not
        carry into the next step's sum. On a shard, stencil forces read its
        halo ``window`` and bonds its ``partners``."""
        net = torch.zeros((dense.N, 3), dtype=torch.float32, device=dense.device)
        need_torque = self._rotational()
        ntq = torch.zeros_like(net) if need_torque else None
        ctx = self._ctx()
        for f, tbl in zip(self._forces(), tbls, strict=True):
            r = self._evaluate(f, dense, meta, t, ctx, tbl, window, "force", partners)
            net = net + r.force
            if need_torque and r.torque is not None:
                ntq = ntq + r.torque
        return net, ntq

    def _evaluate(self, f, dense: State, meta: D.GridMeta, t: int, ctx, tbl, window,
                  want: str, partners=None) -> ForceResult:
        """One force on a whole layout or a shard (a stencil force then reads
        the shard's halo ``window``, a bond its ``partners``)."""
        kw = {}
        if window is not None and f._needs_nlist:
            kw["window"] = window
        if partners is not None and f._reads_partners:
            kw["partners"] = partners
        return f._compute_dense(dense, self._grid_spec, meta.slot_of, t, ctx, tbl, want=want,
                                **kw)

    def _windows(self, shards: tuple) -> tuple:
        """Each shard's halo window, carrying the fields the stencil forces
        read; None for a whole layout."""
        from .parallel.spatial import halo_window

        if not self._sharded():
            return (None,) * len(shards)
        fields = ["position", "typeid", "tag"]
        if any(f._needs_velocity_j for f in self._forces()):
            fields.append("velocity")
        if any(f._needs_quat_j for f in self._forces()):
            fields.append("orientation")
        return tuple(halo_window(shards, d, self._grid_spec, tuple(fields))
                     for d in range(len(shards)))

    def _partners(self, shards: tuple) -> tuple:
        """Each shard's bond partners: every slot's position, joined in block
        order on the shard's device, and the shard's first global slot; None
        for a whole layout or without a force that reads them."""
        if not self._sharded() or not any(f._reads_partners for f in self._forces()):
            return (None,) * len(shards)
        from .parallel.mesh import _key

        by_device, out, first = {}, [], 0
        for s in shards:
            pos = by_device.get(_key(s.device))
            if pos is None:
                pos = torch.cat([x.position.to(s.device) for x in shards])
                by_device[_key(s.device)] = pos
            out.append((pos, first))
            first += s.N
        return tuple(out)

    def _with_forces(self, shards: tuple, metas: tuple, t: int, tbls) -> tuple:
        """The shards (one for a whole layout) with this step's net force
        (and net torque) set, each for its own slots."""
        views = zip(shards, metas, tbls, self._windows(shards), self._partners(shards),
                    strict=True)
        out = tuple(self._set_net(s, *self._compute_net(s, m, t, tb, w, p))
                    for s, m, tb, w, p in views)
        self.force_evaluations += len(self._forces())
        return out

    @staticmethod
    def _set_net(dense: State, net, ntq) -> State:
        if ntq is None:
            return dense.replace(net_force=net)
        return dense.replace(net_force=net, net_torque=ntq)

    def _prepare(self):
        """Compute initial forces, accelerations and torques (HOOMD's pre-run prep)."""
        self._ensure_dense()
        shards = self._with_forces(_as_shards(self._dense), _as_shards(self._meta),
                                   self._timestep, self._force_tables())
        self._dense = self._as_layout(
            tuple(s.replace(acceleration=s.net_force / s.mass[:, None]) for s in shards))
        self._state_stale = True
        self._prepared = True

    # -- spatial decomposition and profiling ----------------------------------
    def enable_spatial_decomposition(self, mesh, migrate_cap: int | None = None):
        """Decompose the simulation into the spatial domains of ``mesh``.

        The cell-major slot axis splits into contiguous blocks of whole z
        cell columns: whole x planes (slabs) when the mesh size divides Dx,
        (x, y) strips otherwise, so more blocks than x planes still
        decompose. The grid's (Dx, Dy) snaps down to a product the mesh size
        divides when it is made (``GridSpec.create``'s ``strip_devices``);
        an existing grid that does not divide is rebuilt at the next run.

        A mesh of views (parallel/mesh.py) must lie on the simulation's
        device: the global rebin's slot layout is the blocks', so the
        rebuilds stay global. A sharded mesh must lie on the simulation's
        device or on distinct CUDA devices: each block gets slot storage of
        its own there, rebuilds run the block-local rebin whose migrant
        buffers hold ``migrate_cap`` rows a direction and hop (default
        ``parallel.slab_migrate_capacity``), stencil forces read halo
        windows, bonds every shard's positions, and an MPCD solvent is cut
        into particle blocks when the mesh size divides it. Either way the
        trajectory is the undecomposed one on the same grid, bitwise, but
        for a sharded solvent's collisions (within float32 round-off).
        """
        from .parallel.mesh import same_device

        devices = mesh.devices
        on_sim = all(same_device(d, self.device) for d in devices)
        if mesh.sharded:
            cards = mesh.distinct and all(d.type == "cuda" for d in devices)
            if not (on_sim or cards):
                raise ValueError(f"a sharded mesh lies on the simulation's device "
                                 f"({self.device}) or on distinct CUDA devices, not on "
                                 f"{[str(d) for d in devices]}")
        elif not on_sim:
            raise ValueError(
                f"the mesh's blocks lie on {devices[0]}, the simulation on {self.device}"
            )
        self._spatial_mesh, self._spatial_migrate_cap = mesh, migrate_cap
        self._drop_runner()
        spec = self._grid_spec
        if self._attached and spec is not None and (spec.dims[0] * spec.dims[1]) % mesh.size:
            # regrid at the next attach; pull the positions out of the dense
            # layout FIRST (_drop_dense clears the stale flag, so dropping an
            # unsynced layout would roll the trajectory back to the last sync)
            self._synced_state()
            self._invalidate()
            self._drop_dense()
        else:
            # lay the layout as it stands out for this mesh (split, joined
            # or split anew): the trajectory goes on from where it is
            self._place_spatial()

    @contextlib.contextmanager
    def profile(self, logdir):
        """``with sim.profile(logdir): sim.run(n)`` records a
        ``torch.profiler`` trace of the host (and of the GPU for a simulation
        on CUDA) and writes it into ``logdir`` for TensorBoard. The step
        loop's phases are ranges named after the reference's scopes:
        ``rebin`` (once a rebuild), ``integrate_step1``,
        ``verlet_drift_check`` (with a grid), ``forces``,
        ``integrate_step2`` (each once a step), ``updaters`` (a step where
        an updater fires) and ``mpcd_joint_collision`` (once a collision).
        Inside it the rebuild segments run eagerly, never as CUDA graphs, so
        that every phase's range holds its own launches. Yields the
        ``torch.profiler.profile``."""
        from torch.profiler import ProfilerActivity, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities,
                                    on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
            self._phase_range = torch.profiler.record_function
            try:
                yield prof
            finally:
                self._phase_range = _no_range
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

    # -- running -------------------------------------------------------------
    def _run_chunk(self, dense, meta, t0: int, n_steps: int, seg_len: int, tbls,
                   rebin_first: bool = True, solv=None):
        """Run ``n_steps`` steps from timestep ``t0``; no host synchronisation.

        ``dense`` and ``meta`` are the layout as ``_dense`` and ``_meta``
        hold it: on a sharded mesh one State and one GridMeta a shard, and
        every phase runs once a shard (an updater through its
        ``_update_shards``, the joint collision with the solvent's blocks).
        With ``rebin_first`` (a chunk that starts on the rebuild schedule),
        the grid rebuilds before chunk-relative steps 0, seg_len, 2*seg_len,
        ...; otherwise the chunk continues the previous chunk's segment.
        With an MPCD coupling, ``solv`` is the solvent's anchor ``(position,
        velocity, t_a)``; the joint collision after step t (when the
        coupling's trigger holds at t, at MD clock t + 1) moves it.
        Returns ``(dense, meta, violated, solv)`` with ``violated`` a device
        bool and ``dense`` and ``meta`` tensors of their own. Each segment
        is a CUDA graph where :meth:`_graphs_apply`, else runs eagerly
        (:meth:`_run_segment`).
        """
        segments = _segments(n_steps, seg_len, rebin_first)
        if self._graphs_apply():
            runner = self._build_runner(tbls)
            runner.load(dense, meta, t0, self._variant_values(t0, n_steps),
                        self._trigger_masks(t0, n_steps))
            for a, n, rebuild in segments:
                runner.run(t0 + a, n, rebuild)
            dense, meta, viol = runner.result()
            return dense, meta, viol, solv
        shards, metas = _as_shards(dense), _as_shards(meta)
        viol = torch.zeros((), dtype=torch.bool, device=shards[0].device)
        steps = self._eager_steps(t0, n_steps, shards[0].device)
        for a, n, rebuild in segments:
            shards, metas, viol, solv = self._run_segment(shards, metas, viol, t0 + a, n,
                                                          rebuild, tbls, solv, steps)
        return self._as_layout(shards), self._as_layout(metas), viol, solv

    def _step_variants(self) -> tuple:
        """The variants the steps read that are not ``Constant`` (attributes
        of the methods and forces), each once: a run schedules their values
        (``core/variant.py::scheduled``)."""
        from .core.variant import Constant, Variant

        integ = self.operations.integrator
        found = {}
        for op in (*integ.methods, *integ.forces) if integ is not None else ():
            for v in vars(op).values():
                if isinstance(v, Variant) and not isinstance(v, Constant):
                    found.setdefault(id(v), v)
        return tuple(found.values())

    def _step_updaters(self) -> list:
        """The updaters that run inside the steps (an MPCD coupling runs
        beside them)."""
        return [u for u in self.operations.updaters if not getattr(u, "_updates_mpcd", False)]

    def _variant_values(self, t0: int, n: int):
        """float32 ``[variants, n]``: each scheduled variant's value at the
        timesteps ``t0 .. t0 + n - 1`` (``Variant.values``), or None."""
        variants = self._step_variants()
        if not variants:
            return None
        return np.stack([v.values(t0, n) for v in variants])

    def _trigger_masks(self, t0: int, n: int):
        """bool ``[updaters, n]``: whether each updater fires after each of
        the timesteps ``t0 .. t0 + n - 1`` (``Trigger.mask``), or None."""
        updaters = self._step_updaters()
        if not updaters:
            return None
        return np.stack([u.trigger.mask(t0, n) for u in updaters])

    def _eager_steps(self, t0: int, n: int, device):
        """The eager loop's :class:`graph.Steps` from ``t0``: the variants'
        values for ``n`` steps on ``device`` (one copy), the host's triggers."""
        from .graph import Steps, to_device

        values = self._variant_values(t0, n)
        return Steps(t0, None if values is None else to_device(values, device), None)

    def _run_segment(self, shards: tuple, metas: tuple, viol, t0: int, n_steps: int,
                     rebuild: bool, tbls, solv=None, steps=None) -> tuple:
        """One rebuild segment (the reference's ``seg_body``): the grid
        rebuild when ``rebuild``, then ``n_steps`` steps from timestep
        ``t0``, each step1 -> the drift check ORed into ``viol`` -> forces ->
        step2 -> the updaters and the joint collision that fire after it.
        With a grid the last method's step1 makes the drift check
        (:meth:`_step1_checked`; on the card in its launch); the
        ``verlet_drift_check`` range then holds the shards' verdict.
        ``steps`` (a :class:`graph.Steps` covering the segment; default the
        eager loop's, made here) holds the variants' values, which the
        operations read as 0-d tensors, and, under the CUDA graphs, the
        updaters' triggers as device bools: each updater then runs after
        every step as the reference's masked select
        (``Updater._update_masked``), bit for bit the host-fired update.
        Makes no host read, so that it can be captured as a CUDA graph.
        Returns ``(shards, metas, viol, solv)``. Inside :meth:`profile`,
        each phase that does work is a range named after the reference's
        scope."""
        from .core.variant import scheduled

        if steps is None:
            steps = self._eager_steps(t0, n_steps, shards[0].device)
        if steps.fires is not None and len(shards) > 1:
            raise ValueError("the masked updaters run on a whole layout")
        spec = self._grid_spec
        scope = self._phase_range
        integ = self.operations.integrator
        methods = integ.methods if integ is not None else []
        updaters = self._step_updaters()
        coupling = self._coupling
        mass_s = self._mpcd["mass"] if coupling is not None else None
        dt = self.dt_ref()
        seed = self.seed
        if spec is not None and rebuild:
            with scope("rebin"):
                shards, metas = self._rebuild(shards, metas)
        # with a grid the last method's step1 carries the drift check (on
        # the card K7 and K6 in one launch): the verdict on a whole layout,
        # each shard's two largest drifts on shards
        checked = methods[-1] if spec is not None and methods else None
        unchecked = methods[:-1] if checked is not None else methods
        host_form = not steps.graph  # the eager loop: kernels take kT by value
        with scheduled(self._step_variants(), steps.values, steps.t0, host_form):
            for t in range(t0, t0 + n_steps):
                self.steps_run += 1
                with scope("integrate_step1"):
                    for m in unchecked:
                        shards = tuple(m.step1(s, dt, t, seed) for s in shards)
                    if checked is not None:
                        shards, found = self._step1_checked(checked, shards, metas, viol, dt,
                                                            t, seed)
                if spec is not None:
                    with scope("verlet_drift_check"):
                        if checked is None:
                            viol = self._drifted(shards, metas, viol)
                        elif len(shards) == 1:
                            (viol,) = found
                        else:
                            viol = self._verdict_of(found, viol)
                with scope("forces"):
                    shards = self._with_forces(shards, metas, t, tbls)
                with scope("integrate_step2"):
                    for m in methods:
                        shards = tuple(m.step2(s, dt, t, seed) for s in shards)
                if steps.fires is not None:
                    # the graphs: every updater after every step, kept where
                    # its trigger (the schedule's bool) holds
                    with scope("updaters"):
                        for k, u in enumerate(updaters):
                            shards = (u._update_masked(shards[0], steps.fires[k, t - steps.t0],
                                                       t, seed),)
                else:
                    fired = [u for u in updaters if u.trigger(t)]
                    if fired:
                        with scope("updaters"):
                            for u in fired:
                                shards = u._update_shards(shards, t, seed)
                if coupling is not None and coupling.trigger(t):
                    with scope("mpcd_joint_collision"):
                        shards, solv = coupling._collide(shards, solv, t + 1, seed, mass_s)
        return shards, metas, viol, solv

    def _graphs_apply(self) -> bool:
        """Whether this run's segments are CUDA graphs: on the card (or
        with a stand-in capture), not ``_eager``, outside :meth:`profile`,
        and :meth:`_graph_eligible`."""
        return (not self._eager and (self.device.type == "cuda" or self._capture is not None)
                and self._phase_range is _no_range and self._graph_eligible())

    def _graph_eligible(self) -> bool:
        """The rule on the operations: a whole layout (no sharded mesh), an
        integrator, no MPCD coupling (its joint collision moves the solvent
        beside the segment), and only the flow fields of ``flow.py``. Any
        variant and any other updater qualify: the chunk's schedule carries
        the variants' values and the triggers to the card (graph.py), where
        the updaters run as the reference's masked selects."""
        from .flow import FlowField

        integ = self.operations.integrator
        if self._sharded() or integ is None:
            return False
        if any(getattr(u, "_updates_mpcd", False) for u in self.operations.updaters):
            return False
        for op in (*integ.methods, *integ.forces):
            flow = getattr(op, "flow_field", None)
            if flow is not None and not isinstance(flow, FlowField):
                return False
        return True

    def _advance_graphs_apply(self) -> bool:
        """Whether the SRD advance of this run replays CUDA graphs: on the
        card (or with a stand-in capture), not ``_eager``, outside
        :meth:`profile`, a solvent in one block and no MPCD coupling (the
        joint collision moves a coupled stream inside the step loop)."""
        srd = self.mpcd_dynamics
        return (not self._eager and (self.device.type == "cuda" or self._capture is not None)
                and self._phase_range is _no_range and self._mpcd is not None
                and srd is not None and len(self._mpcd["position"]) == 1
                and self._coupling is None and not srd._coupled)

    def _advance_runner(self):
        """The SRD advance's graphs where :meth:`_advance_graphs_apply` (the
        one held while its key holds: the SRD, its parameters, box and
        seed, the stream's shape and device), else None."""
        from .graph import AdvanceGraphs, Counters

        if not self._advance_graphs_apply():
            return None
        srd = self.mpcd_dynamics
        pos, vel = self._mpcd["position"][0], self._mpcd["velocity"][0]
        key = (srd, srd._fingerprint(), srd._built_key, tuple(pos.shape), pos.device)
        if self._advance_graphs is None or self._advance_graphs.key != key:
            self._advance_graphs = AdvanceGraphs(key, pos, vel, Counters(self),
                                                 capture=self._capture,
                                                 totals=self._advance_totals)
        return self._advance_graphs

    def _build_runner(self, tbls):
        """The segment graphs of this layout, bound to ``tbls`` (the
        reference's ``_build_runner`` and ``_bind_tables``): the one held
        when its key (grid spec and cap, payload fields, the operations'
        fingerprint, the tables' identity, rotational or not) still holds,
        else a new one on buffers shaped like the current layout."""
        from .graph import Counters, SegmentGraphs

        variants, updaters = self._step_variants(), self._step_updaters()
        key = (self._grid_spec, self._fields, self._ops_fp, id(tbls), self._rotational(),
               self._dense.N, self._state.N, tuple(map(id, variants)), tuple(map(id, updaters)),
               self.max_chunk)
        if self._runner is not None and self._runner.key == key:
            return self._runner

        def segment(dense, meta, viol, t0, n_steps, rebuild, steps=None):
            (dense,), (meta,), viol, _ = self._run_segment((dense,), (meta,), viol, t0, n_steps,
                                                           rebuild, tbls, steps=steps)
            return dense, meta, viol

        self._runner = SegmentGraphs(key, segment, self._dense, self._meta, Counters(self),
                                     capture=self._capture, totals=self._graph_totals,
                                     n_values=len(variants), n_fires=len(updaters),
                                     max_steps=self.max_chunk)
        return self._runner

    def _rebuild(self, shards: tuple, metas: tuple) -> tuple:
        """The grid rebuild: the global rebin on a whole layout, the
        block-local rebin with migration on shards."""
        from .parallel.spatial import spatial_rebin

        spec, N_tags = self._grid_spec, self._state.N
        need_slot_of = self._state.n_bonds > 0
        if self._sharded():
            return spatial_rebin(shards, metas, spec, N_tags, self._fields, need_slot_of,
                                 mesh=self._spatial_mesh, migrate_cap=self._spatial_migrate_cap)
        (dense,), (meta,) = shards, metas
        dense, meta = D.rebin(dense, meta, spec, N_tags, self._fields, need_slot_of)
        return (dense,), (meta,)

    def _step1_checked(self, method, shards: tuple, metas: tuple, viol, dt, t, seed) -> tuple:
        """``method``'s step1 on every shard with the drift check of the new
        positions: ``(shards, found)``, ``found`` holding the verdict
        ``viol | needs_rebin`` on a whole layout, each shard's two largest
        squared drifts on shards (``needs_rebin_of`` takes them)."""
        whole = len(shards) == 1
        stepped = [method.step1(s, dt, t, seed,
                                DriftCheck(m, self._grid_spec, viol if whole else None))
                   for s, m in zip(shards, metas, strict=True)]
        return tuple(s for s, _ in stepped), tuple(f for _, f in stepped)

    def _drifted(self, shards: tuple, metas: tuple, viol: torch.Tensor) -> torch.Tensor:
        """``viol`` ORed with the Verlet drift criterion over every shard, as
        a bool on the first shard's device: each shard's two largest drifts
        go there (on CUDA one K6 launch a shard and one for the verdict)."""
        if len(shards) == 1:
            return D.needs_rebin(shards[0], metas[0], self._grid_spec, viol)
        return self._verdict_of([D.drift_top_two(s, m) for s, m in zip(shards, metas)], viol)

    def _verdict_of(self, tops, viol: torch.Tensor) -> torch.Tensor:
        """``viol`` ORed with the drift criterion over the shards' two
        largest drifts ``tops`` (one [2] a shard), gathered on the first
        shard's device: on CUDA one K6 launch over their values."""
        dev0 = tops[0].device
        return D.needs_rebin_of(torch.cat([top.to(dev0) for top in tops]), self._grid_spec, viol)

    def _chunk_flags(self, meta, violated) -> tuple:
        """(overflow, violated, max_occ) of a chunk, read in one transfer
        (the chunk's one host synchronisation); over every shard's meta on
        a sharded mesh."""
        metas = _as_shards(meta)
        dev = violated.device
        flags = torch.stack([violated.to(torch.int32)]
                            + [m.overflow.to(dev).to(torch.int32) for m in metas]
                            + [m.max_occ.to(dev) for m in metas]).tolist()
        n = len(metas)
        return max(flags[1:1 + n]), flags[0], max(flags[1 + n:])

    def _find_coupling(self):
        """The MPCD coupling updater (at most one) and whether it keeps its
        default trigger: collisions at MD clocks divisible by the period,
        on which the rebuild interval is snapped to a divisor."""
        from .md.trigger import Periodic

        couplings = [u for u in self.operations.updaters if getattr(u, "_updates_mpcd", False)]
        if len(couplings) > 1:
            raise ValueError("only one MPCD coupling updater is supported")
        coupling = couplings[0] if couplings else None
        if coupling is not None:
            trig = coupling.trigger
            coupling._ingraph = bool(
                self._mpcd is not None
                and type(trig) is Periodic
                and trig.period == coupling.srd.period
                and trig.phase == coupling.srd.period - 1
            )
        return coupling

    def _snap_to_period(self, seg_base: int, P: int) -> int:
        """The rebuild interval snapped down to a divisor of the collision
        period P, so every collision clock is a rebuild point and the
        rebuild schedule is the reference's; warns once when that more than
        halves it."""
        while P % seg_base != 0:
            seg_base -= 1
        if seg_base * 2 <= self._seg_len and not self._warned_divisor_collapse:
            # a period with no divisor near the adapted interval (a prime
            # period) snaps to a tiny divisor: near per-step rebuilds
            self._warned_divisor_collapse = True
            warnings.warn(
                f"in-graph MPCD coupling: collision period {P} has "
                f"no divisor near the adapted rebuild interval "
                f"{self._seg_len}, so rebuilds snap to every "
                f"{seg_base} step(s). Choose a collision period "
                "with divisors near the natural rebuild interval "
                "(or a composite period) to avoid the extra "
                "rebuild cost.",
                stacklevel=3,
            )
        return seg_base

    def run(self, n_steps: int):
        from .write import _fire_writers, _writer_next_fire

        n_steps = int(n_steps)
        fp, fp_refs = self._ops_fingerprint()
        if self._ops_fp != fp:
            # integrator, methods or forces changed since the last attach
            self._ops_fp = fp
            self._ops_fp_refs = fp_refs
            self._invalidate()
        if not self._attached:
            self._attach()
        if not self._prepared:
            self._prepare()
        writers = list(self.operations.writers)
        for w in writers:
            w._attach(self)
        for c in self.operations.computes:
            c._attach(self)
        self._coupling = self._find_coupling()
        if self._mpcd is not None and self.mpcd_dynamics is not None:
            self.mpcd_dynamics._ensure_built(self._state.box, self.seed)
        remaining = n_steps
        tbls = self._force_tables()
        while remaining > 0:
            # the scheduled tune fires the first time the absolute timestep
            # reaches auto_tune_after, so its point does not depend on the
            # run() chunking
            auto_pending = not self._auto_tuned and self.auto_tune_after is not None
            if auto_pending and self._timestep >= self.auto_tune_after:
                self.tune_cell_capacity()
                if not self._prepared:
                    self._prepare()
                auto_pending = False
            chunk = min(remaining, self.max_chunk)
            if auto_pending:
                chunk = min(chunk, self.auto_tune_after - self._timestep)
            if writers:
                # end the chunk at the next writer fire
                nw = _writer_next_fire(writers, self._timestep + 1)
                if nw is not None:
                    chunk = min(chunk, nw - self._timestep)
            # while the interval adapts, chunks end at quantum boundaries so
            # interval changes land at the same timestep whatever the chunking
            if self._seg_adapt and (self._seg_len < self._seg_ceiling or self._seg_ceiling < 50):
                chunk = min(chunk, _GROW_QUANTUM - self._timestep % _GROW_QUANTUM)
            # align to the absolute rebuild schedule: an unaligned start runs
            # a no-rebuild continuation up to the next schedule point
            seg_base = self._seg_len
            if self._coupling is not None and self._coupling._ingraph:
                seg_base = self._snap_to_period(seg_base, self._coupling.srd.period)
            off = self._timestep % seg_base
            rebin_first = off == 0
            if off:
                chunk = min(chunk, seg_base - off)
            seg_arg = seg_base
            if off and self._realign:
                seg_arg = 1
                rebin_first = True
            elif not off:
                self._realign = False
            if self._probe_until is not None and rebin_first:
                # after an overflow: one rebuild a chunk, at its start
                chunk = min(chunk, seg_arg)

            solv = None
            if self._coupling is not None:
                solv = self._mpcd.get("_srd_anchor") or (
                    self._mpcd["position"], self._mpcd["velocity"], self._timestep)
            backup_dense, backup_meta = self._dense, self._meta
            dense, meta, violated, solv = self._run_chunk(
                backup_dense, backup_meta, self._timestep, chunk, seg_arg, tbls, rebin_first, solv
            )
            # the one host synchronisation of the chunk
            overflow, violated, max_occ = self._chunk_flags(meta, violated)
            if self._grid_spec is not None and overflow:
                if not all(bool(torch.isfinite(d.position).all()) for d in _as_shards(dense)):
                    raise RuntimeError(
                        "simulation diverged: non-finite particle positions at timestep "
                        f"~{self._timestep} (cell overflow requested capacity {max_occ}). "
                        "Typical causes: overlapping initial coordinates, dt too large, "
                        "or a potential evaluated inside its divergence."
                    )
                self._dense, self._meta = backup_dense, backup_meta
                self._state_stale = True
                if chunk > seg_arg:
                    # the chunk held several rebuilds: replay it one rebuild a
                    # chunk, so the capacity grows at the rebuild that
                    # overflowed, a timestep that does not depend on where
                    # chunks end (writers end them anywhere)
                    self._probe_until = self._timestep + chunk
                    continue
                # transactional replay from the rebuild that overflowed, with
                # a capacity sized by the recorded max occupancy
                self._probe_until = None
                self._synced_state()
                self._grow_and_rebuild(max_occ)
                continue
            if violated:
                if seg_arg > 1:
                    # a particle out-drifted the Verlet margin inside a
                    # segment: re-derive the interval from the peak speed at
                    # the chunk start (safety 1.5: the violation shows the
                    # estimate was optimistic here) and replay
                    est = self._interval_from_vmax(backup_dense, safety=1.5)
                    est_opt = self._interval_from_vmax(backup_dense)
                    if est is None:
                        est = max(self._seg_len // 2, 1)
                        est_opt = est
                    new_seg = max(1, min(self._seg_len - 1, est))
                    self._seg_ceiling = max(new_seg, min(est_opt, 50))
                    self._clean_quanta = 0
                    self._dense, self._meta = backup_dense, backup_meta
                    self._seg_len = new_seg
                    self._realign = True
                    self.viol_replays += 1
                    continue
                # seg_len == 1: a particle crossed more than the buffer in
                # one step (HOOMD's "dangerous build"); accept with a warning
                warnings.warn(
                    "dangerous neighbor rebuild: a particle moved more than the Verlet "
                    "buffer in a single step; increase the nlist buffer or reduce dt",
                    stacklevel=2,
                )
            self._dense, self._meta = dense, meta
            self._state_stale = True
            self._timestep += chunk
            remaining -= chunk
            if self._probe_until is not None and self._timestep >= self._probe_until:
                # the replay passed the overflowed chunk without an overflow
                # (a CUDA replay with atomic sums need not repeat its bits)
                self._probe_until = None
            if solv is not None:
                # the chunk's joint collisions moved the solvent's anchor
                self._mpcd = {**self._mpcd, "position": solv[0], "velocity": solv[1],
                              "_srd_anchor": solv}
            if self._mpcd is not None and self.mpcd_dynamics is not None:
                # advance the stream over the accepted chunk only (a replay
                # must not advance it twice); collisions key on the absolute
                # timestep, so this does not depend on the chunking
                self._mpcd = self.mpcd_dynamics._advance(
                    self._mpcd, self._state.box, self._timestep - chunk, self._timestep, self.seed,
                    graphs=self._advance_runner())
            if self._seg_adapt and self._timestep % _GROW_QUANTUM == 0:
                self._clean_quanta += 1
                if self._seg_len < self._seg_ceiling:
                    self._seg_len += 1
                elif self._seg_ceiling < 50 and self._clean_quanta % 10 == 0:
                    self._seg_ceiling += 1
                    self._seg_len = min(self._seg_len + 1, self._seg_ceiling)
            if writers:
                _fire_writers(self, writers, self._timestep)

    # -- observables -----------------------------------------------------------
    def _compute_single_force(self, force) -> ForceResult:
        """One force with energy, virial and (anisotropic) torque, in tag order."""
        if not self._attached:
            self._attach()
        if not self._prepared:
            self._prepare()
        i = self._forces().index(force)
        shards, metas = _as_shards(self._dense), _as_shards(self._meta)
        ctx = self._ctx()
        # each shard's own slots, joined in block order
        rs = [self._evaluate(force, s, m, self._timestep, ctx, tb[i], w, "all", p)
              for s, m, tb, w, p in zip(shards, metas, self._force_tables(),
                                        self._windows(shards), self._partners(shards),
                                        strict=True)]
        dev = self.device

        def join(name):
            parts = [getattr(r, name) for r in rs]
            if parts[0] is None or len(parts) == 1:
                return parts[0]
            return torch.cat([p.to(dev) for p in parts])

        r = ForceResult(force=join("force"), energy=join("energy"), virial=join("virial"),
                        torque=join("torque"))
        dense = self._whole_dense()
        N = self._state.N
        dest = torch.where(dense.tag >= 0, dense.tag, N).to(torch.int64)

        def back(x):
            if x is None:
                return None
            out = torch.zeros((N + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            out[dest] = x
            return out[:N]

        return ForceResult(force=back(r.force), energy=back(r.energy), virial=back(r.virial),
                           torque=back(r.torque))
