"""Rebuild segments as CUDA graphs: the port's counterpart of the reference's
compiled chunk runner.

The reference compiles a whole chunk of steps into one jitted
``lax.fori_loop`` (``azplugins_tpu/simulation.py``: ``run_chunk``,
``steps_span``, bound once with its force tables by ``_bind_tables``), so
the host sees a chunk once. The port runs the same segments eagerly, a few
dozen launches a step, each costing the host more than the card; here one
rebuild segment (the optional rebuild, then L steps) becomes one CUDA graph,
replayed with no host work between segments but the replay call.

:class:`SegmentGraphs` owns fixed state buffers (the dense layout's slot
tensors, its grid bookkeeping, the chunk's violation flag and a clock: the
timestep on the card). A segment reads them, writes its results back into
them and advances the clock, so successive replays chain. The first time a
segment shape ``(L, rebuild)`` is seen it runs eagerly on the buffers (real
work, which also builds every lazy device cache); the second time it is
captured into the runner's one memory pool and replayed from then on. The
draws key on the clock (``core/rng.py::device_clock``), not on a timestep
frozen into the graph. Nothing falls back: a capture or replay that fails
raises.

:class:`AdvanceGraphs` is the counterpart of the reference's jitted SRD
advance (``azplugins_tpu/mpcd.py``: ``SRD._build``'s ``advance``, its
collisions a ``lax.fori_loop``) for an uncoupled whole MPCD stream: fixed
buffers hold the stream's anchor, its observable state and a clock; each
collision is a graph keyed ``("collide", lead)`` that streams from the
anchor, collides (its keys and grid shift drawn from the clock) and moves
the anchor and the clock; the observation stream is a graph keyed
``("stream", n)`` (``mpcd.py::SRD._advance_graphed``). Both runners share
one cache logic (:class:`_GraphCache`): a key runs eagerly the first time,
is captured the second and replayed after.

What a step reads beyond the state and the clock is a chunk's schedule
(:class:`Steps`): each variant's float32 value at each step and each
updater's trigger, filled by the host in :meth:`SegmentGraphs.load` once a
chunk, in one copy from pinned memory, into fixed rows sized to the
runner's longest chunk. A segment gathers its own columns at ``clock -
chunk_t0`` through a device index, so one ``(L, rebuild)`` graph serves
every ``t0``: the variants reach the operations as 0-d tensors
(``core/variant.py::scheduled``) and the updaters run as the reference's
masked selects (``Updater._update_masked``).

:class:`Counters` keeps the host counters exact under replay: a capture
records, by kernel, the launches its segment made (and the steps and force
evaluations the simulation counted), takes them back, and every replay adds
them again.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import NamedTuple

import numpy as np
import torch

from .core import rng as _rng
from .ops import (aniso_kernel, cellsum_kernel, dpd_kernel, integrate_kernel, pair_kernel,
                  pick_kernel, rng_kernel)

__all__ = ["AdvanceGraphs", "Counters", "SegmentGraphs", "Steps", "cuda_capture", "to_device"]


class Steps(NamedTuple):
    """What the steps from timestep ``t0`` read besides the state:
    ``values[k, j]``, the k-th scheduled variant's float32 value at step
    ``t0 + j`` (a tensor on the layout's device; None: no variant to
    schedule), and ``fires[u, j]``, whether the u-th updater fires after
    that step (device bools: the masked selects of the graphs; None: the
    host's triggers decide, as on the eager loop). ``graph``: the steps run
    inside a CUDA graph, so no host float may stand in for a value."""

    t0: int
    values: torch.Tensor | None
    fires: torch.Tensor | None
    graph: bool = False


def _host(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``x`` as a CPU tensor to copy to ``dev``: for CUDA in pinned memory,
    so that the copy is queued on the current stream with no synchronising
    call (the caching host allocator keeps the block until it has run)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if dev.type == "cuda" else t


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``dev``, in one copy that makes no synchronising
    call."""
    return _host(x, dev).to(dev, non_blocking=True)

# (module, attribute) of every launch counter a kernel wrapper keeps: an int
# or a dict of ints by kernel (or potential)
_LAUNCH_COUNTERS = (
    (pair_kernel, "launches"), (pair_kernel, "launches_by_potential"),
    (dpd_kernel, "launches"), (aniso_kernel, "launches"),
    (rng_kernel, "launches"), (rng_kernel, "launches_by_kernel"), (pick_kernel, "launches"),
    (integrate_kernel, "launches"), (integrate_kernel, "launches_by_kernel"),
    (cellsum_kernel, "launches"),
)
# the simulation's own counters a segment advances
_SIM_COUNTERS = ("steps_run", "force_evaluations")


class Counters:
    """The host counters a segment advances: the kernel wrappers' launch
    counts and ``sim``'s steps and force evaluations."""

    def __init__(self, sim):
        self._targets = [*_LAUNCH_COUNTERS, *((sim, a) for a in _SIM_COUNTERS)]

    def read(self) -> list:
        """Every counter's value (dicts copied)."""
        return [dict(v) if isinstance(v := getattr(o, a), dict) else v
                for o, a in self._targets]

    def since(self, before: list) -> list:
        """What each counter gained since ``before`` (a :meth:`read`)."""
        out = []
        for now, was in zip(self.read(), before, strict=True):
            if isinstance(now, dict):
                now = {k: n - was.get(k, 0) for k, n in now.items() if n != was.get(k, 0)}
            else:
                now = now - was
            out.append(now)
        return out

    def restore(self, values: list) -> None:
        """Set every counter back to ``values`` (a dict keeps its object)."""
        for (o, a), v in zip(self._targets, values, strict=True):
            if isinstance(v, dict):
                d = getattr(o, a)
                d.clear()
                d.update(v)
            else:
                setattr(o, a, v)

    def add(self, delta: list) -> None:
        """Add ``delta`` (a :meth:`since`) to every counter."""
        for (o, a), v in zip(self._targets, delta, strict=True):
            if isinstance(v, dict):
                d = getattr(o, a)
                for k, n in v.items():
                    d[k] = d.get(k, 0) + n
            else:
                setattr(o, a, getattr(o, a) + v)


def cuda_capture(runner: "_GraphCache", fn):
    """Capture ``fn`` into a ``torch.cuda.CUDAGraph`` in the runner's pool.
    A synchronising call inside raises (``set_sync_debug_mode("error")``),
    as does anything else the capture refuses; the graph's work has not run
    when this returns. Python's cyclic collector is held off meanwhile: it
    may free another simulation's graphs, which a capture forbids. The
    device memory the capture reserves is counted as the pool's."""
    graph = torch.cuda.CUDAGraph()
    dev = runner.clock.device
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=runner.pool):
            reserved = torch.cuda.memory_reserved(dev)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    finally:
        if collecting:
            gc.enable()
    runner._count("pool_bytes", torch.cuda.memory_reserved(dev) - reserved)
    return graph


def _tensor_fields(x) -> list[str]:
    return [f.name for f in dataclasses.fields(x) if isinstance(getattr(x, f.name), torch.Tensor)]


def _clone(x, skip=()):
    """A dataclass of tensors with every tensor field but ``skip`` cloned."""
    return x.replace(**{n: getattr(x, n).clone() for n in _tensor_fields(x) if n not in skip})


def _copy_into(dst, src, skip=()) -> None:
    """Copy ``src``'s tensor fields (but ``skip``) into ``dst``'s, in place."""
    for n in _tensor_fields(dst):
        if n in skip:
            continue
        d, s = getattr(dst, n), getattr(src, n)
        if d is not s:
            d.copy_(s)


# State fields that are not slot arrays: the bonds stay the simulation's own
_FIXED = ("bond_typeid", "bond_group")


class _GraphCache:
    """CUDA graphs of one runner, keyed by what their work bakes in: a key
    runs eagerly the first time it is seen (real work, which also builds
    every lazy device cache), is captured the second time into the runner's
    one memory pool and replayed from then on. At most ``max_graphs`` are
    kept, the least recently replayed dropped first. ``capture(runner, fn)``
    records ``fn`` as a graph with ``replay()`` (:func:`cuda_capture` on
    CUDA; tests inject a stand-in). ``captures``, ``capture_seconds`` (host
    time in captures), ``replays``, ``eager_segments`` (first runs) and
    ``pool_bytes`` (the device memory reserved during captures) describe
    the cache; each is also added to ``totals`` (a dict that outlives
    runners). ``clock``: the timestep on the card, a 0-d int64."""

    def __init__(self, key, counters: "Counters", device, capture=None, max_graphs: int = 32,
                 totals: dict | None = None):
        self.key = key
        self._counters = counters
        self._capture = capture if capture is not None else cuda_capture
        self.max_graphs = int(max_graphs)
        self.clock = torch.zeros((), dtype=torch.int64, device=device)
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        # key -> (graph, counter delta a replay adds)
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._seen: set = set()
        self.captures = self.replays = self.eager_segments = self.pool_bytes = 0
        self.capture_seconds = 0.0
        self._totals = totals if totals is not None else {}

    def _count(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)
        self._totals[name] = self._totals.get(name, 0) + n

    def graph_keys(self) -> list:
        """The key of every graph held, least recent first."""
        return list(self._graphs)

    def _run(self, key, make_body) -> None:
        """Run the work of ``key`` (``make_body()`` returns it, called only
        when no graph of ``key`` is held): eagerly the first time, then as a
        graph."""
        entry = self._graphs.get(key)
        if entry is None:
            body = make_body()
            if key not in self._seen:
                self._seen.add(key)
                self._count("eager_segments")
                body()
                return
            entry = self._record(body)
            self._graphs[key] = entry
            while len(self._graphs) > self.max_graphs:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        graph, delta = entry
        graph.replay()
        self._counters.add(delta)
        self._count("replays")

    def _record(self, body) -> tuple:
        """Capture ``body``; the counters it moved are taken back and
        returned as what each replay adds."""
        before = self._counters.read()
        t0 = time.perf_counter()
        try:
            graph = self._capture(self, body)
        finally:
            delta = self._counters.since(before)
            self._counters.restore(before)
        self._count("captures")
        self._count("capture_seconds", time.perf_counter() - t0)
        return graph, delta


class SegmentGraphs(_GraphCache):
    """Rebuild segments of one layout as CUDA graphs on fixed buffers.

    ``segment(dense, meta, viol, t0, n_steps, rebuild)`` runs one segment
    (``Simulation._run_segment`` on a whole layout) and returns ``(dense,
    meta, viol)``; it makes no host read. With ``n_values`` variants or
    ``n_fires`` updaters to schedule, the runner holds their rows for up to
    ``max_steps`` steps (a chunk) and hands the segment its own columns as
    ``steps=`` (a :class:`Steps`). ``key`` is what the graphs are
    bound to (grid spec and cap, the operations' fingerprint, the force
    tables' identity, rotational or not); a graph is found under ``(L,
    rebuild)`` within it (:class:`_GraphCache`).
    """

    def __init__(self, key, segment, dense, meta, counters: Counters, capture=None,
                 max_graphs: int = 32, totals: dict | None = None, n_values: int = 0,
                 n_fires: int = 0, max_steps: int = 0):
        dev = dense.device
        super().__init__(key, counters, dev, capture, max_graphs, totals)
        self._segment = segment
        self.dense = _clone(dense, skip=_FIXED)
        self.meta = _clone(meta)
        self.viol = torch.zeros((), dtype=torch.bool, device=dev)
        # the chunk's schedule, one byte buffer filled by one copy: its first
        # timestep (int64), each variant's float32 row, each trigger's bool
        # row, max_steps entries a row
        self.n_values, self.n_fires, self.max_steps = int(n_values), int(n_fires), int(max_steps)
        self.schedule = None
        if self.n_values or self.n_fires:
            v_bytes = 4 * self.n_values * self.max_steps
            self.schedule = torch.zeros(8 + v_bytes + self.n_fires * self.max_steps,
                                        dtype=torch.uint8, device=dev)
            self.chunk_t0 = self.schedule[:8].view(torch.int64)[0]
            self.values = self.schedule[8:8 + v_bytes].view(torch.float32).view(
                self.n_values, self.max_steps)
            self.fires = self.schedule[8 + v_bytes:].view(torch.bool).view(
                self.n_fires, self.max_steps)
            self._steps_of = torch.arange(self.max_steps, dtype=torch.int64, device=dev)

    def buffers(self) -> list[torch.Tensor]:
        """Every tensor a segment reads and writes."""
        return ([getattr(self.dense, n) for n in _tensor_fields(self.dense) if n not in _FIXED]
                + [getattr(self.meta, n) for n in _tensor_fields(self.meta)]
                + [self.viol, self.clock]
                + ([self.schedule] if self.schedule is not None else []))

    def load(self, dense, meta, t0: int, values: np.ndarray | None = None,
             fires: np.ndarray | None = None) -> None:
        """Start a chunk: the layout into the buffers, the violation flag
        cleared, the clock at ``t0``; with a schedule, the chunk's
        ``values`` (float32 ``[n_values, n]``) and ``fires`` (bool
        ``[n_fires, n]``) from ``t0`` into its rows in one copy from pinned
        memory, which makes no synchronising call."""
        _copy_into(self.dense, dense, skip=_FIXED)
        _copy_into(self.meta, meta)
        self.viol.zero_()
        self.clock.fill_(int(t0))
        if self.schedule is None:
            return
        host = np.zeros(self.schedule.numel(), dtype=np.uint8)
        host[:8].view(np.int64)[0] = int(t0)
        for rows, got, dtype in ((self.values, values, np.float32),
                                 (self.fires, fires, np.bool_)):
            if not rows.shape[0]:
                continue
            got = np.asarray(got, dtype=dtype)
            if got.ndim != 2 or got.shape[0] != rows.shape[0] or got.shape[1] > self.max_steps:
                raise ValueError(f"a schedule of {rows.shape[0]} rows of at most "
                                 f"{self.max_steps} steps expected, got {got.shape}")
            first = 8 + (0 if dtype is np.float32 else 4 * self.values.numel())
            view = host[first:first + rows.numel() * got.itemsize].view(dtype)
            view.reshape(rows.shape)[:, :got.shape[1]] = got
        self.schedule.copy_(_host(host, self.schedule.device), non_blocking=True)

    def _steps(self, t0: int, n_steps: int) -> Steps:
        """The segment's columns of the schedule, gathered at ``clock -
        chunk_t0`` on the card (the clock holds the segment's first step)."""
        at = (self.clock - self.chunk_t0) + self._steps_of[:n_steps]
        return Steps(t0, self.values.index_select(1, at) if self.n_values else None,
                     self.fires.index_select(1, at) if self.n_fires else None, graph=True)

    def result(self) -> tuple:
        """``(dense, meta, viol)``: the buffers cloned into tensors the
        caller owns (the next replay overwrites the buffers)."""
        return _clone(self.dense, skip=_FIXED), _clone(self.meta), self.viol.clone()

    def _body(self, t0: int, n_steps: int, rebuild: bool):
        """The work of one segment on the buffers: what is captured."""

        def body():
            with _rng.device_clock(self.clock, t0):
                extra = {} if self.schedule is None else {"steps": self._steps(t0, n_steps)}
                dense, meta, viol = self._segment(self.dense, self.meta, self.viol, t0,
                                                  n_steps, rebuild, **extra)
            _copy_into(self.dense, dense, skip=_FIXED)
            _copy_into(self.meta, meta)
            if viol is not self.viol:
                self.viol.copy_(viol)
            self.clock.add_(n_steps)

        return body

    def run(self, t0: int, n_steps: int, rebuild: bool) -> None:
        """Run one segment from timestep ``t0`` (the clock holds it): eagerly
        the first time its shape ``(L, rebuild)`` is seen, then as a graph."""
        self._run((int(n_steps), bool(rebuild)), lambda: self._body(t0, n_steps, rebuild))


class AdvanceGraphs(_GraphCache):
    """The SRD advance of an uncoupled whole MPCD stream as CUDA graphs on
    fixed buffers: the anchor's position and velocity ``pos_a``/``vel_a``,
    the observable ``pos``/``vel`` and the clock (the anchor's timestep).
    ``mpcd.py::SRD._advance_graphed`` runs each collision as the graph
    ``("collide", lead)`` and the observation stream as ``("stream", n)``
    (:meth:`run`). ``key`` is what the graphs are bound to (the SRD, its
    parameters, box and seed, the stream's shape and device)."""

    def __init__(self, key, pos: torch.Tensor, vel: torch.Tensor, counters: Counters,
                 capture=None, max_graphs: int = 32, totals: dict | None = None):
        super().__init__(key, counters, pos.device, capture, max_graphs, totals)
        self.pos_a, self.vel_a = pos.clone(), vel.clone()
        self.pos, self.vel = torch.empty_like(pos), torch.empty_like(vel)

    def buffers(self) -> list[torch.Tensor]:
        """Every tensor the graphs read and write."""
        return [self.pos_a, self.vel_a, self.pos, self.vel, self.clock]

    def load(self, pos_a: torch.Tensor, vel_a: torch.Tensor, t_a: int) -> None:
        """The anchor into its buffers (no copy where it is them already)
        and the clock at its timestep ``t_a``."""
        for dst, src in ((self.pos_a, pos_a), (self.vel_a, vel_a)):
            if dst is not src:
                dst.copy_(src)
        self.clock.fill_(int(t_a))

    def run(self, key: tuple, make_body) -> None:
        """Run the work of ``key`` (``make_body()`` returns it): eagerly the
        first time, then as a graph."""
        self._run(key, make_body)
