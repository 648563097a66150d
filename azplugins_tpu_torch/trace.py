"""The run loop's tracer: host spans, counters and device phase marks.

``Simulation.tracer`` (one a simulation, off by default) has three parts.

Host spans at the run loop's boundaries, on ``time.perf_counter_ns``:
``az.run`` (a ``Simulation.run`` call), ``az.chunk`` (one chunk between the
loop's host reads, a replayed one included), ``az.chunk.read`` (the chunk's
one blocking read of its flags), ``az.runner.build`` and ``az.runner.load``
(a new runner of segment graphs; a chunk's state and schedule into its
buffers), ``az.segment.first``, ``az.segment.capture`` and
``az.segment.replay`` (a graph key's eager first sight, its capture, a
replay), ``az.segment.loop`` (a segment on the eager loop), ``az.tune`` and
``az.grow`` (the capacity tune, a capacity grown after an overflow),
``az.mpcd.advance`` (the solvent's advance over an accepted chunk) and
``az.writers`` (the writers' fires after a chunk). Each records its name,
start and end, its parent span and the ``Simulation.run`` call it belongs
to, and is kept until :meth:`Tracer.drain`. While a ``torch.profiler``
records, a span is also a ``record_function`` range. Off, a span is one
shared null context: no clock read, no range.

Counters, counted whether the tracer is on or not (an integer a chunk):
the segment graph cache's ``captures``, ``replays``, ``eager_segments``,
``capture_seconds``, ``pool_bytes``, ``evictions`` (a graph dropped for
the cache's bound) and ``recaptures`` (a key captured again after its
eviction); runner builds by what changed in the runner's key
(``runner_builds``: ``first``, ``grid``, ``operations``, ``mesh``,
``tables``, or ``dropped`` where the key held but the runner was dropped);
chunks by what ended them (``chunk_ends``: ``steps``, ``max_chunk``,
``tune``, ``writer``, ``quantum``, ``align``, ``probe``); steps run and
thrown away (``discarded_steps``: ``violation``, ``overflow``); the
loop's synchronising host reads by site (``sync_reads``); and K1's Verlet
pair lists (``pair_list``: ``builds``, one a rebuild segment on the card
with a K1 force, ``sweeps``, the force-only K1 calls that take the
list, exact under replay, and ``fallback_blocks``, the blocks of every
build that sweep every candidate instead, which the builds add up on the
card: read, with one host read, only by :meth:`Tracer.counters`).

Device phase marks (``enable(marks=True)``): each phase of a rebuild
segment (``Simulation._run_segment``) launches, as it begins, an empty
kernel ``az_phase_mark<id>`` (``csrc/phase_mark.cu``) on the current
stream, and the segment ends with the mark ``end``. The phases are
``rebin``, ``pair_list`` (K1's list builds, after the rebuild),
``integrate_step1``, ``verlet_drift_check``, one
``force.<Class>`` a force of the integrator, ``integrate_step2``, one
``updater.<Class>`` an updater and ``mpcd_joint_collision``, and on the
segment graphs ``writeback`` (the segment's results copied into the
runner's buffers) before the ``end``; a second operation of one class gets
``.1``, a third ``.2``. The marks are captured
into the segment graphs (whether marks are on is part of a graph's key), so
in a device trace every operation between a mark and the next one belongs
to the first mark's phase, on the device's own clock: :meth:`mark_table`
maps each id to its phase. On the eager loop, while a profiler records,
each phase is also a ``record_function`` range. Marks are counted by phase
(``marks``), exactly under replay (``graph.Counters``); on the CPU a mark
is its count alone. The trajectory is bitwise the same with the tracer
off, with spans and with marks.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import NamedTuple

import torch

__all__ = ["MARK_KERNEL", "SPANS", "Span", "Tracer", "mark_id"]

# every span the run loop records
SPANS = ("az.run", "az.chunk", "az.chunk.read", "az.runner.build", "az.runner.load",
         "az.segment.first", "az.segment.capture", "az.segment.replay", "az.segment.loop",
         "az.tune", "az.grow", "az.mpcd.advance", "az.writers")

_NULL = contextlib.nullcontext()

# the mark kernel's name, and its template argument (the phase's id) in a
# device trace's demangled name
MARK_KERNEL = "az_phase_mark"
_MARK_ID = re.compile(rf"(?<![A-Za-z0-9_]){MARK_KERNEL}<(\d+)>")
# template instances in csrc/phase_mark.cu (kMarks)
N_MARKS = 64
# the fixed phases' ids; the forces' and updaters' come after, in the order
# a simulation first marks them
_FIXED_PHASES = ("end", "rebin", "integrate_step1", "verlet_drift_check", "integrate_step2",
                 "mpcd_joint_collision", "writeback", "pair_list")

_COUNTER_GROUPS = ("runner_builds", "chunk_ends", "discarded_steps", "sync_reads")


def mark_id(kernel_name: str) -> int | None:
    """The phase id of a device operation's name, where it is a phase mark."""
    m = _MARK_ID.search(kernel_name)
    return int(m.group(1)) if m else None


def phase_names(kind: str, ops) -> list[str]:
    """``<kind>.<Class>`` for each of ``ops``; a second of one class gets
    ``.1``, a third ``.2``."""
    seen: dict[str, int] = {}
    out = []
    for op in ops:
        name = f"{kind}.{type(op).__name__}"
        k = seen.get(name, 0)
        seen[name] = k + 1
        out.append(name if k == 0 else f"{name}.{k}")
    return out


class Span(NamedTuple):
    """A finished span: its id, name, start and end (``perf_counter_ns``),
    its parent's id (None at the top) and the ``Simulation.run`` call it
    belongs to (1 for the tracer's first, None outside any)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    run: int | None


class _OpenSpan:
    __slots__ = ("tracer", "name", "id", "parent", "run", "start", "range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        if self.name == "az.run":
            tr._runs += 1
            tr._run = tr._runs
        self.id = tr._next_id
        tr._next_id += 1
        self.parent = tr._stack[-1].id if tr._stack else None
        self.run = tr._run
        tr._stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self.tracer
        if self.range is not None:
            self.range.__exit__(None, None, None)
        tr._stack.pop()
        tr._spans.append(Span(self.id, self.name, self.start, end, self.parent, self.run))
        if self.name == "az.run":
            tr._run = None
        return False


class Tracer:
    """A simulation's tracer: see the module's docstring. Read-only for a
    caller but through :meth:`enable`, :meth:`disable` and :meth:`drain`."""

    def __init__(self):
        self._spans_on = False
        self._marks_on = False
        self._spans: list[Span] = []
        self._stack: list[_OpenSpan] = []
        self._next_id = 0
        self._runs = 0
        self._run: int | None = None
        # the segment graph cache's totals over every runner (the simulation
        # hands this dict to each runner)
        self.graph: dict = {}
        self._counts: dict = {g: {} for g in _COUNTER_GROUPS}
        # marks launched by phase (a graph.Counters target: exact under replay)
        self.marks: dict = {}
        # K1's list builds and sweeps (a graph.Counters target), and by
        # device the 0-d int64 total the builds add their fallen-back blocks to
        self.pair_list: dict = {}
        self._fallback_totals: dict = {}
        self._ids = {name: k for k, name in enumerate(_FIXED_PHASES)}
        self._range = None  # the eager loop's open phase range

    # -- switches ------------------------------------------------------------
    @property
    def spans_on(self) -> bool:
        return self._spans_on

    @property
    def marks_on(self) -> bool:
        return self._marks_on

    def enable(self, spans: bool = True, marks: bool = False) -> None:
        """Record host spans (``spans``) and launch the device phase marks
        (``marks``); either may be off."""
        self._spans_on, self._marks_on = bool(spans), bool(marks)

    def disable(self) -> None:
        self._spans_on = self._marks_on = False
        self._close_range()

    # -- spans -----------------------------------------------------------------
    def span(self, name: str):
        """A context that records the span ``name`` (a shared null context
        while spans are off)."""
        return _OpenSpan(self, name) if self._spans_on else _NULL

    def drain(self) -> list[Span]:
        """The finished spans since the last drain, in the order they ended;
        spans still open stay."""
        out, self._spans = self._spans, []
        return out

    # -- counters --------------------------------------------------------------
    def count(self, group: str, key: str, n: int = 1) -> None:
        d = self._counts[group]
        d[key] = d.get(key, 0) + n

    def counters(self) -> dict:
        """A copy of every counter: ``graph`` (the segment graph cache's
        totals), ``runner_builds``, ``chunk_ends``, ``discarded_steps``,
        ``sync_reads``, ``marks`` and ``pair_list``, each a dict by cause,
        reason, site, phase or kind. Reading ``pair_list``'s
        ``fallback_blocks`` waits for the card."""
        out = {"graph": dict(self.graph), "marks": dict(self.marks)}
        out.update({g: dict(d) for g, d in self._counts.items()})
        out["pair_list"] = {"builds": 0, "sweeps": 0, **self.pair_list,
                            "fallback_blocks": sum(int(t) for t in self._fallback_totals.values())}
        return out

    def fallback_total(self, device: torch.device) -> torch.Tensor:
        """The 0-d int64 tensor on ``device`` into which K1's list builds add
        the blocks that fall back; one a device for the tracer's life, so a
        CUDA graph may hold its address."""
        key = str(torch.device(device))
        t = self._fallback_totals.get(key)
        if t is None:
            t = self._fallback_totals[key] = torch.zeros((), dtype=torch.int64, device=device)
        return t

    # -- device phase marks ----------------------------------------------------
    def mark_table(self) -> dict[int, str]:
        """Each mark id this tracer has used (and the fixed ones) -> its phase."""
        return {k: name for name, k in self._ids.items()}

    def _id(self, name: str) -> int:
        k = self._ids.get(name)
        if k is None:
            k = len(self._ids)
            if k >= N_MARKS:
                raise RuntimeError(f"more than {N_MARKS} phases to mark; {name!r} has no id")
            self._ids[name] = k
        return k

    def marker(self, device: torch.device, loop: bool):
        """The segment's mark function ``mark(phase)`` while marks are on,
        else None. ``loop``: the segment runs on the eager loop, where each
        phase is also a ``record_function`` range while a profiler records."""
        if not self._marks_on:
            return None
        ranges = loop and torch.autograd._profiler_enabled()
        cuda = device.type == "cuda"
        if cuda:
            from .ops import mark_kernel

        def mark(phase: str) -> None:
            self.marks[phase] = self.marks.get(phase, 0) + 1
            k = self._id(phase)
            if ranges:
                self._close_range()
                if phase != "end":
                    self._range = torch.profiler.record_function(phase)
                    self._range.__enter__()
            if cuda:
                mark_kernel.phase_mark(k, device)

        return mark

    def _close_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
