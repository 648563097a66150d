"""The harness's spans and the traced stretch, and what metrics read from them.

Spans are the harness's own, around its calls into the program: each
``Simulation.run`` call, the warm-up, each writer's fire. A ``--trace 1``
run profiles whole ``Simulation.run`` calls of the window ("stretches")
with ``torch.profiler``; the device operations, their union and the idle
gaps between them come from that trace, each gap named by the harness span
and the host operation open when it began. A ``--trace 1`` run also reads
the program's own tracer (``Simulation.tracer``): its spans over the
window's unprofiled calls, its counters over the window, and its device
phase marks in a marked stretch after the check.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

# profiler range names of the harness's spans
RUN_SPAN = "portbench.run"


class Spans:
    """Host-clock spans ``(name, start, end)``, kept in memory; under a
    profiler each is also a ``record_function`` range."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.names: set[str] = set()
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        self.names.add(name)
        rng = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with rng:
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))


def wrap_writers(sim, spans: Spans) -> None:
    """Each writer's ``write`` inside a span ``write.<Kind>``."""
    for w in sim.operations.writers:
        inner = w.write

        def write(s, timestep, _inner=inner, _name=f"write.{type(w).__name__}"):
            with spans.span(_name):
                return _inner(s, timestep)

        w.write = write


def _events(prof, annotations: set):
    """(device operations, host operations) of a profile: arrays of names,
    start and end in ns on the profiler's clock. The device-side copies of
    the harness's own ranges (``annotations``) are no device operation."""
    dev, host = ([], [], []), ([], [], [])
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and e.name() in annotations:
            continue
        target = dev if on_device else host
        target[0].append(e.name())
        target[1].append(start)
        target[2].append(start + dur)
    def arr(t):
        return (np.array(t[0], dtype=object), np.array(t[1], dtype=np.int64),
                np.array(t[2], dtype=np.int64))
    return arr(dev), arr(host)


class Stretch:
    """One profiled ``Simulation.run`` call: its steps, its wall span (the
    harness range, which ends after a device synchronise), its device
    operations and its host operations. The harness adds the slot layout's
    sizes after the call (``n_slots``, ``n_occupied``) and ``pairs``, the
    mean of the pairs inside the cutoff before and after it."""

    def __init__(self, prof, steps: int, annotations: set):
        self.steps = steps
        (self.dev_name, self.dev_start, self.dev_end), (self.host_name, self.host_start,
                                                        self.host_end) = _events(prof, annotations)
        runs = np.nonzero(self.host_name == RUN_SPAN)[0]
        if len(runs) != 1:
            raise RuntimeError(f"the traced stretch holds {len(runs)} {RUN_SPAN} ranges")
        self.start, self.end = int(self.host_start[runs[0]]), int(self.host_end[runs[0]])
        inside = (self.dev_start >= self.start) & (self.dev_end <= self.end)
        self.dev_name = self.dev_name[inside]
        self.dev_start, self.dev_end = self.dev_start[inside], self.dev_end[inside]
        order = np.argsort(self.dev_start, kind="stable")
        self.dev_name, self.dev_start, self.dev_end = (self.dev_name[order], self.dev_start[order],
                                                       self.dev_end[order])

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        out: list[list[int]] = []
        for a, b in zip(self.dev_start.tolist(), self.dev_end.tolist()):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def gaps(self) -> list[tuple[int, int]]:
        """Idle intervals of the device inside the stretch."""
        edges, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if self.end > t:
            edges.append((t, self.end))
        return edges

    def host_at(self, t: int) -> str:
        """The harness span and the innermost host operation open at ``t``."""
        open_ = (self.host_start <= t) & (self.host_end > t)
        idx = np.nonzero(open_)[0]
        if not len(idx):
            return "host: none"
        spans = [i for i in idx if str(self.host_name[i]).startswith("portbench.")
                 or str(self.host_name[i]).startswith("write.")]
        span = min(spans, key=lambda i: self.host_end[i] - self.host_start[i]) if spans else None
        inner = min(idx, key=lambda i: self.host_end[i] - self.host_start[i])
        head = str(self.host_name[span]) if span is not None else "outside"
        return f"{head} > {self.host_name[inner]}" if inner != span else head


class Context:
    """What a per-layer metric's reader reads: the cell, its configuration
    and traffic, the window's steps, seconds and counters, the harness's
    spans, the traced stretches (each with its layout's sizes and pairs
    inside the cutoff) and the program's kernel names; and from the
    program's tracer ``program_calls`` (each window call's ``steps``,
    ``profiled``, ``spans_on``, ``seconds`` and drained ``spans``),
    ``program_counters`` (its counters over the window,
    :func:`counter_diff`), ``phase_stretches`` (the marked stretch's
    profiled calls) and ``mark_table`` (each mark id's phase)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    # -- the traced stretches ----------------------------------------------------
    @property
    def traced_steps(self) -> int:
        return sum(s.steps for s in self.stretches)

    def traced_wall_s(self) -> float:
        return sum(s.wall_s for s in self.stretches)

    def busy_s(self) -> float:
        return sum(s.busy_s() for s in self.stretches)

    def device_ops(self, pattern=None, program: bool | None = None,
                   stretches=None) -> tuple[int, float]:
        """(count, seconds) of the traced device operations whose name
        matches ``pattern`` (a compiled regex; None: all), restricted to the
        program's own kernels (``program=True``) or to the rest (False), in
        ``stretches`` (default: all)."""
        n, s = 0, 0.0
        for st in self.stretches if stretches is None else stretches:
            for name, a, b in zip(st.dev_name, st.dev_start, st.dev_end):
                name = str(name)
                if pattern is not None and not pattern.search(name):
                    continue
                if program is not None and bool(self.program_kernels.search(name)) != program:
                    continue
                n += 1
                s += (b - a) * 1e-9
        return n, s


def counter_diff(now: dict, was: dict) -> dict:
    """The program's counters (``Tracer.counters()``, a dict of groups) that
    moved from ``was`` to ``now``, by how much."""
    return {g: {k: v - was.get(g, {}).get(k, 0) for k, v in d.items()
                if v != was.get(g, {}).get(k, 0)} for g, d in now.items()}


def breakdown(stretches: list[Stretch], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing."""
    per: dict[str, float] = {}
    gaps = []
    for st in stretches:
        for name, a, b in zip(st.dev_name, st.dev_start, st.dev_end):
            per[str(name)] = per.get(str(name), 0.0) + (b - a) * 1e-9
        gaps += [((b - a) * 1e-9, st, a) for a, b in st.gaps()]
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, key=lambda g: -g[0])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[st.host_at(a)[:200], s] for s, st, a in gaps]}
