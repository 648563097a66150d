"""The program's own spans, counters and phase marks in a cell's run, and
the per-layer metrics that read them.

    python3 portbench/phases.py --workload <cell> --seed <n> [--calls k] [--mark-pairs p]

runs, on a CUDA card and in one process, the cell's set-up and warm-up as
the benchmark's run makes them (``harness.Run``), then:

1. ``--calls`` unprofiled ``Simulation.run(run_steps)`` calls (default: the
   traffic's ``window_steps`` in calls, else 30), the program's spans on
   and off in turns (``Simulation.tracer``), the spans drained after each
   call: the spans' cost (steps/s, and steps run a second with those of
   replayed chunks, on against off pair by pair; a span's own host ns on a
   tracer apart) and the spanned calls the host metrics read;
2. one profiled call with spans off (the benchmark's own traced stretch)
   and one with spans on;
3. the marked stretch as a traced run of the benchmark makes it
   (``harness.Run.mark``): ``MARK_WARM_CALLS`` unprofiled calls with the
   phase marks on, which see and capture the marked segment shapes, then
   ``MARK_PROFILED_CALLS`` profiled call(s) with marks on, kept apart from
   the stretches of step 2 (``Context.phase_stretches``);
4. ``--mark-pairs`` pairs of unprofiled calls with marks on and off in
   turns: the marks' cost (as the spans'; and the marks' own device time
   in the marked stretch).

The last line of standard output holds the per-layer metrics of the
program's spans, counters and marks, each read by its file in
``metrics/`` from a :class:`trace.Context` that carries what a traced
run's does, but ``program_calls`` (each unprofiled or profiled call's
steps and drained spans) and ``program_counters`` (the tracer's counters)
over step 1, with spans on and off in turns;
beside them the device time a step by phase, the share of the PyTorch
operations' time inside a named phase, the ``az.run`` spans' self time,
the graph cache's misses by cause, and the costs of spans and marks. A
program without ``Simulation.tracer`` exits with 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, manifest  # noqa: E402
from portbench.trace import Context, counter_diff  # noqa: E402

# the metrics of this file's Context, each read by its file in metrics/
METRICS = ("churn_ms_per_step", "host_ms_per_step", "discarded_steps_pct", "rebin_ms_per_step",
           "forces_torch_ms_per_step", "step2_torch_ms_per_step", "updaters_torch_ms_per_step")
CHURN = ("az.segment.first", "az.segment.capture", "az.runner.build")
OUTSIDE = "outside"
_MARK = None  # the program's mark_id, set by mark_of's first call


class NoTracer(RuntimeError):
    pass


def mark_of(name: str):
    """The phase id of a device operation's name where it is a phase mark
    (``azplugins_tpu_torch.trace.mark_id``), else None."""
    global _MARK
    if _MARK is None:
        from azplugins_tpu_torch.trace import mark_id

        _MARK = mark_id
    return _MARK(name)


# -- what the metrics read ---------------------------------------------------------
def unprofiled(ctx) -> list[dict]:
    """The spanned unprofiled calls of ``ctx.program_calls`` (none where the
    context carries no program spans)."""
    return [c for c in getattr(ctx, "program_calls", None) or ()
            if not c["profiled"] and c["spans_on"]]


def span_ms(calls: list[dict], names) -> float:
    """Host ms in the spans named ``names`` over ``calls``."""
    return 1e-6 * sum(s.end_ns - s.start_ns for c in calls for s in c["spans"] if s.name in names)


def phase_split(ctx) -> dict | None:
    """``{(phase, program): (count, seconds)}`` of the device operations of
    ``ctx.phase_stretches``: each operation in the phase of the last mark
    before it (``outside`` before the first and after an ``end``), the
    program's own kernels (``program`` True) apart from the rest; the marks
    themselves are left out. None without marked stretches."""
    cached = getattr(ctx, "_phase_split", None)
    if cached is not None:
        return cached
    stretches = getattr(ctx, "phase_stretches", None)
    table = getattr(ctx, "mark_table", None)
    if not stretches or not table:
        return None
    out: dict = {}
    for st in stretches:
        phase = OUTSIDE
        for name, a, b in zip(st.dev_name, st.dev_start, st.dev_end):
            name = str(name)
            k = mark_of(name)
            if k is not None:
                phase = table.get(k, OUTSIDE)
                phase = OUTSIDE if phase == "end" else phase
                continue
            key = (phase, bool(ctx.program_kernels.search(name)))
            n, s = out.get(key, (0, 0.0))
            out[key] = (n + 1, s + (b - a) * 1e-9)
    ctx._phase_split = out
    return out


def marked_steps(ctx) -> int:
    return sum(st.steps for st in getattr(ctx, "phase_stretches", None) or ())


def phase_ms_per_step(ctx, match, program: bool | None = None) -> float | None:
    """Device ms a step in the marked stretches of the phases ``match``
    accepts, of the program's kernels (``program`` True), of the rest
    (False) or of both (None); None where no such phase ran."""
    split = phase_split(ctx)
    if not split:
        return None
    seen, seconds = False, 0.0
    for (phase, own), (_, s) in split.items():
        if phase == OUTSIDE or not match(phase):
            continue
        seen = True
        if program is None or own == program:
            seconds += s
    return 1e3 * seconds / marked_steps(ctx) if seen else None


# -- the measurement ---------------------------------------------------------------
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(sim, steps: int, device) -> tuple[float, int]:
    """(seconds, steps run) of one ``Simulation.run(steps)`` call: the steps
    run count those of chunks thrown away and replayed."""
    _sync(device)
    ran = sim.steps_run
    t0 = time.perf_counter()
    sim.run(steps)
    _sync(device)
    return time.perf_counter() - t0, sim.steps_run - ran


def span_ns(n: int = 20000) -> float:
    """Host ns a span costs (entered and left with spans on, no profiler),
    over ``n`` nested pairs on a tracer of its own."""
    from azplugins_tpu_torch.trace import Tracer

    tr = Tracer()
    tr.enable(spans=True)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tr.span("az.chunk"):
            with tr.span("az.segment.replay"):
                pass
    return (time.perf_counter_ns() - t0) / (2 * n)


def _pairs(rates: list[float]) -> list[list[float]]:
    """(on, off) steps/s of consecutive calls, on first."""
    return [rates[i:i + 2] for i in range(0, len(rates) - 1, 2)]


def _cost(pairs) -> float | None:
    """1 - the median over pairs of on / off."""
    return (1 - statistics.median(a / b for a, b in pairs)) if pairs else None


def _marks_device(stretches) -> tuple[float, float]:
    """(marks a step, device us a step in the marks themselves)."""
    n, ns, steps = 0, 0, sum(st.steps for st in stretches)
    for st in stretches:
        for name, a, b in zip(st.dev_name, st.dev_start, st.dev_end):
            if mark_of(str(name)) is not None:
                n += 1
                ns += int(b - a)
    return n / steps, 1e-3 * ns / steps


def measure(run, calls: int, mark_pairs: int = 2) -> dict:
    """Steps 1-4 of the module's docstring on a warmed-up ``harness.Run``;
    returns the report (see :func:`report`)."""
    sim, dev, steps = run.sim, run.device, run.run_steps
    tracer = getattr(sim, "tracer", None)
    if tracer is None:
        raise NoTracer("the program has no Simulation.tracer")
    program_calls, span_rates = [], []
    c0 = tracer.counters()
    t_first = sim.timestep
    for k in range(calls):
        on = k % 2 == 0
        tracer.enable(spans=on)
        seconds, ran = _timed(sim, steps, dev)
        span_rates.append((steps / seconds, ran / seconds))
        program_calls.append({"steps": steps, "profiled": False, "spans_on": on,
                              "seconds": seconds, "spans": tracer.drain()})
    c1 = tracer.counters()
    window = (t_first, sim.timestep)
    tracer.disable()
    plain = run.profiled(states=False)
    tracer.enable(spans=True)
    spanned = run.profiled(states=False)
    program_calls.append({"steps": steps, "profiled": True, "spans_on": True,
                          "seconds": spanned.wall_s, "spans": tracer.drain()})
    m0 = tracer.counters()
    run.mark()
    m1 = tracer.counters()
    mark_rates = []
    for k in range(2 * mark_pairs):
        tracer.enable(spans=False, marks=k % 2 == 0)
        seconds, ran = _timed(sim, steps, dev)
        mark_rates.append((steps / seconds, ran / seconds))
    tracer.disable()
    ctx = Context(cell=run.cell, params=run.params, traffic=run.traffic, steps=calls * steps,
                  program_calls=program_calls, program_counters=counter_diff(c1, c0),
                  stretches=[plain], phase_stretches=run.phase_stretches,
                  mark_table=run.mark_table,
                  program_kernels=run.program_kernels, n_types=len(run.params["types"]),
                  roofline=manifest.roofline)
    return report(ctx, window=window, spanned=spanned, span_rates=span_rates,
                  mark_rates=mark_rates, marked_counters=counter_diff(m1, m0))


def _by_phase(ctx) -> dict:
    """Device ms a step by phase in the marked stretches: the program's
    kernels and the other operations apart."""
    out: dict = {}
    steps = marked_steps(ctx)
    for (phase, own), (n, s) in sorted((phase_split(ctx) or {}).items()):
        row = out.setdefault(phase, {"program_ms": 0.0, "torch_ms": 0.0, "ops": 0.0})
        row["program_ms" if own else "torch_ms"] += 1e3 * s / steps
        row["ops"] += n / steps
    return out


def _run_self_share(ctx) -> float | None:
    """The ``az.run`` spans' time outside their child spans over their time,
    in the spanned unprofiled calls."""
    total = inside = 0
    for c in unprofiled(ctx):
        runs = {s.id: s for s in c["spans"] if s.name == "az.run"}
        total += sum(s.end_ns - s.start_ns for s in runs.values())
        inside += sum(s.end_ns - s.start_ns for s in c["spans"] if s.parent in runs)
    return (total - inside) / total if total else None


def _misses(ctx) -> dict:
    """The window's unreplayed segments by cause: a first sight in a chunk
    that built a new runner, another first sight (a shape new to the
    runner), a recapture (a shape evicted before) and another capture."""
    first_new, first_shape = 0, 0
    for c in unprofiled(ctx):
        built = {s.parent for s in c["spans"] if s.name == "az.runner.build"}
        for s in c["spans"]:
            if s.name == "az.segment.first":
                if s.parent in built:
                    first_new += 1
                else:
                    first_shape += 1
    graph = ctx.program_counters.get("graph", {})
    return {"spanned_calls": len(unprofiled(ctx)), "first_sight_new_runner": first_new,
            "first_sight_new_shape": first_shape, "recaptures": graph.get("recaptures", 0),
            "captures": graph.get("captures", 0), "eager_segments": graph.get("eager_segments", 0),
            "evictions": graph.get("evictions", 0),
            "capture_host_ms": 1e3 * graph.get("capture_seconds", 0.0),
            "runner_builds": ctx.program_counters.get("runner_builds", {})}


def report(ctx, window=None, spanned=None, span_rates=(), mark_rates=(),
           marked_counters=None) -> dict:
    """The metrics of :data:`METRICS` (each by its file in ``metrics/``) and
    what stands beside them (see the module's docstring)."""
    metrics = {m: manifest.metric_reader(m)(ctx) for m in METRICS}
    torch_ops = manifest.metric_reader("torch_ops_ms_per_step")
    marked_ctx = Context(stretches=ctx.phase_stretches, program_kernels=ctx.program_kernels)
    torch_marked = torch_ops(marked_ctx) if ctx.phase_stretches else None
    split = phase_split(ctx) or {}
    torch_s = sum(s for (_, own), (_, s) in split.items() if not own)
    torch_named = sum(s for (p, own), (_, s) in split.items() if not own and p != OUTSIDE)
    named = ("rebin_ms_per_step", "forces_torch_ms_per_step", "step2_torch_ms_per_step",
             "updaters_torch_ms_per_step")
    four = sum(metrics[m] or 0.0 for m in named)
    calls = unprofiled(ctx)
    steps = sum(c["steps"] for c in calls)
    spans_a_step = sum(len(c["spans"]) for c in calls) / steps if steps else None
    per_span = span_ns()
    pairs, mpairs = _pairs([r[0] for r in span_rates]), _pairs([r[0] for r in mark_rates])
    run_pairs = _pairs([r[1] for r in span_rates])
    mrun_pairs = _pairs([r[1] for r in mark_rates])
    marks_a_step, marks_us = _marks_device(ctx.phase_stretches)
    out = {
        "metrics": metrics,
        "window_timesteps": window,
        "by_phase_ms_per_step": _by_phase(ctx),
        "torch_ops_ms_per_step.marked": torch_marked,
        "torch_ops_ms_per_step.unmarked": torch_ops(ctx),
        "torch_share_in_named_phases": torch_named / torch_s if torch_s else None,
        "four_phase_metrics_over_torch_ops": four / torch_marked if torch_marked else None,
        "az_run_self_share": _run_self_share(ctx),
        "misses": _misses(ctx),
        "counters": ctx.program_counters,
        "sync_reads_per_step": {k: v / ctx.steps for k, v in
                                ctx.program_counters.get("sync_reads", {}).items()},
        "marked_counters": marked_counters,
        "host_ms_per_step.calls": [1e3 * c["seconds"] / c["steps"] for c in calls],
        "spans_on_off_tps_pairs": pairs,
        "spans_cost": _cost(pairs),
        "spans_on_off_steps_run_rate_pairs": run_pairs,
        "spans_cost_on_steps_run": _cost(run_pairs),
        "span_host_ns": per_span,
        "spans_a_step": spans_a_step,
        "spans_host_us_a_step": 1e-3 * per_span * spans_a_step if spans_a_step else None,
        "marks_on_off_tps_pairs": mpairs,
        "marks_cost": _cost(mpairs),
        "marks_on_off_steps_run_rate_pairs": mrun_pairs,
        "marks_cost_on_steps_run": _cost(mrun_pairs),
        "marks_a_step": marks_a_step,
        "marks_device_us_a_step": marks_us,
        "profiled_ms_per_step": {
            "spans_off": 1e3 * ctx.stretches[0].wall_s / ctx.stretches[0].steps,
            "spans_on": (1e3 * spanned.wall_s / spanned.steps) if spanned else None,
            "marked": [1e3 * st.wall_s / st.steps for st in ctx.phase_stretches]},
        "busy_ms_per_step": {
            "spans_off": 1e3 * ctx.stretches[0].busy_s() / ctx.stretches[0].steps,
            "spans_on": (1e3 * spanned.busy_s() / spanned.steps) if spanned else None,
            "marked": [1e3 * st.busy_s() / st.steps for st in ctx.phase_stretches]},
        "unprofiled_spanned_steps": steps,
    }
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/phases.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--mark-pairs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phases need a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    run = harness.Run(bench, cell, args.seed, torch.device("cuda", 0))
    run.warm_up()
    calls = args.calls or -(-int(run.traffic.get("window_steps", 30 * run.run_steps))
                            // run.run_steps)
    try:
        out = measure(run, calls, args.mark_pairs)
    except NoTracer as exc:
        print(f"[phases] {exc}", file=sys.stderr)
        return 2
    out = {"workload": args.workload, "seed": args.seed, "device": harness.card(), **out}
    run.close()
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
