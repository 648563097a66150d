"""One run of one cell: set-up, the measured window, the check, the result.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` builds the cell's configuration through the program's
public API from the seed, warms up (the capacity tune at step 200, the
first eager run and the capture of the segment shapes), then issues
``Simulation.run(run_steps)`` calls until ``--seconds`` have passed, or,
where the traffic states ``window_steps``, until those steps are done
(``--seconds`` then caps the window): the window is every whole call,
synchronised at both ends. With ``--trace 1`` some calls of the window run
under ``torch.profiler``, the program's tracer records its spans over the
others and its counters over the window, and the cell's per-layer metrics
are read from them. After the window the program runs single steps more,
every state is read, a traced run's marked stretch runs (the program's
device phase marks on), the program is freed, and the plain reference
judges what the program produced: the configuration's physics family,
``reference/<family>.py``, reached only through ``manifest.reference``.
The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), and last ``checked``, each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from . import initial, manifest, port
from .reference import outputs
from .trace import RUN_SPAN, Context, Spans, Stretch, breakdown, counter_diff, wrap_writers

FORBIDDEN = ("jax", "jaxlib", "flax", "azplugins_tpu")
GSD_CHUNKS = ("particles/position", "particles/velocity", "configuration/step")
# single steps the check may run after the window to judge ``check_steps``
# of them, and an updater's fire, on replayed CUDA graphs
CHECK_MAX_STEPS = 200
# the harness's own number beside a family's
SHORTFALL = "replay_shortfall"
# the marked stretch of a traced run: unprofiled calls with the phase marks
# on, which see and capture the marked segment shapes, then profiled ones
MARK_WARM_CALLS = 2
MARK_PROFILED_CALLS = 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(loaded=None) -> list[str]:
    """The modules of JAX and of the JAX package among ``loaded`` (default:
    those this process has loaded), compared by whole top-level names
    (``azplugins_tpu_torch`` is not ``azplugins_tpu``)."""
    names = list(sys.modules) if loaded is None else loaded
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card() -> dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=60, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def attach_writers(az, sim, traffic: dict, workdir: str) -> list:
    """The traffic's writers: a ``Table`` of logged quantities and a ``GSD``
    trajectory, each at its period, their files in ``workdir``. Returns
    ``(writer, kind, file)`` for each."""
    attached = []
    for w in traffic.get("writers", []):
        if w["kind"] == "Table":
            thermo = az.compute.ThermodynamicQuantities()
            sim.operations.computes.append(thermo)
            logger = az.write.Logger()
            logger.add(thermo, list(w["quantities"]), prefix="thermo")
            path = os.path.join(workdir, "table.log")
            writer = az.write.Table(w["period"], logger, output=path)
        elif w["kind"] == "GSD":
            path = os.path.join(workdir, "trajectory.gsd")
            writer = az.write.GSD(w["period"], path, dynamic_only=bool(w.get("dynamic_only", True)))
        else:
            raise ValueError(f"unknown writer {w['kind']!r}")
        attached.append((writer, w["kind"], path))
    sim.operations.writers[:] = [w for w, _, _ in attached]
    return attached


class Run:
    """One run of one cell, in its phases: set-up (``__init__`` and
    :meth:`warm_up`), the window (:meth:`window`), the check
    (:meth:`check`) and the result (:meth:`result`). ``overrides`` and
    ``params_overrides`` replace entries of the traffic and of the
    configuration (the tests' small sizes on the CPU)."""

    def __init__(self, bench: dict, cell: dict, seed: int, device: torch.device,
                 overrides: dict | None = None, params_overrides: dict | None = None):
        self.bench, self.cell, self.device = bench, cell, device
        self.params = {**manifest.config_params(bench, cell["config"]),
                       **(params_overrides or {})}
        self.builder = manifest.config_builder(cell["config"])
        self.family = manifest.reference(cell)
        self.traffic = {**manifest.traffic(cell["traffic"]), **(overrides or {})}
        self.run_steps = int(self.traffic["run_steps"])
        az = port.load(device)
        self.program_kernels = port.kernel_pattern(port.kernel_names())
        self.init = self.builder.initial_state(self.params, self.traffic,
                                               initial.generator(seed, device))
        self.sim_seed = initial.simulation_seed(seed)
        self.sim = az.Simulation(device=device, seed=self.sim_seed)
        self.sim.create_state_from_snapshot(self.family.snapshot(az, self.init))
        self.builder.build(az, self.sim, self.params)
        self.workdir = tempfile.mkdtemp(prefix="portbench-")
        self.writers = attach_writers(az, self.sim, self.traffic, self.workdir)
        self.spans = Spans()
        wrap_writers(self.sim, self.spans)
        # what a traced run reads from the program's tracer
        self.trace = False
        self.program_calls: list[dict] = []
        self.program_counters: dict = {}
        self.phase_stretches: list[Stretch] = []
        self.mark_table: dict = {}

    def warm_up(self) -> dict:
        """The traffic's ``warmup_calls`` calls of the window's own size."""
        with self.spans.span("portbench.warmup"):
            for _ in range(int(self.traffic["warmup_calls"])):
                with self.spans.span(RUN_SPAN):
                    self.sim.run(self.run_steps)
            _sync(self.device)
        self.c0 = port.counters(self.sim)
        return self.c0

    def window(self, seconds: float, trace: bool) -> None:
        """``Simulation.run`` calls until ``seconds`` have passed outside the
        traced stretches or, where the traffic states ``window_steps``,
        until those steps are done (``seconds`` then caps it). Traced
        stretches start at the shares ``trace_at`` of the window's time or
        of its calls; the window is every whole call. With ``trace`` the
        program's spans are on over the unprofiled calls and off over the
        profiled ones, each call's drained into ``program_calls``, and the
        program's counters over the window are ``program_counters``."""
        sim, dev = self.sim, self.device
        self.trace = trace
        trace_at = sorted(self.traffic.get("trace_at", [])) if trace else []
        fixed = self.traffic.get("window_steps")
        n_calls = -(-int(fixed) // self.run_steps) if fixed else None
        self.stretches: list[Stretch] = []
        tracer = port.tracer(sim) if trace else None
        if tracer is not None:
            tracer.drain()
            pc0 = tracer.counters()
            tracer.enable(spans=True)
        calls, profiled_s, builds = 0, 0.0, Builds(self.c0["builds"])
        _sync(dev)
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0 - profiled_s
            done = elapsed >= seconds or (n_calls is not None and calls >= n_calls)
            if calls and done and not trace_at:
                break
            share = elapsed / seconds if n_calls is None else calls / n_calls
            if trace_at and (share >= trace_at[0] or done):
                trace_at.pop(0)
                tp = time.perf_counter()
                tracer.disable()
                st = self.profiled()
                tracer.enable(spans=True)
                self.stretches.append(st)
                profiled_s += time.perf_counter() - tp
                self.program_calls.append({"steps": self.run_steps, "profiled": True,
                                           "spans_on": False, "seconds": st.wall_s,
                                           "spans": tracer.drain()})
            elif tracer is None:
                with self.spans.span(RUN_SPAN):
                    sim.run(self.run_steps)
            else:
                tc = time.perf_counter()
                with self.spans.span(RUN_SPAN):
                    sim.run(self.run_steps)
                self.program_calls.append({"steps": self.run_steps, "profiled": False,
                                           "spans_on": True, "seconds": time.perf_counter() - tc,
                                           "spans": tracer.drain()})
            builds.read(sim)
            calls += 1
        _sync(dev)
        self.window_t0, self.window_s = t0, time.perf_counter() - t0
        if tracer is not None:
            tracer.disable()
            self.program_counters = counter_diff(tracer.counters(), pc0)
        self.steps = calls * self.run_steps
        self.peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)
        self.c1 = port.counters(sim)
        self.c1["builds"] = self.c0["builds"] + builds.total
        self.n_slots, self.n_occupied = port.slots(sim)
        capped = f", capped at {seconds} s before {fixed} steps" if fixed and self.steps < fixed \
            else ""
        log(f"[portbench] window {self.steps} steps in {self.window_s:.4f} s "
            f"({self.steps / self.window_s:.2f} steps/s), {calls} calls{capped}; timesteps "
            f"{sim.timestep - self.steps} to {sim.timestep}; counters {self.c1}; slots "
            f"{self.n_slots}, occupied {self.n_occupied}, cell cap {port.cell_cap(sim)}")
        for k, st in enumerate(self.stretches):
            log(f"[portbench] traced stretch {k} (steps {st.steps} to timestep {st.t1}): "
                f"{1e3 * st.wall_s / st.steps:.4f} ms/step, busy "
                f"{1e3 * st.busy_s() / st.steps:.4f} ms/step, "
                f"{len(st.dev_name) / st.steps:.2f} device operations a step")

    def check(self, control: bool = False) -> dict:
        """Single steps more through the same entry, their states read, until
        ``check_steps`` of them and a step on which an updater fires were
        run as CUDA graph replays (any step, where the program runs no
        graphs); then the program freed and its writers' files read back;
        then the family's judgement of the window-end state and of those
        steps: the widest reading of each of its numbers, and
        ``replay_shortfall``, the judged steps missing after
        ``CHECK_MAX_STEPS`` (with ``control``, also the control's readings,
        the reference in the family's ``CONTROL`` dtype in the program's
        place, under ``"control"``). A fire is waited for where the
        family's ``fires`` says that one comes within ``CHECK_MAX_STEPS``.
        A step counts as a replay by :func:`replayed`. A traced run's
        marked stretch (:meth:`mark`) runs once every judged state and
        every writer's file is read, before the program is freed."""
        sim, family = self.sim, self.family
        model = self.builder.model(self.params, self.init, self.sim_seed)
        on_graphs = port.on_graphs(sim)
        end = family.read_state(sim)
        steps, want = [], int(self.traffic["check_steps"])
        fire_due = any(family.fires(model, t) for t in range(end["t"], end["t"] + CHECK_MAX_STEPS))
        prev, ran = end, 0
        while (len(steps) < want or fire_due) and ran < CHECK_MAX_STEPS:
            c0 = port.counters(sim)
            sim.run(1)
            ran += 1
            ok = replayed(c0, port.counters(sim), on_graphs, port.advance_on_graphs(sim))
            cur = family.read_state(sim)
            fires = family.fires(model, prev["t"])
            if ok and (len(steps) < want or (fires and fire_due)):
                steps.append((prev, cur))
                fire_due = fire_due and not fires
            prev = cur
        shortfall = max(want - len(steps), 0) + int(fire_due)
        written = self.read_back()
        if self.trace:
            self.mark()
        self.free()
        t0 = time.perf_counter()
        L = torch.tensor(self.init["L"], dtype=torch.float64, device=self.device)
        judge = family.Judge(model, L)
        first = judge.judge_state(end)
        readings = [first] + [judge.judge_step(a, b) for a, b in steps]
        if written:
            readings.append(judge.judge_outputs(end, **written))
        numbers = worst(readings, family.NUMBERS)
        numbers[SHORTFALL] = shortfall
        for st in self.stretches:
            st.pairs = family.stretch_work(st.states, model, L)
            st.states = None
        notes = {k: v for k, v in first.items() if k not in family.NUMBERS}
        log(f"[portbench] check: {ran} single steps after the window ({'on' if on_graphs else 'no'}"
            f" CUDA graphs), {len(steps)} judged, at timesteps {[a['t'] for a, _ in steps]}; "
            f"at the window's end {notes}; {time.perf_counter() - t0:.2f} s")
        for name, (value, where) in judge.where.items():
            log(f"[portbench] widest {name} {value!r}: {where}")
        if control:
            low = family.CONTROL
            cj = family.Judge(model, L)
            ctl = [cj.judge_state(cj.stored(end, low))]
            ctl += [cj.judge_step(a, cj.step(a, low)) for a, _ in steps]
            if written:
                stand_in = cj.outputs(end, low)
                ctl.append(cj.judge_outputs(end, **{k: stand_in[k] for k in written}))
            numbers["control"] = worst(ctl, family.NUMBERS)
            log(f"[portbench] control (the reference in {low}): {numbers['control']}")
        return numbers

    def profiled(self, states: bool = True) -> Stretch:
        """One ``Simulation.run`` call under the profiler inside the
        harness's run span, and the slot layout's sizes after it; with
        ``states``, the family's states before and after it, cut to its
        ``STRETCH_READS`` (``Stretch.states``; its ``stretch_work`` reads
        them once the program is freed). The device-side copies of the
        harness's and the program's spans are no device operation."""
        from torch.profiler import ProfilerActivity, profile

        sim, family, device = self.sim, self.family, self.device
        before = family.read_state(sim) if states else None
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            self.spans.profiling = True
            try:
                with self.spans.span(RUN_SPAN):
                    sim.run(self.run_steps)
                    _sync(device)
            finally:
                self.spans.profiling = False
        st = Stretch(prof, self.run_steps, self.spans.names | set(port.span_names()))
        if states:
            after = family.read_state(sim)
            st.states = [{k: S[k] for k in family.STRETCH_READS} for S in (before, after)]
            st.t1 = after["t"]
        st.n_slots, st.n_occupied = port.slots(sim)
        return st

    def mark(self) -> None:
        """The marked stretch: ``MARK_WARM_CALLS`` unprofiled calls with the
        program's device phase marks on, then ``MARK_PROFILED_CALLS``
        profiled ones, kept apart from the window's stretches
        (``phase_stretches``), with the tracer's ``mark_table``. The
        program's spans stay off, and its tracer is off after it."""
        tracer = port.tracer(self.sim)
        t0 = time.perf_counter()
        tracer.enable(spans=False, marks=True)
        try:
            for _ in range(MARK_WARM_CALLS):
                self.sim.run(self.run_steps)
            self.phase_stretches = [self.profiled(states=False)
                                    for _ in range(MARK_PROFILED_CALLS)]
        finally:
            tracer.disable()
        self.mark_table = tracer.mark_table()
        log(f"[portbench] marked stretch: {MARK_WARM_CALLS} + {MARK_PROFILED_CALLS} calls of "
            f"{self.run_steps} steps to timestep {self.sim.timestep} in "
            f"{time.perf_counter() - t0:.3f} s")

    def read_back(self) -> dict:
        """The writers closed and taken off the simulation, their files read
        back (the Table's last row, the GSD file's last frame) and
        removed."""
        written = {}
        for w, kind, path in self.writers:
            w.close()
            if kind == "Table":
                written["table"] = outputs.table_last_row(path)
            elif kind == "GSD":
                written["frame"] = outputs.gsd_last(path, GSD_CHUNKS)
        if self.writers:
            self.sim.operations.writers[:] = []
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.writers = []
        return written

    def free(self) -> None:
        """Free the program."""
        self.sim = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> dict:
        """:meth:`read_back`, then :meth:`free`."""
        written = self.read_back()
        self.free()
        return written

    def result(self, setup_s: float, trace: bool, numbers: dict) -> dict:
        name = self.cell["name"]
        metrics = {}
        if not trace:
            window = {"steps": self.steps, "seconds": self.window_s, "setup_s": setup_s}
            for m in manifest.end_to_end_of(self.bench, name):
                value = manifest.end_to_end_reader(m["name"])(window)
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = card() if self.device.type == "cuda" else {
            "platform": self.device.type, "kind": "cpu", "count": 1, "power_limit_w": None}
        dev["memory_peak_bytes"] = int(self.peak)
        out = {"correct": None, "attempted": self.steps, "failed": 0, "metrics": metrics,
               "device": dev}
        if trace:
            ctx = Context(cell=self.cell, params=self.params, traffic=self.traffic,
                          steps=self.steps, window_s=self.window_s, window_t0=self.window_t0,
                          window_t1=self.window_t0 + self.window_s,
                          counters={k: self.c1[k] - self.c0[k] for k in self.c0},
                          spans=self.spans, stretches=self.stretches,
                          program_kernels=self.program_kernels,
                          n_types=len(self.params["types"]), roofline=manifest.roofline,
                          program_calls=self.program_calls,
                          program_counters=self.program_counters,
                          phase_stretches=self.phase_stretches, mark_table=self.mark_table)
            for m in manifest.per_layer_of(self.bench, name):
                value = manifest.metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if self.stretches:
                dev["busy_s"] = ctx.busy_s()
                dev["window_s"] = ctx.traced_wall_s()
                out["breakdown"] = breakdown(self.stretches)
        checked = judged(numbers, manifest.limits(name), self.family.NUMBERS)
        out["correct"] = bool(checked) and all(c["value"] <= c["limit"] for c in checked.values())
        if "control" in numbers:
            out["control"] = numbers["control"]
        out["checked"] = checked
        for k, c in checked.items():
            log(f"checked {k}: {c['value']!r} (limit {c['limit']!r})")
        return out


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, overrides: dict | None = None,
             control: bool = False, params_overrides: dict | None = None) -> dict:
    """Run ``cell`` once and return its result; ``t_start`` is the process's
    start, from which ``setup_s`` counts."""
    run = Run(bench, cell, seed, device, overrides, params_overrides)
    c0 = run.warm_up()
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] set-up {setup_s:.3f} s to timestep {run.sim.timestep}; counters {c0}")
    run.window(seconds, trace)
    numbers = run.check(control)
    return run.result(setup_s, trace, numbers)


def worst(readings: list[dict], names) -> dict:
    """The widest reading of each number in ``names`` over several
    judgements."""
    out = {}
    for r in readings:
        for k in names:
            if k in r:
                out[k] = max(out.get(k, 0), r[k])
    return out


def judged(numbers: dict, limits: dict, names) -> dict:
    """Each number reported beside its limit, in the order of ``names``
    (the family's) and ``replay_shortfall`` last. Nothing goes unjudged:
    a number reported without a limit, or a limit of a number that neither
    the family nor the harness reports, raises :class:`Unjudged`."""
    known = (*names, SHORTFALL)
    unlimited = [k for k in known if k in numbers and k not in limits]
    unknown = sorted(set(limits) - set(known))
    if unlimited or unknown:
        raise Unjudged(unlimited, unknown)
    return {k: {"value": numbers[k], "limit": limits[k]} for k in known if k in numbers}


def replayed(before: dict, after: dict, on_graphs: bool, advance: bool) -> bool:
    """Whether a single step, between the program's ``port.counters``
    ``before`` and ``after``, ran as CUDA graph replays: the segment graphs
    replayed (any step, where the program runs no segment graphs) and,
    where the step advanced an uncoupled SRD stream on the advance graphs
    (``advance``), those replayed too, with no advance capture and no
    advance first sight run eagerly."""
    if on_graphs and after["replays"] <= before["replays"]:
        return False
    return not advance or (after["advance_replays"] > before["advance_replays"]
                           and after["advance_captures"] == before["advance_captures"]
                           and after["advance_eager"] == before["advance_eager"])


class Builds:
    """Grid builds summed over the window's calls: the program counts them
    since its slot layout was made, and a capacity grown mid-window makes
    a new layout (the builds before it in that call are then lost)."""

    def __init__(self, first: int):
        self.last, self.total = first, 0

    def read(self, sim) -> None:
        now = port.counters(sim)["builds"]
        self.total += now - self.last if now >= self.last else now
        self.last = now


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}")


class Unjudged(ValueError):
    def __init__(self, unlimited, unknown):
        super().__init__(f"numbers reported without a limit: {unlimited}; limits of numbers "
                         f"that nothing reports: {unknown}")


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"[portbench] {args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t_start)
    except ForbiddenModules as exc:
        log(f"[portbench] {exc}")
        return 3
    except Unjudged as exc:
        log(f"[portbench] {exc}")
        return 4
    print(json.dumps(result), flush=True)
    return 0
