"""One run of one cell: set-up, the measured window, the check, the result.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` builds the cell's configuration through the program's
public API from the seed, warms up (the capacity tune at step 200, the
first eager run and the capture of the segment shapes), then issues
``Simulation.run(run_steps)`` calls until ``--seconds`` have passed, or,
where the traffic states ``window_steps``, until those steps are done
(``--seconds`` then caps the window): the window is every whole call,
synchronised at both ends. With ``--trace 1`` some calls of the window run
under ``torch.profiler`` and the cell's per-layer metrics are read from
them. After the window the program runs single steps more, every state is
read, the program is freed, and the plain reference judges what the
program produced (``reference/check.py``).
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
from .reference import check, outputs, physics
from .trace import RUN_SPAN, Context, Spans, Stretch, breakdown, wrap_writers

FORBIDDEN = ("jax", "jaxlib", "flax", "azplugins_tpu")
GSD_CHUNKS = ("particles/position", "particles/velocity", "configuration/step")
# single steps the check may run after the window to judge ``check_steps``
# of them, and an updater's fire, on replayed CUDA graphs
CHECK_MAX_STEPS = 200


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
        self.traffic = {**manifest.traffic(cell["traffic"]), **(overrides or {})}
        self.run_steps = int(self.traffic["run_steps"])
        az = port.load(device)
        self.program_kernels = port.kernel_pattern(port.kernel_names())
        self.init = self.builder.initial_state(self.params, self.traffic,
                                               initial.generator(seed, device))
        self.sim_seed = initial.simulation_seed(seed)
        self.sim = az.Simulation(device=device, seed=self.sim_seed)
        self.sim.create_state_from_snapshot(initial.snapshot(az, self.init))
        self.builder.build(az, self.sim, self.params)
        self.workdir = tempfile.mkdtemp(prefix="portbench-")
        self.writers = attach_writers(az, self.sim, self.traffic, self.workdir)
        self.spans = Spans()
        wrap_writers(self.sim, self.spans)

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
        of its calls; the window is every whole call."""
        sim, dev = self.sim, self.device
        trace_at = sorted(self.traffic.get("trace_at", [])) if trace else []
        fixed = self.traffic.get("window_steps")
        n_calls = -(-int(fixed) // self.run_steps) if fixed else None
        self.stretches: list[Stretch] = []
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
                self.stretches.append(_profiled(sim, self.spans, self.run_steps, dev))
                profiled_s += time.perf_counter() - tp
            else:
                with self.spans.span(RUN_SPAN):
                    sim.run(self.run_steps)
            builds.read(sim)
            calls += 1
        _sync(dev)
        self.window_t0, self.window_s = t0, time.perf_counter() - t0
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
        then the reference's judgement of the window-end state and of those
        steps: the widest reading of each number, and ``replay_shortfall``,
        the judged steps missing after ``CHECK_MAX_STEPS`` (with
        ``control``, also the control's readings, the reference in bfloat16
        in the program's place, under ``"control"``)."""
        sim = self.sim
        model = self.builder.model(self.params, self.init, self.sim_seed)
        on_graphs = port.on_graphs(sim)
        end = port.read_state(sim)
        steps, want = [], int(self.traffic["check_steps"])
        fires_at = model.get("evaporator") is not None
        fire_due = fires_at
        prev, ran = end, 0
        while (len(steps) < want or fire_due) and ran < CHECK_MAX_STEPS:
            r0 = port.counters(sim)["replays"]
            sim.run(1)
            ran += 1
            replayed = port.counters(sim)["replays"] > r0
            cur = port.read_state(sim)
            fires = fires_at and physics.evaporator_fires(model, prev["t"])
            if (replayed or not on_graphs) and (len(steps) < want or (fires and fire_due)):
                steps.append((prev, cur))
                fire_due = fire_due and not fires
            prev = cur
        shortfall = max(want - len(steps), 0) + int(fire_due)
        written = self.close()
        t0 = time.perf_counter()
        L = torch.tensor(self.init["L"], dtype=torch.float64, device=self.device)
        judge = check.Judge(model, L)
        first = judge.judge_state(end)
        readings = [first] + [judge.judge_step(a, b) for a, b in steps]
        if written:
            readings.append(judge.judge_outputs(end, **written))
        numbers = check.worst(readings)
        numbers["replay_shortfall"] = shortfall
        for st in self.stretches:
            st.pairs = 0.5 * sum(physics.pair_forces(x.to(torch.float64), ty, L, model)[2]
                                 for x, ty in st.states)
            st.states = None
        log(f"[portbench] check: {ran} single steps after the window ({'on' if on_graphs else 'no'}"
            f" CUDA graphs), {len(steps)} judged, at timesteps {[a['t'] for a, _ in steps]}; "
            f"{first['pairs']} pairs inside the cutoff at the window's end, "
            f"{int((end['type'] != 0).sum())} particles of other types than the first; "
            f"{time.perf_counter() - t0:.2f} s")
        for name, (value, where) in judge.where.items():
            log(f"[portbench] widest {name} {value!r}: {where}")
        if control:
            cj = check.Judge(model, L)
            ctl = [cj.judge_state(cj.stored(end, torch.bfloat16))]
            ctl += [cj.judge_step(a, cj.step(a, torch.bfloat16)) for a, _ in steps]
            if written:
                stand_in = cj.outputs(end, torch.bfloat16)
                ctl.append(cj.judge_outputs(end, **{k: stand_in[k] for k in written}))
            numbers["control"] = check.worst(ctl)
            log(f"[portbench] control (the reference in bfloat16): {numbers['control']}")
        return numbers

    def close(self) -> dict:
        """Free the program: its writers closed, their files read back (the
        Table's last row, the GSD file's last frame) and removed."""
        written = {}
        for w, kind, path in self.writers:
            w.close()
            if kind == "Table":
                written["table"] = outputs.table_last_row(path)
            elif kind == "GSD":
                written["frame"] = outputs.gsd_last(path, GSD_CHUNKS)
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.sim = self.writers = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
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
                          n_types=len(self.params["types"]), roofline=manifest.roofline)
            for m in manifest.per_layer_of(self.bench, name):
                value = manifest.metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if self.stretches:
                dev["busy_s"] = ctx.busy_s()
                dev["window_s"] = ctx.traced_wall_s()
                out["breakdown"] = breakdown(self.stretches)
        limits = manifest.limits(name)
        checked = {k: {"value": numbers[k], "limit": limits[k]}
                   for k in check.NUMBERS if k in numbers}
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


def _profiled(sim, spans: Spans, run_steps: int, device) -> Stretch:
    """One ``Simulation.run`` call under the profiler, with the positions
    and types before and after it (``Stretch.states``; the pairs inside
    the cutoff are counted on them once the program is freed) and the slot
    layout's sizes after it."""
    from torch.profiler import ProfilerActivity, profile

    before = port.read_state(sim)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        spans.profiling = True
        try:
            with spans.span(RUN_SPAN):
                sim.run(run_steps)
                _sync(device)
        finally:
            spans.profiling = False
    after = port.read_state(sim)
    st = Stretch(prof, run_steps, spans.names)
    st.states = [(S["x"], S["type"]) for S in (before, after)]
    st.t1 = after["t"]
    st.n_slots, st.n_occupied = port.slots(sim)
    return st


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
    print(json.dumps(result), flush=True)
    return 0
