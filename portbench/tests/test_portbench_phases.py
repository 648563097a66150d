"""The readers of the program's spans, counters and phase marks
(``phases.py`` and its metrics in ``metrics/``) on a made-up trace and
made-up spans; on the CPU, ``phases.measure`` on a small cell, which leaves
the harness's traced stretches and the existing readers' values as they
were; and the ``--trace 0`` result's keys, with the program's tracer off
through the harness's own run."""

import pytest
import torch

from azplugins_tpu_torch.trace import Span
from portbench import harness, manifest, phases, port
from portbench.trace import RUN_SPAN, Context, Stretch

from ._small import BENCH, SMALL, run
from .test_portbench_trace import CPU, CUDA, K1, SORT, STEP2, _Event, _Prof

DROPLET = "droplet_evaporation.n20k.late"
NEW = ("churn_ms_per_step", "host_ms_per_step", "discarded_steps_pct", "rebin_ms_per_step",
       "forces_torch_ms_per_step", "step2_torch_ms_per_step", "updaters_torch_ms_per_step")


def _mark(k):
    return f"void (anonymous namespace)::az_phase_mark<{k}>()"


FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >"
TABLE = {0: "end", 1: "rebin", 2: "integrate_step1", 4: "integrate_step2",
         6: "force.SphericalHarmonicBarrier", 7: "updater.ParticleEvaporator"}


def _marked():
    # 2 steps in 1,000 ns: before the first mark a copy (outside); rebin: the
    # sort 20-60; step1: K1 110-130 (the program's); force: two fills 210-240
    # and 250-260; step2: K8 310-320 and a fill 330-350; the updater: the sort
    # 410-430; end; then a fill 520-540 outside
    ev = [_Event(RUN_SPAN, 0, 1000, CPU), _Event(SORT, 1, 10, CUDA),
          _Event(_mark(1), 10, 12, CUDA), _Event(SORT, 20, 60, CUDA),
          _Event(_mark(2), 100, 102, CUDA), _Event(K1, 110, 130, CUDA),
          _Event(_mark(6), 200, 202, CUDA), _Event(FILL, 210, 240, CUDA),
          _Event(FILL, 250, 260, CUDA), _Event(_mark(4), 300, 302, CUDA),
          _Event(STEP2, 310, 320, CUDA), _Event(FILL, 330, 350, CUDA),
          _Event(_mark(7), 400, 402, CUDA), _Event(SORT, 410, 430, CUDA),
          _Event(_mark(0), 500, 502, CUDA), _Event(FILL, 520, 540, CUDA)]
    return Stretch(_Prof(ev), 2, {RUN_SPAN})


def _calls():
    # two spanned unprofiled calls of 100 steps and a profiled one; the
    # second call builds a runner and sees a shape in the chunk that built it
    one = [Span(1, "az.chunk.read", 100, 400, 0, 1), Span(2, "az.segment.first", 500, 1500, 0, 1),
           Span(0, "az.chunk", 50, 2000, 9, 1), Span(9, "az.run", 0, 2100, None, 1)]
    two = [Span(11, "az.runner.build", 10, 210, 10, 2), Span(12, "az.segment.first", 300, 800, 10, 2),
           Span(13, "az.segment.capture", 900, 1200, 10, 2), Span(14, "az.chunk.read", 1300, 1400, 10, 2),
           Span(10, "az.chunk", 5, 1900, 19, 2), Span(19, "az.run", 0, 1900, None, 2)]
    prof = [Span(21, "az.segment.first", 0, 10**6, 29, 3), Span(29, "az.run", 0, 10**7, None, 3)]
    return [{"steps": 100, "profiled": False, "spans_on": True, "seconds": 2.1e-6, "spans": one},
            {"steps": 100, "profiled": False, "spans_on": False, "seconds": 1e-6, "spans": []},
            {"steps": 100, "profiled": False, "spans_on": True, "seconds": 1.9e-6, "spans": two},
            {"steps": 100, "profiled": True, "spans_on": True, "seconds": 1e-5, "spans": prof}]


def _ctx(**kw):
    base = dict(stretches=[], program_kernels=port.kernel_pattern(port.kernel_names()),
                steps=300, program_calls=_calls(),
                program_counters={"discarded_steps": {"violation": 12, "overflow": 3},
                                  "graph": {"recaptures": 1, "captures": 1, "evictions": 2}},
                phase_stretches=[_marked()], mark_table=TABLE)
    base.update(kw)
    return Context(**base)


def test_the_mark_kernel_is_the_programs_own():
    assert port.kernel_pattern(port.kernel_names()).search(_mark(3))
    assert phases.mark_of(_mark(3)) == 3 and phases.mark_of(K1) is None


def test_the_host_readers_on_made_up_spans():
    ctx = _ctx()
    read = manifest.metric_reader
    # first sights 1,000 + 500 ns, a capture 300 ns, a build 200 ns over 200 steps
    assert read("churn_ms_per_step")(ctx) == pytest.approx(2000e-6 / 200)
    # az.run 2,100 + 1,900 ns less the reads 300 + 100 ns
    assert read("host_ms_per_step")(ctx) == pytest.approx(3600e-6 / 200)
    assert read("discarded_steps_pct")(ctx) == pytest.approx(5.0)
    assert read("churn_ms_per_step.droplet")(ctx) == read("churn_ms_per_step")(ctx)
    misses = phases._misses(ctx)
    assert (misses["first_sight_new_runner"], misses["first_sight_new_shape"]) == (1, 1)
    # az.run's self time: 2,100 - 1,950 and 1,900 - 1,895 ns
    assert phases._run_self_share(ctx) == pytest.approx(155 / 4000)


def test_the_phase_readers_on_a_made_up_marked_trace():
    ctx = _ctx()
    read = manifest.metric_reader
    assert read("rebin_ms_per_step")(ctx) == pytest.approx(1e3 * 40e-9 / 2)
    assert read("forces_torch_ms_per_step.droplet")(ctx) == pytest.approx(1e3 * 40e-9 / 2)
    assert read("step2_torch_ms_per_step.droplet")(ctx) == pytest.approx(1e3 * 20e-9 / 2)
    assert read("updaters_torch_ms_per_step.droplet")(ctx) == pytest.approx(1e3 * 20e-9 / 2)
    split = phases.phase_split(ctx)
    assert split[("integrate_step1", True)] == (1, pytest.approx(20e-9))
    assert split[(phases.OUTSIDE, False)] == (2, pytest.approx(29e-9))
    by = phases._by_phase(ctx)
    assert by["integrate_step2"]["program_ms"] == pytest.approx(1e3 * 10e-9 / 2)
    assert by["force.SphericalHarmonicBarrier"]["ops"] == 1.0


def test_the_new_readers_find_nothing_in_the_harness_context():
    """A bare context, built here without the program's spans, counters or
    marks (the harness's own context carries the tracer's): every new
    reader returns None, and raises nothing."""
    ctx = Context(stretches=[_marked()], program_kernels=port.kernel_pattern(port.kernel_names()),
                  steps=1000, counters={"builds": 1})
    for name in NEW:
        assert manifest.metric_reader(name)(ctx) is None, name


@pytest.mark.parametrize("cell", ["plj_langevin.n262k", DROPLET])
def test_a_traced_run_reads_the_programs_tracer(cell):
    """A traced small run reports each new entry of the cell that the CPU
    can read (the program's spans and counters); the marks' readers find
    no device trace on the CPU, where a mark is its count alone, and their
    entries are left out."""
    new = {m["name"] for m in manifest.per_layer_of(BENCH, cell)
           if m["name"].split(".")[0] in NEW}
    res = run(cell, trace=True, seconds=600.0 if cell == DROPLET else 0.2)
    assert res["correct"] is True
    host = {n for n in new if n.split(".")[0] in
            ("churn_ms_per_step", "host_ms_per_step", "discarded_steps_pct")}
    assert len(host) == 3 and host <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] >= 0 for n in host)
    assert next(res["metrics"][n]["value"] for n in host if n.startswith("host_")) > 0
    assert not (new - host) & set(res["metrics"])


def _small_run(window_steps=50):
    w = manifest.workload(BENCH, DROPLET)
    traffic, params = SMALL[w["config"]]
    r = harness.Run(BENCH, w, 24681357911, torch.device("cpu"),
                    {**traffic, "window_steps": window_steps}, params)
    r.warm_up()
    return r


def test_the_marked_stretch_leaves_the_traced_stretches_and_their_readings():
    """After a traced window, ``phases.measure`` (its calls, its profiled
    and marked stretches) adds nothing to the harness's stretches and moves
    none of the existing readers' values."""
    r = _small_run()
    r.window(600.0, trace=True)
    existing = [m["name"] for m in manifest.per_layer_of(BENCH, DROPLET)
                if m["source"] == "device_trace"]

    def readings():
        ctx = Context(stretches=r.stretches, program_kernels=r.program_kernels,
                      params=r.params, n_types=len(r.params["types"]),
                      roofline=manifest.roofline, steps=r.steps)
        return {m: manifest.metric_reader(m)(ctx) for m in existing}

    stretches, before = list(r.stretches), readings()
    names = [list(map(str, st.dev_name)) for st in r.stretches]
    out = phases.measure(r, calls=2, mark_pairs=1)
    assert r.stretches == stretches and readings() == before
    assert [list(map(str, st.dev_name)) for st in r.stretches] == names
    assert set(out["metrics"]) == set(NEW)
    # on the CPU the marks are counts (no device trace): the host readers read
    assert out["metrics"]["host_ms_per_step"] > 0
    assert out["metrics"]["churn_ms_per_step"] is not None
    assert out["metrics"]["discarded_steps_pct"] is not None
    assert out["metrics"]["rebin_ms_per_step"] is None
    marked = out["marked_counters"]["marks"]
    assert marked["integrate_step1"] == (
        harness.MARK_WARM_CALLS + harness.MARK_PROFILED_CALLS) * r.run_steps
    r.close()


def test_the_untraced_result_keeps_its_keys_and_the_tracer_stays_off():
    r = _small_run()
    r.window(600.0, trace=False)
    tracer = r.sim.tracer
    assert not tracer.spans_on and not tracer.marks_on and tracer.drain() == []
    assert tracer.counters()["marks"] == {}
    r.close()
    res = run(DROPLET)
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "checked"}
    assert set(res["metrics"]) == {"tps.droplet", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count", "power_limit_w",
                                  "memory_peak_bytes"}
