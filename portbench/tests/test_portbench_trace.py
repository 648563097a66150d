"""The traced stretch's arithmetic on a made-up trace, and the per-layer
metrics read from it."""

import re

import pytest
import torch

from portbench import manifest, port
from portbench.trace import RUN_SPAN, Context, Stretch, breakdown

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


K1 = "void (anonymous namespace)::cell_pair_force_kernel<0, false, false, false>(float const*)"
DRIFT = "void (anonymous namespace)::drift_kernel<1, false, false>(float const*)"
STEP2 = "void (anonymous namespace)::step2_kernel<2, false, false>(int const*)"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<long>"


def _stretch():
    # a 1,000 ns stretch of 2 steps: K1 100-400, the sort 350-450 (overlapping),
    # K7+K6 500-520, K8 600-630, another K1 700-900; a copy of the harness's
    # range on the device is no operation; one event outside the range
    ev = [_Event(RUN_SPAN, 0, 1000, CPU), _Event("cudaGraphLaunch", 450, 500, CPU),
          _Event(RUN_SPAN, 0, 1000, CUDA), _Event(K1, 100, 400, CUDA),
          _Event(SORT, 350, 450, CUDA), _Event(DRIFT, 500, 520, CUDA),
          _Event(STEP2, 600, 630, CUDA), _Event(K1, 700, 900, CUDA),
          _Event(K1, 1100, 1200, CUDA)]
    st = Stretch(_Prof(ev), 2, {RUN_SPAN})
    st.n_slots, st.n_occupied, st.pairs = 216, 64, 576
    return st


def test_busy_union_gaps_and_breakdown():
    st = _stretch()
    assert len(st.dev_name) == 5
    assert st.busy_intervals() == [(100, 450), (500, 520), (600, 630), (700, 900)]
    assert st.busy_s() == pytest.approx(600e-9)
    assert st.gaps() == [(0, 100), (450, 500), (520, 600), (630, 700), (900, 1000)]
    assert st.host_at(460) == f"{RUN_SPAN} > cudaGraphLaunch"
    b = breakdown([st])
    assert b["device_ops"][0] == [K1, pytest.approx(500e-9)]
    assert b["idle_gaps"][0][1] == pytest.approx(100e-9) and len(b["idle_gaps"]) == 5


def _ctx(**kw):
    base = dict(stretches=[_stretch()], program_kernels=port.kernel_pattern(port.kernel_names()),
                params={"pair": {"potential": "PerturbedLennardJones"}, "method": {}},
                n_types=1,
                roofline=manifest.roofline, steps=1000, counters={"builds": 125,
                                                                  "captures": 2,
                                                                  "eager_segments": 3})
    base.update(kw)
    return Context(**base)


def test_the_per_layer_metrics_on_the_made_up_trace():
    ctx = _ctx()
    read = manifest.metric_reader
    assert read("device_idle_pct")(ctx) == pytest.approx(40.0)
    assert read("device_ops_per_step")(ctx) == 2.5
    # the sort is PyTorch's: 100 ns over 2 steps
    assert read("torch_ops_ms_per_step")(ctx) == pytest.approx(1e3 * 100e-9 / 2)
    pair = manifest.roofline("pair").bound_s("PerturbedLennardJones", 64, 216, 1, 576)
    assert read("pair_roofline_pct")(ctx) == pytest.approx(100 * pair / 250e-9)
    roof = manifest.roofline("integrator")
    want = (roof.step1_drift_s(216, 64) + roof.step2_s(216, 64, False)) / 50e-9
    assert read("integrator_roofline_pct")(ctx) == pytest.approx(100 * want)
    assert read("steps_per_rebuild")(ctx) == 8.0
    assert read("graph_unreplayed_segments")(ctx) == 5


def test_the_rooflines_take_each_stretch_at_its_own_pairs_and_slots():
    late = _stretch()
    late.n_slots, late.n_occupied, late.pairs = 432, 60, 288
    ctx = _ctx(stretches=[_stretch(), late])
    roof = manifest.roofline("pair")
    want = 2 * roof.bound_s("PerturbedLennardJones", 64, 216, 1, 576) \
        + 2 * roof.bound_s("PerturbedLennardJones", 60, 432, 1, 288)
    assert manifest.metric_reader("pair_roofline_pct")(ctx) == pytest.approx(100 * want / 1000e-9)
    integ = manifest.roofline("integrator")
    want = (integ.step1_drift_s(216, 64) + integ.step2_s(216, 64, False)
            + integ.step1_drift_s(432, 60) + integ.step2_s(432, 60, False))
    assert manifest.metric_reader("integrator_roofline_pct")(ctx) == pytest.approx(
        100 * want / 100e-9)


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = _stretch()
    empty.pairs = 0
    assert manifest.metric_reader("pair_roofline_pct")(_ctx(stretches=[empty])) is None
    ctx = _ctx(stretches=[])
    for name in ("device_idle_pct", "device_ops_per_step", "torch_ops_ms_per_step",
                 "pair_roofline_pct", "integrator_roofline_pct"):
        assert manifest.metric_reader(name)(ctx) is None
    assert manifest.metric_reader("steps_per_rebuild")(_ctx(counters={"builds": 0})) is None


def test_the_writers_share_comes_from_the_harness_spans():
    spans = type("S", (), {"spans": [("write.Table", 1.0, 1.004), ("write.GSD", 2.0, 2.01),
                                     ("portbench.run", 1.0, 3.0), ("write.Table", 9.0, 9.1)]})()
    ctx = _ctx(spans=spans, window_t0=0.5, window_t1=5.0, steps=1000)
    assert manifest.metric_reader("write_ms_per_step.logged")(ctx) == pytest.approx(0.014)
    assert re.fullmatch(r"[A-Za-z0-9_.\-]+", "write_ms_per_step.logged")
