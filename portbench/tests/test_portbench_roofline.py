"""The roofline arithmetic and the kernel names it reads, against hand counts."""

import math

import pytest
import torch

from portbench import manifest, port
from portbench.reference import physics

PAIR = manifest.roofline("pair")
INTEGRATOR = manifest.roofline("integrator")
PEAKS = manifest.roofline("peaks")


def _lattice(n_side, a):
    x = torch.arange(n_side, dtype=torch.float64) * a - n_side * a / 2
    return torch.stack(torch.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)


def _model(r_cut):
    return {"types": ["A"], "pair": {"r_cut": r_cut, "params": {(0, 0): {
        "epsilon": 1.0, "sigma": 1.0, "attraction_scale_factor": 0.5}}}}


@pytest.mark.parametrize("n_side, r_cut, per_particle", [
    (4, 1.5, 18),    # 6 at 1 and 12 at sqrt(2): every axis under three cells
    (7, 1.5, 18),    # the same with a cell list (7 / 1.5: four cells an axis)
    (7, 1.8, 26),    # and the 8 at sqrt(3)
    (9, 2.1, 32),    # and the 6 at 2
])
def test_pairs_inside_the_cutoff_on_a_lattice(n_side, r_cut, per_particle):
    x = _lattice(n_side, 1.0)
    L = torch.full((3,), float(n_side), dtype=torch.float64)
    pairs = physics.pair_forces(x, torch.zeros(len(x), dtype=torch.int64), L,
                                _model(r_cut))[2]
    assert pairs == n_side**3 * per_particle // 2


def test_pair_bound_by_hand():
    # 64 particles in 216 slots, 576 pairs: operations 576 x 29 / 67e12,
    # bytes 64 x 16 + 216 x 16 + 4 x 8 (one type pair)
    t_ops = 576 * 29 / 67e12
    t_bytes = (64 * 16 + 216 * 16 + 32) / 3.35e12
    assert PAIR.bound_s("PerturbedLennardJones", 64, 216, 1, 576) == max(t_ops, t_bytes)
    # the headline's sizes are bound by operations, ~1.3 us a call
    b = PAIR.bound_s("PerturbedLennardJones", 64000, 82944, 1, 3_070_000)
    assert b == pytest.approx(3_070_000 * 29 / 67e12)


def test_integrator_bounds_by_hand():
    assert INTEGRATOR.step2_bytes(100, 60) == 40 * 100 + 20 * 60 + 12 * 40
    assert INTEGRATOR.step2_bytes(100, 60, flow=True) == 40 * 100 + 20 * 60 + 12 * 40 + 12 * 60
    # K7+K6 at the headline's 82,944 slots, 64,000 occupied: bytes bind
    n, n_act = 82944, 64000
    assert INTEGRATOR.step1_drift_s(n, n_act) == pytest.approx((52 * n + 24 * n_act) / 3.35e12)
    # K8 with its two Threefry hashes: the ALU pipe's 2 x 43 operations a slot
    alu = n_act * 2 * 43 / (64 * 132 * 1.98e9)
    t_bytes = INTEGRATOR.step2_bytes(n, n_act) / 3.35e12
    assert INTEGRATOR.step2_s(n, n_act, False) == pytest.approx(max(alu, t_bytes))
    assert PEAKS.ALU_OPS_PER_S == 64 * 132 * 1.98e9


def test_kernel_names_come_from_the_global_functions():
    names = port.kernel_names()
    for want in ("cell_pair_force_kernel", "drift_kernel", "step2_kernel", "pick_scan_kernel",
                 "pick_select_kernel", "particle_bits_kernel", "sum_kernel", "place_kernel"):
        assert want in names
    assert "az_step2" not in names  # a host entry point, not a kernel


@pytest.mark.parametrize("name, ours", [
    ("void drift_kernel<(Prologue)1>(float const*, float const*, int const*, int, float)", True),
    ("step2_kernel<(Step2Mode)2, true, false>", True),
    ("void (anonymous namespace)::cell_pair_force_kernel<3>(float const*, int const*)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", False),
    ("void at::native::(anonymous namespace)::sum_kernel_impl<float>", False),
    ("Memcpy DtoD (Device -> Device)", False),
    ("my_drift_kernel", False),
])
def test_a_device_operation_is_the_programs_by_its_kernel_name(name, ours):
    assert bool(port.kernel_pattern(port.kernel_names()).search(name)) is ours


def test_the_droplet_counts_its_pairs_at_every_type_pair():
    # two types, the second interacting with nothing, still counted
    model = {"types": ["a", "b"], "pair": {"r_cut": 1.5, "params": {
        (0, 0): {"epsilon": 1.0, "sigma": 1.0, "attraction_scale_factor": 1.0},
        (0, 1): {"epsilon": 0.0, "sigma": 1.0, "attraction_scale_factor": 0.0},
        (1, 1): {"epsilon": 0.0, "sigma": 1.0, "attraction_scale_factor": 0.0}}}}
    x = _lattice(7, 1.0)
    types = (torch.arange(len(x)) % 2).to(torch.int64)
    L = torch.full((3,), 7.0, dtype=torch.float64)
    f, _, pairs, _ = physics.pair_forces(x, types, L, model)
    assert pairs == 7**3 * 18 // 2
    assert math.isfinite(float(f.abs().max()))
