"""The plain reference against the program on the CPU at small sizes: the
program's runs come out correct, the control (the reference in bfloat16 in
the program's place) does not."""

import pytest
import torch

from portbench import initial, manifest
from portbench.reference import check, physics, threefry

from ._small import run

CELLS = ["plj_langevin.n64k", "droplet_evaporation.n20k", "plj_langevin.n64k.logged"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_and_the_control_is_not(cell):
    r = run(cell, control=True)
    assert r["correct"] is True
    numbers = set(check.NUMBERS) - ({"table_gap", "frame_gap"} if "logged" not in cell else set())
    assert list(r)[-1] == "checked" and set(r["checked"]) == numbers
    ctl = r["control"]
    assert any(ctl[k] > c["limit"] for k, c in r["checked"].items())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in manifest.end_to_end_of(manifest.load(), cell)}
    assert r["checked"]["replay_shortfall"]["value"] == 0


@pytest.mark.parametrize("config, traffic", [("plj_langevin", {"n_particles": 1000}),
                                             ("droplet_evaporation", {"n_particles": 20239})])
def test_a_seed_gives_the_same_inputs(config, traffic):
    params = manifest.config_params(manifest.load(), config)
    build = manifest.config_builder(config).initial_state
    cpu = torch.device("cpu")
    a, b, c = (build(params, traffic, initial.generator(seed, cpu))
               for seed in (2**40 + 7, 2**40 + 7, 2**40 + 8))
    assert torch.equal(a["v"], b["v"]) and not torch.equal(a["v"], c["v"])
    assert (a["x"] == b["x"]).all() and a["L"] == b["L"]
    assert initial.simulation_seed(2**40 + 7) == initial.simulation_seed(2**40 + 7) < 2**16


def test_uniforms_by_hand():
    # threefry2x32-20 of key (0, 0) and counter (0, 0): random123's known answer
    x0, x1 = threefry.threefry2x32(0, 0, torch.tensor([0]), torch.tensor([0]))
    assert (int(x0), int(x1)) == (0x6B200159, 0x99BA4EFE)
    u = threefry.uniform3(threefry.LANGEVIN, 5, 10, torch.arange(1000))
    assert u.shape == (1000, 3) and float(u.min()) >= -1.0 and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.05


def test_barrier_and_wall_by_hand():
    L = torch.full((3,), 44.0, dtype=torch.float64)
    x = torch.tensor([[12.0, 0.0, 0.0], [0.0, 0.0, -19.0], [1.0, 1.0, 1.0]], dtype=torch.float64)
    types = torch.zeros(3, dtype=torch.int64)
    barrier = {"types": ["s"], "barrier": {"R0": 10.0, "alpha": 0.0, "k": [50.0],
                                           "offset": [0.0]}}
    f, e = physics.external_forces(x[[0, 2]], types[:2], L, barrier, 0)
    assert f[0].tolist() == pytest.approx([-100.0, 0.0, 0.0])  # k (r - R), inward
    assert float(e[0]) == pytest.approx(100.0)
    assert f[1].tolist() == [0.0, 0.0, 0.0]
    # SphereArea: R(t)^2 = R0^2 - alpha t / (4 pi)
    b = {"R0": 20.0, "alpha": 0.05}
    want = (400 - 0.05 * 4000 / (4 * 3.141592653589793)) ** 0.5
    assert physics.barrier_radius(b, 4000) == pytest.approx(want)
    wall = {"types": ["s"], "walls": [{"origin": (0.0, 0.0, -20.0), "normal": (0, 0, 1),
                                       "epsilon": [1.0], "sigma": [1.0], "r_cut": [3.0]}]}
    f, _ = physics.external_forces(x, types, L, wall, 0)
    # LJ93 at d = 1: F = 9 (2/15) - 3 = -1.8 along the normal; beyond r_cut nothing
    assert f[1].tolist() == pytest.approx([0.0, 0.0, 9 * 2 / 15 - 3])
    assert f[0].tolist() == [0.0, 0.0, 0.0] and f[2].tolist() == [0.0, 0.0, 0.0]
