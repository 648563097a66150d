"""The capacity tune and the run-loop knobs of the port, against the JAX
reference.

A Lennard-Jones lattice sizes the cell capacity for its commensurate
start (three lattice planes share a cell). At timestep 200 both packages
tune: the capacity becomes the 8-multiple above the measured max cell
occupancy and the rebuild interval follows the fastest particle. Both are
integers, so the port's must equal the reference's, not be close to them
(the trajectories agree to float32 rounding, far from any cell boundary
or interval step that would tell them apart). The clock starts at 190, so
the tune reads a lattice ten steps old and the test stays cheap. A second,
sparser liquid (whose capacity the plain CPU force sweeps four times
faster) melts from timestep 0 through the tune: its trajectory is bitwise
independent of how ``run`` is chunked across the tune point. A resume
past the tune point does not tune again; a capacity grows by the
reference's rule before and after the tune.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402

torch.set_num_threads(1)


def _liquid(az, n=8, a=1.1, seed=11, t0=0):
    """n^3 particles on a simple-cubic lattice in 3^3 cells, Langevin kT 1.5,
    the clock at ``t0``."""
    N = n**3
    L = n * a
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=seed, **kw)
    sim.create_state_from_snapshot(snap)
    sim.timestep = t0
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.Langevin(kT=1.5, default_gamma=1.0)], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.5)
    return sim


def _sparse(t0=0):
    """216 particles, two lattice planes a cell: capacity 16."""
    return _liquid(port, n=6, a=1.45, seed=12, t0=t0)


def _record_tune(sim):
    """Record the capacity and interval the tune sets, when it fires."""
    seen = {}
    tune = sim.tune_cell_capacity

    def spy(*args, **kwargs):
        tune(*args, **kwargs)
        seen.update(t=sim.timestep, cap=sim._grid_spec.cap, seg=sim._seg_len,
                    ceiling=sim._seg_ceiling)

    sim.tune_cell_capacity = spy
    return seen


def _bits(sim):
    p = sim.state.get_snapshot().particles
    return p.position.view(np.int32), p.velocity.view(np.int32), p.image


def test_tune_at_200_matches_reference():
    rsim, psim = _liquid(ref, t0=190), _liquid(port, t0=190)
    rseen, pseen = _record_tune(rsim), _record_tune(psim)
    rsim.run(11)
    psim.run(5)
    cap0 = psim._grid_spec.cap
    psim.run(6)
    assert pseen == rseen and pseen["t"] == 200
    assert pseen["cap"] < cap0  # the lattice's capacity was too large
    assert psim._auto_tuned and rsim._auto_tuned


def test_chunking_across_the_tune_point_is_bitwise():
    split, whole = _sparse(), _sparse()
    seen = _record_tune(split)
    split.run(150)
    split.run(150)
    whole.run(300)
    assert seen["t"] == 200 and (seen["seg"], seen["ceiling"]) != (10, 50)
    for a, b in zip(_bits(split), _bits(whole)):
        np.testing.assert_array_equal(a, b)
    assert split._grid_spec == whole._grid_spec and split._seg_len == whole._seg_len


def test_resume_past_the_tune_point_does_not_tune():
    psim = _liquid(port)
    psim.timestep = 150
    assert not psim._auto_tuned  # still ahead of the tune point
    psim.timestep = 500
    assert psim._auto_tuned and psim.timestep == 500
    psim.run(5)
    cap = psim._grid_spec.cap
    psim.run(5)
    assert psim._grid_spec.cap == cap
    off = _liquid(port)
    off.auto_tune_after = None
    off.run(1)
    assert not off._auto_tuned


@pytest.mark.parametrize("tuned", [False, True])
def test_capacity_growth_follows_the_reference(tuned):
    """Before the tune an overflow jumps to the recorded occupancy plus a
    quantum; after it the capacity grows by one 8-slot quantum."""
    rsim, psim = _liquid(ref), _liquid(port)
    for sim in (rsim, psim):
        sim.run(0)
        if tuned:
            sim.tune_cell_capacity()
        cap = sim._grid_spec.cap
        sim._grow_and_rebuild(cap + 13)
    assert psim._grid_spec.cap == rsim._grid_spec.cap
    assert psim._grid_spec.cap == (cap + 8 if tuned else int(np.ceil((cap + 21) / 8) * 8))
    assert psim._seg_len == rsim._seg_len
    assert not bool(psim._meta.overflow)


def test_max_chunk_and_seg_adapt():
    """A pinned interval never grows back after a violation lowers it;
    short chunks give the same bits."""
    pinned = _sparse()
    pinned._seg_adapt = False
    pinned.auto_tune_after = None
    pinned.run(60)
    seg = pinned._seg_len
    pinned.run(100)
    assert pinned._seg_len <= seg <= 10
    a, b = _sparse(), _sparse()
    a.max_chunk = 7
    a.run(40)
    b.run(40)
    for x, y in zip(_bits(a), _bits(b)):
        np.testing.assert_array_equal(x, y)
