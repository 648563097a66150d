"""azplugins_tpu_torch: the PyTorch and CUDA port of azplugins_tpu.

The same user API as ``azplugins_tpu``, in PyTorch, for one NVIDIA H100;
the JAX package beside it is the reference every module is tested against.
This first slice runs the perturbed Lennard-Jones fluid under NVE or
Langevin dynamics on the dense cell grid, with the pair force on CUDA
devices in a hand-written kernel (``csrc/cell_pair_force.cu``).

Quick start::

    import azplugins_tpu_torch as az

    snap = az.Snapshot(N=1000)
    snap.configuration.box = [20, 20, 20, 0, 0, 0]
    snap.particles.types = ["A"]
    ...  # fill positions

    sim = az.Simulation(device="cuda", seed=7)
    sim.create_state_from_snapshot(snap)

    cell = az.md.nlist.Cell(buffer=0.4)
    lj = az.pair.PerturbedLennardJones(nlist=cell, default_r_cut=3.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)

    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.Langevin(kT=1.0)], forces=[lj]
    )
    sim.state.thermalize_particle_momenta(kT=1.0)
    sim.run(1000)
"""

from . import compute, logging, md, ops
from .core import Box, Snapshot, State, variant
from .md import filter, pair  # noqa: A004 - mirrors hoomd.filter
from .simulation import Operations, Simulation

__all__ = [
    "Box",
    "Operations",
    "Simulation",
    "Snapshot",
    "State",
    "compute",
    "filter",
    "logging",
    "md",
    "ops",
    "pair",
    "variant",
]
