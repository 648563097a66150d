"""azplugins_tpu_torch: the PyTorch and CUDA port of azplugins_tpu.

The same user API as ``azplugins_tpu``, in PyTorch, for one NVIDIA H100;
the JAX package beside it is the reference every module is tested against.
It runs isotropic pair potentials (the perturbed Lennard-Jones fluid,
the ExpandedYukawa polymer melt and the rest of the plugin's set), the
anisotropic TwoPatchMorse with rotational dynamics, bonds, the DPD
thermostat, harmonic barriers and wall potentials under NVE, Langevin or
Brownian dynamics (with flow fields) on the dense cell grid, the type
updaters (the evaporating droplet), the capacity tune, an MPCD (SRD)
solvent with its collisional coupling to the MD particles, and the
velocity computes and binning, the writers (``write.Table``,
``Trajectory``, ``GSD``) and checkpoints (``io``), spatial decomposition
into blocks on one device (``parallel``) and a profiler trace of the step's
phases (``Simulation.profile``), with
every pair force on CUDA devices in a hand-written kernel
(``csrc/cell_pair_force.cu``, ``csrc/cell_dpd_force.cu``,
``csrc/cell_aniso_force.cu``). A Simulation runs on the GPU unless it is
given ``device="cpu"``.

Quick start::

    import azplugins_tpu_torch as az

    snap = az.Snapshot(N=1000)
    snap.configuration.box = [20, 20, 20, 0, 0, 0]
    snap.particles.types = ["A"]
    ...  # fill positions

    sim = az.Simulation(seed=7)  # on the GPU; device="cpu" for the CPU
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

from . import compute, external, flow, io, logging, md, mpcd, ops, parallel, update, write
from .core import Box, Snapshot, State, variant
from .md import bond, filter, pair, trigger  # noqa: A004 - mirrors hoomd.filter
from .simulation import Operations, Simulation
from .version import __version__

__all__ = [
    "Box",
    "Operations",
    "Simulation",
    "Snapshot",
    "State",
    "__version__",
    "bond",
    "compute",
    "external",
    "filter",
    "flow",
    "io",
    "logging",
    "md",
    "mpcd",
    "ops",
    "pair",
    "parallel",
    "trigger",
    "update",
    "variant",
    "write",
]
