"""Evaporating droplet: the classic azplugins workflow.

A solvent droplet is confined by a spherical harmonic barrier whose
radius shrinks at constant area rate (variant.SphereArea), while
ParticleEvaporator removes solvent from the top slab at a budgeted rate —
the simulation setup of Howard et al. drying-droplet studies the
plugin was built for (azplugins' legacy components VariantSphereArea and
ParticleEvaporator).
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def main(device=None):
    """Run the example on ``device`` (the GPU unless the caller asks for
    the CPU: ``main(device="cpu")``)."""
    L, R0 = (20.0, 5.0) if FAST else (30.0, 9.0)
    # carve the droplet from a simple-cubic lattice (overlap-free start)
    a = 1.1
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    N = len(pts)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pts

    sim = az.Simulation(device=device, seed=7)
    sim.create_state_from_snapshot(snap)

    lj = az.pair.PerturbedLennardJones(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5
    )
    lj.params[("solvent", "solvent")] = dict(
        epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0
    )
    # evaporated "vapor" particles are inert
    lj.params[("evaporated", "evaporated")] = dict(
        epsilon=0.0, sigma=1.0, attraction_scale_factor=0.0
    )
    lj.params[("solvent", "evaporated")] = dict(
        epsilon=0.0, sigma=1.0, attraction_scale_factor=0.0
    )

    # shrinking spherical confinement: R(t) = sqrt(R0^2 - alpha t / 4 pi)
    radius = az.variant.SphereArea(R0=R0, alpha=0.05)
    barrier = az.external.SphericalHarmonicBarrier(location=radius)
    barrier.params["solvent"] = dict(k=50.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)

    evap = az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(50),
        solvent_type="solvent",
        evaporated_type="evaporated",
        lo=0.5,   # slab through the droplet's upper half
        hi=L / 2,
        N_evap_max=5,
    )
    sim.operations.updaters.append(evap)

    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=1.0, default_gamma=1.0)],
        forces=[lj, barrier],
    )
    sim.state.thermalize_particle_momenta(kT=1.0)

    for block in range(2 if FAST else 5):
        sim.run(150 if FAST else 500)
        snap_now = sim.state.get_snapshot()
        n_solvent = int((snap_now.particles.typeid == 0).sum())
        print(
            f"t={sim.timestep:5d}  R={float(radius(sim.timestep)):6.3f}  "
            f"solvent left: {n_solvent}"
        )


if __name__ == "__main__":
    main()
