"""Poiseuille (parabolic) flow with Langevin dynamics + velocity-field
measurement — the flow/compute workflow of the reference
(flow.ParabolicFlow + compute.CartesianVelocityFieldCompute).

Particles are dragged toward the imposed parabolic profile u_x(y); the
binned velocity field measured across y should reproduce it.
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def main(device=None):
    """Run the example on ``device`` (the GPU unless the caller asks for
    the CPU: ``main(device="cpu")``)."""
    n, a = (8 if FAST else 12), 1.1
    N, L = n**3, n * 1.1
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), -1
    ).reshape(-1, 3)

    sim = az.Simulation(device=device, seed=10)
    sim.create_state_from_snapshot(snap)

    lj = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.2)
    lj.params[("A", "A")] = dict(epsilon=5.0)

    flow = az.flow.ParabolicFlow(mean_velocity=1.0, separation=L)
    method = az.md.methods.LangevinFlow(
        kT=0.5, flow_field=flow, default_gamma=2.0
    )
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[method], forces=[lj]
    )

    field = az.compute.CartesianVelocityFieldCompute(
        num_bins=[0, 8, 0],
        lower_bounds=[0, -L / 2, 0],
        upper_bounds=[0, L / 2, 0],
        filter=az.filter.All(),  # like the reference, filter=None bins nothing
    )
    sim.operations.computes.append(field)

    sim.state.thermalize_particle_momenta(kT=0.5)
    sim.run(300 if FAST else 3000)

    y = np.asarray(field.coordinates)
    v = np.asarray(field.velocities)
    print(" y       v_x(measured)  v_x(imposed)")
    for yi, vi in zip(y, v):
        u = 1.5 * 1.0 * (1 - (2 * yi / L) ** 2)
        print(f"{yi:7.3f}  {vi[0]:12.3f}  {u:12.3f}")


if __name__ == "__main__":
    main()
