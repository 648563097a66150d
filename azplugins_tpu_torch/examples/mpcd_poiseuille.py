"""MPCD solvent Poiseuille flow in a slit, measured with the velocity
field observable.

The classic mesoscale-hydrodynamics validation: an SRD solvent
(az.mpcd.SRD) confined between no-slip bounce-back plates and driven by
a constant body force develops the parabolic velocity profile. The
profile is measured exactly the way an azplugins user would — with
``VelocityFieldCompute(include_mpcd_particles=True)``
(azplugins' VelocityFieldCompute reads the same stream).
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def main(device=None):
    """Run the example on ``device`` (the GPU unless the caller asks for
    the CPU: ``main(device="cpu")``)."""
    rng = np.random.default_rng(12)
    N, L = (4000, 8.0) if FAST else (40000, 16.0)
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(
        [L, L, 0.98 * L]
    )
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))

    sim = az.Simulation(device=device, seed=4)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[]
    )
    sim.mpcd_dynamics = az.mpcd.SRD(
        dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0,
        body_force=(0.03, 0.0, 0.0), plates=("z", L),
    )

    sim.run(600 if FAST else 3000)  # develop the flow

    nbins = 8 if FAST else 16
    field = az.compute.CartesianVelocityFieldCompute(
        num_bins=(0, 0, nbins),
        lower_bounds=(0, 0, -L / 2),
        upper_bounds=(0, 0, L / 2),
        include_mpcd_particles=True,
    )
    sim.operations.computes.append(field)
    sim.run(50)
    field._attach(sim)
    prof = np.asarray(field.velocities)[..., 0].reshape(nbins)

    z = (np.arange(nbins) + 0.5) / nbins - 0.5
    A = np.stack([0.25 - z**2, np.ones(nbins)], 1)
    coef, *_ = np.linalg.lstsq(A, prof, rcond=None)
    fit = A @ coef
    r2 = 1 - ((prof - fit) ** 2).sum() / max(
        ((prof - prof.mean()) ** 2).sum(), 1e-12
    )
    print(
        f"v_x profile: {np.round(prof, 3).tolist()}  "
        f"parabola R^2 = {r2:.3f}  peak = {prof.max():.3f}"
    )
    assert prof.max() > 0.03, "flow did not develop"
    if not FAST:
        assert r2 > 0.95, "profile is not parabolic"


if __name__ == "__main__":
    main()
