"""Two-patch Morse particles: anisotropic pair forces + torques.

The TwoPatchMorse potential modulates a Morse well by patch alignment
Omega(gamma) = 1/(1 + exp(-omega (gamma^2 - alpha))), with the patch
direction given by each particle's orientation quaternion (reference
src/AnisoPairEvaluatorTwoPatchMorse.h). Torques are exposed as an
observable.
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def main(device=None):
    """Run the example on ``device`` (the GPU unless the caller asks for
    the CPU: ``main(device="cpu")``)."""
    rng = np.random.default_rng(8)
    n, a = 6, 1.5
    N, L = n**3, n * 1.5
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["P"]
    x = (np.arange(n) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), -1
    ).reshape(-1, 3)
    # random orientations (normalized quaternions)
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.moment_inertia[:] = [0.4, 0.4, 0.4]

    sim = az.Simulation(device=device, seed=2)
    sim.create_state_from_snapshot(snap)

    patchy = az.pair.TwoPatchMorse(
        nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.6, mode="shift"
    )
    patchy.params[("P", "P")] = dict(
        M_d=1.5, M_r=0.05, r_eq=1.0, omega=20.0, alpha=0.4, repulsion=True
    )

    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=0.3, default_gamma=1.0)],
        forces=[patchy],
        integrate_rotational_dof=True,
    )
    sim.state.thermalize_particle_momenta(kT=0.3)
    q0 = sim.state.get_snapshot().particles.orientation.copy()
    sim.run(150 if FAST else 1000)

    torques = np.asarray(patchy.torques)
    q1 = sim.state.get_snapshot().particles.orientation
    print(f"U/N = {patchy.energy / N:.4f}")
    print(f"mean |torque| = {np.linalg.norm(torques, axis=1).mean():.4f}")
    print(f"mean orientation drift = {np.abs(q1 - q0).mean():.4f}")


if __name__ == "__main__":
    main()
