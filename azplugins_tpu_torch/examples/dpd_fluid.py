"""DPD fluid with the general-weight thermostat.

A=25 conservative + dissipative/random pair forces under NVE integration:
the pair thermostat alone must hold kT (the reference's statistical test,
src/pytest/test_pair_dpd.py pattern). Also demonstrates the s exponent of
the general weight function w(r) = (1 - r/rcut)^(s/2).
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def main(device=None):
    """Run the example on ``device`` (the GPU unless the caller asks for
    the CPU: ``main(device="cpu")``)."""
    n = 6 if FAST else 10
    rho = 3.0  # standard DPD density
    N = n**3
    L = (N / rho) ** (1 / 3)
    a = L / n
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), -1
    ).reshape(-1, 3)

    sim = az.Simulation(device=device, seed=5)
    sim.create_state_from_snapshot(snap)

    dpd = az.pair.DPDGeneralWeight(
        nlist=az.md.nlist.Cell(buffer=0.4), kT=1.0, default_r_cut=1.0
    )
    dpd.params[("A", "A")] = dict(A=25.0, gamma=4.5, s=0.5)

    sim.operations.integrator = az.md.Integrator(
        dt=0.01, methods=[az.md.methods.ConstantVolume()], forces=[dpd]
    )
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)

    sim.run(100 if FAST else 500)  # thermostat heats the lattice from rest
    samples = []
    for _ in range(3 if FAST else 20):
        sim.run(50)
        samples.append(thermo.kinetic_temperature)
    print(f"<kT> = {np.mean(samples):.3f} +- {np.std(samples):.3f} (target 1.0)")


if __name__ == "__main__":
    main()
