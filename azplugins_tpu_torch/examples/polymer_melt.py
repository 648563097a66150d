"""Polymer melt: quartic (scissile) backbone bonds + expanded-Yukawa pairs.

BASELINE config 1. Chains of beads connected by breakable quartic bonds
(the Tsige-Stevens scission parameterization azplugins documents for
its quartic bond) with screened-electrostatic
ExpandedYukawa non-bonded interactions, run at constant temperature.
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def make_melt(n_chains, chain_len, spacing=0.97, rho=0.5):
    """Straight chains as x-rows of a tetragonal lattice.

    Beads sit at the quartic bond's near-minimum spacing along x, one
    chain per lattice row, with the transverse row spacing chosen to
    hit the target density. The minimum non-bonded separation is the
    row spacing (~1.44 sigma), so every initial force is gentle — an
    overlapping random-coil start kicks particles across the whole
    Verlet buffer in one step (ExpandedYukawa diverges at r = delta)
    and trips the engine's dangerous-rebuild warning. The melt
    disorders on its own within a few hundred steps at kT = 1.
    """
    N = n_chains * chain_len
    b_t = np.sqrt(1.0 / (rho * spacing))  # transverse row spacing
    # row grid (ny x nz) as square as n_chains allows
    ny = int(np.sqrt(n_chains))
    while n_chains % ny:
        ny -= 1
    nz = n_chains // ny
    Lx, Ly, Lz = chain_len * spacing, ny * b_t, nz * b_t
    snap = az.Snapshot(N=N, bond_N=n_chains * (chain_len - 1))
    snap.configuration.box = [Lx, Ly, Lz, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.bonds.types = ["backbone"]
    b = 0
    for c in range(n_chains):
        iy, iz = c % ny, c // ny
        for m in range(chain_len):
            i = c * chain_len + m
            snap.particles.position[i] = [
                (m + 0.5) * spacing - Lx / 2,
                (iy + 0.5) * b_t - Ly / 2,
                (iz + 0.5) * b_t - Lz / 2,
            ]
            if m < chain_len - 1:
                snap.bonds.typeid[b] = 0
                snap.bonds.group[b] = [i, i + 1]
                b += 1
    return snap


def main(device=None):
    """Run the example on ``device`` (the GPU unless the caller asks for
    the CPU: ``main(device="cpu")``)."""
    n_chains, chain_len = (8, 10) if FAST else (32, 25)
    snap = make_melt(n_chains, chain_len)
    sim = az.Simulation(device=device, seed=14)
    sim.create_state_from_snapshot(snap)

    bonds = az.bond.Quartic()
    bonds.params["backbone"] = dict(
        k=1434.3, r_0=1.5, b_1=-0.7589, b_2=0.0, U_0=67.2234,
        sigma=1.0, epsilon=1.0, delta=0.0,
    )
    pairs = az.pair.ExpandedYukawa(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5
    )
    pairs.params[("A", "A")] = dict(epsilon=2.0, kappa=1.5, delta=0.5)

    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[bonds, pairs],
    )
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.state.thermalize_particle_momenta(kT=1.0)

    sim.run(200 if FAST else 2000)
    # intact backbone: bond energy per bond far below the U_0 plateau
    n_bonds = snap.bonds.N
    print(
        f"kT = {thermo.kinetic_temperature:.3f}  "
        f"U_bond/bond = {bonds.energy / n_bonds:.3f} (plateau 67.2)  "
        f"U_pair/N = {pairs.energy / snap.particles.N:.3f}"
    )


if __name__ == "__main__":
    main()
