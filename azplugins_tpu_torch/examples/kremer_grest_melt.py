"""Kremer-Grest bead-spring melt: FENEWCA backbone + WCA pairs.

The classic coarse-grained polymer model (Kremer & Grest 1990) built
entirely from the HOOMD-core substrate set (SURVEY §2.13): FENE springs
with a WCA core on the backbone, purely repulsive WCA (LJ cut at
2^(1/6) sigma, shifted to zero) between all beads, Langevin thermostat.
azplugins workflows layer the plugin potentials on top of exactly this
substrate, so it doubles as the migration smoke test for az.pair.LJ and
az.bond.FENEWCA.
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"

WCA_CUT = 2.0 ** (1.0 / 6.0)


def make_melt(n_chains, chain_len, spacing=0.97, lateral=1.3):
    """Chains laid along z on a lateral grid: no initial overlaps (the
    nearest inter-chain distance exceeds the WCA cut), so the stiff
    FENE+WCA melt equilibrates without a soft push-off stage."""
    N = n_chains * chain_len
    nx = int(np.ceil(np.sqrt(n_chains)))
    L_lat = nx * lateral
    Lz = chain_len * spacing
    snap = az.Snapshot(N=N, bond_N=n_chains * (chain_len - 1))
    snap.configuration.box = [L_lat, L_lat, Lz, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.bonds.types = ["backbone"]
    b = 0
    for c in range(n_chains):
        x = (c % nx + 0.5) * lateral - L_lat / 2
        y = (c // nx + 0.5) * lateral - L_lat / 2
        for m in range(chain_len):
            i = c * chain_len + m
            z = (m + 0.5) * spacing - Lz / 2
            snap.particles.position[i] = [x, y, z]
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
    sim = az.Simulation(device=device, seed=20)
    sim.create_state_from_snapshot(snap)

    bonds = az.bond.FENEWCA()
    # standard Kremer-Grest parameterization
    bonds.params["backbone"] = dict(
        k=30.0, R0=1.5, epsilon=1.0, sigma=1.0, delta=0.0
    )
    # purely repulsive WCA: LJ cut at the minimum and shifted to zero
    pairs = az.pair.LJ(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=WCA_CUT,
        mode="shift",
    )
    pairs.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)

    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[bonds, pairs],
    )
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.state.thermalize_particle_momenta(kT=1.0)

    sim.run(200 if FAST else 2000)
    # FENE bonds cannot break: every bond length must stay below R0
    s = sim.state.get_snapshot()
    r = s.particles.position[snap.bonds.group[:, 0]] - s.particles.position[
        snap.bonds.group[:, 1]
    ]
    L = np.asarray(s.configuration.box[:3])
    r -= np.round(r / L) * L  # min image
    bond_len = np.linalg.norm(r, axis=1)
    print(
        f"kT = {thermo.kinetic_temperature:.3f}  "
        f"max bond = {bond_len.max():.3f} (R0 = 1.5)  "
        f"U_bond/bond = {bonds.energy / snap.bonds.N:.3f}"
    )
    assert bond_len.max() < 1.5, "FENE bond exceeded R0"


if __name__ == "__main__":
    main()
