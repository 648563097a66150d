"""Colloids advected by an MPCD solvent: hydrodynamic coupling demo.

LJ colloids (no explicit drag force, plain NVE) are embedded in an SRD
solvent through collisional coupling (az.mpcd.CollisionCoupling). A
body force drives the solvent; the colloids pick up the flow purely by
exchanging momentum in the collision cells — the mesoscale analog of
the reference's flow-field integrators (LangevinFlow prescribes u(r);
here the solvent IS simulated and the coupling produces the drag).
"""

import os

import numpy as np

import azplugins_tpu_torch as az

# CI smoke mode: tiny system + short runs (tests/test_torch_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def main(device=None):
    """Run the example on ``device`` (the GPU unless the caller asks for
    the CPU: ``main(device="cpu")``)."""
    rng = np.random.default_rng(21)
    L = 10.0 if FAST else 16.0
    N_s = int(5 * L**3)  # solvent at density 5 per collision cell
    n = 4 if FAST else 5
    N_c = n**3
    # FAST mode has few colloids and few collisions; drive harder so the
    # advective signal clears the colloids' thermal noise
    g = 0.06 if FAST else 0.02

    snap = az.Snapshot(N=N_c, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["colloid"]
    x = (np.arange(n) + 0.5) * (L / n) - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), -1
    ).reshape(-1, 3)
    snap.particles.mass[:] = 5.0
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)

    sim = az.Simulation(device=device, seed=33)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4),
                    default_r_cut=2.0 ** (1 / 6), mode="shift")
    lj.params[("colloid", "colloid")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.ConstantVolume()], forces=[lj]
    )
    srd = az.mpcd.SRD(
        dt=0.005, period=20, angle=130.0, cell_size=1.0, kT=1.0,
        body_force=(g, 0.0, 0.0),
    )
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))

    steps = 400 if FAST else 4000
    sim.run(steps // 2)  # develop the flow
    # time-average the colloid drift over the second half (a single
    # snapshot of few colloids is thermal-noise dominated)
    drifts = []
    for _ in range(steps // 2 // 40):
        sim.run(40)  # two collision events per sample
        s = sim.state.get_snapshot()
        drifts.append(s.particles.velocity[:, 0].mean())
    v_c = s.particles.velocity
    v_drift = float(np.mean(drifts))
    v_s = s.mpcd.velocity
    print(
        f"solvent drift vx = {v_s[:, 0].mean():.3f}  "
        f"colloid drift vx = {v_drift:.3f}  "
        f"colloid kT = {(5.0 * (v_c - v_c.mean(0))**2).sum() / (3 * len(v_c)):.2f}"
    )
    # the colloids ride the flow: their drift tracks the solvent's
    assert v_drift > 0.3 * v_s[:, 0].mean(), (v_drift, v_s[:, 0].mean())


if __name__ == "__main__":
    main()
