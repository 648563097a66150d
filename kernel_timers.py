#!/usr/bin/env python3
"""Time the force kernels and K4-K9 of a checkout with three timers, on one GPU.

    python3 kernel_timers.py [ROOT]    # ROOT: a checkout; default: this one

Imports azplugins_tpu_torch from ROOT, builds its kernels there, and times
each on the state chip_smoke.py times it on: the pair kernel's
PerturbedLennardJones instantiation at the 64k headline (cap 72) and its
ExpandedYukawa instantiation at the polymer melt (cap 48), the DPD kernel at
the DPD fluid (cap 40) and the anisotropic kernel at the patchy colloids
(cap 16); the headline's drift check (K6, ``needs_rebin``), drift half
step (K7, ``Langevin.step1``), both in one launch where the checkout has
it (K7+K6, ``Langevin.step1`` with a drift check) and Langevin kick (K8,
``Langevin.step2``) on its state after HEADLINE_STEPS steps (past the
capacity tune: cap 48, 82,944 slots); the draws at the shapes chip_smoke.py
times them at (K4 ``particle_uniform3`` and ``particle_bits`` of one word
on 82,944 tags; K5's axis form at pure SRD's 262,144 rows and its two-key
form at Poiseuille's 4,352 where the checkout has them, and its single
draw ``jax_normal`` on pure SRD's [262,144, 3] where the checkout has
that); and the NO_SQUISH rotation's step1 mode (K9) on the patchy
colloids' 194,672 slots; the SRD collision's cell sums at pure SRD's 262,144
rows and cells (K10 where the checkout has it, and CUDA ``index_add_``, its
library call, in every checkout) and K5's clock form where the checkout has
it; the pair kernel at the
droplet (T = 2) and the droplet's masked evaporator
(``ParticleEvaporator._update_masked``, what its CUDA graphs run every
step) on its state after DROPLET_STEPS steps, and where the checkout has
K4 at the pick, the pick fired and unfired, the plain pick's flips and
``torch.topk`` alone over the slots' keys; through the public calls.
Three timers, CUDA events around ``REPS`` calls each:

- synced: the calls start right after a synchronize, so where the
  wrapper's host time exceeds the kernel's the host is timed;
- queued: chip_smoke.py's ``_cuda_time_ms``, the calls queued behind a
  spinning stream, so only the card is timed;
- replay (K4-K9, K7+K6 and the droplet's pair kernel and masked
  evaporator): the ``REPS`` calls captured into one CUDA
  graph and the graph replayed, as the run loop's rebuild segments replay
  them: no host work and no launch queue between the calls.

Two turns, each timer in turn. Running it on two checkouts (an older one
unpacked with ``git archive``, say) in one session, in the order old, new,
new, old, compares their kernels with each timer alike. Prints one line per
kernel and turn, then the card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs  # this checkout's: before ROOT goes on the path

REPS = 50
HEADLINE_STEPS = 300
DROPLET_STEPS = 1000


def _synced_time_ms(fn, reps: int, warm: int = 2) -> float:
    """Device ms per call: CUDA events around ``reps`` calls issued right
    after a synchronize."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the calls captured into one CUDA graph and replayed (chip_smoke.py's)
_replay_time_ms = cs._replay_time_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_timers: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else cs.HERE
    sys.path.insert(0, str(root))
    import azplugins_tpu_torch as az

    if not Path(az.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"azplugins_tpu_torch imported from {az.__file__}, not {root}")
    from azplugins_tpu_torch.ops import aniso_kernel as AK
    from azplugins_tpu_torch.ops import cuda_build
    from azplugins_tpu_torch.ops import dense as D
    from azplugins_tpu_torch.ops import dpd_kernel as DK
    from azplugins_tpu_torch.ops import integrate_kernel as IK
    from azplugins_tpu_torch.ops import pair_kernel as PK
    from azplugins_tpu_torch.ops import rng_kernel as RK

    try:
        from azplugins_tpu_torch.ops import pick_kernel as EK
    except ImportError:  # an older checkout: K4 at the pick in rng_kernel, or none
        EK = RK if hasattr(RK, "evaporator_pick") else None
    sources = {PK._SOURCE, DK._SOURCE, AK._SOURCE, IK._SOURCE, RK._SOURCE}
    cuda_build.load_libraries(*sorted(sources | ({EK._SOURCE} if EK else set())))
    from azplugins_tpu_torch.core import rng

    dev = torch.device("cuda")
    calls = {}
    replayed = set()  # the calls timed in a replay too

    dense, spec, _ = cs._dense_case(
        az, D, cs._lattice_snapshot(az, counts=(40, 40, 40), rho=0.85, jitter=0.05, seed=6), 3.0,
        0.4, dev)
    tbl = cs._pair_tables(az, "PerturbedLennardJones", 1, 11, 3.0, dev)
    plj = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"])
    calls[f"cell_pair_force[PerturbedLennardJones] 64k headline cap {spec.cap}"] = (
        lambda d=dense, s=spec: PK.cell_pair_force(d, s, plj, "PerturbedLennardJones", "none"))

    dense, spec = cs._prepared_dense(cs.build_polymer(az, dev)[0])
    tbl = cs._pair_tables(az, "ExpandedYukawa", 1, 11, 2.5, dev)
    eyk = PK.kernel_tables("ExpandedYukawa", tbl["params"], tbl["r_cut"])
    calls[f"cell_pair_force[ExpandedYukawa] polymer melt 32k cap {spec.cap}"] = (
        lambda d=dense, s=spec: PK.cell_pair_force(d, s, eyk, "ExpandedYukawa", "none"))

    dense, spec = cs._prepared_dense(cs.build_dpd(az, dev)[0])
    g = torch.Generator(device=dev).manual_seed(25)
    vel = torch.randn(dense.velocity.shape, generator=g, device=dev)
    dense = dense.replace(velocity=torch.where(dense.tag[:, None] >= 0, vel, 0.0))
    one = torch.ones((1, 1), device=dev)
    dpd = DK.dpd_kernel_tables({"A": 25.0 * one, "gamma": 4.5 * one, "s": 0.5 * one}, one, 1.0,
                               0.01)
    calls[f"cell_dpd_force DPD fluid 22k cap {spec.cap}"] = (
        lambda d=dense, s=spec: DK.cell_dpd_force(d, s, dpd, 5, 777))

    dense, spec = cs._prepared_dense(cs.build_patchy(az, dev)[0])
    tbl = cs._aniso_tables(az, 1, 35, dev)
    tpm = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "shift")
    calls[f"cell_aniso_force patchy colloids 27k cap {spec.cap}"] = (
        lambda d=dense, s=spec: AK.cell_aniso_force(d, s, tpm))
    name = f"no_squish (K9, step1 mode) patchy colloids {dense.N:,} slots cap {spec.cap}"
    calls[name] = lambda d=dense, dt=0.002: IK.no_squish(
        0, d.tag, None, d.typeid, d.orientation, d.angmom, d.moment_inertia, d.net_torque, dt)
    replayed.add(name)

    tags = cs._rng_tags(cs.HEADLINE_SLOTS, 1).to(dev)
    for name, fn in (
            (f"particle_uniform3 (K4) {cs.HEADLINE_SLOTS:,} tags",
             lambda: rng.particle_uniform3(rng.Stream.LANGEVIN, 1, 2, tags)),
            (f"particle_bits (K4, 1 word) {cs.HEADLINE_SLOTS:,} tags",
             lambda: rng.particle_bits(rng.Stream.PARTICLE_EVAPORATOR, 1, 2, tags, 1))):
        calls[name] = fn
        replayed.add(name)
    if hasattr(rng, "jax_normal"):  # K5's single draw, where the checkout has it
        name = f"jax_normal (K5) pure SRD {cs.NORMAL_SHAPES['srd']}"
        calls[name] = lambda: rng.jax_normal((0, 42), cs.NORMAL_SHAPES["srd"], "cuda")
        replayed.add(name)
    if hasattr(rng, "jax_normal_axis"):  # K5's axis form, where the checkout has it
        for name, fn in (
                (f"jax_normal_axis (K5, axis form) pure SRD {cs.NORMAL_SHAPES['srd'][0]:,} rows",
                 lambda: rng.jax_normal_axis((0, 42), cs.NORMAL_SHAPES["srd"][0], "cuda")),
                (f"jax_normal_axis (K5, two keys) Poiseuille "
                 f"{cs.NORMAL_SHAPES['poiseuille'][0]:,} rows",
                 lambda: rng.jax_normal_axis((0, 42), cs.NORMAL_SHAPES["poiseuille"][0], "cuda",
                                             (1, 2)))):
            calls[name] = fn
            replayed.add(name)

    # the SRD collision at pure SRD's shape: the cell sums (K10 where the
    # checkout has it; CUDA index_add_ on the payload, its library call,
    # in every checkout) and K5's clock form beside its host-key form
    cid, vel, _, cells = cs._cellsum_shapes(az, dev)["srd"]
    mpcd = az.mpcd
    pay = torch.cat([torch.ones((vel.shape[0], 2), device=dev), vel,
                     torch.sum(vel * vel, dim=1, keepdim=True)], dim=1)
    name = f"index_add_ (the cell sums, atomic) pure SRD {cid.numel():,} rows, {cells:,} cells"
    calls[name] = lambda: torch.zeros((cells + 1, 6), device=dev).index_add_(0, cid, pay)
    replayed.add(name)
    try:
        from azplugins_tpu_torch.ops import cellsum_kernel as CK
    except ImportError:  # an older checkout: index_add_ on the card
        CK = None
    if CK is not None:
        name = f"cell_sums (K10) pure SRD {cid.numel():,} rows, {cells:,} cells"
        calls[name] = lambda: CK.cell_sums(cid, vel, None, cells)
        replayed.add(name)
    if hasattr(rng, "collision_draws"):  # K5's clock form, where the checkout has it
        clock = torch.tensor(5, dtype=torch.int64, device=dev)
        inner = mpcd._inner_key(42)

        def clocked(rows, second):
            with rng.device_clock(clock, 5):
                return rng.collision_draws(inner, 8, rows, dev, 1.0, True, second)

        for name, fn in (
                (f"collision_draws (K5's clock form) pure SRD {cs.NORMAL_SHAPES['srd'][0]:,} rows",
                 lambda: clocked(cs.NORMAL_SHAPES["srd"][0], False)),
                (f"collision_draws (K5's clock form, two keys) Poiseuille "
                 f"{cs.NORMAL_SHAPES['poiseuille'][0]:,} rows",
                 lambda: clocked(cs.NORMAL_SHAPES["poiseuille"][0], True))):
            calls[name] = fn
            replayed.add(name)

    sim = cs.build_headline(az, dev)[0]
    sim.run(HEADLINE_STEPS)
    torch.cuda.synchronize()
    hd, hmeta, hspec = sim._dense, sim._meta, sim._grid_spec
    lang = sim.operations.integrator.methods[0]
    dt, t, seed = sim.dt_ref(), sim.timestep, sim.seed
    viol = torch.tensor(False, device=dev)
    at = f"64k headline after {HEADLINE_STEPS} steps, {hd.N:,} slots"
    headline = {
        f"drift_check (K6) {at}": lambda: D.needs_rebin(hd, hmeta, hspec, viol),
        f"step1 (K7) {at}": lambda: lang.step1(hd, dt, t, seed),
        f"step2 (K8, Langevin) {at}": lambda: lang.step2(hd, dt, t, seed)}
    if hasattr(IK, "step1_drift"):  # K7+K6 in one launch, where the checkout has it
        check = az.md.methods.DriftCheck(hmeta, hspec, viol)
        headline[f"step1_drift (K7+K6) {at}"] = lambda: lang.step1(hd, dt, t, seed, check)
    calls.update(headline)
    replayed.update(headline)

    sim = cs.build_droplet(az, dev)[0]
    sim.run(DROPLET_STEPS)
    torch.cuda.synchronize()
    dd, dspec = sim._dense, sim._grid_spec
    f = sim.operations.integrator.forces[0]
    tables, evap = f._device_tables(dev)["kernel"], sim.operations.updaters[0]
    t, seed = sim.timestep, sim.seed
    unfired = torch.tensor(False, device=dev)
    at = f"droplet after {DROPLET_STEPS} steps, cap {dspec.cap}, {dd.N:,} slots"
    droplet = {
        f"cell_pair_force[PerturbedLennardJones] {at}": (
            lambda: PK.cell_pair_force(dd, dspec, tables, "PerturbedLennardJones", f.mode)),
        f"masked evaporator (its operations together) {at}": (
            lambda: evap._update_masked(dd, unfired, t, seed)) if hasattr(
                evap, "_update_masked") else None}
    droplet = {k: fn for k, fn in droplet.items() if fn is not None}
    if EK is not None:
        # K4 at the pick fired and unfired (k = 10; the flips written as the
        # solvent type, so the state stays), the plain pick's flips and
        # torch.topk(k=10) alone over the slots' keys (the pick's library call)
        fired, tid = torch.tensor(True, device=dev), dd.typeid.clone()
        lo, hi = float(np.float32(evap.lo)), float(np.float32(evap.hi))
        keys = evap._keys(dd, evap._candidates(dd), t, seed)

        def pick(fire):
            return lambda: EK.evaporator_pick(tid, dd.position, dd.tag, evap._k,
                                              evap._solvent_id, evap._solvent_id, lo, hi,
                                              dd.box.Lz, rng.Stream.PARTICLE_EVAPORATOR, seed,
                                              t, fire)

        droplet.update({
            f"evaporator_pick (K4 at the pick) fired {at}": pick(fired),
            f"evaporator_pick (K4 at the pick) unfired {at}": pick(unfired),
            f"plain pick (the flips of the composed pick) {at}": (
                lambda: evap._flips((dd,), t, seed)),
            f"torch.topk(k={evap._k}) over the {dd.N:,} int64 keys {at}": (
                lambda: torch.topk(keys, evap._k, largest=False, sorted=False))})
    calls.update(droplet)
    replayed.update(droplet)

    for turn in range(2):
        for name, fn in calls.items():
            synced = _synced_time_ms(fn, REPS)
            queued = cs._cuda_time_ms(fn, REPS)
            replay = (f", replay {_replay_time_ms(fn, REPS):.4f} ms" if name in replayed
                      else "")
            print(f"[timers] {root.name} turn {turn} {name}: synced {synced:.4f} ms, queued "
                  f"{queued:.4f} ms{replay} per call", flush=True)
    print(cs._card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
