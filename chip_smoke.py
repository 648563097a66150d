#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU, end to end.

    python3 chip_smoke.py        # from the repository root; needs one GPU

1. checks for a CUDA device and prints its name and power limit;
2. builds the CUDA kernels from azplugins_tpu_torch/csrc/, one nvcc per
   source, all at once, and prints each build's time and ptxas registers
   and spills;
3. holds the pair kernel, for every isotropic potential in modes
   none/shift/xplor, the DPD kernel and the anisotropic (TwoPatchMorse
   force and torque) kernel in modes none/shift against their plain
   PyTorch versions on the card: small orthorhombic, tilted,
   axis-under-3-cells and two-type shapes, the polymer melt (32,000), DPD
   fluid (21,952) and patchy colloids (27,000) at full size, and the 64k
   headline; the packed schedule's own shapes too: cells filled to exactly
   their capacity, mostly empty cells, a capacity whose stencils are staged
   in rounds (above 256; forced to 64 for TwoPatchMorse), two axes under 3
   cells, 41 types (tables in global memory) and, for TwoPatchMorse, cells
   of more particles than its block has threads; checks that two launches
   give the same bits; prints the candidate pairs per call beside the
   pairs inside r_cut; times each
   kernel against its plain version and computes its bound (the larger of
   its bytes over the memory rate and its operations over the float32
   rate, for this run's inputs);
4. [rng] checks that Threefry and the Langevin noise are bitwise the same
   on the GPU and the CPU; holds the random-draw kernels of
   csrc/threefry.cu against their plain versions on the card: K4
   (particle_bits, particle_uniform3) bitwise at 64,000, 82,944 and 20,239
   tags (-1 and 2**31 - 1 among them), 1-8 words, three uniform ranges,
   three streams, two timesteps (one above 2**32), and in its clock form
   (the timestep read from the card, core/rng.py's device_clock) at
   CLOCK_STEPS; K5 (jax_normal_axis: the collision's unit axes, with the
   virtual fill's normals under a second key in the same launch) within
   1 ulp of its plain version at the three MPCD paths' collision grids, its
   maximum printed, bitwise the plain normalisation of its own normals (the
   card's torch.sum order over 3) and bitwise two single draws;
   runs BrownianFlow through the public API; times K4 at the headline's
   slots and K5 at each grid against their plain versions and bounds;
   [cellsum] holds the SRD collision's cell sums (K10, csrc/cell_sums.cu:
   each cell's rows added in ascending row order) bitwise against the plain
   ordered sum (mpcd.py's _cell_sums_plain) at pure SRD's shape (262,144
   rows into 262,144 cells), the colloids' (163,840 solvent and 74,088
   dense slots, 2,744 of mass 5, the empty ones trashed; 32,768 cells) and
   the Poiseuille slit's (40,000 rows, 4,352 cells), and at one deep cell,
   two calls the same bits; K5's clock form (the collision's keys and grid
   shift derived on the card from a clock) bitwise its host-key form and
   the host's shift at the three grids, CLOCK_STEPS, two cell sizes, the
   shift on and off; times K10 queued and in a replay against CUDA
   index_add_ (its library call) and its bound, and K5's clock form
   against its host-key form;
5. runs, through the public API, each with the launch counts set to 0 just
   before it and read just after (configs 1-5 and every other simulation
   that qualifies run their rebuild segments as CUDA graphs, and print
   their captures and replays; a path that qualifies must replay):
   - the 64k perturbed-LJ Langevin headline (the JAX package's bench
     headline, BASELINE config 1), then [integrate] on its state (below),
     then [profile] 20 of its steps under Simulation.profile: the trace's
     phase ranges counted (one of each step phase a step, rebin once a
     build) and the device operations and device-busy ms a step split by
     phase, with the host's us an operation (ms/step over operations a
     step); integrate_step1, verlet_drift_check and integrate_step2 at most
     2 operations a step each;
   - [io] the headline again, with writers: a Table of kT and the
     potential energy every 100 steps, a Trajectory (aztraj) and a GSD
     every 250, over 1,000 steps; the frames' timesteps, the last frame of
     each file against get_snapshot() bit for bit and the Table's rows
     checked, synchronising calls and host ms per fire counted; ms/step
     without and with the writers in alternating turns; a checkpoint
     restored twice through load_checkpoint and once through
     create_state_from_gsd, the three runs of 200 steps equal bit for bit;
   - [spatial] the headline built three times from one seed: whole, in 4
     slabs (make_mesh(4, device="cuda")) and in 16 strips, run in turns for
     300 steps (across the tune) and 300 more; the decomposed layouts equal
     the whole one bit for bit after each stretch, K1 launched once a force
     evaluation; then again on 4 and 16 shards of their own slot storage
     (make_mesh(n, device="cuda", sharded=True): the block-local rebin with
     migration, halo windows into K1): the gathered layouts equal the whole
     one bit for bit after each stretch, K1 launched n times a force
     evaluation; the windowed K1, K1', K2 and K3 equal to the whole grid's
     launches on each shard's own slots bit for bit; the windowed K1's time
     a call per shard against its bound, the halo bytes and copies a force
     evaluation, and device operations, device-busy ms and ms/step at n =
     1, 4 and 16;
   - [spatial_ops] updaters, bonds and the MPCD solvent on 4 shards: the
     droplet (600 + 600 steps; its evaporator on shards) and the polymer
     melt (300 + 300 from the built rods; its bonds read across shards),
     each whole (on the grid the mesh snaps to) and sharded in turns, equal
     bit for bit after each stretch; colloid hydrodynamics (400 steps, its
     solvent in 4 particle blocks) within its path's limits on shards, and
     one joint collision on shards within 1e-6 of max|v| of the whole one;
     ms/step, device operations, busy ms and synchronising calls a step,
     the evaporator's pick on shards with no synchronising call and its
     operations a fire, the position gather's ms, the joint collision's ms
     and operations, and the windowed K1/K1' of shards 0 and 2 against the
     plain windowed stencil with their ms and bound;
   - the DPD fluid (BASELINE config 3, 21,952 particles, ConstantVolume);
   - the polymer melt (BASELINE config 2, 1,280 chains of 25, Quartic
     bonds + ExpandedYukawa, Langevin);
   - the patchy colloids (BASELINE config 4, 27,000 TwoPatchMorse
     particles, Langevin with NO_SQUISH rotation);
   - [graph] the headline, the polymer melt, the DPD fluid, the patchy
     colloids and the droplet at full size and a small liquid under a
     Ramp kT (RAMP_SIDE^3), each built three times from one seed: two
     run the eager loop (the private Simulation._eager), one the CUDA
     graphs (the droplet's evaporator masked every step, its barrier's
     SphereArea and the ramp's kT read from the chunk's schedule on the
     card); GRAPH_STEPS steps each, then turns of GRAPH_STEPS (eager,
     graph, graph, eager), the second eager run keeping pace: the graph
     run equal to the eager one bit for bit
     (GRAPH_FIELDS, typeid among them) wherever the two eager runs are
     (the differences printed), launch counts exact under replay, at
     least GRAPH_LEAST_REPLAYS replays; ms/step both ways, host us a
     step, device operations and busy ms a step, captures, replays and
     the pool's MB; for the droplet the masked updaters' operations and
     busy ms a step against its busy step, and the chunk's schedule
     loaded with no synchronising call; K2, K4, K8 and K9 in their clock
     forms and K8 and K9 in their device-kT forms (kT a 0-d float32 on
     the card, at DEVICE_KTS) bitwise their host forms at CLOCK_STEPS,
     and the DPD sigma table from a device kT bitwise the float one;
     then pure SRD and the Poiseuille slit on the SRD advance graphs in
     turns of ADVANCE_GRAPH_STEPS (eager, graph, graph, eager): the
     streams and their anchors bitwise, eager == eager == graph, K5 and K10
     exactly once a collision in every turn;
   - the evaporating droplet (BASELINE config 5, 20,239 particles: a
     two-type PLJ liquid inside a shrinking SphereArea barrier, an LJ93
     wall, a ParticleEvaporator firing every 25 steps, Langevin in a
     parabolic flow), on the CUDA graphs (its pick through K4 at the pick
     every step, reading the trigger on the card), then [pick] on its
     state: K4 at the pick (csrc/pick.cu, two launches) bitwise
     the plain pick over PICK_TIMESTEPS timesteps with the trigger's flag
     set, unset and absent, for k of 1, 10, PICK_BINS + 1, the candidates'
     count less one, their count and the slot count, and in a tie case
     (PICK_TIE: a word of 0xFFFFFFFF on two candidates); timed fired and
     unfired against the plain pick, torch.topk(k=10) over the slots' keys
     and its bound;
   - a short run of every other isotropic potential;
   - colloid hydrodynamics (the JAX package's bench, bench.py:510-569):
     2,744 WCA colloids of mass 5 in a 163,840-particle SRD solvent driven
     by a body force, coupled through the joint collision every 20 steps,
     warmed for 260 steps (the tune at step 150), then 400 timed steps, and
     [profile] 40 more under Simulation.profile (two joint collisions); two
     identical 60-step runs must agree bit for bit (the cell sums are K10's);
   - the SRD Poiseuille slit (examples/mpcd_poiseuille.py at full size:
     40,000 solvent between no-slip plates, 3,000 steps, the profile read
     with CartesianVelocityFieldCompute over 16 bins), its SRD advance on
     the advance graphs (a collision a replay, its keys and shift from the
     card's clock), which must replay;
   - pure SRD throughput (bench.py:470-507): 262,144 solvent, a collision
     every step, 500 steps, on the advance graphs too;
   - [examples] the port's nine examples (azplugins_tpu_torch/examples/)
     in their smoke mode (AZTPU_EXAMPLE_FAST=1), main(device="cuda"), each
     in a directory of its own inside the checkout, removed afterwards;
   and checks that every pair-force evaluation went through a kernel, that
   every step of the timed steps went through the integrator kernels
   exactly (K8 once a step a method a shard; step1 once a step a method a
   shard, the last method's on a grid path as K7+K6 in one launch, the
   others and those of a path without a grid as K7; K6 alone once a step
   for the verdict on shards; K9 twice a step a method with rotation;
   Langevin's draw inside K8 and K9), that every other random draw did too (the
   evaporator's pick through K4 at the pick at least once a fire: once a
   step under the graphs, where it runs masked, on shards through K4;
   thermalize once a setup; the MPCD collision's K5 exactly once a
   collision, its clock form on the advance graphs, and K10 exactly once a
   collision), and that the result is physical; on each
   full-size path the capacity tune fires at step 200, and the path prints the capacity and rebuild
   interval before and after it and the device-busy time a step in the 20
   steps before it and after the timed steps; after the headline, the DPD
   fluid, the patchy colloids and the droplet, times their kernel on the
   path's state at two capacities, in two turns (72 and 48; 40 and the
   smallest that fits; 16 and 32; the droplet's before and after the
   tune), and K1 at the droplet's state (K1' at the colloids') against its
   plain version and bound; the colloid path also times one joint collision;
6. [integrate], on the headline's, the patchy colloids' and the droplet's
   states after their runs: the integrator and drift-check kernels of
   csrc/integrate.cu (K6-K9) against their plain versions on the card,
   bitwise (K9 within NO_SQUISH_ULP ulp, its worst printed): the path's
   method and ConstantVolume, a noiseless Langevin and one under a Type
   filter (the droplet: its LangevinFlow's flow field under a Type filter),
   step1 and step2 (step2 also in its clock form), the patchy state also
   with frozen axes; K6 on each
   layout with the violation flag clear and set, and at the headline on a
   NaN drift, an exact tie at the maximum and 4 shards; K7+K6 in one
   launch (step1 with the drift check, the grid paths' step1) against K7
   then K6 and against the plain step1 then the plain check, the verdict
   with the flag clear and set and the top two, on every state and
   method, at the headline also on a NaN drift and 4 shards; each
   kernel's ms against its plain ms and its bound (K6-K8 at the
   headline's slots, K8 with the droplet's flow, K9 at the patchy
   colloids'; K7, K6 and K7+K6 on all three states, K7+K6 beside K7 + K6);
7. prints the kernel summary and, last, the contract line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the result lines.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# kernel bar: per-slot values within atol = BAR * max|ref| and rtol = BAR
BAR = 2e-5
HEADLINE = dict(N_side=40, rho=0.85, seed=12345)
MODES = ("none", "shift", "xplor")
PAIR_REPLACES = "azplugins_tpu/ops/dense.py:1384"  # _pallas_half_pair_force
DPD_REPLACES = "azplugins_tpu/ops/dense.py:1552"  # _pallas_half_dpd_force
ANISO_REPLACES = "azplugins_tpu/ops/dense.py:1914"  # _pallas_half_aniso_force
# the random-draw kernels replace no pallas_call: the reference's draws are
# jnp code that XLA fuses into its step
RNG_BITS_REPLACES = ("azplugins_tpu/core/rng.py:133 (particle_bits; particle_uniform3 :146), "
                     "XLA-fused, no pallas_call")
RNG_NORMAL_REPLACES = ("azplugins_tpu/mpcd.py:314, 323-326 (jax.random.normal, the axes' "
                       "normalisation), XLA-fused, no pallas_call")
PICK_REPLACES = ("azplugins_tpu/update.py:139-172 (ParticleEvaporator._update: particle_bits "
                 "and lax.top_k), XLA-fused, no pallas_call")
RNG_CLOCK_REPLACES = ("azplugins_tpu/mpcd.py:239-248, 314, 323-326 (the collision's fold_in, "
                      "split and grid shift, jax.random.normal and the axes' normalisation), "
                      "XLA-fused, no pallas_call")
CELLSUM_REPLACES = ("azplugins_tpu/mpcd.py:267-273 (the collision's payload and scatter-add "
                    ".at[cid].add), XLA-fused, no pallas_call")
PATCHY = dict(M_d=1.5, M_r=0.05, r_eq=1.0, omega=20.0, alpha=0.4, repulsion=True)
# the patchy path's warm-up steps and its kT band (PERF.md: the kT curve)
PATCHY_WARM = 8000
PATCHY_KT_BAND = 0.01
# the step at which every path's capacity tune fires (Simulation's default)
TUNE_AT = 200
# the droplet (bench.py build_droplet): 20,239 particles; an evaporator
# firing after steps 0, 25, 50, ... retypes 10 each time, so after 3,000
# steps exactly 1,200 are of type "evaporated"; their kinetic temperature
# relative to the flow must read 1.0 within DROPLET_KT_BAND (4 sigma of a
# 5-sample mean over 1,200 x 3 degrees of freedom); no solvent particle
# lies more than DROPLET_OVERSHOOT beyond the barrier (thermal overshoot
# sqrt(kT / k) = 0.14)
DROPLET_N = 20_239
DROPLET_EVAP_PER_FIRING = 10
DROPLET_PERIOD = 25
DROPLET_KT_BAND = 0.1
DROPLET_OVERSHOOT = 1.0
# colloid hydrodynamics (bench.py bench_mpcd_coupled): the tune fires at
# step 150, 260 warm-up steps (13 collisions), 400 timed; the solvent's kT
# relative to its mean velocity within COLLOID_KT_BAND of 1 (the thermostat
# sets each cell's relative kinetic energy); total momentum within
# COLLOID_P_BAND * m_s N_s of the body force's impulse
COLLOID_TUNE_AT = 150
COLLOID_WARM = 260
COLLOID_STEPS = 400
COLLOID_KT_BAND = 0.03
COLLOID_P_BAND = 1e-4
# the Poiseuille slit (examples/mpcd_poiseuille.py) and pure SRD (bench.py
# bench_mpcd): steps and limits
POISEUILLE_STEPS = 3000
POISEUILLE_BINS = 16
SRD_WARM = 50
SRD_STEPS = 430
SRD_KT_BAND = 0.02
# the headline with writers (the [io] phase): a Table every 100 steps, a
# Trajectory and a GSD every 250, over 1,000 steps that end on a frame; the
# Table's kT within IO_KT_BAND of 1; ms/step with and without the writers
# in IO_TURNS alternating turns of IO_TURN_STEPS; three restarts of
# IO_RESTART_STEPS from the last frame (two from a checkpoint, one from the
# GSD file)
IO_STEPS = 1000
IO_TABLE_PERIOD = 100
IO_FRAME_PERIOD = 250
IO_KT_BAND = 0.05
IO_TURNS = 6
IO_TURN_STEPS = 400
IO_RESTART_STEPS = 200
# [spatial]: the headline in 4 slabs (Dx = 12: 3 x planes a block) and 16
# strips of 9 z columns, two stretches each, against the whole run; as views
# of one slot axis, then as shards of their own
SPATIAL_MESHES = (4, 16)
SPATIAL_STRETCH = 300
# [profile]: the headline's steps under Simulation.profile (the colloids
# run two collision periods)
PROFILE_STEPS = 20
# [spatial_ops]: the droplet, the polymer melt and colloid hydrodynamics,
# whole and on SPATIAL_OPS_SHARDS shards, two stretches each in turns (the
# colloids one: they are held to their limits, not to the whole run)
SPATIAL_OPS_SHARDS = 4
SPATIAL_OPS_STRETCH = {"droplet": 600, "polymer": 300, "colloid": 400}
# a joint collision on shards against the whole one, of max|v|: the
# reference's ~1e-7 relative a collision (the blocks' partial sums regrouped)
SPATIAL_OPS_COLLISION_BAR = 1e-6
# [rng]: the tag counts K4 is held at (64k particles; the headline's 12^3
# slots of cap 48; the droplet's particle count, not a multiple of the
# block), the headline's slots it is timed at, and the MPCD paths' collision
# grids [C, 3] K5 is held and timed at (colloid L 32, Poiseuille 16^2 x (16
# + 1 wall cell), pure SRD 64^3; each path checks its own)
RNG_TAGS = (64_000, 82_944, DROPLET_N)
HEADLINE_SLOTS = 82_944
NORMAL_SHAPES = {"colloid": (32**3, 3), "poiseuille": (16 * 16 * 17, 3), "srd": (64**3, 3)}
NORMAL_ULP = 1
# [pick]: the timesteps K4 at the pick is held at, and one k above the
# select's radix histogram of 2048 bins (csrc/pick.cu kBins); PICK_TIE
# is a (seed, timestep, tag) whose evaporator word is 0xFFFFFFFF (found by
# hashing every int32 tag at the keys of seeds 3 and 7, timesteps 0-3)
PICK_TIMESTEPS = 120
PICK_BINS = 2048
PICK_TIE = (7, 3, 1853371083)

# [integrate]: what K6-K9 (csrc/integrate.cu) replace: no pallas_call, jnp
# code that XLA fuses into the reference's step
INTEGRATE_REPLACES = {
    "drift_check": "azplugins_tpu/ops/dense.py:666 (needs_rebin), XLA-fused, no pallas_call",
    "step1": "azplugins_tpu/md/methods.py:68 (Method.step1), XLA-fused, no pallas_call",
    "step1_drift": ("azplugins_tpu/md/methods.py:68 (Method.step1) then "
                    "azplugins_tpu/ops/dense.py:666 (needs_rebin), one step body "
                    "(azplugins_tpu/simulation.py:641-652), XLA-fused, no pallas_call"),
    "step2": ("azplugins_tpu/md/methods.py:172 (LangevinFlow.step2; Method.step2 :79), "
              "XLA-fused, no pallas_call"),
    "no_squish": ("azplugins_tpu/md/rotation.py:89-146 (angmom_kick, free_rotation; "
                  "md/methods.py:94, 106, 194), XLA-fused, no pallas_call"),
}
# K9's bar in ulp against its plain version (K6-K8 are held bitwise)
NO_SQUISH_ULP = 0
# [cellsum]: the collision's cell sums (K10) held bitwise to the plain
# ordered sum at the MPCD paths' shapes: pure SRD (64^3 rows and cells),
# the colloids' (163,840 solvent and 21^3 cells of 8 dense slots, 2,744 of
# them colloids of mass 5, the rest empty and trashed; 32^3 cells) and the
# Poiseuille slit's (40,000 rows, 16^2 x 17 cells), and one deep cell
# (the first CELLSUM_DEEP of those rows in one cell); K5's clock form held bitwise to
# its host-key form and the host's shift at CLOCK_STEPS, cell sizes 1.0 and
# 0.75, the shift on and off, one key and two
CELLSUM_DEEP = 5000
CELLSUM_CELL_SIZES = (1.0, 0.75)
# [graph]'s MPCD-only turns: pure SRD and the Poiseuille slit on the SRD
# advance graphs against the eager advance, warm-up and turns of these steps
ADVANCE_GRAPH_STEPS = {"srd": 200, "poiseuille": 500}
# [graph]: turns of GRAPH_STEPS steps, eager against CUDA graphs, compared
# on GRAPH_FIELDS; the graph turns replay at least GRAPH_LEAST_REPLAYS
# segments; the clock forms are checked at CLOCK_STEPS
GRAPH_STEPS = 600
GRAPH_FIELDS = ("position", "velocity", "net_force", "orientation", "angmom", "typeid")
GRAPH_LEAST_REPLAYS = 20
CLOCK_STEPS = (0, 7, 2**32 - 1, 2**32 + 5)
# [graph]'s small Ramp-kT case: the headline's liquid at RAMP_SIDE^3, kT
# ramped over the phase's steps; K8 and K9 in their device-kT form checked
# against their host form at these kT (and CLOCK_STEPS)
RAMP_SIDE = 16
RAMP_KT = (1.2, 0.9)
DEVICE_KTS = (0.3, 1.0, 1.2345678)
# float32 operations a slot, each libm call (cos, sin), divide and sqrt as
# one, counted from the plain versions' formulas: K7 4 a component; K8 NVE
# 3 a component, noiseless Langevin 9 a component, noisy 9 a component + 4
# for the noise scale + 9 for the uniforms (a flow field 1 more a
# component); K9 mode 0 the kick (rotate_inv 27, the product 16, the add
# 8) and five axis rotations (the dot 11, 4 for the angle, cos and sin, 16
# for q and p) and the norm (12); K6 8 a slot; K7+K6 K7's 12 and K6's 8.
INTEGRATE_F32_OPS = {"drift_check": 8, "step1": 12, "step1_drift": 20, "step2[nve]": 9,
                     "step2[noiseless]": 27, "step2": 40, "no_squish[step1]": 233,
                     "no_squish[langevin]": 140}

# The least time the card could take for a kernel's work, for the bound:
# H100 SXM HBM3 at 3.35 TB/s, and its float32 rate outside the tensor cores,
# 67 TFLOP/s (NVIDIA's data sheet, at the 700 W limit).
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Integer work has no data-sheet rate. Its bound takes two limits of the
# Hopper SM (NVIDIA's white paper) at 132 SMs and the 1.98 GHz boost clock:
# shifts and logic operations run on the ALU pipe, 64 lanes an SM; and every
# instruction takes an issue slot, 4 schedulers x 32 lanes = 128 an SM a
# clock (integer adds go to the 128-lane FMA pipe as IMAD.IADD or IADD3,
# float32 operations too). The pipes run at once, so a draw's bound is the
# largest of these times and the float32 one, never their sum.
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_OPS_PER_S = 64 * SM_CLOCKS_PER_S
ISSUE_OPS_PER_S = 128 * SM_CLOCKS_PER_S
# A Threefry-2x32 round needs an add, a funnel shift (the rotate) and a
# xor, two of them on the ALU pipe; the key injections and the counter adds
# are left out (IADD3 fuses them with the rounds' adds, or they are uniform
# over the launch), so the count is at most what the card must issue. A
# uniform adds a shift and an or (ALU) and 3 float32 operations; a normal
# adds a xor, a shift and an or (ALU) and ~30 float32 operations (the
# uniform's 4, -x^2 and its log1p, the branch, 8 Horner steps of 2, the
# products), each log1p and sqrt counted as one.
THREEFRY_ROUND_ALU, THREEFRY_ROUND_OPS = 2, 3
NORMAL_F32_OPS = 30
# the axis form adds, a row of 3, three squares, two adds, the square root,
# the clamp and three divides: 10 a row, 10 / 3 a normal of the axes (the
# two-key form's 6 normals a row share the row's 10)
NORMAL_AXIS_ROW_OPS = 10
NORMAL_AXIS_F32_OPS = NORMAL_F32_OPS + NORMAL_AXIS_ROW_OPS / 3
# Operations of one pair evaluation on the force path (want="force"),
# counted from the plain version's formulas with each exp, sqrt, divide,
# pow and log as one: the evaluator, plus the geometry and the
# accumulation that every pair needs (3 subtractions and 5 operations for
# the separation and its square, the cutoff compare, 3 products for the
# force and 3 additions into each member's sums: 18). DPD adds its 13-round
# Threefry (~76 int32 operations, counted at the float32 rate) and the drag;
# TwoPatchMorse its two patch rotations, three exps and the torques, and 6
# more additions for them.
OPS_PER_PAIR = {
    "PerturbedLennardJones": 29, "LJ": 27, "Colloid": 33, "ExpandedYukawa": 31,
    "Hertz": 31, "Morse": 32, "Gaussian": 23, "Yukawa": 28, "DPD": 130, "TwoPatchMorse": 170,
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _import_port():
    sys.path.insert(0, str(HERE))
    import azplugins_tpu_torch as az

    if not Path(az.__file__).resolve().is_relative_to(HERE):
        raise RuntimeError(f"azplugins_tpu_torch imported from {az.__file__}, not this checkout")
    return az


def _cuda_time_ms(fn, reps: int, warm: int = 2) -> float:
    """Device ms per call: CUDA events around ``reps`` calls, queued while
    the stream spins (torch.cuda._sleep), so the calls run back to back and
    the host's launch overhead (tens of us a call) is not timed."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of the card's clock, longer than the queueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _replay_time_ms(fn, reps: int, replays: int = 5, warm: int = 2) -> float:
    """Device ms per call inside a CUDA graph: ``reps`` calls captured into
    one graph (their outputs from the graph's pool), replayed once to warm
    up, then ``replays`` times between CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _lattice_snapshot(az, counts, rho, jitter, seed, tilt=(0.0, 0.0, 0.0), n_types=1,
                      clustered=False, quats=False, span=1.0):
    """A jittered simple-cubic lattice of counts[0] x counts[1] x counts[2]
    sites at number density rho, filling ``span`` of each edge of a box of
    that shape from its corner (optionally tilted, optionally squeezed along
    x into uneven cell occupancies), with normal(0, 1) velocities (and, with
    ``quats``, random unit orientations)."""
    rng = np.random.default_rng(seed)
    N = int(np.prod(counts))
    a = (1.0 / rho) ** (1.0 / 3.0)
    Ls = [c * a / span for c in counts]
    snap = az.Snapshot(N=N)
    snap.configuration.box = [*Ls, *tilt]
    snap.particles.types = (["A", "B", "C", "D"] + [f"t{i}" for i in range(4, n_types)])[:n_types]
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in counts], indexing="ij"), -1)
    f = span * (grid.reshape(-1, 3) + 0.5) / np.asarray(counts)
    if clustered:
        # periodic squeeze: sites crowd (spacing x0.7) around x = -L/2
        f[:, 0] = f[:, 0] - 0.3 * np.sin(2.0 * np.pi * f[:, 0]) / (2.0 * np.pi)
    h = np.array([[Ls[0], tilt[0] * Ls[1], tilt[1] * Ls[2]],
                  [0.0, Ls[1], tilt[2] * Ls[2]],
                  [0.0, 0.0, Ls[2]]])
    snap.particles.position[:] = (f - 0.5) @ h.T + rng.normal(0.0, jitter, (N, 3))
    snap.particles.velocity[:] = rng.normal(0.0, 1.0, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, n_types, N)
    if quats:
        q = rng.normal(size=(N, 4))
        snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return snap


def _dense_case(az, D, snap, r_cut, buffer, device, cap=None, fields=()):
    """Densify, growing the capacity from ``cap`` (default: the grid's own)
    until the configuration fits, as the simulation does on overflow."""
    state, types, _ = az.core.state_from_snapshot(snap, device)
    spec = D.GridSpec.create(state.box, state.N, r_cut, buffer)
    if cap is not None:
        spec = spec.replace(cap=cap)
    dense, meta = D.densify(state, spec, fields=fields)
    while bool(meta.overflow):
        spec = spec.replace(cap=int(np.ceil((int(meta.max_occ) + 1) / 8.0) * 8))
        dense, meta = D.densify(state, spec, fields=fields)
    return dense, spec, len(types)


def _pairs_inside(D, dense, spec, r_cut):
    """Unordered pairs within ``r_cut`` on this dense state (one type pair),
    counted by the plain stencil loop: the pair work a kernel must do."""

    def count(dx, dy, dz, rsq, mask, j, newton):
        inside = (mask & (rsq > 0) & (rsq < r_cut * r_cut)).to(torch.float32)
        return [inside], [torch.zeros_like(inside)]

    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    (n,) = D._stencil_drive(dense, jb, spec, 1, count)
    total = float(n.double().sum())
    return int(round(total if spec.newton_ok else total / 2))


def _stencil_occupancy(dense, spec):
    """([Dx, Dy, Dz] occupied slots of each cell, of each cell's stencil)."""
    occ = (dense.tag >= 0).reshape(*spec.dims, spec.cap).sum(dim=-1).double()
    around = sum(torch.roll(occ, shifts=tuple(-int(o) for o in off), dims=(0, 1, 2))
                 for off in spec.stencil())
    return occ, around


def _candidates(dense, spec):
    """Candidate pairs a packed-schedule call tests: the sum over cells of
    n_i times the occupied slots of the cell's stencil (its own included)."""
    occ, around = _stencil_occupancy(dense, spec)
    return int((occ * around).sum())


def _check_packed_shapes(stage_entries, cases, threads=0):
    """Each packed-schedule shape is the case it is named for. stage_entries:
    the candidates one staging round of the kernel holds; threads: its
    block's threads."""
    for label, dense, spec, T, *_ in cases:
        occ, around = _stencil_occupancy(dense, spec)
        ok = {
            "full cells": lambda: bool((occ == spec.cap).all()),
            "mostly empty": lambda: float((occ == 0).double().mean()) > 0.75,
            "cap >= 256 in rounds": lambda: spec.cap >= 256 and float(around.max()) > stage_entries,
            "cap 64 in rounds": lambda: spec.cap == 64 and float(around.max()) > stage_entries,
            "cells above kThreads": lambda: spec.newton_ok and float(occ.max()) > threads > 0,
            "two axes under 3": lambda: sorted(spec.dims)[1] < 3,
            "41 types": lambda: T == 41,
        }.get(label, lambda: True)()
        if not ok:
            raise AssertionError(f"{label}: dims {spec.dims}, cap {spec.cap}, T {T} is not the "
                                 "shape it is named for")


def _stage_bytes() -> int:
    """The packed schedule's staging buffer per block (cell_stencil.cuh's
    kStageBytes): a stencil with more candidates is staged in rounds."""
    header = (HERE / "azplugins_tpu_torch" / "csrc" / "cell_stencil.cuh").read_text()
    return int(re.search(r"kStageBytes = (\d+) \* 1024;", header).group(1)) * 1024


def _source_constant(source: str, name: str) -> int:
    """A ``constexpr int name = n;`` of one kernel source under csrc/."""
    text = (HERE / "azplugins_tpu_torch" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _same_bits(name, first, second):
    """Two launches' outputs (ForceResult) bit for bit."""
    for what in ("force", "torque", "energy", "virial"):
        a, b = getattr(first, what), getattr(second, what)
        if a is None and b is None:
            continue
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name}: two launches on the same input differ in {what}")


def _bound(dense, in_bytes, out_bytes, table_bytes, pairs, ops_per_pair):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the pair operations over the float32 rate. The bytes are what the
    function must move: ``in_bytes`` of inputs for each occupied slot only
    (an empty slot's position, type or orientation is never read), the
    4-byte tag of every slot (which marks the occupied ones), ``out_bytes``
    of outputs for every slot, and the tables, each once."""
    S, N = dense.tag.numel(), int((dense.tag >= 0).sum())
    t_bytes = (N * in_bytes + S * (4 + out_bytes) + table_bytes) / MEM_BYTES_PER_S
    t_ops = pairs * ops_per_pair / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def potential_params(name: str, T: int, rng) -> dict:
    """User parameters per type pair at which lattice pairs (r ~ 0.7-3)
    give finite, non-trivial forces (the same ranges as
    tests/test_torch_kernels.py). Colloid radii are 0 under three types."""

    def sym(lo, hi):
        m = rng.uniform(lo, hi, (T, T))
        return (m + m.T) / 2

    if name == "Colloid":
        rad = np.zeros(T) if T < 3 else np.array([0.0, 0.15, 0.25] + [0.0] * (T - 3))
        ii, jj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
        return {"A": sym(1.0, 3.0), "a_1": rad[np.minimum(ii, jj)],
                "a_2": rad[np.maximum(ii, jj)], "sigma": sym(0.8, 1.0)}
    ranges = {
        "PerturbedLennardJones": {"epsilon": (0.5, 1.5), "sigma": (0.85, 1.05),
                                  "attraction_scale_factor": (0.0, 1.0)},
        "LJ": {"epsilon": (0.5, 1.5), "sigma": (0.85, 1.0)},
        "ExpandedYukawa": {"epsilon": (1.0, 2.0), "kappa": (1.0, 2.0), "delta": (0.3, 0.5)},
        "Hertz": {"epsilon": (1.0, 5.0)},
        "Morse": {"D0": (0.5, 1.5), "alpha": (1.5, 2.5), "r0": (0.9, 1.2)},
        "Gaussian": {"epsilon": (1.0, 2.0), "sigma": (0.4, 0.8)},
        "Yukawa": {"epsilon": (1.0, 2.0), "kappa": (0.5, 1.5)},
    }[name]
    return {k: sym(*lohi) for k, lohi in ranges.items()}


def _pair_tables(az, potential, T, seed, r_cut, device):
    """Device tables of one potential: params, r_cut (one pair at 0.8 r_cut
    where T > 1) and r_on (0.75 r_cut; one pair at 1.1 r_cut, where xplor
    shifts plainly)."""
    rng = np.random.default_rng(seed)
    if potential == "PerturbedLennardJones" and T == 1:
        host = {"epsilon": np.ones((1, 1)), "sigma": np.ones((1, 1)),
                "attraction_scale_factor": np.full((1, 1), 0.5)}
    else:
        host = potential_params(potential, T, rng)
    pre = az.ops.evaluators.PAIR_POTENTIALS[potential].precompute(host)
    rc = np.full((T, T), r_cut, np.float32)
    rc[0, -1] = rc[-1, 0] = r_cut * 0.8 if T > 1 else r_cut
    r_on = (0.75 * rc).astype(np.float32)
    if T > 1:
        r_on[-1, -1] = 1.1 * rc[-1, -1]

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"params": {k: dev(v) for k, v in pre.items()}, "r_cut": dev(rc), "r_on": dev(r_on)}


def _compare(name, got, ref):
    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    bound = BAR * scale + BAR * ref.abs()
    worst = float((err - bound).max())
    max_err = float(err.max())
    if not torch.isfinite(got).all() or worst > 0:
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {max_err:.3e}, scale {scale:.3e})")
    return max_err, scale


def _compare_result(tag, got, ref, want):
    """Force (and energy and virial for want="all") within the bar. Returns
    the force's max abs error and the worst error relative to its output's
    max |value| over the outputs compared."""
    outputs = [("force", got.force, ref.force)]
    if want == "all":
        outputs += [("energy", got.energy, ref.energy), ("virial", got.virial, ref.virial)]
    errs = [_compare(f"{tag} {what}", g, r) for what, g, r in outputs]
    return errs[0][0], max(err / max(scale, 1e-30) for err, scale in errs)


# ---------------------------------------------------------------------------
# The full-size configurations, through the public API
# ---------------------------------------------------------------------------
def build_headline(az, device, snapshot=None, N_side=HEADLINE["N_side"]):
    """BASELINE config 1, the bench headline: 64k PLJ under Langevin. With
    ``snapshot`` (a restart) the state is taken from it as it is."""
    rho, seed = HEADLINE["rho"], HEADLINE["seed"]
    sim = az.Simulation(device=device, seed=seed)
    if snapshot is not None:
        sim.create_state_from_snapshot(snapshot)
        return sim, _headline_forces(az, sim)
    N = N_side**3
    L = (N / rho) ** (1.0 / 3.0)
    a = L / N_side
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(N_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim.create_state_from_snapshot(snap)
    forces = _headline_forces(az, sim)
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, forces


def _headline_forces(az, sim):
    lj = az.pair.PerturbedLennardJones(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=3.0, mode="none"
    )
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    lang = az.md.methods.Langevin(kT=1.0, default_gamma=0.1)
    sim.operations.integrator = az.md.Integrator(dt=0.005, methods=[lang], forces=[lj])
    return [lj]


def build_dpd(az, device, n_side=28, rho=3.0, seed=5):
    """BASELINE config 3 (bench.py build_dpd_fluid): 28^3 DPD fluid at rho 3,
    A 25, gamma 4.5, s 0.5, r_cut 1, kT 1, ConstantVolume, dt 0.01, from a
    lattice at rest."""
    N = n_side**3
    L = (N / rho) ** (1.0 / 3.0)
    a = L / n_side
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    dpd = az.pair.DPDGeneralWeight(nlist=az.md.nlist.Cell(buffer=0.4), kT=1.0,
                                   default_r_cut=1.0)
    dpd.params[("A", "A")] = dict(A=25.0, gamma=4.5, s=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.01, methods=[az.md.methods.ConstantVolume()], forces=[dpd])
    return sim, [dpd]


def build_polymer(az, device, n_chains=1280, chain_len=25, rho=0.5, seed=14):
    """BASELINE config 2 (bench.py build_polymer_melt): 1,280 straight rods
    of 25 beads at rho 0.5, Quartic scissile bonds + ExpandedYukawa pairs
    (epsilon 2, kappa 1.5, delta 0.5, r_cut 2.5), Langevin kT 1, gamma 0.5,
    dt 0.002."""
    N = n_chains * chain_len
    L = (N / rho) ** (1.0 / 3.0)
    snap = az.Snapshot(N=N, bond_N=n_chains * (chain_len - 1))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.bonds.types = ["backbone"]
    gy = int(np.floor(np.sqrt(n_chains)))
    gz = (n_chains + gy - 1) // gy
    c = np.arange(n_chains)
    y = ((c % gy) + 0.5) * L / gy - L / 2
    z = ((c // gy) + 0.5) * L / gz - L / 2
    x = -0.97 * (chain_len - 1) / 2 + 0.97 * np.arange(chain_len)
    pos = np.zeros((n_chains, chain_len, 3))
    pos[:, :, 0] = x[None, :]
    pos[:, :, 1] = y[:, None]
    pos[:, :, 2] = z[:, None]
    snap.particles.position[:] = pos.reshape(-1, 3)
    first = (c[:, None] * chain_len + np.arange(chain_len - 1)[None, :]).reshape(-1)
    snap.bonds.typeid[:] = 0
    snap.bonds.group[:] = np.stack([first, first + 1], axis=-1)
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    bonds = az.bond.Quartic()
    bonds.params["backbone"] = dict(k=1434.3, r_0=1.5, b_1=-0.7589, b_2=0.0, U_0=67.2234,
                                    sigma=1.0, epsilon=1.0, delta=0.0)
    pairs = az.pair.ExpandedYukawa(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    pairs.params[("A", "A")] = dict(epsilon=2.0, kappa=1.5, delta=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[bonds, pairs])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, [bonds, pairs]


def build_patchy(az, device, n_side=30, a=1.5, seed=2):
    """BASELINE config 4 (bench.py build_patchy): 30^3 patchy colloids on a
    lattice of spacing 1.5 with random unit quaternions, moment of inertia
    0.4, TwoPatchMorse (M_d 1.5, M_r 0.05, r_eq 1, omega 20, alpha 0.4,
    repulsion, r_cut 1.6, mode shift, buffer 0.3), Langevin kT 0.3, gamma 1
    (gamma_r 1), dt 0.002, rotational DOF integrated."""
    N = n_side**3
    L = n_side * a
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["P"]
    x = (np.arange(n_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.moment_inertia[:] = [0.4, 0.4, 0.4]
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    patchy = az.pair.TwoPatchMorse(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.6,
                                   mode="shift")
    patchy.params[("P", "P")] = dict(PATCHY)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=0.3, default_gamma=1.0)], forces=[patchy],
        integrate_rotational_dof=True)
    sim.state.thermalize_particle_momenta(kT=0.3)
    return sim, [patchy]


def build_droplet(az, device, R0=20.0, a=1.1, seed=7):
    """BASELINE config 5 (bench.py build_droplet): a lattice droplet of
    radius 0.93 R0 in a box of 2 R0 + 4; PLJ solvent (epsilon 1, sigma 1,
    lambda 1, r_cut 2.5, buffer 0.4), an "evaporated" type that interacts
    with nothing (epsilon 0); a SphericalHarmonicBarrier (k 50) at
    SphereArea(R0, alpha 0.05); an LJ93 plane wall 0.5 above the box floor;
    a ParticleEvaporator retyping up to 10 solvent particles of the slab
    z in [R0/2, L/2) every 25 steps; LangevinFlow kT 1, gamma 1, in a
    parabolic flow of mean 0.5 across L - 2; dt 0.002."""
    L = 2 * R0 + 4.0
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    snap = az.Snapshot(N=len(pts))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pts
    sim = az.Simulation(device=device, seed=seed)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("solvent", "solvent")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0)
    lj.params[("solvent", "evaporated")] = dict(epsilon=0.0, sigma=1.0,
                                                attraction_scale_factor=0.0)
    lj.params[("evaporated", "evaporated")] = dict(epsilon=0.0, sigma=1.0,
                                                   attraction_scale_factor=0.0)
    barrier = az.external.SphericalHarmonicBarrier(
        location=az.variant.SphereArea(R0=R0, alpha=0.05))
    barrier.params["solvent"] = dict(k=50.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    wall = az.external.wall.LJ93(
        walls=[az.external.wall.Plane(origin=(0, 0, -L / 2 + 0.5), normal=(0, 0, 1))])
    wall.params["solvent"] = dict(epsilon=1.0, sigma=1.0, r_cut=3.0)
    wall.params["evaporated"] = dict(epsilon=0.0, sigma=1.0, r_cut=3.0)
    sim.operations.updaters.append(az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(DROPLET_PERIOD), solvent_type="solvent",
        evaporated_type="evaporated", lo=R0 / 2, hi=L / 2, N_evap_max=DROPLET_EVAP_PER_FIRING))
    flow = az.flow.ParabolicFlow(mean_velocity=0.5, separation=L - 2.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.LangevinFlow(kT=1.0, flow_field=flow, default_gamma=1.0)],
        forces=[lj, barrier, wall])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, [lj, barrier, wall]


def build_colloid(az, device, L=32.0, n=14):
    """Colloid hydrodynamics (bench.py bench_mpcd_coupled): n^3 = 2,744 LJ
    WCA colloids (epsilon 1, sigma 1, r_cut 2^(1/6), shift, buffer 0.4) of
    mass 5 on a lattice, at rest, in 5 L^3 = 163,840 SRD solvent particles
    (period 20, angle 130, kT 1, body force (0.02, 0, 0)) coupled through
    the joint collision; ConstantVolume, dt 0.005; rng seed 9, sim seed 11."""
    rng = np.random.default_rng(9)
    N_s = int(5 * L**3)
    N_c = n**3
    snap = az.Snapshot(N=N_c, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["colloid"]
    x = (np.arange(n) + 0.5) * (L / n) - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.mass[:] = 5.0
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    sim = az.Simulation(device=device, seed=11)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0 ** (1 / 6),
                    mode="shift")
    lj.params[("colloid", "colloid")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.ConstantVolume()], forces=[lj])
    srd = az.mpcd.SRD(dt=0.005, period=20, angle=130.0, cell_size=1.0, kT=1.0,
                      body_force=(0.02, 0.0, 0.0))
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    sim.auto_tune_after = COLLOID_TUNE_AT
    return sim, [lj]


def build_poiseuille(az, device, N=40_000, L=16.0):
    """examples/mpcd_poiseuille.py at full size: an SRD solvent between
    no-slip plates at z = +-L/2 (period 5, angle 130, kT 1, body force
    (0.03, 0, 0)), two idle MD particles, ConstantVolume, dt 0.02."""
    rng = np.random.default_rng(12)
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray([L, L, 0.98 * L])
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = az.Simulation(device=device, seed=4)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
    sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0,
                                    body_force=(0.03, 0.0, 0.0), plates=("z", L))
    return sim


def build_srd(az, device, n=64):
    """Pure SRD throughput (bench.py bench_mpcd): n^3 = 262,144 solvent at
    one particle a cell, a collision every step (period 1, kT 1), two idle
    MD particles, dt 0.02."""
    rng = np.random.default_rng(3)
    N, L = n**3, float(n)
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = az.Simulation(device=device, seed=5)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[])
    sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, period=1, cell_size=1.0, kT=1.0)
    return sim


def _prepared_dense(sim):
    """The main path's dense state and grid, as its first step sees them."""
    sim.run(0)
    torch.cuda.synchronize()
    return sim._dense, sim._grid_spec


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------
def check_pair_kernel(az, D, PK, record):
    """Every potential, mode and want at every listed shape; times each
    potential at the polymer melt's full size (the 64k headline for PLJ)."""
    dev = torch.device("cuda")
    shapes = [
        ("small orthorhombic", dict(counts=(14, 14, 14), rho=0.85, jitter=0.06, seed=1), 2.5),
        ("tilted", dict(counts=(14, 14, 14), rho=0.8, jitter=0.06, seed=2,
                        tilt=(0.35, -0.2, 0.15)), 2.5),
        ("axis under 3 cells", dict(counts=(5, 16, 16), rho=0.85, jitter=0.06, seed=5), 2.5),
        ("two types", dict(counts=(12, 12, 12), rho=0.85, jitter=0.06, seed=4, n_types=2),
         2.0),
        ("three types uneven", dict(counts=(16, 14, 14), rho=0.6, jitter=0.03, seed=3,
                                     n_types=3, clustered=True), 2.0, 16),
        # the packed schedule's own shapes: 12^3 cells of exactly 8 at cap 8;
        # a cluster in 0.4 of each edge (most cells empty); 4^3 cells of
        # ~244 at cap ~296, staged in rounds; two axes under 3 cells; 41
        # types, whose tables are read from global memory
        ("full cells", dict(counts=(24, 24, 24), rho=0.85, jitter=0.04, seed=7, n_types=2),
         1.6, 8),
        ("mostly empty", dict(counts=(12, 12, 12), rho=0.85, jitter=0.06, seed=8, n_types=2,
                              span=0.4), 2.0),
        ("cap >= 256 in rounds", dict(counts=(25, 25, 25), rho=0.85, jitter=0.06, seed=9,
                                      n_types=2), 6.0),
        ("two axes under 3", dict(counts=(5, 5, 20), rho=0.85, jitter=0.06, seed=12,
                                  n_types=2), 2.0),
        ("41 types", dict(counts=(14, 14, 14), rho=0.85, jitter=0.06, seed=13, n_types=41), 2.0),
    ]
    cases = []
    for label, kw, r_cut, *cap in shapes:
        dense, spec, T = _dense_case(az, D, _lattice_snapshot(az, **kw), r_cut, 0.4, dev, *cap)
        cases.append((label, dense, spec, T, r_cut))
    _check_packed_shapes(_stage_bytes() // 16, cases)
    poly_dense, poly_spec = _prepared_dense(build_polymer(az, dev)[0])
    cases.append(("polymer melt 32k", poly_dense, poly_spec, 1, 2.5))
    poly_pairs = _pairs_inside(D, poly_dense, poly_spec, 2.5)
    poly_candidates = _candidates(poly_dense, poly_spec)
    print(f"[kernel] polymer melt 32k cap {poly_spec.cap}: {poly_candidates} "
          f"candidate pairs per call, {poly_pairs} unordered pairs inside r_cut (each "
          f"evaluated from both sides)", flush=True)
    ef = az.ops.evaluators.PAIR_POTENTIALS

    timing = {}
    for pot in PK.KERNEL_POTENTIALS:
        n_checks, worst = 0, 0.0
        for label, dense, spec, T, r_cut in cases:
            tbl = _pair_tables(az, pot, T, 10 + T, r_cut, dev)
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
            for mode in MODES:
                tables = PK.kernel_tables(pot, tbl["params"], tbl["r_cut"], tbl["r_on"], mode)
                for want in ("force", "all"):
                    got = PK.cell_pair_force(dense, spec, tables, pot, mode, want)
                    ref = D.dense_pair_force(ef[pot].energy_force, dense, jb, spec,
                                             tbl["params"], tbl["r_cut"], tbl["r_on"], mode,
                                             want)
                    torch.cuda.synchronize()
                    tag = f"{pot} {label} dims={spec.dims} cap={spec.cap} T={T} {mode} {want}"
                    ferr, rel = _compare_result(tag, got, ref, want)
                    record(f"cell_pair_force[{pot}]", ferr)
                    n_checks, worst = n_checks + 1, max(worst, rel)
            if label.startswith("polymer"):
                tables = PK.kernel_tables(pot, tbl["params"], tbl["r_cut"], tbl["r_on"], "none")
                ms = _cuda_time_ms(lambda: PK.cell_pair_force(dense, spec, tables, pot, "none"), 30)
                plain_ms = _cuda_time_ms(
                    lambda: D.dense_pair_force(ef[pot].energy_force, dense, jb, spec,
                                               tbl["params"], tbl["r_cut"], None, "none",
                                               "force"), 3)
                # inputs: position 12 B, type 4 B; outputs: force 12 B
                bound = _bound(dense, 16, 12, 4 * tables.numel(), poly_pairs, OPS_PER_PAIR[pot])
                timing[pot] = (ms, plain_ms, f"polymer melt 32k, cap {spec.cap}", bound,
                               poly_candidates)
        print(f"[kernel] cell_pair_force[{pot}]: {n_checks} checks ({len(cases)} shapes: "
              f"{', '.join(c[0] for c in cases)}; modes {'/'.join(MODES)}; force/all), worst "
              f"error {worst:.3e} of max|value| (bar {BAR})", flush=True)

    # the 64k headline, the PLJ instantiation's own main-path shape
    dense, spec, _ = _dense_case(
        az, D, _lattice_snapshot(az, counts=(40, 40, 40), rho=0.85, jitter=0.05, seed=6), 3.0,
        0.4, dev)
    tbl = _pair_tables(az, "PerturbedLennardJones", 1, 11, 3.0, dev)
    jb = D.make_jblocks(dense, spec, half=True)
    tables = PK.kernel_tables("PerturbedLennardJones", tbl["params"], tbl["r_cut"])
    for want in ("force", "all"):
        got = PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "none", want)
        ref = D.dense_pair_force(ef["PerturbedLennardJones"].energy_force, dense, jb, spec,
                                 tbl["params"], tbl["r_cut"], None, "none", want)
        torch.cuda.synchronize()
        tag = f"PerturbedLennardJones 64k headline cap={spec.cap} none {want}"
        ferr, rel = _compare_result(tag, got, ref, want)
        record("cell_pair_force[PerturbedLennardJones]", ferr)
        print(f"[kernel] {tag}: force max_abs_err {ferr:.3e}, worst error {rel:.3e} of "
              f"max|value|", flush=True)
    _same_bits("cell_pair_force[PerturbedLennardJones] 64k headline",
               *[PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "none", "all")
                 for _ in range(2)])
    ms = _cuda_time_ms(
        lambda: PK.cell_pair_force(dense, spec, tables, "PerturbedLennardJones", "none"), 50)
    plain_ms = _cuda_time_ms(
        lambda: D.dense_pair_force(ef["PerturbedLennardJones"].energy_force, dense, jb, spec,
                                   tbl["params"], tbl["r_cut"], None, "none", "force"), 5)
    pairs = _pairs_inside(D, dense, spec, 3.0)
    candidates = _candidates(dense, spec)
    print(f"[kernel] PerturbedLennardJones 64k headline cap {spec.cap}: two launches give the "
          f"same bits; {candidates} candidate pairs per call, {pairs} unordered "
          f"pairs inside r_cut (each evaluated from both sides)", flush=True)
    bound = _bound(dense, 16, 12, 4 * tables.numel(), pairs,
                   OPS_PER_PAIR["PerturbedLennardJones"])
    timing["PerturbedLennardJones"] = (ms, plain_ms, f"64k headline, cap {spec.cap}", bound,
                                       candidates)
    for pot, (ms, plain_ms, where, (bound_ms, by), _) in timing.items():
        print(f"[kernel] cell_pair_force[{pot}] at {where}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms per call (force, mode none); bound {bound_ms:.5f} ms "
              f"({by})", flush=True)
    return timing


def check_dpd_kernel(az, D, DK, record):
    """The DPD kernel at every listed shape, force and all, with velocities
    and tags at and above 2**24 in the Threefry key; timed at full size."""
    dev = torch.device("cuda")
    shapes = [
        ("small orthorhombic", dict(counts=(18, 18, 18), rho=3.0, jitter=0.1, seed=21)),
        ("tilted", dict(counts=(18, 16, 16), rho=3.0, jitter=0.1, seed=22,
                        tilt=(0.3, -0.2, 0.15))),
        ("axis under 3 cells", dict(counts=(5, 20, 20), rho=3.0, jitter=0.1, seed=23)),
        ("two types", dict(counts=(16, 16, 16), rho=3.0, jitter=0.1, seed=24, n_types=2)),
        # the packed schedule's own shapes (see check_pair_kernel); the
        # rounds need a cutoff of 4 at rho 3: 3^3 cells of ~296
        ("full cells", dict(counts=(24, 24, 24), rho=2.9, jitter=0.03, seed=27, n_types=2), 1.0,
         8),
        ("mostly empty", dict(counts=(12, 12, 12), rho=3.0, jitter=0.1, seed=28, n_types=2,
                              span=0.4)),
        ("cap >= 256 in rounds", dict(counts=(20, 20, 20), rho=3.0, jitter=0.1, seed=29,
                                      n_types=2), 4.0),
        ("two axes under 3", dict(counts=(5, 5, 20), rho=3.0, jitter=0.1, seed=30, n_types=2)),
        ("41 types", dict(counts=(16, 16, 16), rho=3.0, jitter=0.1, seed=31, n_types=41)),
    ]
    cases = []
    for label, kw, *grid in shapes:
        r_cut, *cap = grid or [1.0]
        dense, spec, T = _dense_case(az, D, _lattice_snapshot(az, **kw), r_cut, 0.4, dev, *cap)
        cases.append((label, dense, spec, T, r_cut))
    _check_packed_shapes(_stage_bytes() // 32, cases)
    sim, _ = build_dpd(az, dev)
    dense, spec = _prepared_dense(sim)
    g = torch.Generator(device=dev).manual_seed(25)
    vel = torch.randn(dense.velocity.shape, generator=g, device=dev)
    dense = dense.replace(velocity=torch.where(dense.tag[:, None] >= 0, vel, 0.0))
    cases.append(("DPD fluid 22k", dense, spec, 1, 1.0))

    rng = np.random.default_rng(26)
    timing = None
    for label, dense, spec, T, r_cut in cases:
        A = rng.uniform(15.0, 30.0, (T, T))
        gamma = rng.uniform(3.0, 6.0, (T, T))
        s = rng.uniform(0.3, 2.0, (T, T))
        if label.startswith("DPD"):
            A, gamma, s = np.full((1, 1), 25.0), np.full((1, 1), 4.5), np.full((1, 1), 0.5)

        def dev_t(a):
            return torch.as_tensor(np.asarray((a + a.T) / 2, np.float32), device=dev)

        rc = np.full((T, T), r_cut)
        rc[0, -1] = rc[-1, 0] = 0.85 * r_cut if T > 1 else r_cut
        tbl = {"params": {"A": dev_t(A), "gamma": dev_t(gamma), "s": dev_t(s)},
               "r_cut": dev_t(rc)}
        jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_velocity=True, need_tag=True)
        worst = max_abs = 0.0
        for timestep in (777, 2**24 + 5):
            for want in ("force", "all"):
                got = DK.dpd_force(dense, spec, tbl, 1.0, 0.01, 5, timestep, want)
                ref = D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], 1.0, 0.01,
                                        5, timestep, want)
                torch.cuda.synchronize()
                tag = f"DPD {label} dims={spec.dims} cap={spec.cap} T={T} t={timestep} {want}"
                ferr, rel = _compare_result(tag, got, ref, want)
                record("cell_dpd_force", ferr)
                worst, max_abs = max(worst, rel), max(max_abs, ferr)
        print(f"[kernel] cell_dpd_force {label} dims={spec.dims} cap={spec.cap} T={T} "
              f"(timesteps 777 and 2**24+5, force/all): force max_abs_err {max_abs:.3e}, worst "
              f"error {worst:.3e} of max|value| (bar {BAR})", flush=True)
        if label.startswith("DPD"):
            tables = DK.dpd_kernel_tables(tbl["params"], tbl["r_cut"], 1.0, 0.01)
            _same_bits("cell_dpd_force DPD fluid 22k",
                       *[DK.cell_dpd_force(dense, spec, tables, 5, 777, "all") for _ in range(2)])
            ms = _cuda_time_ms(lambda: DK.cell_dpd_force(dense, spec, tables, 5, 777), 30)
            plain_ms = _cuda_time_ms(
                lambda: D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], 1.0,
                                          0.01, 5, 777, "force"), 3)
            # inputs: position and velocity 24 B, type 4 B; outputs: force 12 B
            pairs = _pairs_inside(D, dense, spec, 1.0)
            bound_ms, by = _bound(dense, 28, 12, 4 * tables.numel(), pairs, OPS_PER_PAIR["DPD"])
            candidates = _candidates(dense, spec)
            timing = (ms, plain_ms, f"DPD fluid 22k, cap {spec.cap}", (bound_ms, by), candidates)
            print(f"[kernel] cell_dpd_force at DPD fluid 22k cap {spec.cap}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms per call (force); bound {bound_ms:.5f} ms ({by}); "
                  f"two launches give the same bits; {candidates} candidate pairs "
                  f"per call, {pairs} unordered pairs inside r_cut (each evaluated from both "
                  f"sides)", flush=True)
    return timing


def _aniso_tables(az, T, seed, device):
    """TwoPatchMorse device tables: the patchy path's parameters for one
    type; for two, stiff random ones (M_r down to 0.05, omega up to 20) with
    a flat-bottom pair and a shorter per-pair cutoff."""
    if T == 1:
        host = {k: np.full((1, 1), float(v)) for k, v in PATCHY.items()}
        rc = np.full((1, 1), 1.6, np.float32)
    else:
        rng = np.random.default_rng(seed)

        def sym(lo, hi):
            m = rng.uniform(lo, hi, (T, T))
            return (m + m.T) / 2

        host = {"M_d": sym(1.0, 2.0), "M_r": sym(0.05, 0.15), "r_eq": sym(0.95, 1.1),
                "omega": sym(5.0, 20.0), "alpha": sym(0.3, 0.5), "repulsion": np.ones((T, T))}
        host["repulsion"][-1, -1] = 0.0
        rc = np.full((T, T), 1.6, np.float32)
        rc[0, -1] = rc[-1, 0] = 1.4
    pre = az.ops.evaluators.ANISO_PAIR_POTENTIALS["TwoPatchMorse"].precompute(host)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"params": {k: dev(v) for k, v in pre.items()}, "r_cut": dev(rc)}


def _newton_residual(force):
    """|sum of the per-slot forces| over their summed magnitudes: 0 up to
    the round-off of the per-slot sums when each pair's two contributions
    are exact negations."""
    f = force.double()
    return float(f.sum(0).abs().max() / f.abs().sum(0).max().clamp_min(1e-300))


def _compare_aniso(tag, got, ref, want):
    """Force, torque (and energy and virial for want="all"), each against
    the bar relative to its own max |value|. Returns the force's max abs
    error and the worst relative error over the outputs compared."""
    outputs = [("force", got.force, ref.force), ("torque", got.torque, ref.torque)]
    if want == "all":
        outputs += [("energy", got.energy, ref.energy), ("virial", got.virial, ref.virial)]
    errs = [_compare(f"{tag} {what}", g, r) for what, g, r in outputs]
    return errs[0][0], max(err / max(scale, 1e-30) for err, scale in errs)


def check_aniso_kernel(az, D, AK, record):
    """The TwoPatchMorse kernel at every listed shape, modes none/shift and
    force/all, with the summed force checked at round-off on Newton grids
    and two launches held bit for bit; timed at the patchy path's full
    size."""
    dev = torch.device("cuda")
    tpm = az.ops.evaluators.ANISO_PAIR_POTENTIALS["TwoPatchMorse"].energy_force_torque
    shapes = [
        ("small orthorhombic", dict(counts=(16, 16, 16), rho=0.6, jitter=0.06, seed=31)),
        ("tilted", dict(counts=(16, 15, 15), rho=0.6, jitter=0.06, seed=32,
                        tilt=(0.3, -0.2, 0.15))),
        ("axis under 3 cells", dict(counts=(3, 18, 18), rho=0.6, jitter=0.06, seed=33)),
        ("two types", dict(counts=(14, 14, 14), rho=0.6, jitter=0.06, seed=34, n_types=2)),
        # the packed schedule's own shapes: 12^3 cells of exactly 8 at cap
        # 8; a cluster in 0.4 of each edge (most cells empty); cap forced to
        # 64 with more candidates in a stencil than one staging round holds;
        # two axes under 3 cells; 4^3 cells of 64, more than the block has
        # threads, so the slots go in rounds; 41 types with per-pair
        # cutoffs, whose tables are read from global memory
        ("full cells", dict(counts=(24, 24, 24), rho=1.0, jitter=0.03, seed=36, n_types=2), 8),
        ("mostly empty", dict(counts=(12, 12, 12), rho=0.6, jitter=0.06, seed=37, n_types=2,
                              span=0.4)),
        ("cap 64 in rounds", dict(counts=(18, 18, 18), rho=1.2, jitter=0.05, seed=38,
                                  n_types=2), 64),
        ("two axes under 3", dict(counts=(3, 3, 24), rho=0.6, jitter=0.06, seed=39, n_types=2)),
        ("cells above kThreads", dict(counts=(16, 16, 16), rho=8.0, jitter=0.02, seed=40,
                                      n_types=2)),
        ("41 types", dict(counts=(14, 14, 14), rho=0.6, jitter=0.06, seed=41, n_types=41)),
    ]
    cases = []
    for label, kw, *cap in shapes:
        dense, spec, T = _dense_case(az, D, _lattice_snapshot(az, quats=True, **kw), 1.6, 0.3,
                                     dev, *cap, fields=("quat",))
        cases.append((label, dense, spec, T))
    _check_packed_shapes(_source_constant(AK._SOURCE, "kStageEntries"), cases,
                         _source_constant(AK._SOURCE, "kThreads"))
    dense, spec = _prepared_dense(build_patchy(az, dev)[0])
    cases.append(("patchy colloids 27k", dense, spec, 1))

    timing = None
    for label, dense, spec, T in cases:
        tbl = _aniso_tables(az, T, 35, dev)
        jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_quat=True)
        worst = max_abs = resid = 0.0
        for mode in ("none", "shift"):
            tables = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], mode)
            for want in ("force", "all"):
                got = AK.cell_aniso_force(dense, spec, tables, want)
                ref = D.dense_aniso_force(tpm, dense, jb, spec, tbl["params"], tbl["r_cut"],
                                          mode, want)
                torch.cuda.synchronize()
                tag = f"TwoPatchMorse {label} dims={spec.dims} cap={spec.cap} T={T} {mode} {want}"
                ferr, rel = _compare_aniso(tag, got, ref, want)
                record("cell_aniso_force", ferr)
                worst, max_abs = max(worst, rel), max(max_abs, ferr)
                if spec.newton_ok:
                    resid = max(resid, _newton_residual(got.force))
                _same_bits(tag, got, AK.cell_aniso_force(dense, spec, tables, want))
        if resid > 1e-5:
            raise AssertionError(f"TwoPatchMorse {label}: summed kernel force {resid:.3e} of the "
                                 "summed magnitudes, not round-off")
        print(f"[kernel] cell_aniso_force {label} dims={spec.dims} cap={spec.cap} T={T} "
              f"(modes none/shift, force/all): force max_abs_err {max_abs:.3e}, worst error "
              f"{worst:.3e} of max|value| (bar {BAR}); summed force "
              f"{resid if spec.newton_ok else float('nan'):.2e} of the summed magnitudes; two "
              f"launches give the same bits", flush=True)
        if label.startswith("patchy"):
            tables = AK.aniso_kernel_tables(tbl["params"], tbl["r_cut"], "shift")
            ms = _cuda_time_ms(lambda: AK.cell_aniso_force(dense, spec, tables), 50)
            plain_ms = _cuda_time_ms(
                lambda: D.dense_aniso_force(tpm, dense, jb, spec, tbl["params"], tbl["r_cut"],
                                            "shift", "force"), 3)
            pairs = _pairs_inside(D, dense, spec, 1.6)
            # inputs: position 12 B, quaternion 16 B, type 4 B; outputs:
            # force and torque 24 B
            bound_ms, by = _bound(dense, 32, 24, 4 * tables.numel(), pairs,
                                  OPS_PER_PAIR["TwoPatchMorse"])
            candidates = _candidates(dense, spec)
            timing = (ms, plain_ms, f"patchy colloids 27k, cap {spec.cap}", (bound_ms, by),
                      candidates)
            print(f"[kernel] cell_aniso_force at patchy colloids 27k cap {spec.cap} "
                  f"({int((dense.tag >= 0).sum())} of {spec.S} slots occupied): kernel {ms:.4f} "
                  f"ms, plain {plain_ms:.4f} ms per call (force, mode shift); bound "
                  f"{bound_ms:.5f} ms ({by}); {candidates} candidate pairs per call, {pairs} "
                  f"unordered pairs inside r_cut (each evaluated from both sides)", flush=True)
    return timing


def _rng_tags(n, seed):
    """Slot tags as a dense grid holds them: random tags, a fifth of the
    slots empty (-1) and the first four -1, 0 and the two largest int32."""
    g = np.random.default_rng(seed)
    tags = g.integers(0, 2**31 - 1, n).astype(np.int32)
    tags[g.random(n) < 0.2] = -1
    tags[:4] = [-1, 0, 2**31 - 1, 2**31 - 2]
    return torch.as_tensor(tags)


def _rng_bound(n, hashes, alu_ops, int_ops, f32_ops, bytes_moved):
    """(bound_ms, bound_by) of a draw of n elements, each ``hashes``
    Threefry-2x32-20 calls, ``int_ops`` more integer operations (``alu_ops``
    of them on the ALU pipe) and ``f32_ops`` float32 ones, moving
    ``bytes_moved`` bytes: the larger
    of the bytes over the memory rate and the operations' time, itself the
    largest of the ALU pipe's, the issue slots' and the float32 rate's."""
    alu = hashes * 20 * THREEFRY_ROUND_ALU + alu_ops
    issued = hashes * 20 * THREEFRY_ROUND_OPS + int_ops + f32_ops
    t_bytes = n * bytes_moved / MEM_BYTES_PER_S
    t_ops = n * max(alu / ALU_OPS_PER_S, issued / ISSUE_OPS_PER_S, f32_ops / F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_rng(az, RK):
    """Threefry and the Langevin noise on the GPU against the CPU, bitwise;
    the random-draw kernels against their plain versions on the card: K4
    bitwise for every word count and uniform range at the paths' tag counts
    (and one that is not a multiple of the block), for three streams and
    two timesteps (one above 2**32); K5 at the MPCD paths' collision grids,
    bitwise or within its 1-ulp bar, the maximum printed. Times each
    against its plain version and its bound. Returns {kernel: timing}."""
    from azplugins_tpu_torch.core import rng

    t0 = time.perf_counter()
    g = np.random.default_rng(7)
    tags = torch.as_tensor(g.integers(-1, 2**31 - 1, 64000).astype(np.int32))
    ctr = torch.as_tensor(g.integers(0, 2**32, 64000, dtype=np.uint64).astype(np.int64))
    for rounds in (rng.FAST_ROUNDS, 20):
        cpu = rng.threefry2x32(0x00D20000 ^ 42, 1234, tags, ctr, rounds=rounds)
        gpu = rng.threefry2x32(0x00D20000 ^ 42, 1234, tags.cuda(), ctr.cuda(), rounds=rounds)
        for a, b in zip(cpu, gpu):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"threefry2x32 ({rounds} rounds) differs on the GPU")
    gamma = torch.full((64000,), 0.1)
    for dev in ("cpu", "cuda"):
        u = rng.particle_uniform3(rng.Stream.LANGEVIN, 12345, 777, tags.to(dev))
        noise = torch.sqrt(6.0 * gamma.to(dev) * 1.0 / 0.005)[:, None] * u
        if dev == "cpu":
            ref = noise
        elif not torch.equal(noise.cpu().view(torch.int32), ref.view(torch.int32)):
            raise AssertionError("Langevin noise differs between the GPU and the CPU")

    # K4: every case bitwise the plain version on the card
    cases = 0
    for n in RNG_TAGS:
        t = _rng_tags(n, n).cuda()
        for stream in (rng.Stream.LANGEVIN, rng.Stream.PARTICLE_EVAPORATOR, rng.Stream.THERMALIZE):
            for seed, step in ((12345, 777), (7, 2**32 + 9)):
                for n_words in (1, 2, 3, 4, 8):
                    got = rng.particle_bits(stream, seed, step, t, n_words)
                    want = rng._particle_bits_plain(stream, seed, step, t, n_words)
                    if len(got) != n_words or not all(
                            a.dtype == torch.int64 and torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"particle_bits kernel differs: {n} tags, stream "
                                             f"{stream}, timestep {step}, {n_words} words")
                    cases += 1
                for low, high in ((-1.0, 1.0), (0.0, 1.0), (-3.5, 0.25)):
                    got = rng.particle_uniform3(stream, seed, step, t, low, high)
                    want = rng._particle_uniform3_plain(stream, seed, step, t, low, high)
                    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                        raise AssertionError(f"particle_uniform3 kernel differs: {n} tags, "
                                             f"stream {stream}, timestep {step}, [{low}, {high})")
                    cases += 1
    # K4's clock form (a CUDA graph's draws): the key's timestep word read
    # from a clock on the card, 3 steps behind at offset 3
    for n in RNG_TAGS:
        t = _rng_tags(n, n).cuda()
        for step in CLOCK_STEPS:
            clock = torch.tensor(step - 3, dtype=torch.int64, device="cuda")
            with rng.device_clock(clock, 1000):
                got_words = rng.particle_bits(rng.Stream.THERMALIZE, 42, 1003, t, 5)
                got = rng.particle_uniform3(rng.Stream.LANGEVIN, 42, 1003, t)
            want_words = rng._particle_bits_plain(rng.Stream.THERMALIZE, 42, step, t, 5)
            want = rng._particle_uniform3_plain(rng.Stream.LANGEVIN, 42, step, t)
            if not (all(torch.equal(a, b) for a, b in zip(got_words, want_words))
                    and torch.equal(got.view(torch.int32), want.view(torch.int32))):
                raise AssertionError(f"K4's clock form differs from its plain version: {n} "
                                     f"tags, timestep {step}")
            cases += 2
    # K5, the axis form every collision launches (with plates the virtual
    # fill's normals under a second key, in the same launch), at each MPCD
    # path's collision grid and an odd count: the axes and the normals
    # within the bar of their plain versions; the axes bitwise the plain
    # normalisation of the kernel's own normals (drawn as another launch's
    # second key: the card's torch.sum order over 3) and the one-key form's;
    # the normals bitwise those of a launch under another first key
    ulp_max, err_max, differ = 0, 0.0, 0
    for shape in (*NORMAL_SHAPES.values(), (1001, 3)):
        rows = shape[0]
        for key, second in (((0, 42), rng.jax_fold_in(rng.jax_key(11), 41)),
                            (rng.jax_fold_in(rng.jax_key(11), 40), (7, 9))):
            axis, normals = rng.jax_normal_axis(key, rows, "cuda", second)
            one, none = rng.jax_normal_axis(key, rows, "cuda")
            p_axis, p_normals = rng._jax_normal_axis_plain(key, rows, "cuda", second)
            _, raw = rng.jax_normal_axis((5, 6), rows, "cuda", key)
            _, again = rng.jax_normal_axis((5, 6), rows, "cuda", second)
            own = raw / torch.clamp_min(torch.sqrt(torch.sum(raw * raw, dim=1, keepdim=True)),
                                        1e-12)
            if not (bool(torch.isfinite(axis).all()) and bool(torch.isfinite(normals).all())
                    and axis.shape == normals.shape == shape and none is None
                    and torch.equal(axis.view(torch.int32), own.view(torch.int32))
                    and torch.equal(axis.view(torch.int32), one.view(torch.int32))
                    and torch.equal(normals.view(torch.int32), again.view(torch.int32))):
                raise AssertionError(f"jax_normal_axis kernel: non-finite or misshapen, not the "
                                     f"plain normalisation of its own normals, or not two "
                                     f"single draws, at {shape}")
            for got, want in ((axis, p_axis), (normals, p_normals)):
                ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
                ulp_max = max(ulp_max, int(ulps.max()))
                differ += int((ulps > 0).sum())
                err_max = max(err_max, float((got - want).abs().max()))
    if ulp_max > NORMAL_ULP:
        raise AssertionError(f"jax_normal_axis kernel: {ulp_max} ulp from its plain version "
                             f"(bar {NORMAL_ULP})")
    record_err = {"particle_bits": 0.0, "jax_normal_axis": err_max}
    # BrownianFlow.step1, which no path below runs, through the public API
    snap = _lattice_snapshot(az, (16, 16, 16), 0.5, 0.1, 3)
    sim = az.Simulation(device="cuda", seed=5)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.001, methods=[az.md.methods.BrownianFlow(kT=1.0, default_gamma=1.0)], forces=[])
    RK.launches_by_kernel.clear()
    sim.run(20)
    brownian = RK.launches_by_kernel.get("particle_bits", 0)
    _check_wrapped(sim, "brownian")
    if brownian < 20:
        raise AssertionError(f"BrownianFlow: {brownian} random-draw kernel launches in 20 steps")
    del sim
    print(f"[rng] threefry (13 and 20 rounds) and Langevin noise: GPU == CPU bitwise; K4 "
          f"(particle_bits, particle_uniform3) bitwise its plain version in {cases} cases "
          f"({', '.join(map(str, RNG_TAGS))} tags, -1 and 2**31 - 1 among them; 1-8 words; "
          f"three ranges; three streams; timesteps 777 and 2**32 + 9; the clock form at "
          f"{', '.join(map(str, CLOCK_STEPS))}); K5 (jax_normal_axis, one and two keys) at "
          f"{', '.join(f'{k} {v}' for k, v in NORMAL_SHAPES.items())} and (1001, 3): max "
          f"{ulp_max} ulp from its plain version ({differ} values differ; bar {NORMAL_ULP}), "
          f"max |diff| {err_max:.3e}, the axes bitwise the plain normalisation of its own "
          f"normals, the two-key form two single draws; BrownianFlow (4,096 "
          f"particles): {brownian} K4 launches in 20 steps", flush=True)

    # times at the headline's slots (K4) and the MPCD grids (K5), with bounds
    timing = {}
    t = _rng_tags(HEADLINE_SLOTS, 1).cuda()
    draws = {
        "particle_uniform3": (
            lambda: rng.particle_uniform3(rng.Stream.LANGEVIN, 1, 2, t),
            lambda: rng._particle_uniform3_plain(rng.Stream.LANGEVIN, 1, 2, t),
            HEADLINE_SLOTS, _rng_bound(HEADLINE_SLOTS, 2, 6, 6, 9, 16)),
        "particle_bits[1 word]": (
            lambda: rng.particle_bits(rng.Stream.PARTICLE_EVAPORATOR, 1, 2, t, 1),
            lambda: rng._particle_bits_plain(rng.Stream.PARTICLE_EVAPORATOR, 1, 2, t, 1),
            HEADLINE_SLOTS, _rng_bound(HEADLINE_SLOTS, 1, 0, 0, 0, 12)),
    }
    for name, shape in NORMAL_SHAPES.items():
        n = int(np.prod(shape))
        # the form each path's collision launches: the axes, with plates
        # (Poiseuille) also the virtual fill's normals
        second = (1, 2) if name == "poiseuille" else None
        n_draws = n * (2 if second else 1)
        draws[f"jax_normal_axis[{name}]"] = (
            lambda shape=shape, second=second: rng.jax_normal_axis((0, 42), shape[0], "cuda",
                                                                   second),
            lambda shape=shape, second=second: rng._jax_normal_axis_plain((0, 42), shape[0],
                                                                          "cuda", second),
            n_draws, _rng_bound(n_draws, 1, 3, 3, (2 * NORMAL_F32_OPS + NORMAL_AXIS_ROW_OPS / 3)
                                / 2 if second else NORMAL_AXIS_F32_OPS, 4))
    lines = []
    for name, (kernel, plain, n, bound) in draws.items():
        ms = _cuda_time_ms(kernel, 50)
        plain_ms = _cuda_time_ms(plain, 3)
        timing[name] = (ms, plain_ms, bound)
        lines.append(f"{name} {n:,}: {ms:.4f} ms (plain {plain_ms:.4f}), bound {bound[0]:.5f} ms "
                     f"({bound[1]}), {ms / bound[0]:.0f}x")
    print(f"[rng] {'; '.join(lines)}; the phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return timing, record_err


# ---------------------------------------------------------------------------
# [cellsum]: K10 and K5's clock form, the SRD advance graphs' kernels
# ---------------------------------------------------------------------------
def _cellsum_shapes(az, device):
    """{label: (cid, vel, mass, cells)}: a collision's cell sums at the MPCD
    paths' shapes, the cell ids from an SRD's own binning under a grid
    shift (one seed each), and one deep cell."""
    from azplugins_tpu_torch import mpcd as M
    from azplugins_tpu_torch.core.box import Box

    out = {}
    for label, L, n, plates in (("srd", 64.0, 64**3, None), ("colloid", 32.0, 5 * 32**3, None),
                                ("poiseuille", 16.0, 40_000, ("z", 16.0))):
        g = np.random.default_rng(len(label))
        srd = M.SRD(dt=0.02, cell_size=1.0, kT=1.0, plates=plates)
        srd._build(Box.from_lengths(L, L, L), 3)
        cells = int(np.prod(srd._grid_dims()))
        z = 0.98 if plates else 1.0
        pos = (g.random((n, 3)) - 0.5) * np.asarray([L, L, z * L])
        vel = g.normal(0.0, 1.0, (n, 3))
        mass, invalid = None, None
        if label == "colloid":  # the dense slots after the solvent: 21^3 cells of 8
            slots, real = 21**3 * 8, 14**3
            invalid = np.ones(n + slots, bool)
            invalid[:n] = False
            invalid[n + g.choice(slots, real, replace=False)] = False
            pos = np.concatenate([pos, (g.random((slots, 3)) - 0.5) * L])
            vel = np.concatenate([vel, g.normal(0.0, 0.2, (slots, 3))])
            vel[invalid] = 0.0
            mass = np.where(invalid, 0.0, np.where(np.arange(n + slots) < n, 1.0, 5.0))
            mass = torch.as_tensor(mass.astype(np.float32), device=device)
        pos = torch.as_tensor(pos.astype(np.float32), device=device)
        cid = srd._cell_ids(pos, np.asarray([0.31, 0.62, 0.17], np.float32))
        if invalid is not None:
            cid = torch.where(torch.as_tensor(invalid, device=device), cells, cid)
        out[label] = (cid, torch.as_tensor(vel.astype(np.float32), device=device), mass, cells)
    cid, vel, _, cells = out["poiseuille"]
    out["deep"] = (torch.where(torch.arange(cid.numel(), device=device) < CELLSUM_DEEP, 5, cid),
                   vel, None, cells)
    return out


def _cellsum_bound(cid, mass, cells):
    """(bound_ms, "bytes") of K10: each row's id, velocity and mass read
    once, each cell's six sums written once, over the memory rate (its
    float work, a dozen operations a row, takes far less)."""
    n = cid.numel()
    moved = n * (8 + 12 + (4 if mass is not None else 0)) + cells * 24
    return 1e3 * moved / MEM_BYTES_PER_S, "bytes"


def check_cellsum(az, RK, CK):
    """[cellsum]: K10 against the plain ordered cell sum on the card,
    bitwise, at pure SRD's, the colloids' and the Poiseuille slit's shapes
    and at one deep cell, two calls the same bits; K5's clock form against
    its host-key form and the host's shift, bitwise, at the three MPCD
    grids; each timed queued and in a replay, K10 against CUDA index_add_
    (its library call: the same sums, atomic) and its bound, K5's clock
    form against the host-key form. Returns {kernel: timing}."""
    from azplugins_tpu_torch import mpcd as M
    from azplugins_tpu_torch.core import rng

    t0 = time.perf_counter()
    dev = "cuda"
    shapes = _cellsum_shapes(az, dev)
    lines = []
    timing = {}
    for label, (cid, vel, mass, cells) in shapes.items():
        n0 = CK.launches
        got = M._cell_sums(cid, vel, mass, cells)
        again = CK.cell_sums(cid, vel, mass, cells)
        pay = M._payload(vel, mass)
        want = M._cell_sums_plain(cid, pay, cells)
        if not (CK.launches == n0 + 2 and got.shape == (cells, 6)
                and torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(again.view(torch.int32), got.view(torch.int32))):
            diff = float((got - want).abs().max())
            raise AssertionError(f"cellsum {label}: K10 differs from the plain ordered sum "
                                 f"(max |diff| {diff:.3e}) or from itself")
        atomic = torch.zeros((cells + 1, 6), device=dev).index_add_(0, cid, pay)[:cells]
        deepest = int(torch.bincount(cid, minlength=cells + 1)[:cells].max())
        lines.append(f"{label} ({cid.numel():,} rows, {cells:,} cells, deepest {deepest}): "
                     f"bitwise; CUDA index_add_ max |diff| "
                     f"{float((atomic - want).abs().max()):.3e}")
        if label == "deep":
            continue
        kernel = lambda c=cid, v=vel, m=mass, k=cells: CK.cell_sums(c, v, m, k)  # noqa: E731
        library = lambda c=cid, p=pay, k=cells: torch.zeros(  # noqa: E731
            (k + 1, 6), device=dev).index_add_(0, c, p)
        timing[label] = {
            "ms": _cuda_time_ms(kernel, 50), "replay_ms": _replay_time_ms(kernel, 50),
            "plain_ms": _cuda_time_ms(lambda c=cid, p=pay, k=cells: M._cell_sums_plain(c, p, k),
                                      3),
            "library_ms": _cuda_time_ms(library, 50),
            "library_replay_ms": _replay_time_ms(library, 50),
            "bound": _cellsum_bound(cid, mass, cells)}
    # K5's clock form: the keys and shift on the card against the host's
    cases = 0
    inner = M._inner_key(11)
    for label, (rows, _) in NORMAL_SHAPES.items():
        for t in CLOCK_STEPS:
            kshift, kaxis, kvirt = M._collision_keys(11, t)
            clock = torch.tensor(t - 3, dtype=torch.int64, device=dev)
            for cell_size in CELLSUM_CELL_SIZES:
                for shift_on, second in ((True, label == "poiseuille"), (False, True)):
                    a = np.float32(cell_size)
                    host = (rng.jax_uniform_host(kshift, 3) * a if shift_on
                            else np.zeros(3, np.float32))
                    axis, normals = rng.jax_normal_axis(kaxis, rows, dev,
                                                        kvirt if second else None)
                    with rng.device_clock(clock, 1000):
                        got = rng.collision_draws(inner, 1003, rows, dev, cell_size, shift_on,
                                                  second)
                    ok = (torch.equal(got[0].view(torch.int32), axis.view(torch.int32))
                          and (got[1] is None) == (not second)
                          and (not second or torch.equal(got[1].view(torch.int32),
                                                         normals.view(torch.int32)))
                          and np.array_equal(got[2].cpu().numpy().view(np.uint32),
                                             host.view(np.uint32))
                          and np.array_equal(got[3].cpu().numpy().view(np.uint32),
                                             (host / a).view(np.uint32)))
                    if not ok:
                        raise AssertionError(f"cellsum: K5's clock form differs from its "
                                             f"host-key form at {label}, timestep {t}, cell "
                                             f"size {cell_size}, shift {shift_on}")
                    cases += 1
    clock = torch.tensor(5, dtype=torch.int64, device=dev)
    for label, (rows, _) in NORMAL_SHAPES.items():
        second = label == "poiseuille"
        _, kaxis, kvirt = M._collision_keys(11, 8)

        def clocked(rows=rows, second=second):
            with rng.device_clock(clock, 5):
                return rng.collision_draws(inner, 8, rows, dev, 1.0, True, second)

        def host(rows=rows, second=second, kaxis=kaxis, kvirt=kvirt):
            return rng.jax_normal_axis(kaxis, rows, dev, kvirt if second else None)

        n_draws = 3 * rows * (2 if second else 1)
        timing[f"clock[{label}]"] = {
            "ms": _cuda_time_ms(clocked, 50), "replay_ms": _replay_time_ms(clocked, 50),
            "host_ms": _cuda_time_ms(host, 50), "host_replay_ms": _replay_time_ms(host, 50),
            "plain_ms": _cuda_time_ms(lambda rows=rows, second=second: rng._collision_draws_plain(
                inner, 8, rows, dev, 1.0, True, second), 3),
            "bound": _rng_bound(n_draws, 1, 3, 3, (2 * NORMAL_F32_OPS + NORMAL_AXIS_ROW_OPS / 3)
                                / 2 if second else NORMAL_AXIS_F32_OPS, 4)}
    print(f"[cellsum] K10 against the plain ordered sum: {'; '.join(lines)}; K5's clock form "
          f"bitwise its host-key form and the host's shift in {cases} cases (the three MPCD "
          f"grids, timesteps {', '.join(map(str, CLOCK_STEPS))}, cell sizes "
          f"{', '.join(map(str, CELLSUM_CELL_SIZES))}, the shift on and off, one key and two)",
          flush=True)
    for label, tm in timing.items():
        b = tm["bound"][0]
        if label.startswith("clock"):
            print(f"[cellsum] K5's clock form at {label[6:-1]}: queued {tm['ms']:.4f} ms, in a "
                  f"replay {tm['replay_ms']:.4f} ms; host-key form queued {tm['host_ms']:.4f}, "
                  f"in a replay {tm['host_replay_ms']:.4f}; plain {tm['plain_ms']:.4f}; bound "
                  f"{b:.5f} ms ({tm['bound'][1]})", flush=True)
        else:
            print(f"[cellsum] K10 at {label}: queued {tm['ms']:.4f} ms, in a replay "
                  f"{tm['replay_ms']:.4f} ms; CUDA index_add_ (atomic) queued "
                  f"{tm['library_ms']:.4f}, in a replay {tm['library_replay_ms']:.4f}; plain "
                  f"{tm['plain_ms']:.4f}; bound {b:.5f} ms (bytes), "
                  f"{tm['replay_ms'] / b:.1f}x in a replay", flush=True)
    print(f"[cellsum] the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return timing


# ---------------------------------------------------------------------------
# [pick]: K4 at the droplet's pick against the plain pick
# ---------------------------------------------------------------------------
def _pick_bound(n, n_solvent, n_marked, k):
    """(bound_ms, bound_by) of the pick on n slots: each slot's typeid, each
    solvent slot's z and each candidate's tag read once, the flips written
    once; a Threefry-2x32-20 a candidate."""
    t_bytes = 4 * (n + n_solvent + n_marked + min(k, n_marked)) / MEM_BYTES_PER_S
    hashes = n_marked
    t_ops = hashes * max(20 * THREEFRY_ROUND_ALU / ALU_OPS_PER_S,
                         20 * THREEFRY_ROUND_OPS / ISSUE_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_pick(sim, RK, EK):
    """[pick]: K4 at the pick (``csrc/pick.cu``, two launches a pick:
    ParticleEvaporator's pick on a whole layout) at the droplet's state
    after its run, against
    the plain pick on the card, bitwise: PICK_TIMESTEPS timesteps (one past
    2**32), the trigger's flag set, unset and absent (fired), k of 1, the
    droplet's 10, PICK_BINS + 1, the candidates' count less one, their
    count and the slot count; the flag unset leaves typeid's bits; the
    flips number min(k, candidates). On the slab widened to the whole box
    (more candidates than PICK_BINS + 1): k of PICK_BINS + 1, half the
    candidates and all but one. A tie case: PICK_TIE's tag (its
    evaporator word is 0xFFFFFFFF) on two candidates at the lowest slots, k
    one past the candidates below it, so the k-th smallest key over all
    slots is a tying one. Times the fired and unfired pick (k = 10; the
    flips written as the solvent type, so the state stays) against the
    plain pick, ``torch.topk(k=10)`` over the slots' keys (the library call
    of the pick) and the bound. Returns {name: (ms, plain_ms, bound,
    library_ms)}."""
    from azplugins_tpu_torch.core import rng

    t0 = time.perf_counter()
    st, seed, evap = sim._dense, sim.seed, sim.operations.updaters[0]
    dev = st.device
    n = st.N
    cand = evap._candidates(st)
    m = int(cand.sum())
    k_path = evap._k
    flags = {"fired (no flag)": None, "flag set": torch.tensor(True, device=dev),
             "flag unset": torch.tensor(False, device=dev)}
    steps = [sim.timestep + j for j in range(PICK_TIMESTEPS - 1)] + [2**32 + 3]
    cases = 0
    lo_path = evap.lo
    try:
        for k in sorted({1, k_path, PICK_BINS + 1, m - 1, m, n} - {0}):
            evap._k = k
            for t in steps:
                want = st.typeid.clone()
                evap._pick_plain(want, st, None, t, seed)
                if int((want != st.typeid).sum()) != min(k, m):
                    raise AssertionError(f"pick: the plain pick flipped "
                                         f"{int((want != st.typeid).sum())}, not min({k}, {m})")
                for what, fire in flags.items():
                    got = st.typeid.clone()
                    before = EK.launches
                    evap._pick(got, st, fire, t, seed)
                    if EK.launches != before + 2:
                        raise AssertionError("pick: the kernels were not launched")
                    expect = st.typeid if what == "flag unset" else want
                    if not torch.equal(got, expect):
                        raise AssertionError(f"pick: the kernel differs from the plain pick at "
                                             f"k {k}, timestep {t}, {what}")
                    cases += 1
        # k above the select's radix bins with more candidates than k: the
        # slab widened to the whole box (every solvent slot a candidate)
        evap.lo = -0.5 * float(st.box.L[2])
        m_wide = int(evap._candidates(st).sum())
        if m_wide <= PICK_BINS + 1:
            raise AssertionError(f"pick: {m_wide} candidates on the whole box")
        wide = sorted({PICK_BINS + 1, m_wide // 2, m_wide - 1})
        for k in wide:
            evap._k = k
            for t in steps[::10]:
                want = st.typeid.clone()
                evap._pick_plain(want, st, None, t, seed)
                got = st.typeid.clone()
                evap._pick(got, st, None, t, seed)
                if not torch.equal(got, want) or int((got != st.typeid).sum()) != k:
                    raise AssertionError(f"pick: the kernel differs from the plain pick on the "
                                         f"whole box at k {k}, timestep {t}")
                cases += 1
        evap.lo = lo_path
        # the tie: two candidates at slots 0 and 1 whose word is 0xFFFFFFFF
        tie_seed, tie_t, tie_tag = PICK_TIE
        (word,) = RK.particle_bits(rng.Stream.PARTICLE_EVAPORATOR, tie_seed, tie_t,
                                   torch.tensor([tie_tag], dtype=torch.int32, device=dev), 1)
        if int(word[0]) != 0xFFFFFFFF:
            raise AssertionError(f"pick: PICK_TIE's word is {int(word[0]):#x}")
        z = 0.5 * (evap.lo + evap.hi)
        tied = st.replace(
            typeid=st.typeid.clone().index_fill_(0, torch.arange(2, device=dev), evap._solvent_id),
            tag=st.tag.clone().index_fill_(0, torch.arange(2, device=dev), tie_tag),
            position=st.position.clone().index_put_(
                (torch.arange(2, device=dev), torch.full((2,), 2, device=dev)),
                torch.tensor(z, device=dev)))
        m_tied = int(evap._candidates(tied).sum())
        tie_flips = []
        for k in (m_tied - 2, m_tied - 1):
            evap._k = k
            want = tied.typeid.clone()
            evap._pick_plain(want, tied, None, tie_t, tie_seed)
            got = tied.typeid.clone()
            evap._pick(got, tied, None, tie_t, tie_seed)
            if not torch.equal(got, want):
                raise AssertionError(f"pick: the kernel differs from the plain pick in the tie "
                                     f"case at k {k}")
            tie_flips.append(f"k {k}: slots 0, 1 flipped {want[:2].tolist()}")
            cases += 1
    finally:
        evap._k, evap.lo = k_path, lo_path

    # times at k = 10, the flips written as the solvent type (no change)
    on, off = flags["flag set"], flags["flag unset"]
    tid, t = st.typeid.clone(), sim.timestep
    lo, hi = float(np.float32(evap.lo)), float(np.float32(evap.hi))

    def pick(fire):
        return lambda: EK.evaporator_pick(tid, st.position, st.tag, k_path, evap._solvent_id,
                                          evap._solvent_id, lo, hi, st.box.Lz,
                                          rng.Stream.PARTICLE_EVAPORATOR, seed, t, fire)

    keys = evap._keys(st, cand, t, seed)
    n_solvent = int((st.typeid == evap._solvent_id).sum())
    bound = _pick_bound(n, n_solvent, m, k_path)
    library_ms = _cuda_time_ms(lambda: torch.topk(keys, k_path, largest=False, sorted=False), 50)
    plain_ms = _cuda_time_ms(lambda: evap._pick_plain(st.typeid.clone(), st, on, t, seed), 5)
    timing = {"fired": (_cuda_time_ms(pick(on), 50), plain_ms, bound, library_ms),
              "unfired": (_cuda_time_ms(pick(off), 50), plain_ms, bound, library_ms)}
    print(f"[pick] K4 at the pick (az_pick_scan, az_pick_select) at the droplet's state ({n:,} slots, "
          f"{m:,} candidates, {n_solvent:,} solvent) bitwise the plain pick in {cases} cases "
          f"(k {sorted({1, k_path, PICK_BINS + 1, m - 1, m, n} - {0})}, {len(steps)} timesteps "
          f"to {steps[-1]}, the flag set, unset and absent; the flips min(k, candidates); on "
          f"the whole box, {m_wide:,} candidates, k {wide} at {len(steps[::10])} timesteps; "
          f"the tie case {PICK_TIE}: {'; '.join(tie_flips)}); fired {timing['fired'][0]:.4f} ms, "
          f"unfired {timing['unfired'][0]:.4f} ms (k {k_path}), plain {plain_ms:.4f} ms, "
          f"torch.topk(k={k_path}) over the {n:,} keys {library_ms:.4f} ms, bound "
          f"{bound[0]:.5f} ms ({bound[1]}); the phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return timing


# ---------------------------------------------------------------------------
# [integrate]: K6-K9 against their plain versions on the paths' states
# ---------------------------------------------------------------------------
def _integrate_bound(bytes_moved, n_act, f32_ops, hashes=0):
    """(bound_ms, bound_by) of a streaming pass moving ``bytes_moved`` bytes
    whose ``n_act`` acting slots each do ``f32_ops`` float32 operations and
    ``hashes`` Threefry-2x32-20 calls (with their uniforms' 6 integer
    operations): the larger of the bytes' time and the operations' (the
    largest of the ALU pipe's, the issue slots' and the float32 rate's)."""
    alu = hashes * (20 * THREEFRY_ROUND_ALU + 3)
    issued = hashes * (20 * THREEFRY_ROUND_OPS + 3) + f32_ops
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = n_act * max(alu / ALU_OPS_PER_S, issued / ISSUE_OPS_PER_S, f32_ops / F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kernel_bits(what, got, want, ulp_bar=0):
    """The largest difference in ulp (int32 patterns) of ``got`` from
    ``want``, at most ``ulp_bar``; NaN must meet NaN."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"integrate: {what}: {tuple(got.shape)} {got.dtype} against "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.bool:
        if not torch.equal(got, want):
            raise AssertionError(f"integrate: {what}: the verdict differs")
        return 0, 0.0
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"integrate: {what}: NaN where the plain version has none")
    g, w = got[~nan], want[~nan]
    ulps = (g.view(torch.int32).long() - w.view(torch.int32).long()).abs()
    worst = int(ulps.max()) if ulps.numel() else 0
    if worst > ulp_bar:
        raise AssertionError(f"integrate: {what}: {worst} ulp from the plain version "
                             f"({int((ulps > 0).sum())} values differ; bar {ulp_bar})")
    return worst, float((g - w).abs().max()) if g.numel() else 0.0


def _drift_cases(D, dense, meta, spec, label):
    """K6 against the plain drift check on the path's layout and, at the
    headline, on a NaN drift, a tie at the maximum and 4 shards (the
    slots cut in 4): whole verdicts with the violation flag clear and set,
    each shard's top two, the combine. Returns the number of cases."""
    pos, tag = dense.position, dense.tag
    layouts = {"path": (pos, meta.ref_position)}
    if label == "headline":
        # two slots at the same reference drift by the same step, beyond
        # every other slot's drift
        live = torch.nonzero(tag >= 0).flatten()
        ref_tie = meta.ref_position.clone()
        ref_tie[live[1]] = ref_tie[live[0]]
        tie = pos.clone()
        tie[live[:2]] = ref_tie[live[0]] + torch.tensor([0.3, 0.1, 0.0], device=pos.device)
        nan = pos.clone()
        nan[live[len(live) // 2], 1] = float("nan")
        layouts.update(tie=(tie, ref_tie), nan=(nan, meta.ref_position))
    cases = 0
    for name, (x, refp) in layouts.items():
        d = types.SimpleNamespace(position=x, tag=tag, device=x.device)
        meta = types.SimpleNamespace(ref_position=refp)
        for viol0 in (False, True):
            viol = torch.tensor(viol0, device=x.device)
            want = viol | D._needs_rebin_plain(d, meta, spec)
            _kernel_bits(f"{label} drift {name} viol={viol0}", D.needs_rebin(d, meta, spec, viol),
                         want)
            cases += 1
        if name == "nan" and bool(D._needs_rebin_plain(d, meta, spec)):
            raise AssertionError("integrate: a NaN drift asks for a rebuild")
        if label != "headline":
            continue
        cuts = torch.tensor_split(torch.arange(x.shape[0], device=x.device), 4)
        tops, plain = [], []
        for c in cuts:
            sd = types.SimpleNamespace(position=x[c], tag=tag[c], device=x.device)
            sm = types.SimpleNamespace(ref_position=refp[c])
            tops.append(D.drift_top_two(sd, sm))
            plain.append(D._drift_top_two_plain(sd, sm))
            _kernel_bits(f"{label} drift {name} shard top two", tops[-1], plain[-1])
        tops, plain = torch.cat(tops), torch.cat(plain)
        viol = torch.tensor(False, device=x.device)
        got = D.needs_rebin_of(tops, spec, viol)
        _kernel_bits(f"{label} drift {name} on 4 shards", got, D._needs_rebin_of_plain(plain, spec))
        _kernel_bits(f"{label} drift {name}: 4 shards against whole", got,
                     D._needs_rebin_plain(d, meta, spec))
        cases += 5
    return cases


def _step1_drift_cases(D, methods, states, meta, spec, dt, t, seed, label, fields, rotational):
    """K7+K6 in one launch (``Method.step1`` with a drift check) against K7
    then K6 and against the plain step1 then the plain check, on every
    state and method: the verdict with the flag clear and set, and the top
    two; at the headline also on a NaN drift and as 4 shards' top twos and
    their combine. Every field bitwise (K9's within NO_SQUISH_ULP). Returns
    (cases, worst K9 ulp, max abs error of the fused outputs)."""
    from azplugins_tpu_torch.md.methods import DriftCheck

    cases, worst, err = 0, 0, 0.0

    def same(what, got, k7, plain):
        nonlocal worst, err
        for k in fields:
            bar = NO_SQUISH_ULP if k in rotational else 0
            for other, name in ((k7, "K7"), (plain, "plain")):
                ulp, e = _kernel_bits(f"{what} {k} against {name}", getattr(got, k),
                                      getattr(other, k), bar)
                if k in rotational:
                    worst = max(worst, ulp)
                else:
                    err = max(err, e)

    layouts = dict(states)
    if label == "headline":
        live = torch.nonzero(states["path"].tag >= 0).flatten()
        nan = states["path"].position.clone()
        nan[live[len(live) // 2], 1] = float("nan")
        layouts["nan"] = states["path"].replace(position=nan)
    for sname, st in layouts.items():
        for mname, m in methods.items():
            if sname == "nan" and mname != "path":
                continue
            what = f"{label} {sname} {mname} step1 with the drift check"
            k7, plain = m.step1(st, dt, t, seed), m._step1_plain(st, dt, t, seed)
            for viol0 in (False, True):
                viol = torch.tensor(viol0, device=st.device)
                got, verdict = m.step1(st, dt, t, seed, DriftCheck(meta, spec, viol))
                same(f"{what} viol={viol0}", got, k7, plain)
                _kernel_bits(f"{what} viol={viol0}: verdict against K6", verdict,
                             D.needs_rebin(k7, meta, spec, viol))
                _kernel_bits(f"{what} viol={viol0}: verdict against plain", verdict,
                             viol | D._needs_rebin_plain(plain, meta, spec))
                cases += 1
            got, top = m.step1(st, dt, t, seed, DriftCheck(meta, spec, None))
            same(f"{what} (top two)", got, k7, plain)
            _kernel_bits(f"{what}: top two against K6", top, D.drift_top_two(k7, meta))
            _kernel_bits(f"{what}: top two against plain", top, D._drift_top_two_plain(plain, meta))
            cases += 1
    if label == "headline":
        st, m = states["path"], methods["path"]
        plain = m._step1_plain(st, dt, t, seed)
        tops, plains = [], []
        for c in torch.tensor_split(torch.arange(st.N, device=st.device), 4):
            sub = st.replace(**{k: getattr(st, k)[c] for k in (
                "position", "tag", "velocity", "typeid", "image", "orientation", "mass",
                "diameter", "charge", "net_force", "acceleration", "angmom", "moment_inertia",
                "net_torque")})
            smeta = types.SimpleNamespace(ref_position=meta.ref_position[c])
            got, top = m.step1(sub, dt, t, seed, DriftCheck(smeta, spec, None))
            _kernel_bits(f"{label} shard step1 with the drift check position", got.position,
                         plain.position[c])
            tops.append(top)
            plains.append(D._drift_top_two_plain(
                types.SimpleNamespace(position=plain.position[c], tag=st.tag[c]), smeta))
            _kernel_bits(f"{label} shard top two against plain", tops[-1], plains[-1])
        verdict = D.needs_rebin_of(torch.cat(tops), spec, torch.tensor(False, device=st.device))
        _kernel_bits(f"{label} 4 shards' verdict", verdict,
                     D._needs_rebin_of_plain(torch.cat(plains), spec))
        _kernel_bits(f"{label} 4 shards' verdict against whole", verdict,
                     D._needs_rebin_plain(plain, meta, spec))
        cases += 5
    return cases, worst, err


def check_integrate(az, D, K, sim, label, timing, record):
    """[integrate] on one main path's full-size state after its run: every
    method case's step1 and step2 through the kernels (K7, K8, K9) against
    their plain versions on the card, bitwise (K9 within NO_SQUISH_ULP);
    the path's own method and ConstantVolume; at the headline a noiseless
    Langevin and one under a Type filter; at the droplet its LangevinFlow
    (a flow field) and one under a Type filter; at the patchy colloids a
    noiseless one and the state with frozen axes (a third of the slots
    without their z axis, a third without x). K6 on the path's layout, and
    at the headline on NaN, tie and 4-shard cases. K7+K6 in one launch
    (step1 with the drift check) on every state and method against K7 then
    K6 and the plain composition (``_step1_drift_cases``). Times each
    kernel the path runs against its plain version and its bound into
    ``timing`` ({name: (ms, plain_ms, (bound_ms, bound_by))}): K6, K7 and
    K7+K6 on every state ("drift_check", "step1", "step1_drift" at the
    headline, else with "[label]"), K7+K6 printed beside the sum of K7 and
    K6 of the same call; K8 in the headline's three modes ("step2",
    "step2[nve]", "step2[noiseless]"), the droplet's with its flow
    ("step2[flow]"), the patchy colloids' ("step2[patchy]"); the patchy
    colloids' K9.
    Prints each with the host us a call of its wrapper and, not the same
    function, torch.amax over as many float32 as the state has slots (the
    card's floor for a one-launch reduction)."""
    t0 = time.perf_counter()
    IK = K.IK
    dense, meta, spec = sim._dense, sim._meta, sim._grid_spec
    dt, t, seed = sim.dt_ref(), sim.timestep, sim.seed
    integ = sim.operations.integrator
    rot = integ.integrate_rotational_dof
    path = integ.methods[0]
    Ls = az.md.methods
    methods = {"path": path, "nve": Ls.ConstantVolume()}
    if label == "headline":
        methods["noiseless"] = Ls.Langevin(kT=1.0, default_gamma=0.1, noiseless=True)
        methods["type_filter"] = Ls.Langevin(kT=1.0, default_gamma=0.1,
                                             filter=az.md.filter.Type(["A"]))
    elif label == "droplet":
        methods["type_filter"] = Ls.LangevinFlow(kT=1.0, flow_field=path.flow_field,
                                                 filter=az.md.filter.Type(["solvent"]))
    else:
        methods["noiseless"] = Ls.Langevin(kT=0.3, default_gamma=1.0, noiseless=True)
    for name, m in methods.items():
        if m is not path:
            m._attach(sim)
    states = {"path": dense}
    if rot:
        inertia = dense.moment_inertia.clone()
        inertia[0::3, 2] = 0.0
        inertia[1::3, 0] = 0.0
        states["frozen_axes"] = dense.replace(moment_inertia=inertia)
    rotational = ("orientation", "angmom", "net_torque")
    fields = ("position", "velocity", "acceleration") + (rotational if rot else ())
    cases, worst, errs = 0, 0, {}
    from azplugins_tpu_torch.core import rng

    # step2 also in its clock form (a CUDA graph's draws: K8's and K9's key
    # word read from a clock on the card, 5 steps behind at offset 5)
    clock = torch.tensor(t - 5, dtype=torch.int64, device=dense.device)
    for sname, st in states.items():
        for mname, m in methods.items():
            for step, clocked in (("step1", False), ("step2", False), ("step2", True)):
                if clocked:
                    with rng.device_clock(clock, t - 5):
                        got = m.step2(st, dt, t, seed)
                else:
                    got = getattr(m, step)(st, dt, t, seed)
                want = getattr(m, f"_{step}_plain")(st, dt, t, seed)
                for k in fields:
                    kernel = ("no_squish" if k in rotational else
                              "step1" if step == "step1" else "step2")
                    ulp, err = _kernel_bits(
                        f"{label} {sname} {mname} {step}{' (clock form)' * clocked} {k}",
                        getattr(got, k), getattr(want, k),
                        NO_SQUISH_ULP if kernel == "no_squish" else 0)
                    worst = max(worst, ulp) if kernel == "no_squish" else worst
                    errs[kernel] = max(errs.get(kernel, 0.0), err)
                cases += 1
    cases += _drift_cases(D, dense, meta, spec, label)
    errs["drift_check"] = 0.0
    fused, ulp, errs["step1_drift"] = _step1_drift_cases(D, methods, states, meta, spec, dt, t,
                                                         seed, label, fields, rotational)
    cases += fused
    worst = max(worst, ulp)
    for name, err in errs.items():
        record(name, err)

    live = dense.tag >= 0
    n, n_act = dense.N, int(live.sum())
    viol = torch.tensor(False, device=dense.device)
    ops = INTEGRATE_F32_OPS
    # the bounds' bytes are what each function needs: a field counts on the
    # slots whose result depends on it (the drift's positions and the
    # acceleration, force, mass, type, inertia and torque on acting slots;
    # the old acceleration on masked ones, which copy it), the fields copied
    # or written on every slot
    at = "" if label == "headline" else f"[{label}]"
    drift, k7, k76 = f"drift_check{at}", f"step1{at}", f"step1_drift{at}"

    def fused_plain():
        s = _translational_plain(path, "step1", dense, dt, t, seed)
        return s.position, s.velocity, viol | D._needs_rebin_plain(s, meta, spec)

    # K6, K7 and K7+K6 alone (no rotation) on the path's state: each method
    # on the path moves every occupied slot
    timed = {drift: (lambda: D.needs_rebin(dense, meta, spec, viol),
                     lambda: viol | D._needs_rebin_plain(dense, meta, spec),
                     _integrate_bound(4 * n + 24 * n_act, n_act, ops["drift_check"])),
             k7: (lambda: IK.step1(dense.tag, None, dense.position, dense.velocity,
                                   dense.acceleration, dt),
                  lambda: _translational_plain(path, "step1", dense, dt, t, seed),
                  _integrate_bound(52 * n + 12 * n_act, n_act, ops["step1"])),
             k76: (lambda: IK.step1_drift(dense.tag, None, dense.position, dense.velocity,
                                          dense.acceleration, dt, meta.ref_position, spec.buffer,
                                          viol),
                   fused_plain,
                   _integrate_bound(52 * n + 24 * n_act, n_act, ops["step1_drift"]))}
    if label == "headline":
        for name, m, kind in (("step2", path, "noisy"), ("step2[nve]", methods["nve"], "nve"),
                              ("step2[noiseless]", methods["noiseless"], "noiseless")):
            timed[name] = (lambda m=m: m.step2(dense, dt, t, seed),
                           lambda m=m: m._step2_plain(dense, dt, t, seed),
                           _integrate_bound(_step2_bytes(n, n_act, langevin=kind != "nve"), n_act,
                                            ops[name], hashes=2 * (kind == "noisy")))

        def clocked_step2():
            with rng.device_clock(clock, t - 5):
                return path.step2(dense, dt, t, seed)

        # K8 in its clock form (a CUDA graph's: one load more), the same bound
        timed["step2[clock]"] = (clocked_step2, timed["step2"][1], timed["step2"][2])
    elif label == "droplet":
        flow = path.flow_field(dense.box.wrap(dense.position)[0])
        timed["step2[flow]"] = (
            _k8_alone(IK, path, dense, dt, t, seed, flow),
            lambda: path._step2_plain(dense, dt, t, seed),
            _integrate_bound(_step2_bytes(n, n_act, flow=True), n_act, ops["step2"] + 3,
                             hashes=2))
    else:
        timed["step2[patchy]"] = (
            _k8_alone(IK, path, dense, dt, t, seed),
            lambda: _translational_plain(path, "step2", dense, dt, t, seed),
            _integrate_bound(_step2_bytes(n, n_act), n_act, ops["step2"], hashes=2))
        timed["no_squish"] = (
            lambda: IK.no_squish(0, dense.tag, None, dense.typeid, dense.orientation,
                                 dense.angmom, dense.moment_inertia, dense.net_torque, dt),
            lambda: path._rot_step1(dense, dt),
            _integrate_bound(68 * n + 24 * n_act, n_act, ops["no_squish[step1]"]))
    lines = []
    for name, (kernel, plain, bound) in timed.items():
        ms = _cuda_time_ms(kernel, 50)
        plain_ms = _cuda_time_ms(plain, 5)
        timing[name] = (ms, plain_ms, bound)
        lines.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f}; host {_host_us(kernel):.1f} us a "
                     f"call), bound {bound[0]:.5f} ms ({bound[1]}), {ms / bound[0]:.1f}x")
    k7_k6 = timing[k7][0] + timing[drift][0]
    lines.append(f"{k76} in one launch {timing[k76][0]:.4f} ms against K7 + K6 "
                 f"{timing[k7][0]:.4f} + {timing[drift][0]:.4f} = {k7_k6:.4f} ms in this call "
                 f"({timing[k76][0] / k7_k6:.2f}x)")
    floor = torch.rand(n, device=dense.device)
    lines.append(f"not the same function, the card's floor for a one-launch reduction: "
                 f"torch.amax over {n:,} float32 {_cuda_time_ms(lambda: torch.amax(floor), 50):.4f}"
                 f" ms")
    print(f"[integrate] {label} ({n:,} slots, {n_act:,} particles): {cases} cases "
          f"({', '.join(methods)} x step1/step2/step2 in its clock form/step1 with the drift "
          f"check{' x path/frozen axes' if rot else ''}; the drift check) bitwise the plain "
          f"versions (and K7+K6 bitwise K7 then K6) on the card"
          f"{f'; K9 max {worst} ulp (bar {NO_SQUISH_ULP})' if rot else ''}; "
          f"{'; '.join(lines)}; the phase {time.perf_counter() - t0:.1f} s", flush=True)


def _step2_bytes(n, n_act, langevin=True, flow=False):
    """The bytes K8 needs: tag, v in, v' and a' out on every slot; force,
    mass (and type, for Langevin; flow where given) on a moving slot; the
    old acceleration on a masked one."""
    return 40 * n + (20 if langevin else 16) * n_act + 12 * (n - n_act) + 12 * n_act * flow


def _k8_alone(IK, m, dense, dt, t, seed, flow=None):
    """K8 alone on the Langevin method ``m``'s arguments (its step2 adds K9
    with rotation and forms the flow velocity first)."""
    noise = IK.Noise(m._table_on("_gamma_table", dense.device), m._rng_stream, seed, t, m.kT(t),
                     not m.noiseless and dt > 0)
    return lambda: IK.step2(dense.tag, None, dense.typeid, dense.velocity, dense.acceleration,
                            dense.net_force, dense.mass, dt, noise, flow)


def _translational_plain(m, step, dense, dt, t, seed):
    """``m``'s plain ``step`` ("step1" or "step2") without its rotation:
    what K7 or K8 alone computes."""
    rot, m._rotational = m._rotational, False
    try:
        return getattr(m, f"_{step}_plain")(dense, dt, t, seed)
    finally:
        m._rotational = rot


def _host_us(fn, reps: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to issue its work, the card
    left to run behind (no synchronisation inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------
def _reset_counts(K):
    K.PK.launches = 0
    K.PK.launches_by_potential.clear()
    K.DK.launches = 0
    K.AK.launches = 0
    K.RK.launches = 0
    K.RK.launches_by_kernel.clear()
    K.EK.launches = 0
    K.IK.launches = 0
    K.IK.launches_by_kernel.clear()
    K.CK.launches = 0


def _draws(K, label, least, exact=False):
    """The random-draw kernels' launches since the counts were set to 0
    (K4 at the pick's, two a pick, as "evaporator_pick"; K10's calls as
    "cell_sums"), each at least ``least[name]`` (a path's draws a step times
    its steps, plus its updaters' fires), or exactly with ``exact`` (K5 and
    K10: one launch a collision): {name: launches}."""
    counts = {**K.RK.launches_by_kernel, "evaporator_pick": K.EK.launches,
              "cell_sums": K.CK.launches}
    got = {name: counts.get(name, 0) for name in least}
    if any(got[name] < n or (exact and got[name] != n) for name, n in least.items()):
        raise AssertionError(f"{label}: random-draw kernel launches {got}, "
                             f"{'exactly' if exact else 'at least'} {least} expected")
    return got


def _integrator_launches(K, label, steps, n_methods, shards=1, grid=True, rotational=False):
    """K6-K9's launches since the counts were set to 0, each exactly what
    ``steps`` steps (replays counted) of ``n_methods`` methods on ``shards``
    shards launch: step1 and step2 once a step a method a shard, the last
    method's step1 on a grid path as K7+K6 in one launch ("step1_drift",
    the verdict on a whole layout, each shard's top two on shards) and the
    others as K7 ("step1"); the drift check alone (K6) once a step for the
    verdict on shards, never on a whole layout; the rotation twice a step a
    method a shard. Returns {name: launches}."""
    fused = steps * shards if grid and n_methods else 0
    want = {"step1": steps * n_methods * shards - fused, "step1_drift": fused,
            "step2": steps * n_methods * shards,
            "drift_check": steps if grid and shards > 1 else 0,
            "no_squish": 2 * steps * n_methods * shards if rotational else 0}
    got = {name: K.IK.launches_by_kernel.get(name, 0) for name in want}
    if got != want:
        raise AssertionError(f"{label}: integrator kernel launches {got}, {want} expected "
                             f"({steps} steps, {n_methods} methods, {shards} shards)")
    return got


def _timed_run(sim, steps):
    """sim.run(steps) between CUDA events: (ms per step, host seconds)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    sim.run(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, time.perf_counter() - t0


def _check_wrapped(sim, what):
    pos = sim.state.get_snapshot().particles.position
    L = np.asarray(sim.state.box.L)
    if not (np.isfinite(pos).all() and (np.abs(pos) <= L / 2 + 1e-3).all()):
        raise AssertionError(f"{what}: positions non-finite or outside the box")
    return pos


def _temperatures(thermo):
    """(translational, rotational or None) kinetic temperature."""
    trans = 2.0 * thermo.kinetic_energy / thermo.translational_degrees_of_freedom
    rdof = thermo.rotational_degrees_of_freedom
    return trans, (2.0 * thermo.rotational_kinetic_energy / rdof if rdof > 0 else None)


def _mean_kT(sim, thermo, n=5, gap=20):
    """Mean translational and rotational (None without rotation) kT over
    ``n`` samples ``gap`` steps apart."""
    temps = []
    for _ in range(n):
        sim.run(gap)
        temps.append(_temperatures(thermo))
    rot = [r for _, r in temps if r is not None]
    return float(np.mean([t for t, _ in temps])), (float(np.mean(rot)) if rot else None)


def _profile(sim, steps=20):
    """Per step over a short profiled window: device operations,
    device-busy milliseconds, host-to-device copies, and the calls that made
    the host wait for the device (torch.cuda's sync debug mode; the run
    reads its flags once per chunk by design). torch.profiler's own host
    overhead makes this a breakdown, not a timer."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sim.run(steps)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    ops, busy_ms = _device_work(prof)
    htod = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy HtoD"))
    return ops / steps, busy_ms / steps, htod / steps, syncs / steps


def _device_work(prof):
    """(device operations, device-busy ms) in a torch.profiler trace."""
    ops = busy_us = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            ops += e.count
            busy_us += us
    return ops, busy_us / 1000.0


def _kernels_on_state(az, D, K, sim, forces, record):
    """Each pair kernel against its plain version on the path's own state
    after the run (want="all")."""
    dense, spec, dev = sim._dense, sim._grid_spec, sim.device
    errs = []
    for f in forces:
        if not f._needs_nlist:
            continue
        tbl = f._device_tables(dev)
        if isinstance(f, az.pair.DPDGeneralWeight):
            kT, dt, t = f.kT(sim.timestep), sim.dt_ref(), sim.timestep
            got = K.DK.dpd_force(dense, spec, tbl, kT, dt, sim.seed, t, "all")
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_velocity=True,
                                need_tag=True)
            ref = D.dense_dpd_force(dense, jb, spec, tbl["params"], tbl["r_cut"], kT, dt,
                                    sim.seed, t, "all")
            name = "cell_dpd_force"
        elif isinstance(f, az.pair.TwoPatchMorse):
            got = K.AK.cell_aniso_force(dense, spec, tbl["kernel"], "all")
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok, need_quat=True)
            ref = D.dense_aniso_force(f._def.energy_force_torque, dense, jb, spec,
                                      tbl["params"], tbl["r_cut"], f.mode, "all")
            name = "cell_aniso_force"
        else:
            pot = f._evaluator_name
            got = K.PK.cell_pair_force(dense, spec, tbl["kernel"], pot, f.mode, "all")
            jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
            ref = D.dense_pair_force(f._def.energy_force, dense, jb, spec, tbl["params"],
                                     tbl["r_cut"], tbl["r_on"], f.mode, "all")
            name = f"cell_pair_force[{pot}]"
        torch.cuda.synchronize()
        tag = f"{name} on the path's state"
        if got.torque is not None:
            ferr, _ = _compare_aniso(tag, got, ref, "all")
        else:
            ferr, _ = _compare_result(tag, got, ref, "all")
        record(name, ferr)
        errs.append(f"{name} {ferr:.3e}")
    return ", ".join(errs)


def _time_at_caps(az, D, K, sim, forces, caps):
    """The path's pair kernel on the path's own state, densified anew at
    each cap (grown by 8 until the state fits): ms per call in two turns
    (the caps in order, then in reverse) and candidate pairs, to show
    whether the time still follows cap. Returns the caps timed, their ms
    per turn and their candidates."""
    dense, spec, dev = sim._dense, sim._grid_spec, sim.device
    f = next(f for f in forces if f._needs_nlist)
    fields = ("quat",) if isinstance(f, az.pair.TwoPatchMorse) else ()
    state = D.undensify(dense, sim.state.N_particles, fields=fields)
    tbl = f._device_tables(dev)
    max_occ = int((dense.tag >= 0).reshape(spec.n_cells, spec.cap).sum(dim=1).max())
    if isinstance(f, az.pair.TwoPatchMorse):

        def call(d, sp):
            return K.AK.cell_aniso_force(d, sp, tbl["kernel"])
    elif isinstance(f, az.pair.DPDGeneralWeight):
        tables = K.DK.dpd_kernel_tables(tbl["params"], tbl["r_cut"], f.kT(sim.timestep),
                                        sim.dt_ref())

        def call(d, sp):
            return K.DK.cell_dpd_force(d, sp, tables, sim.seed, sim.timestep)
    else:

        def call(d, sp):
            return K.PK.cell_pair_force(d, sp, tbl["kernel"], f._evaluator_name, f.mode)

    grids = []
    for cap in caps:
        while True:
            sp = spec.replace(cap=cap)
            d, meta = D.densify(state, sp, fields=fields)
            if not bool(meta.overflow):
                break
            cap += 8
        grids.append((cap, d, sp))
    ms = {cap: [] for cap, _, _ in grids}
    for cap, d, sp in (*grids, *reversed(grids)):
        ms[cap].append(_cuda_time_ms(lambda: call(d, sp), 50))
    timed = [(cap, ms[cap], _candidates(d, sp)) for cap, d, sp in grids]
    print(f"[caps] kernel on the path's state (max occupancy {max_occ}), two turns: " + "; ".join(
        f"cap {c}: {' and '.join(f'{t:.4f}' for t in turns)} ms, {n} candidate pairs"
        for c, turns, n in timed), flush=True)
    return timed


def _record_tune(sim):
    """Record the capacity and rebuild interval before and after the
    capacity tune when the run fires it."""
    seen = {}
    tune = sim.tune_cell_capacity

    def recorded(*args, **kwargs):
        seen.update(t=sim.timestep, cap0=sim._grid_spec.cap, seg0=sim._seg_len,
                    ceiling0=sim._seg_ceiling)
        tune(*args, **kwargs)
        seen.update(cap=sim._grid_spec.cap, seg=sim._seg_len, ceiling=sim._seg_ceiling)

    sim.tune_cell_capacity = recorded
    return seen


def run_path(az, D, K, card, record, label, build, warm_steps, steps, counts, draws=None,
             extra_check=None, kT=1.0, kT_band=0.05, caps=()):
    """One main path at full size: warm up (printing the temperatures five
    times on the way), then ``steps`` timed steps with the launch counts set
    to 0 just before and read just after. The warm-up profiles the 20 steps
    before the capacity tune at step TUNE_AT and records the capacity and
    interval on both sides of it. ``counts`` maps each kernel name the path
    must run to a function that reads its count; ``draws`` maps each
    random-draw kernel the path must run to its least launches in the timed
    steps. The translational (and
    rotational) kinetic temperature must read ``kT`` within ``kT_band``
    after the timed steps (``kT=None``: the path checks its own). Afterwards
    the pair kernel is timed at each of ``caps`` on the path's state
    (``"tune"``: the capacities before and after the tune). Returns the
    counts and the simulation. A path with ``draws`` thermalizes its
    momenta in ``build``, through K4 too."""
    _reset_counts(K)
    sim, forces = build(az, "cuda")
    setup_draws = K.RK.launches_by_kernel.get("particle_bits", 0)
    if draws and setup_draws < 1:
        raise AssertionError(f"{label}: thermalize launched no random-draw kernel")
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    tuned = _record_tune(sim)
    t0 = time.perf_counter()
    sim.run(TUNE_AT - 20)
    pre_ops, pre_busy, _, _ = _profile(sim)
    curve = []
    chunk = (warm_steps - TUNE_AT) // 5
    for _ in range(5):
        sim.run(chunk)
        curve.append("/".join(f"{x:.4f}" for x in _temperatures(thermo) if x is not None))
    torch.cuda.synchronize()
    if tuned.get("t") != TUNE_AT:
        raise AssertionError(f"{label}: the capacity tune did not fire at step {TUNE_AT}")
    print(f"[{label}] N={sim.state.N_particles} grid {sim._grid_spec}: {sim.timestep} warm-up "
          f"steps in {time.perf_counter() - t0:.1f} s; kT (translational"
          f"{'/rotational' if '/' in curve[0] else ''}) every {chunk} steps after step "
          f"{TUNE_AT}: {', '.join(curve)}", flush=True)
    print(f"[{label}] tune at step {tuned['t']}: cap {tuned['cap0']} -> {tuned['cap']}, "
          f"rebuild interval {tuned['seg0']} -> {tuned['seg']} (ceiling {tuned['ceiling0']} -> "
          f"{tuned['ceiling']}); the 20 steps before it: {pre_ops:.1f} device operations and "
          f"{pre_busy:.4f} ms device-busy per step", flush=True)
    before = extra_check(sim, "before") if extra_check else None

    builds0, replays0, evals0 = sim.n_builds, sim.viol_replays, sim.force_evaluations
    steps0 = sim.steps_run
    n_pair_forces = sum(1 for f in forces if f._needs_nlist)
    _reset_counts(K)
    totals0 = dict(sim._graph_totals)
    ms_step, wall = _timed_run(sim, steps)
    graphed = {k: sim._graph_totals.get(k, 0) - totals0.get(k, 0)
               for k in ("captures", "replays", "eager_segments")}
    if sim._graphs_apply() and graphed["replays"] < 1:
        raise AssertionError(f"{label}: on the CUDA graphs, but no segment was replayed")
    launched = {name: read() for name, read in counts.items()}
    drawn = _draws(K, label, draws or {})
    evals = sim.force_evaluations - evals0
    builds = sim.n_builds - builds0
    replays = sim.viol_replays - replays0
    pair_evals = evals * n_pair_forces // len(forces)
    integ = sim.operations.integrator
    stepped = sim.steps_run - steps0
    integrated = _integrator_launches(K, label, stepped, len(integ.methods),
                                      grid=sim._grid_spec is not None,
                                      rotational=integ.integrate_rotational_dof)
    if sum(launched.values()) != pair_evals or min(launched.values()) < steps:
        raise AssertionError(f"{label}: kernel launches {launched} for {pair_evals} pair-force "
                             f"evaluations in {steps} steps")
    _check_wrapped(sim, label)
    after = extra_check(sim, "after", before) if extra_check else ""
    kT_trans, kT_rot = _mean_kT(sim, thermo)
    for what, value in (("translational", kT_trans), ("rotational", kT_rot)):
        if kT is not None and value is not None and abs(value - kT) > kT_band:
            raise AssertionError(f"{label}: {what} kinetic temperature {value:.4f} outside "
                                 f"{kT} +- {kT_band}")
    if not 0 < builds < steps:
        raise AssertionError(f"{label}: {builds} grid builds in {steps} steps")
    # observables through the kernels' energy/virial path
    energies = [f.energy for f in forces]
    p = thermo.pressure
    if not (np.all(np.isfinite(energies)) and np.isfinite(p)):
        raise AssertionError(f"{label}: non-finite energy or pressure")
    on_state = _kernels_on_state(az, D, K, sim, forces, record)
    ops, busy, htod, syncs = _profile(sim)
    print(f"[{label}] {steps} steps: {ms_step:.4f} ms/step, {1000.0 / ms_step:.1f} TPS "
          f"(host wall {wall:.3f} s) on {card}", flush=True)
    print(f"[{label}] launches {launched} for {evals} force evaluations "
          f"({sum(launched.values()) / steps:.3f} kernel launches per step); {builds} grid "
          f"builds ({steps / max(builds, 1):.1f} steps each), {replays} violation replays; "
          f"cap {sim._grid_spec.cap}, rebuild interval {sim._seg_len}; random-draw kernel "
          f"launches {drawn} (thermalize: {setup_draws}); integrator kernel launches "
          f"{integrated} ({stepped} steps x {len(integ.methods)} methods); CUDA graphs "
          f"{'on' if sim._graphs_apply() else 'off (the eager loop: ' + _why_eager(sim) + ')'}: "
          f"{graphed['captures']} captures, {graphed['replays']} replays, "
          f"{graphed['eager_segments']} first segments run eagerly", flush=True)
    print(f"[{label}] profile: {ops:.1f} device operations and {busy:.4f} ms device-busy "
          f"per step; {htod:.2f} host-to-device copies and {syncs:.2f} synchronising calls "
          f"per step", flush=True)
    rot = f", rotational {kT_rot:.4f}" if kT_rot is not None else ""
    target = f"target {kT} +- {kT_band}" if kT is not None else "lab frame, not checked"
    print(f"[{label}] kinetic temperature: translational {kT_trans:.4f}{rot} ({target}), "
          f"energies per particle "
          f"{[round(e / sim.state.N_particles, 5) for e in energies]}, pressure {p:.4f}"
          f"{after}; kernel vs plain on this state: {on_state}", flush=True)
    _busy_at_caps(sim, label, tuned["cap0"])
    if caps == "tune":
        caps = (tuned["cap"], tuned["cap0"])
    if caps:
        _time_at_caps(az, D, K, sim, forces, caps)
    return {**launched, **drawn, **integrated}, sim


def _why_eager(sim) -> str:
    """Why ``sim`` runs the eager loop on the card (Simulation._graph_eligible's rule)."""
    if any(getattr(u, "_updates_mpcd", False) for u in sim.operations.updaters):
        return "the MPCD coupling"
    if sim._sharded():
        return "a sharded mesh"
    if sim.operations.integrator is None:
        return "no integrator"
    return "a flow field of its own"


def _why_advance_eager(sim) -> str:
    """Why ``sim``'s SRD advance runs the eager loop on the card
    (Simulation._advance_graphs_apply's rule)."""
    if sim._coupling is not None or sim.mpcd_dynamics._coupled:
        return "the MPCD coupling"
    if len(sim._mpcd["position"]) > 1:
        return "a solvent in several blocks"
    if sim._eager:
        return "_eager"
    return "a profile"


def _advance_line(sim, totals0):
    """The SRD advance graphs' figures since ``totals0`` (a copy of
    sim._advance_totals), as a path's line prints them."""
    got = {k: sim._advance_totals.get(k, 0) - totals0.get(k, 0)
           for k in ("captures", "replays", "eager_segments")}
    if not sim._advance_graphs_apply():
        return got, f"SRD advance graphs off (the eager loop: {_why_advance_eager(sim)})"
    runner = sim._advance_graphs
    return got, (f"SRD advance graphs on: {got['captures']} captures, {got['replays']} replays, "
                 f"{got['eager_segments']} first runs eagerly; keys {runner.graph_keys()}, pool "
                 f"{runner.pool_bytes / 2**20:.1f} MB")


def _busy_at_caps(sim, label, untuned):
    """Device-busy ms a step at the path's capacity and at the one it had
    before the tune, on the path's state after its checks, in two turns
    (tuned, untuned, untuned, tuned): what the tune is worth on the card."""
    tuned = sim._grid_spec.cap
    if tuned == untuned:
        return
    busy = {tuned: [], untuned: []}
    for cap in (tuned, untuned, untuned, tuned):
        sim._synced_state()
        sim._grid_spec = sim._grid_spec.replace(cap=cap)
        sim._drop_dense()
        busy[cap].append(_profile(sim)[:2])
    print(f"[{label}] device-busy per step, two turns of 20 steps on the path's state: " +
          "; ".join(f"cap {c} ({'tuned' if c == tuned else 'before the tune'}): "
                    f"{' and '.join(f'{b:.4f} ms ({o:.1f} operations)' for o, b in busy[c])}"
                    for c in (tuned, untuned)), flush=True)


def _evaporated_after(t: int) -> int:
    """Particles the droplet's evaporator has retyped after t steps: one
    firing after each step divisible by the period, 10 each."""
    return DROPLET_EVAP_PER_FIRING * ((t + DROPLET_PERIOD - 1) // DROPLET_PERIOD)


def _droplet_check(sim, when, before=None):
    """N and the types unchanged but for the evaporated count, exact; no
    solvent particle beyond the barrier by more than DROPLET_OVERSHOOT;
    after the timed steps, the evaporated particles' kinetic temperature
    relative to the flow, m <|v - u(r)|^2> / 3, over 5 samples 100 steps
    apart."""
    integ = sim.operations.integrator
    barrier, method = integ.forces[1], integ.methods[0]

    def read():
        p = sim.state.get_snapshot().particles
        if p.N != DROPLET_N or not np.isin(p.typeid, (0, 1)).all():
            raise AssertionError(f"droplet: N {p.N} or typeids {np.unique(p.typeid)} changed")
        return p

    p = read()
    evaporated = int((p.typeid == 1).sum())
    if evaporated != _evaporated_after(sim.timestep):
        raise AssertionError(f"droplet: {evaporated} evaporated after {sim.timestep} steps, "
                             f"not {_evaporated_after(sim.timestep)}")
    R = barrier.location(sim.timestep)
    overshoot = float((np.linalg.norm(p.position[p.typeid == 0], axis=1) - R).max())
    if overshoot > DROPLET_OVERSHOOT:
        raise AssertionError(f"droplet: a solvent particle lies {overshoot:.3f} beyond the "
                             f"barrier at R = {R:.4f}")
    if when == "before":
        return evaporated, overshoot
    temps = []
    for _ in range(5):
        sim.run(100)
        p = read()
        evap = p.typeid == 1
        u = method.flow_field(torch.as_tensor(p.position[evap])).numpy()
        rel = p.velocity[evap] - u
        temps.append(float((p.mass[evap] * (rel * rel).sum(axis=1)).mean() / 3.0))
    kT_rel = float(np.mean(temps))
    if abs(kT_rel - 1.0) > DROPLET_KT_BAND:
        raise AssertionError(f"droplet: evaporated kT relative to the flow {kT_rel:.4f} outside "
                             f"1.0 +- {DROPLET_KT_BAND}")
    return (f", evaporated {before[0]} -> {evaporated} (exact), solvent beyond the barrier by "
            f"at most {before[1]:.4f} -> {overshoot:.4f} (R = {R:.4f}), evaporated kT relative "
            f"to the flow {kT_rel:.4f} over {int(evap.sum())} particles (samples "
            f"{', '.join(f'{t:.4f}' for t in temps)})")


def _dpd_momentum(sim, when, before=None):
    """|total momentum| / N; DPD conserves it, so it stays at its start
    value (0: the fluid starts at rest) up to float32 round-off."""
    snap = sim.state.get_snapshot()
    p = np.abs((snap.particles.velocity * snap.particles.mass[:, None]).sum(axis=0)).max()
    p_per = float(p) / snap.particles.N
    if p_per > 1e-5:
        raise AssertionError(f"DPD: |total momentum|/N = {p_per:.3e} {when} the timed steps")
    return p_per if when == "before" else f", |P|/N {before:.3e} -> {p_per:.3e}"


def _bond_lengths(sim, when, before=None):
    """Bond lengths (minimum image) of the chains of 25: finite."""
    snap = sim.state.get_snapshot()
    d = np.diff(snap.particles.position.reshape(-1, 25, 3), axis=1)
    L = np.asarray(snap.configuration.box[:3])
    r = np.linalg.norm(d - L * np.round(d / L), axis=-1)
    if not np.isfinite(r).all():
        raise AssertionError(f"polymer: non-finite bond lengths {when} the timed steps")
    return f", bond lengths {r.min():.4f}-{r.max():.4f} (mean {r.mean():.4f})"


def _unit_quaternions(sim, when, before=None):
    """|q| = 1 within 1e-4 on every particle."""
    q = sim.state.get_snapshot().particles.orientation
    dev = float(np.abs(np.linalg.norm(q, axis=1) - 1.0).max())
    if not np.isfinite(q).all() or dev > 1e-4:
        raise AssertionError(f"patchy: max ||q| - 1| = {dev:.3e} {when} the timed steps")
    return dev if when == "before" else f", max ||q| - 1| {before:.2e} -> {dev:.2e}"


def run_potential_sweep(az, K):
    """Every other isotropic potential through the public API: 200 Langevin
    steps of a 16^3 lattice fluid each, in turn with modes none/shift/xplor;
    counts set to 0 just before each and read just after."""
    launched = {}
    PK = K.PK
    others = [p for p in PK.KERNEL_POTENTIALS
              if p not in ("PerturbedLennardJones", "ExpandedYukawa")]
    for i, pot in enumerate(others):
        snap = _lattice_snapshot(az, counts=(16, 16, 16), rho=0.85, jitter=0.02, seed=40 + i)
        snap.particles.velocity[:] = 0.0
        sim = az.Simulation(device="cuda", seed=40 + i)
        sim.create_state_from_snapshot(snap)
        mode = MODES[i % 3]
        force = getattr(az.pair, pot)(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0,
                    default_r_on=1.5, mode=mode)
        params = potential_params(pot, 1, np.random.default_rng(50 + i))
        force.params[("A", "A")] = {k: float(v[0, 0]) for k, v in params.items()}
        sim.operations.integrator = az.md.Integrator(
            dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=1.0)],
            forces=[force])
        sim.state.thermalize_particle_momenta(kT=1.0)
        sim.run(0)
        _reset_counts(K)
        evals0 = sim.force_evaluations
        sim.run(200)
        torch.cuda.synchronize()
        n = PK.launches_by_potential.get(pot, 0)
        evals = sim.force_evaluations - evals0
        if n != evals or n < 200 or PK.launches != n:
            raise AssertionError(f"{pot}: {n} kernel launches for {evals} force evaluations")
        _check_wrapped(sim, pot)
        if not np.isfinite(force.energy):
            raise AssertionError(f"{pot}: non-finite energy")
        print(f"[sweep] {pot} (mode {mode}): {n} launches for {evals} force evaluations, "
              f"U/N {force.energy / sim.state.N_particles:.4f}", flush=True)
        launched[pot] = n
    return launched


def _solvent_kT(sim):
    """The solvent's kinetic temperature relative to its mean velocity,
    m_s <|v - <v>|^2> / 3, and its mean velocity."""
    v = sim._whole_mpcd()["velocity"].double()
    mean = v.mean(dim=0)
    kT = float(sim._mpcd["mass"] * ((v - mean) ** 2).sum(dim=1).mean() / 3.0)
    return kT, mean.cpu().numpy()


def _profile_call(fn, reps):
    """(device operations, device-busy ms) per call of ``fn``, over ``reps``
    calls under torch.profiler (a breakdown, not a timer)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops, busy_ms = _device_work(prof)
    return ops / reps, busy_ms / reps


def time_pair_on_state(az, D, PK, sim, f, label):
    """K1 or K1' at a path's own state after its run: kernel and plain ms
    per call (force only), bound, candidate pairs and pairs inside r_cut."""
    dense, spec = sim._dense, sim._grid_spec
    tbl = f._device_tables(sim.device)
    pot, tables = f._evaluator_name, tbl["kernel"]
    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    ef = az.ops.evaluators.PAIR_POTENTIALS[pot].energy_force
    ms = _cuda_time_ms(lambda: PK.cell_pair_force(dense, spec, tables, pot, f.mode), 50)
    plain_ms = _cuda_time_ms(
        lambda: D.dense_pair_force(ef, dense, jb, spec, tbl["params"], tbl["r_cut"],
                                   tbl.get("r_on"), f.mode, "force"), 5)
    pairs = _pairs_inside(D, dense, spec, f._max_r_cut())
    candidates = _candidates(dense, spec)
    bound_ms, by = _bound(dense, 16, 12, 4 * tables.numel(), pairs, OPS_PER_PAIR[pot])
    print(f"[{label}] cell_pair_force[{pot}] at the {label}'s state (mode {f.mode}, cap "
          f"{spec.cap}, dims {spec.dims}, {int((dense.tag >= 0).sum())} particles): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms per call (force); bound {bound_ms:.5f} ms "
          f"({by}); {candidates} candidate pairs per call, {pairs} unordered pairs inside "
          f"r_cut", flush=True)


def _colloid_bits(az):
    """Whether two identical colloid runs of 60 steps (three joint
    collisions) agree bitwise (the cell sums are K10's, in a fixed order),
    and their largest difference."""
    out = []
    for _ in range(2):
        sim, _ = build_colloid(az, "cuda")
        sim.run(60)
        out.append((sim._whole_mpcd()["velocity"], sim._synced_state().velocity.clone()))
        del sim
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(out[0], out[1]))
    diff = max(float((a - b).abs().max()) for a, b in zip(out[0], out[1]))
    return same, diff


def _colloid_limits(sim, label):
    """The colloid path's limits: the total momentum is the body force's
    impulse on the solvent (shared with the colloids by the collisions and
    conserved by the pair force) within COLLOID_P_BAND m_s N_s, and the
    solvent's kT relative to its mean velocity 1.0 +- COLLOID_KT_BAND.
    Returns (P, P wanted, solvent kT, solvent mean velocity)."""
    solvent = sim._whole_mpcd()
    m_s, f_x = solvent["mass"], sim.mpcd_dynamics.body_force[0]
    v_s = solvent["velocity"].double()
    N_s = v_s.shape[0]
    state = sim._synced_state()
    P = (m_s * v_s.sum(dim=0) + (state.mass.double()[:, None]
                                 * state.velocity.double()).sum(dim=0)).cpu().numpy()
    P_want = np.array([m_s * N_s * f_x * sim.timestep * sim.dt_ref(), 0.0, 0.0])
    if not (np.abs(P - P_want) <= COLLOID_P_BAND * m_s * N_s).all():
        raise AssertionError(f"{label}: total momentum {P} against {P_want} "
                             f"(band {COLLOID_P_BAND * m_s * N_s:.3f})")
    kT_s, mean_s = _solvent_kT(sim)
    if abs(kT_s - 1.0) > COLLOID_KT_BAND:
        raise AssertionError(f"{label}: solvent kT relative to its mean velocity {kT_s:.4f} "
                             f"outside 1.0 +- {COLLOID_KT_BAND}")
    return P, P_want, kT_s, mean_s


def run_colloid(az, D, K, card, record):
    """Colloid hydrodynamics at full size through the public API: warm-up
    with the tune at step 150, then COLLOID_STEPS timed steps with the
    launch counts set to 0 just before and read just after; every LJ
    evaluation through K1'; momentum, solvent kT and advection checked.
    Returns the counts."""
    sim, forces = build_colloid(az, "cuda")
    lj = forces[0]
    coupling = sim.operations.updaters[0]
    tuned = _record_tune(sim)
    t0 = time.perf_counter()
    sim.run(COLLOID_WARM - 20)
    pre_ops, pre_busy, _, _ = _profile(sim)
    torch.cuda.synchronize()
    if tuned.get("t") != COLLOID_TUNE_AT:
        raise AssertionError(f"colloid: the capacity tune did not fire at step {COLLOID_TUNE_AT}")
    if not coupling._ingraph:
        raise AssertionError("colloid: the joint collision is not on its default schedule")
    N_c, N_s = sim.state.N_particles, sim._whole_mpcd()["position"].shape[0]
    print(f"[colloid] N_c={N_c} N_s={N_s} grid {sim._grid_spec}: {sim.timestep} warm-up steps "
          f"in {time.perf_counter() - t0:.1f} s; collisions in the step loop: "
          f"{coupling._ingraph}", flush=True)
    print(f"[colloid] tune at step {tuned['t']}: cap {tuned['cap0']} -> {tuned['cap']}, "
          f"rebuild interval {tuned['seg0']} -> {tuned['seg']} (ceiling {tuned['ceiling0']} -> "
          f"{tuned['ceiling']}); steps {COLLOID_WARM - 20}-{COLLOID_WARM}: {pre_ops:.1f} device "
          f"operations and {pre_busy:.4f} ms device-busy per step", flush=True)

    name = "cell_pair_force[LJ]"
    builds0, replays0, evals0 = sim.n_builds, sim.viol_replays, sim.force_evaluations
    steps0 = sim.steps_run
    _reset_counts(K)
    ms_step, wall = _timed_run(sim, COLLOID_STEPS)
    launched = {name: K.PK.launches_by_potential.get("LJ", 0)}
    collisions = COLLOID_STEPS // sim.mpcd_dynamics.period
    # the coupled path keeps the eager loop: K5's host-key form, K10
    drawn = _draws(K, "colloid", {"jax_normal_axis": collisions, "cell_sums": collisions})
    _check_grid(sim, "colloid")
    evals = sim.force_evaluations - evals0
    if launched[name] != evals or evals < COLLOID_STEPS or K.PK.launches != evals:
        raise AssertionError(f"colloid: {launched} LJ kernel launches for {evals} force "
                             f"evaluations in {COLLOID_STEPS} steps")
    builds, replays = sim.n_builds - builds0, sim.viol_replays - replays0
    if not replays and not drawn["jax_normal_axis"] == drawn["cell_sums"] == collisions:
        # (a violation replay collides again)
        raise AssertionError(f"colloid: {drawn['jax_normal_axis']} K5 launches and "
                             f"{drawn['cell_sums']} K10 calls for {collisions} collisions")
    integrated = _integrator_launches(K, "colloid", sim.steps_run - steps0, 1)
    _check_wrapped(sim, "colloid")

    m_s = sim._mpcd["mass"]
    P, P_want, kT_s, mean_s = _colloid_limits(sim, "colloid")
    state = sim._synced_state()
    v_c = state.velocity.double()
    vx_c = float(v_c[:, 0].mean())
    if not 0.0 < vx_c < 1.1 * mean_s[0]:
        raise AssertionError(f"colloid: colloids' mean vx {vx_c:.4f} not in (0, 1.1 x the "
                             f"solvent's {mean_s[0]:.4f})")
    kT_c = float((state.mass.double()[:, None] * (v_c - v_c.mean(dim=0)) ** 2).sum()
                 / (3.0 * (N_c - 1)))
    on_state = _kernels_on_state(az, D, K, sim, forces, record)
    ops, busy, htod, syncs = _profile(sim)

    # one joint collision alone at this state: device time and operations
    dense, seed = sim._dense, sim.seed
    solv = sim._mpcd["_srd_anchor"]
    t_col = solv[2] + sim.mpcd_dynamics.period

    def collide():
        return coupling._collide((dense,), solv, t_col, seed, m_s)

    collide()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        collide()
    end.record()
    torch.cuda.synchronize()
    col_ms = start.elapsed_time(end) / 10
    col_ops, col_busy = _profile_call(collide, 5)
    print(f"[colloid] {COLLOID_STEPS} steps: {ms_step:.4f} ms/step, {1000.0 / ms_step:.1f} TPS "
          f"(host wall {wall:.3f} s) on {card}", flush=True)
    print(f"[colloid] launches {launched} for {evals} force evaluations "
          f"({launched[name] / COLLOID_STEPS:.3f} kernel launches per step); {builds} grid "
          f"builds, {replays} violation replays; cap {sim._grid_spec.cap}, rebuild interval "
          f"{sim._seg_len}; random-draw kernel launches {drawn}; integrator kernel launches "
          f"{integrated}", flush=True)
    print(f"[colloid] profile: {ops:.1f} device operations and {busy:.4f} ms device-busy per "
          f"step; {htod:.2f} host-to-device copies and {syncs:.2f} synchronising calls per "
          f"step", flush=True)
    print(f"[colloid] one joint collision ({N_s + sim._dense.tag.numel()} rows, "
          f"{sim.mpcd_dynamics._grid_dims()} cells): {col_ms:.4f} ms a call (CUDA events over 10 "
          f"calls issued after a synchronize, host launches included), "
          f"{col_ops:.1f} device operations and {col_busy:.4f} ms device-busy", flush=True)
    print(f"[colloid] total momentum {P.round(4).tolist()} against {P_want.round(4).tolist()} "
          f"(band {COLLOID_P_BAND * m_s * N_s:.3f}); solvent kT relative to its mean "
          f"{kT_s:.4f} (1.0 +- {COLLOID_KT_BAND}), solvent mean vx {mean_s[0]:.4f}, colloids' "
          f"mean vx {vx_c:.4f}, colloids' kT {kT_c:.4f} (a reading); kernel vs plain on this "
          f"state: {on_state}", flush=True)
    time_pair_on_state(az, D, K.PK, sim, lj, "colloid")
    run_profile(sim, "colloid", 2 * sim.mpcd_dynamics.period, card, collisions=2)
    del sim
    same, diff = _colloid_bits(az)
    if not same:
        raise AssertionError(f"colloid: two identical 60-step runs differ (max |dv| {diff:.3e})")
    print("[colloid] two identical 60-step runs agree bitwise (the cell sums in K10's fixed "
          "order)", flush=True)
    return {**launched, **drawn, **integrated}


def _check_grid(sim, label):
    """The path's collision grid is the one [rng] held and timed K5 at."""
    cells = int(np.prod(sim.mpcd_dynamics._grid_dims()))
    if (cells, 3) != NORMAL_SHAPES[label]:
        raise AssertionError(f"{label}: collision grid of {cells} cells, [rng] took "
                             f"{NORMAL_SHAPES[label]}")


def run_poiseuille(az, K, card):
    """The SRD Poiseuille slit at full size: POISEUILLE_STEPS steps, then the
    profile over 16 bins of the velocity field compute (the example reads it
    after 50 more steps). The fitted parabola R^2 > 0.95, its peak > 0.03,
    and no solvent particle beyond the plates. Returns the random-draw and
    integrator kernels' launches in the timed steps."""
    sim = build_poiseuille(az, "cuda")
    L = float(sim.state.box.L[2])
    sim.run(TUNE_AT)
    _check_grid(sim, "poiseuille")
    _reset_counts(K)
    steps0 = sim.steps_run
    totals0 = dict(sim._advance_totals)
    ms_step, wall = _timed_run(sim, POISEUILLE_STEPS - TUNE_AT)
    advanced, advance = _advance_line(sim, totals0)
    if advanced["replays"] < 1:
        raise AssertionError(f"poiseuille: the SRD advance replayed no graph ({advance})")
    # one K5 launch a collision (its clock form on the advance graphs: the
    # axes, the virtual fill's normals and the shift) and one K10 call
    collisions = (POISEUILLE_STEPS - TUNE_AT) // sim.mpcd_dynamics.period
    drawn = _draws(K, "poiseuille", {"jax_normal_axis_clock": collisions, "jax_normal_axis": 0,
                                     "cell_sums": collisions}, exact=True)
    # its two MD particles have no pair force, so no grid: K7 alone, no drift check
    drawn.update(_integrator_launches(K, "poiseuille", sim.steps_run - steps0, 1, grid=False))
    field = az.compute.CartesianVelocityFieldCompute(
        num_bins=(0, 0, POISEUILLE_BINS), lower_bounds=(0, 0, -L / 2),
        upper_bounds=(0, 0, L / 2), include_mpcd_particles=True)
    sim.operations.computes.append(field)
    ops, busy, htod, syncs = _profile(sim, steps=50)
    prof = field.velocities[:, 0]
    z = (np.arange(POISEUILLE_BINS) + 0.5) / POISEUILLE_BINS - 0.5
    A = np.stack([0.25 - z**2, np.ones(POISEUILLE_BINS)], 1)
    coef, *_ = np.linalg.lstsq(A, prof, rcond=None)
    r2 = 1 - ((prof - A @ coef) ** 2).sum() / max(((prof - prof.mean()) ** 2).sum(), 1e-12)
    solvent = sim._whole_mpcd()["position"]
    beyond = float(solvent[:, 2].abs().max()) - L / 2
    print(f"[poiseuille] N={solvent.shape[0]} L={L}: steps {TUNE_AT}-"
          f"{POISEUILLE_STEPS}: {ms_step:.4f} ms/step (host wall {wall:.3f} s) on {card}; "
          f"profile: {ops:.1f} device operations and {busy:.4f} ms device-busy per step, "
          f"{htod:.2f} host-to-device copies and {syncs:.2f} synchronising calls per step; "
          f"random-draw, cell-sum and integrator kernel launches {drawn}; {advance}",
          flush=True)
    print(f"[poiseuille] v_x(z) over {POISEUILLE_BINS} bins: {np.round(prof, 4).tolist()}; "
          f"parabola R^2 {r2:.4f} (> 0.95), peak {prof.max():.4f} (> 0.03), furthest solvent "
          f"{beyond:+.2e} beyond the plates", flush=True)
    if not (r2 > 0.95 and prof.max() > 0.03 and beyond <= 1e-4):
        raise AssertionError(f"poiseuille: R^2 {r2:.4f}, peak {prof.max():.4f}, solvent "
                             f"{beyond:.3e} beyond the plates")
    return drawn


def run_srd(az, K, card):
    """Pure SRD throughput: SRD_WARM steps, a 20-step profile, then SRD_STEPS
    timed steps, each with one collision; the solvent's kT relative to its
    mean within SRD_KT_BAND of 1. Returns the random-draw and integrator
    kernels' launches in the timed steps."""
    sim = build_srd(az, "cuda")
    sim.run(SRD_WARM)
    _check_grid(sim, "srd")
    ops, busy, htod, syncs = _profile(sim)
    _reset_counts(K)
    steps0 = sim.steps_run
    totals0 = dict(sim._advance_totals)
    ms_step, wall = _timed_run(sim, SRD_STEPS)
    advanced, advance = _advance_line(sim, totals0)
    if advanced["replays"] < 1:
        raise AssertionError(f"srd: the SRD advance replayed no graph ({advance})")
    drawn = _draws(K, "srd", {"jax_normal_axis_clock": SRD_STEPS, "jax_normal_axis": 0,
                              "cell_sums": SRD_STEPS}, exact=True)
    drawn.update(_integrator_launches(K, "srd", sim.steps_run - steps0, 1, grid=False))
    kT, _ = _solvent_kT(sim)
    print(f"[srd] N={sim._whole_mpcd()['position'].shape[0]}, {SRD_STEPS} steps of one collision each: "
          f"{ms_step:.4f} ms per collision (host wall {wall:.3f} s) on {card}; profile: "
          f"{ops:.1f} device operations and {busy:.4f} ms device-busy per step, {htod:.2f} "
          f"host-to-device copies and {syncs:.2f} synchronising calls per step; solvent kT "
          f"relative to its mean {kT:.4f} (1.0 +- {SRD_KT_BAND}); random-draw, cell-sum and "
          f"integrator kernel launches {drawn}; {advance}", flush=True)
    if abs(kT - 1.0) > SRD_KT_BAND:
        raise AssertionError(f"srd: solvent kT {kT:.4f} outside 1.0 +- {SRD_KT_BAND}")
    return drawn


class _FireLog:
    """Wraps each writer's ``write``: fires, host ms, and the synchronising
    calls torch.cuda's sync debug mode reports inside them (while ``caught``,
    the run's recorded warnings, is set)."""

    def __init__(self, writers):
        self.caught = None
        self.stats = {}
        for w in writers:
            self._wrap(w)

    def _wrap(self, w):
        name, write = type(w).__name__, w.write
        stats = self.stats.setdefault(name, {"fires": 0, "ms": 0.0, "syncs": 0, "at": []})

        def timed(sim, timestep):
            n0 = len(self.caught) if self.caught is not None else 0
            t0 = time.perf_counter()
            write(sim, timestep)
            stats["ms"] += 1000.0 * (time.perf_counter() - t0)
            stats["fires"] += 1
            stats["at"].append(timestep)
            if self.caught is not None:
                stats["syncs"] += sum("synchroniz" in str(m.message) for m in self.caught[n0:])

        w.write = timed

    def reset(self):
        for s in self.stats.values():
            s.update(fires=0, ms=0.0, syncs=0, at=[])


def _same_state(what, got, want):
    """Positions, velocities and images of two snapshots, bit for bit."""
    for field in ("position", "velocity", "image"):
        a, b = getattr(got.particles, field), getattr(want.particles, field)
        if not np.array_equal(a, b):
            raise AssertionError(f"io: {what}: {field} differs (max |d| "
                                 f"{np.abs(np.asarray(a, float) - b).max():.3e})")


def _get_snapshot_cost(sim, reps=3):
    """Host ms of ``get_snapshot()`` on a state a chunk left in slot order
    (the device idle before each call), each beside the ms of its first part,
    the slot-to-tag reorder (``_synced_state`` and a synchronize); and the
    synchronising calls of one call."""
    import warnings

    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        sim._state_stale = True
        t0 = time.perf_counter()
        sim._synced_state()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sim.state.get_snapshot()
        t2 = time.perf_counter()
        ms.append(f"{1000.0 * (t2 - t0):.2f} ({1000.0 * (t1 - t0):.2f} reorder)")
    sim._state_stale = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.state.get_snapshot()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return ms, sum("synchroniz" in str(w.message) for w in caught)


def run_io(az, K, card, sim, workdir):
    """The headline (``sim``, after its own path) with three writers: a Table
    of kT and the potential energy every IO_TABLE_PERIOD steps, a Trajectory
    and a GSD every IO_FRAME_PERIOD, over IO_STEPS steps with the launch
    counts set to 0 just before and read just after. Checks the frames'
    timesteps, the last frame against ``get_snapshot()`` bit for bit, the
    Table's rows (finite, kT 1.0 +- IO_KT_BAND) and that every force
    evaluation (and each energy the Table reads) launched K1 and every step
    K6, K7 and K8 (Langevin's step with its draw) once; counts the
    synchronising calls inside each fire. Then times ms/step without and
    with the writers in alternating turns, and restarts from the last frame
    three times: twice from ``save_checkpoint`` through ``load_checkpoint``
    and the ``timestep`` setter, once through ``create_state_from_gsd``; the
    three must agree bit for bit after IO_RESTART_STEPS. Returns the K1 and
    K6-K8 launches."""
    import warnings

    PK = K.PK
    thermo = next(c for c in sim.operations.computes
                  if isinstance(c, az.compute.ThermodynamicQuantities))
    logger = az.write.Logger()
    logger.add(thermo, ["kinetic_temperature", "potential_energy"], prefix="thermo")
    paths = {k: str(workdir / f"headline.{k}") for k in ("log", "azt", "gsd", "ckpt")}
    writers = [az.write.Table(IO_TABLE_PERIOD, logger, output=paths["log"]),
               az.write.Trajectory(IO_FRAME_PERIOD, paths["azt"]),
               az.write.GSD(IO_FRAME_PERIOD, paths["gsd"])]
    fires = _FireLog(writers)
    sim.run(-sim.timestep % IO_FRAME_PERIOD)  # start on a frame: the run ends on one
    t0 = sim.timestep
    sim.operations.writers[:] = writers
    evals0, steps0 = sim.force_evaluations, sim.steps_run
    _reset_counts(K)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fires.caught = caught
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run(IO_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            fires.caught = None
            for w in writers:
                w.close()
    launched = PK.launches_by_potential.get("PerturbedLennardJones", 0)
    run_syncs = sum("synchroniz" in str(w.message) for w in caught)
    evals = sim.force_evaluations - evals0
    table = fires.stats["Table"]
    if launched != evals + table["fires"] or PK.launches != launched:
        raise AssertionError(f"io: {launched} PLJ launches ({PK.launches} in all) for {evals} "
                             f"force evaluations and {table['fires']} Table energy reads")
    integrated = _integrator_launches(K, "io", sim.steps_run - steps0, 1)
    t1 = sim.timestep
    for name, period in (("Table", IO_TABLE_PERIOD), ("Trajectory", IO_FRAME_PERIOD),
                         ("GSD", IO_FRAME_PERIOD)):
        want = [t for t in range(t0 + 1, t1 + 1) if t % period == 0]
        if fires.stats[name]["at"] != want:
            raise AssertionError(f"io: {name} fired at {fires.stats[name]['at']}, not {want}")
    # the files, read back
    live = sim.state.get_snapshot()
    with az.io.TrajectoryReader(paths["azt"]) as r:
        steps = r.timesteps
        _, last = r.read_frame(len(r) - 1)
    frame = az.io.chunks_to_snapshot(last)
    gsd_last = az.io.read_gsd(paths["gsd"])
    with az.io.GSDReader(paths["gsd"]) as g:
        gsd_steps = [int(g.read_chunk(k, "configuration/step")[0]) for k in range(g.n_frames)]
    if steps != fires.stats["Trajectory"]["at"] or gsd_steps != steps:
        raise AssertionError(f"io: frames at {steps} (aztraj) and {gsd_steps} (GSD)")
    for what, snap in (("aztraj frame", frame), ("GSD frame", gsd_last)):
        for field in ("position", "velocity"):
            if not np.array_equal(getattr(snap.particles, field),
                                  np.float32(getattr(live.particles, field))):
                raise AssertionError(f"io: the last {what}'s {field} is not get_snapshot()'s")
        if not np.array_equal(snap.particles.image, live.particles.image):
            raise AssertionError(f"io: the last {what}'s images are not get_snapshot()'s")
    lines = open(paths["log"]).read().split("\n")
    rows = np.array([[float(v) for v in ln.split()] for ln in lines[1:] if ln.strip()])
    if (lines[0].split() != ["timestep", "thermo.kinetic_temperature", "thermo.potential_energy"]
            or rows.shape != (len(table["at"]), 3) or not np.isfinite(rows).all()
            or np.abs(rows[:, 1] - 1.0).max() > IO_KT_BAND):
        raise AssertionError(f"io: Table header {lines[0]!r}, rows {rows.tolist()}")
    snap_ms, snap_syncs = _get_snapshot_cost(sim)
    n = sim.state.N_particles
    print(f"[io] N={n} from step {t0}: {IO_STEPS} steps with a Table every {IO_TABLE_PERIOD} "
          f"steps and a Trajectory and a GSD every {IO_FRAME_PERIOD}: {launched} K1 launches for "
          f"{evals} force evaluations + {table['fires']} Table energy reads; integrator "
          f"kernel launches {integrated}; aztraj backend: "
          f"{'native C++ (g++)' if az.io.native_available() else 'pure Python'}", flush=True)
    print(f"[io] fires (host ms per fire, synchronising calls per fire): " + "; ".join(
        f"{k} {s['fires']} ({s['ms'] / s['fires']:.2f} ms, {s['syncs'] / s['fires']:.1f} syncs)"
        for k, s in fires.stats.items()) + f"; the whole run {run_syncs} synchronising calls; "
        f"get_snapshot() alone after a chunk: {', '.join(snap_ms)} ms, "
        f"{snap_syncs} synchronising calls", flush=True)
    print(f"[io] files read back: {len(steps)} aztraj frames at {steps}, {len(gsd_steps)} GSD "
          f"frames, {len(rows)} Table rows (kT {rows[:, 1].min():.4f}-{rows[:, 1].max():.4f}, "
          f"U/N {rows[:, 2].min() / n:.4f}-{rows[:, 2].max() / n:.4f}); the last frame of each "
          f"file equals get_snapshot() bit for bit", flush=True)

    # restarts from the last frame: two from a checkpoint, one from the GSD
    az.io.save_checkpoint(sim, paths["ckpt"])
    sim.operations.writers[:] = []
    sim.run(IO_RESTART_STEPS)
    continuous = sim.state.get_snapshot()
    restarts = []
    for how in ("checkpoint", "checkpoint", "gsd"):
        if how == "gsd":
            new = az.Simulation(device=sim.device, seed=HEADLINE["seed"])
            new.create_state_from_gsd(paths["gsd"])
            _headline_forces(az, new)
        else:
            snap, ts = az.io.load_checkpoint(paths["ckpt"])
            new, _ = build_headline(az, sim.device, snapshot=snap)
            new.timestep = ts
        if new.timestep != t1:
            raise AssertionError(f"io: a {how} restart resumed at step {new.timestep}, not {t1}")
        tuned = _record_tune(new)
        new.run(IO_RESTART_STEPS)
        if tuned:
            raise AssertionError(f"io: a {how} restart at step {t1} tuned again")
        restarts.append(new.state.get_snapshot())
        del new
    _same_state("two checkpoint restarts", restarts[1], restarts[0])
    _same_state("the GSD restart against the checkpoint's", restarts[2], restarts[0])
    drift = np.abs(restarts[0].particles.position - continuous.particles.position)
    L = np.asarray(continuous.configuration.box[:3])
    drift = np.minimum(drift, L - drift).max()
    print(f"[io] restarts at step {t1}: two from the checkpoint and one from the GSD file agree "
          f"bit for bit after {IO_RESTART_STEPS} steps; max |dx| against the continuous run "
          f"{drift:.3e} (not bitwise: the restart's stored acceleration and cell capacity "
          f"are rebuilt)", flush=True)

    # ms/step without and with the writers, in alternating turns
    writers = [az.write.Table(IO_TABLE_PERIOD, logger, output=paths["log"]),
               az.write.Trajectory(IO_FRAME_PERIOD, paths["azt"]),
               az.write.GSD(IO_FRAME_PERIOD, paths["gsd"])]
    fires = _FireLog(writers)
    ms = {"without": [], "with": []}
    try:
        for k in range(IO_TURNS):
            turn = ("without", "with", "with", "without")[k % 4]
            sim.operations.writers[:] = writers if turn == "with" else []
            ms[turn].append(_timed_run(sim, IO_TURN_STEPS)[0])
    finally:
        sim.operations.writers[:] = []
        for w in writers:
            w.close()
    n_fires = sum(s["fires"] for s in fires.stats.values())
    extra = (np.mean(ms["with"]) - np.mean(ms["without"])) * IO_TURN_STEPS * len(ms["with"])
    print(f"[io] ms/step in alternating turns of {IO_TURN_STEPS} steps on {card}: without "
          f"writers {', '.join(f'{m:.4f}' for m in ms['without'])}; with them "
          f"{', '.join(f'{m:.4f}' for m in ms['with'])}; {n_fires} fires: "
          f"{extra / max(n_fires, 1):.2f} ms a fire from the step time; host ms per fire: " +
          ", ".join(f"{k} {s['ms'] / max(s['fires'], 1):.2f}" for k, s in fires.stats.items()),
          flush=True)
    return {"cell_pair_force[PerturbedLennardJones]": launched, **integrated}


def run_examples(az, K, card, workdir, device="cuda"):
    """The port's nine examples (azplugins_tpu_torch/examples/), each with
    AZTPU_EXAMPLE_FAST=1 and ``main(device="cuda")`` in a directory of its
    own, one after another: wall time, kernel launches and the last line
    each prints. An example raises on its own checks; every example with a
    pair force must have launched its kernel."""
    import contextlib
    import importlib.util
    import io as _io
    import os

    from azplugins_tpu_torch.examples import EXAMPLES

    os.environ["AZTPU_EXAMPLE_FAST"] = "1"
    src = Path(az.__file__).resolve().parent / "examples"
    cwd = os.getcwd()
    try:
        for name in EXAMPLES:
            run_dir = workdir / name
            run_dir.mkdir()
            os.chdir(run_dir)
            spec = importlib.util.spec_from_file_location(f"smoke_example_{name}",
                                                          src / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if not mod.FAST:
                raise AssertionError(f"examples: {name} is not in its smoke mode")
            _reset_counts(K)
            out = _io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mod.main(device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {"cell_pair_force": K.PK.launches, "cell_dpd_force": K.DK.launches,
                        "cell_aniso_force": K.AK.launches}
            lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
            if not lines or "nan" in out.getvalue().lower():
                raise AssertionError(f"examples: {name} printed {out.getvalue()!r}")
            if name != "mpcd_poiseuille" and sum(launched.values()) == 0:
                raise AssertionError(f"examples: {name} launched no kernel")
            print(f"[examples] {name}: {wall:.2f} s on {card}; launches "
                  f"{ {k: v for k, v in launched.items() if v} }; last line: {lines[-1].strip()}",
                  flush=True)
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# [spatial] and [profile]
# ---------------------------------------------------------------------------
def _same_dense(what, got, want):
    """Two simulations' slot layouts (positions, velocities, images, tags),
    timesteps, rebuild counts and grids, bit for bit."""
    if (got.timestep, got.n_builds, got._grid_spec) != (want.timestep, want.n_builds,
                                                        want._grid_spec):
        raise AssertionError(f"spatial: {what}: timestep, builds, grid {got.timestep}, "
                             f"{got.n_builds}, {got._grid_spec} against {want.timestep}, "
                             f"{want.n_builds}, {want._grid_spec}")
    for field in ("position", "velocity", "image", "tag"):
        a, b = getattr(got._dense, field), getattr(want._dense, field)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"spatial: {what}: {field} differs (max |d| "
                                 f"{float((a.double() - b.double()).abs().max()):.3e})")


def run_spatial(az, K, card):
    """[spatial]: the 64k headline built three times from one seed, whole
    (one block), in SPATIAL_MESHES[0] slabs and in SPATIAL_MESHES[1] strips
    (blocks on the card, ``make_mesh(n, device="cuda")``), run in turns for
    SPATIAL_STRETCH steps (across the tune at step 200) and SPATIAL_STRETCH
    more; after each stretch the decomposed layouts must equal the whole
    one bit for bit, every force evaluation of every run must have
    launched K1 and every step K6, K7 and K8 once (one for the whole slot
    axis), the counts set to 0 just before each run's stretch and read just
    after. Returns the K1 and K6-K8 launches."""
    from azplugins_tpu_torch.parallel import make_mesh

    runs = {1: build_headline(az, "cuda")[0]}
    for n in SPATIAL_MESHES:
        sim, _ = build_headline(az, "cuda")
        sim.enable_spatial_decomposition(make_mesh(n, device="cuda"))
        runs[n] = sim
    launched, integrated = 0, {}
    ms = {n: [] for n in runs}
    for stretch in (1, 2):
        for n, sim in runs.items():
            evals0, steps0 = sim.force_evaluations, sim.steps_run
            _reset_counts(K)
            ms[n].append(_timed_run(sim, SPATIAL_STRETCH)[0])
            evals = sim.force_evaluations - evals0
            k1 = K.PK.launches_by_potential.get("PerturbedLennardJones", 0)
            if k1 != evals or K.PK.launches != evals or evals < SPATIAL_STRETCH:
                raise AssertionError(f"spatial: n={n}: {K.PK.launches} K1 launches for {evals} "
                                     f"force evaluations in {SPATIAL_STRETCH} steps")
            launched += k1
            for name, k in _integrator_launches(K, f"spatial: n={n}", sim.steps_run - steps0,
                                                1).items():
                integrated[name] = integrated.get(name, 0) + k
        for n in SPATIAL_MESHES:
            _same_dense(f"n={n} after {runs[n].timestep} steps", runs[n], runs[1])
    spec = runs[1]._grid_spec
    for n, sim in runs.items():
        kind = ("whole" if n == 1 else "slabs of whole x planes"
                if spec.dims[0] % n == 0 else "strips of z columns")
        print(f"[spatial] n={n} ({kind}): grid {spec.dims}, cap {spec.cap}, "
              f"{spec.dims[0] * spec.dims[1] // n} z columns and {spec.S // n} slots a block; "
              f"ms/step {ms[n][0]:.4f} (steps 0-{SPATIAL_STRETCH}, the tune inside), "
              f"{ms[n][1]:.4f} (steps {SPATIAL_STRETCH}-{2 * SPATIAL_STRETCH}) on {card}; "
              f"{sim.n_builds} builds since the tune, {sim.viol_replays} violation replays",
              flush=True)
    print(f"[spatial] n={'/'.join(map(str, SPATIAL_MESHES))} equal to the whole run bit for "
          f"bit (positions, velocities, images, tags in slot order) after {SPATIAL_STRETCH} "
          f"and {2 * SPATIAL_STRETCH} steps; {launched} K1 launches, one a force evaluation; "
          f"integrator kernel launches {integrated} (one of each a step)", flush=True)
    return {"cell_pair_force[PerturbedLennardJones]": launched, **integrated}


def _shard_windows(dense, spec, n):
    """The dense state split into n shards on the card, with their halo
    windows (every field a stencil kernel reads)."""
    from azplugins_tpu_torch.parallel import halo_window, make_mesh, shard_dense

    shards = shard_dense(dense, make_mesh(n, device=dense.device, sharded=True))
    fields = ("position", "typeid", "tag", "velocity", "orientation")
    return shards, [halo_window(shards, d, spec, fields) for d in range(n)]


def _windowed_equals_whole(name, launch, plain, dense, spec, n, record_as, record):
    """Each of n shards' windowed launch against the whole grid's launch on
    its own slots, bit for bit; and the launches of shards 0 and n/2
    against the plain windowed stencil on the same window (``plain(w)``,
    want="all", on the card) at the [kernel] bar, the force's error
    recorded under ``record_as``. Returns (window columns, min and max)."""
    whole = launch(dense, None)
    shards, windows = _shard_windows(dense, spec, n)
    got = [launch(shards[d], windows[d]) for d in range(n)]
    torch.cuda.synchronize()
    for k in ("force", "torque", "energy", "virial"):
        if getattr(whole, k) is None:
            continue
        joined = torch.cat([getattr(g, k) for g in got])
        if not torch.equal(joined.view(torch.int32), getattr(whole, k).view(torch.int32)):
            raise AssertionError(f"spatial: windowed {name} on {n} shards differs from the "
                                 f"whole grid's launch in {k}")
    for d in (0, n // 2):
        ref = plain(windows[d])
        torch.cuda.synchronize()
        tag = f"windowed {name} shard {d} of {n}"
        compare = _compare_aniso if got[d].torque is not None else _compare_result
        want = "all" if got[d].energy is not None else "force"
        record(record_as, compare(tag, got[d], ref, want)[0])
    cols = [w.n_cols for w in windows]
    return min(cols), max(cols)


def _partners(D, dense, spec, r_cut):
    """Each slot's partners within ``r_cut`` (one type pair), by the plain
    stencil loop: a shard's pair work is half its own slots' sum."""

    def count(dx, dy, dz, rsq, mask, j, newton):
        inside = (mask & (rsq > 0) & (rsq < r_cut * r_cut)).to(torch.float32)
        return [inside], [inside]

    jb = D.make_jblocks(dense, spec, half=spec.newton_ok)
    (n,) = D._stencil_drive(dense, jb, spec, 1, count)
    return n.reshape(-1).double()


def run_spatial_sharded(az, D, K, card, record):
    """[spatial] on shards: the 64k headline built three times from one
    seed, whole and on SPATIAL_MESHES[0] and SPATIAL_MESHES[1] shards of its
    own slot storage on the card (``make_mesh(n, device="cuda",
    sharded=True)``: the block-local rebin with migration, halo windows into
    K1), run in turns for SPATIAL_STRETCH steps (across the tune) and
    SPATIAL_STRETCH more. After each stretch the gathered layout must equal
    the whole one bit for bit, K1 must have launched n times a force
    evaluation, K7+K6 (a shard's step1 and top two in one launch) and K8
    (Langevin's step with its draw) n times a step and K6 once (the
    verdict over the shards' top twos) (the
    counts set to 0 just before each stretch and read just after). Then,
    on the runs' state: the windowed K1 (force) and K1' (PLJ and LJ,
    want="all") against the whole grid's launch on each shard's own slots,
    bit for bit, and the windowed K2 and K3 on the DPD fluid's and
    the patchy colloids' first states, and those of shards 0 and n/2
    against the plain windowed stencil on the card at the [kernel] bar; the
    windowed K1's time a call per shard against the whole grid's and the
    plain windowed stencil's, and its bound at the window's bytes; the halo
    bytes and copies a force evaluation; device operations, device-busy ms
    (over PROFILE_STEPS steps, the [profile] window) and ms/step at each n;
    the phase's wall time. Returns the K1 and K6-K8 launches."""
    from azplugins_tpu_torch.parallel import make_mesh
    from azplugins_tpu_torch.parallel.spatial import halo_runs

    plj = "PerturbedLennardJones"
    ef = az.ops.evaluators.PAIR_POTENTIALS
    phase_t0 = time.perf_counter()
    runs = {1: build_headline(az, "cuda")[0]}
    for n in SPATIAL_MESHES:
        sim, _ = build_headline(az, "cuda")
        sim.enable_spatial_decomposition(make_mesh(n, device="cuda", sharded=True))
        runs[n] = sim
    launched, integrated, stretch_s = 0, {}, 0.0
    ms = {n: [] for n in runs}
    for stretch in (1, 2):
        for n, sim in runs.items():
            evals0, steps0 = sim.force_evaluations, sim.steps_run
            _reset_counts(K)
            ms_step, host_s = _timed_run(sim, SPATIAL_STRETCH)
            ms[n].append(ms_step)
            stretch_s += host_s
            evals = sim.force_evaluations - evals0
            k1 = K.PK.launches_by_potential.get(plj, 0)
            if k1 != n * evals or K.PK.launches != k1 or evals < SPATIAL_STRETCH:
                raise AssertionError(f"spatial: {n} shards: {K.PK.launches} K1 launches for "
                                     f"{evals} force evaluations in {SPATIAL_STRETCH} steps")
            if n > 1 and not isinstance(sim._dense, tuple):
                raise AssertionError(f"spatial: {n} shards: the layout is not sharded")
            launched += k1
            for name, k in _integrator_launches(K, f"spatial: {n} shards",
                                                sim.steps_run - steps0, 1, shards=n).items():
                integrated[name] = integrated.get(name, 0) + k
        whole = runs[1]
        for n in SPATIAL_MESHES:
            sim = runs[n]
            if (sim.timestep, sim.n_builds, sim._grid_spec) != (whole.timestep, whole.n_builds,
                                                                 whole._grid_spec):
                raise AssertionError(f"spatial: {n} shards: timestep, builds, grid "
                                     f"{sim.timestep}, {sim.n_builds}, {sim._grid_spec}")
            got = sim._whole_dense()
            for field in ("position", "velocity", "image", "tag"):
                a, b = getattr(got, field), getattr(whole._dense, field)
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"spatial: {n} shards after {sim.timestep} steps: "
                                         f"{field} differs")
    spec = runs[1]._grid_spec
    dense = runs[1]._dense
    lj = runs[1].operations.integrator.forces[0]
    tbl = lj._device_tables("cuda")
    lj_params = {"lj1": tbl["params"]["lj1"], "lj2": tbl["params"]["lj2"]}
    ljt = K.PK.kernel_tables("LJ", lj_params, tbl["r_cut"], tbl["r_on"], "shift")

    def plain_pair(w, pot, params, mode, want="all", jb=None):
        jb = jb if jb is not None else D.make_jblocks(w.state, spec, half=spec.newton_ok,
                                                      window=w)
        return D.dense_pair_force(ef[pot].energy_force, w.state, jb, spec, params, tbl["r_cut"],
                                  tbl.get("r_on"), mode, want, window=w)

    checks = []
    for n in SPATIAL_MESHES:
        for name, want, pot, tables, params, mode in (
                ("K1", "force", plj, tbl["kernel"], tbl["params"], lj.mode),
                ("K1'", "all", plj, tbl["kernel"], tbl["params"], lj.mode),
                ("K1'", "all", "LJ", ljt, lj_params, "shift")):
            lo, hi = _windowed_equals_whole(
                name, lambda d, w, want=want, pot=pot, tables=tables, mode=mode:
                K.PK.cell_pair_force(d, spec, tables, pot, mode, want, window=w),
                lambda w, pot=pot, params=params, mode=mode: plain_pair(w, pot, params, mode),
                dense, spec, n, f"cell_pair_force[{pot}]", record)
            checks.append(f"{name}[{pot}, {want}] n={n} (windows of {lo}-{hi} columns)")
    # K2 and K3 on the DPD fluid's and the patchy colloids' prepared states
    for build, name, n_of in ((build_dpd, "K2", lambda sp: sp.dims[0]),
                              (build_patchy, "K3", lambda sp: sp.dims[0] * sp.dims[1] // 23)):
        sim, forces = build(az, "cuda")
        d2, s2 = _prepared_dense(sim)
        f = forces[0]
        t2 = f._device_tables("cuda")
        if name == "K2":
            kT, dt, seed = f.kT(0), sim.dt_ref(), sim.seed
            tables = K.DK.dpd_kernel_tables(t2["params"], t2["r_cut"], kT, dt)
            record_as = "cell_dpd_force"

            def launch(d, w, s2=s2, tables=tables, seed=seed):
                return K.DK.cell_dpd_force(d, s2, tables, seed, 0, "all", window=w)

            def plain(w, s2=s2, t2=t2, kT=kT, dt=dt, seed=seed):
                jb = D.make_jblocks(w.state, s2, half=s2.newton_ok, need_velocity=True,
                                    need_tag=True, window=w)
                return D.dense_dpd_force(w.state, jb, s2, t2["params"], t2["r_cut"], kT, dt,
                                         seed, 0, "all", window=w)
        else:
            record_as = "cell_aniso_force"

            def launch(d, w, s2=s2, t2=t2):
                return K.AK.cell_aniso_force(d, s2, t2["kernel"], "all", window=w)

            def plain(w, s2=s2, t2=t2, f=f):
                jb = D.make_jblocks(w.state, s2, half=s2.newton_ok, need_quat=True, window=w)
                return D.dense_aniso_force(f._def.energy_force_torque, w.state, jb, s2,
                                           t2["params"], t2["r_cut"], f.mode, "all", window=w)
        n = n_of(s2)
        lo, hi = _windowed_equals_whole(name, launch, plain, d2, s2, n, record_as, record)
        checks.append(f"{name} n={n} on grid {s2.dims} (windows of {lo}-{hi} columns)")
        del sim
    print(f"[spatial] windowed launches equal the whole grid's on every shard's own slots, bit "
          f"for bit, and the plain windowed stencil's on shards 0 and n/2 within the bar "
          f"({BAR}): {'; '.join(checks)}", flush=True)

    # per shard: the windowed K1's time against the whole grid's, and its bound
    partners = _partners(D, dense, spec, 3.0)
    n_occ = (dense.tag >= 0).double()
    per_col = spec.dims[2] * spec.cap
    whole_ms = _cuda_time_ms(lambda: K.PK.cell_pair_force(dense, spec, tbl["kernel"], plj,
                                                          lj.mode), 50)
    in_bytes = 16  # position, typeid
    for n in SPATIAL_MESHES:
        shards, windows = _shard_windows(dense, spec, n)
        S_loc = spec.S // n
        rows = []
        for d in (0, n // 2):
            w = windows[d]
            t = _cuda_time_ms(lambda: K.PK.cell_pair_force(shards[d], spec, tbl["kernel"], plj,
                                                           lj.mode, window=w), 50)
            jb = D.make_jblocks(w.state, spec, half=spec.newton_ok, window=w)
            t_plain = _cuda_time_ms(lambda: plain_pair(w, plj, tbl["params"], lj.mode, "force",
                                                       jb), 3)
            occ_win = int((w.state.tag >= 0).sum())
            win_bytes = occ_win * in_bytes + w.n_cols * per_col * 4 + S_loc * 12
            pairs = float(partners[d * S_loc:(d + 1) * S_loc].sum()) / 2.0
            t_bytes = win_bytes / MEM_BYTES_PER_S
            t_ops = pairs * OPS_PER_PAIR[plj] / F32_OPS_PER_S
            bound = 1e3 * max(t_bytes, t_ops)
            own = int(n_occ[d * S_loc:(d + 1) * S_loc].sum())
            rows.append(f"shard {d}: {t:.4f} ms, plain {t_plain:.4f} ms ({w.n_cols} window "
                        f"columns, {w.n_cols * per_col} window slots, {own} own particles, bound "
                        f"{bound:.5f} ms by {'bytes' if t_bytes >= t_ops else 'operations'})")
        halo_cols = [halo_runs(tuple(spec.dims), n, d)[1] - spec.dims[0] * spec.dims[1] // n
                     for d in range(n)]
        copies = [sum(1 for e, _, _ in halo_runs(tuple(spec.dims), n, d)[2] if e != d)
                  for d in range(n)]
        halo_bytes = sum(halo_cols) * per_col * 20  # position, typeid, tag
        print(f"[spatial] {n} shards on {card}: windowed K1 a call, against the whole grid's "
              f"{whole_ms:.4f} ms: {'; '.join(rows)}; halo {halo_bytes / 1e6:.3f} MB in "
              f"{sum(copies) * 3} copies a force evaluation ({min(halo_cols)}-{max(halo_cols)} "
              f"columns a shard from {min(copies)}-{max(copies)} other shards, 3 fields)",
              flush=True)
    for n, sim in runs.items():
        ops, busy, _, syncs = _profile(sim, PROFILE_STEPS)
        print(f"[spatial] n={n} ({'whole' if n == 1 else 'shards'}): grid {spec.dims}, cap "
              f"{sim._grid_spec.cap}; ms/step {ms[n][0]:.4f} (steps 0-{SPATIAL_STRETCH}, the "
              f"tune inside), {ms[n][1]:.4f} (steps {SPATIAL_STRETCH}-{2 * SPATIAL_STRETCH}) "
              f"in turns on {card}; profile over {PROFILE_STEPS} steps (a run() start and its "
              f"builds inside, as the headline's profile line): {ops:.1f} device operations and "
              f"{busy:.4f} ms device-busy per step, {syncs:.2f} synchronising calls per step; "
              f"{sim.n_builds} builds, {sim.viol_replays} violation replays", flush=True)
    print(f"[spatial] shards n={'/'.join(map(str, SPATIAL_MESHES))} equal to the whole run bit "
          f"for bit (positions, velocities, images, tags, gathered in slot order; builds, grid) "
          f"after {SPATIAL_STRETCH} and {2 * SPATIAL_STRETCH} steps; {launched} K1 launches, "
          f"n a force evaluation; integrator kernel launches {integrated} (K7+K6, K8 n a "
          f"step, K6 once); the phase took "
          f"{time.perf_counter() - phase_t0:.1f} s, of which {stretch_s:.1f} s the stretches",
          flush=True)
    return {"cell_pair_force[PerturbedLennardJones]": launched, **integrated}


def _same_sharded(what, got, want):
    """A sharded simulation's layout, gathered in slot order, against the
    whole run's (positions, velocities, images, tags, typeids), bit for
    bit, with the timestep, builds and grid."""
    if (got.timestep, got.n_builds, got._grid_spec) != (want.timestep, want.n_builds,
                                                        want._grid_spec):
        raise AssertionError(f"spatial_ops: {what}: timestep, builds, grid {got.timestep}, "
                             f"{got.n_builds}, {got._grid_spec} against {want.timestep}, "
                             f"{want.n_builds}, {want._grid_spec}")
    dense = got._whole_dense()
    for field in ("position", "velocity", "image", "tag", "typeid"):
        a, b = getattr(dense, field), getattr(want._dense, field)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"spatial_ops: {what}: {field} differs (max |d| "
                                 f"{float((a.double() - b.double()).abs().max()):.3e})")


def _phase_ops(sim, steps):
    """``steps`` steps under ``sim.profile`` (a directory inside the
    checkout, removed after): the trace's ranges, device operations and
    device-busy us by phase (``_phase_split``)."""
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_profile_") as logdir:
        with sim.profile(logdir):
            sim.run(steps)
        (trace,) = Path(logdir).glob("*.pt.trace.json")
        return _phase_split(trace)


def _windowed_on_path(az, D, K, sim, f, label, record):
    """The path's pair kernel (K1 or K1', want="force" as the step loop
    launches it) on the sharded run's own shards 0 and n/2, in their halo
    windows, against the plain windowed stencil on the card at the
    [kernel] bar; its ms a call (CUDA events) and its bound (``_bound`` on
    the window: its occupied slots' inputs and every window tag once, the
    own slots' forces, the table; the shard's pairs inside r_cut)."""
    shards, spec = sim._dense, sim._grid_spec
    windows = sim._windows(shards)
    tbl = f._device_tables(sim.device)
    pot = f._evaluator_name
    name = f"cell_pair_force[{pot}]"
    partners = _partners(D, sim._whole_dense(), spec, f._max_r_cut())
    S_loc, n = shards[0].N, len(shards)
    rows = []
    for d in (0, n // 2):
        w = windows[d]

        def launch(d=d, w=w):
            return K.PK.cell_pair_force(shards[d], spec, tbl["kernel"], pot, f.mode, "force",
                                        window=w)

        got = launch()
        jb = D.make_jblocks(w.state, spec, half=spec.newton_ok, window=w)
        ref = D.dense_pair_force(f._def.energy_force, w.state, jb, spec, tbl["params"],
                                 tbl["r_cut"], tbl.get("r_on"), f.mode, "force", window=w)
        torch.cuda.synchronize()
        err, _ = _compare_result(f"{label}: windowed {name} shard {d} of {n}", got, ref, "force")
        record(name, err)
        ms = _cuda_time_ms(launch, 50)
        pairs = float(partners[d * S_loc:(d + 1) * S_loc].sum()) / 2.0
        bound_ms, by = _bound(w.state, 16, 0, 4 * tbl["kernel"].numel() + 12 * S_loc, pairs,
                              OPS_PER_PAIR[pot])
        rows.append(f"shard {d}: {ms:.4f} ms a call, bound {bound_ms:.5f} ms ({by}, "
                    f"{ms / bound_ms:.0f}x), max abs force error {err:.3e} ({w.n_cols} window "
                    f"columns, {int(pairs)} pairs inside r_cut)")
    print(f"[spatial_ops] {label}: windowed {name} on its own state: {'; '.join(rows)}",
          flush=True)


def run_spatial_ops(az, D, K, card, record):
    """[spatial_ops]: updaters, bonds and the MPCD solvent on a sharded mesh.
    The droplet (its evaporator), the polymer melt (its bonds, from the
    built state, no warm-up) and colloid hydrodynamics (its solvent in
    particle blocks and the joint collision), each built twice from one
    seed, whole and on SPATIAL_OPS_SHARDS shards of the card
    (``make_mesh(n, device="cuda", sharded=True)``; the whole run on the
    grid the mesh snaps to, as views of one slot axis), run in turns with the
    launch counts set to 0 just before each run and read just after: K1 or
    K1' once a force evaluation whole, n times on shards. The droplet and
    the polymer must equal the whole run bit for bit after each stretch
    (the evaporated count too, and above 0; the bond lengths finite); the
    colloids on shards hold their path's limits, and one joint collision
    on shards agrees with the whole one within SPATIAL_OPS_COLLISION_BAR of
    max|v|. K7+K6 and K8 must have launched once a step a shard, K6 once
    a step for the verdict, K4 once an evaporator fire a
    shard (the droplet), K5 once a collision (the colloids). Prints
    ms/step, device operations, busy ms and synchronising calls a step
    (PROFILE_STEPS steps, as [spatial]), the updaters phase's
    operations (droplet), the position gather's ms (polymer), the joint
    collision's ms and operations (colloid), the windowed kernel on shards
    0 and n/2 against the plain windowed stencil with its bound, and the
    phase's wall time. Returns the kernel launches."""
    from azplugins_tpu_torch.parallel import make_mesh
    from azplugins_tpu_torch.parallel.spatial import gather_dense

    phase_t0 = time.perf_counter()
    n = SPATIAL_OPS_SHARDS
    launched = {}
    paths = (("droplet", build_droplet, "PerturbedLennardJones"),
             ("polymer", build_polymer, "ExpandedYukawa"),
             ("colloid", build_colloid, "LJ"))
    for label, build, pot in paths:
        t0 = time.perf_counter()
        runs = {}
        for key in ("whole", "shards"):
            sim, forces = build(az, "cuda")
            # the whole run is on the grid the mesh snaps to (the views of
            # one slot axis: one layout, the global rebin, one launch)
            sim.enable_spatial_decomposition(make_mesh(n, device="cuda",
                                                       sharded=key == "shards"))
            runs[key] = (sim, forces)
        stretch = SPATIAL_OPS_STRETCH[label]
        ms = {key: [] for key in runs}
        name = f"cell_pair_force[{pot}]"
        for turn in ((1, 2) if label != "colloid" else (1,)):
            for key, (sim, _) in runs.items():
                evals0, steps0 = sim.force_evaluations, sim.steps_run
                _reset_counts(K)
                ms[key].append(_timed_run(sim, stretch)[0])
                evals = (sim.force_evaluations - evals0) // len(sim.operations.integrator.forces)
                k = K.PK.launches_by_potential.get(pot, 0)
                want = evals * (n if key == "shards" else 1)
                if k != want or K.PK.launches != k or evals < stretch:
                    raise AssertionError(f"spatial_ops: {label} {key}: {K.PK.launches} kernel "
                                         f"launches for {evals} force evaluations")
                launched[name] = launched.get(name, 0) + k
                # K6-K8 every step, once a shard; K4: the evaporator once
                # a fire a shard; K5: the joint collision's axes
                m = n if key == "shards" else 1
                if label == "colloid":
                    least = {"jax_normal_axis": stretch // sim.mpcd_dynamics.period}
                elif label == "droplet" and key == "shards":
                    least = {"particle_bits": m * (stretch // DROPLET_PERIOD)}
                elif label == "droplet":  # K4 at the pick, two launches at least a fire
                    least = {"evaporator_pick": 2 * (stretch // DROPLET_PERIOD)}
                else:
                    least = {}
                drawn = _draws(K, f"spatial_ops: {label} {key}", least)
                drawn.update(_integrator_launches(K, f"spatial_ops: {label} {key}",
                                                  sim.steps_run - steps0, 1, shards=m))
                for kernel, k in drawn.items():
                    launched[kernel] = launched.get(kernel, 0) + k
            whole, sharded = runs["whole"][0], runs["shards"][0]
            if not isinstance(sharded._dense, tuple) or len(sharded._dense) != n:
                raise AssertionError(f"spatial_ops: {label}: the layout is not in {n} shards")
            if label == "colloid":
                continue
            _same_sharded(f"{label} after {sharded.timestep} steps", sharded, whole)
            if label == "droplet":
                counts = [int((s.typeid == 1).sum()) for s in (whole._dense,
                                                                sharded._whole_dense())]
                if counts[0] != counts[1] or counts[0] <= 0:
                    raise AssertionError(f"spatial_ops: droplet: evaporated {counts}")
            else:
                _bond_lengths(sharded, "after")
        (whole, forces), (sharded, _) = runs["whole"], runs["shards"]
        extra = ""
        if label == "droplet":
            evap = sharded.operations.updaters[0]
            shards = sharded._dense
            # the sharded pick against the whole pick on this state, with no
            # host synchronisation allowed
            torch.cuda.synchronize()
            _reset_counts(K)
            torch.cuda.set_sync_debug_mode("error")
            try:
                picked = evap._update_shards(shards, sharded.timestep, sharded.seed)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            _draws(K, "spatial_ops: droplet: the sharded pick", {"particle_bits": n})
            want = evap._update(gather_dense(shards, sharded.device), sharded.timestep,
                                sharded.seed)
            if not torch.equal(gather_dense(picked, sharded.device).typeid, want.typeid):
                raise AssertionError("spatial_ops: droplet: the sharded pick is not the whole "
                                     "pick")
            flipped = int((want.typeid != gather_dense(shards, sharded.device).typeid).sum())
            upd = []
            for key, sim in (("whole", whole), ("shards", sharded)):
                # one fire a period (again in a replayed step)
                ranges, ops, busy = _phase_ops(sim, DROPLET_PERIOD)
                fires = ranges["updaters"]
                if fires < 1:
                    raise AssertionError(f"spatial_ops: droplet {key}: no updaters range in "
                                         f"{DROPLET_PERIOD} steps")
                upd.append(f"{key} {ops['updaters'] / fires:.1f} operations, "
                           f"{busy['updaters'] / 1000.0 / fires:.4f} ms busy "
                           f"({ops['updaters'] / DROPLET_PERIOD:.2f} operations a step)")
            _same_sharded("droplet after the profiled period", sharded, whole)
            extra = (f"; evaporated {int((sharded._whole_dense().typeid == 1).sum())} after "
                     f"{sharded.timestep // DROPLET_PERIOD} fires, equal; the sharded pick at "
                     f"step {sharded.timestep} ({flipped} flipped; one K4 launch a shard) the "
                     f"whole pick bit for bit with no synchronising call; the updaters phase a "
                     f"fire: "
                     f"{'; '.join(upd)}")
        elif label == "polymer":
            gather_ms = _cuda_time_ms(lambda: sharded._partners(sharded._dense), 50)
            extra = (f"; the position gather {gather_ms:.4f} ms a step ({sharded._grid_spec.S} "
                     f"rows into each of {n} shards); {_bond_lengths(sharded, 'after')[2:]}")
        else:
            P, P_want, kT_s, mean_s = _colloid_limits(sharded, "spatial_ops: colloid shards")
            _colloid_limits(whole, "spatial_ops: colloid whole")
            if len(sharded._mpcd["position"]) != n:
                raise AssertionError(f"spatial_ops: colloid: the solvent is not in {n} blocks")
            coupling = sharded.operations.updaters[0]
            m_s, seed = sharded._mpcd["mass"], sharded.seed
            anchor = sharded._mpcd["_srd_anchor"]
            t_col = anchor[2] + sharded.mpcd_dynamics.period
            shards = sharded._dense
            dev = sharded.device
            whole_in = ((gather_dense(shards, dev),),
                        tuple((az.mpcd._joined(a, dev),) for a in anchor[:2]) + (anchor[2],))

            def collide_shards():
                return coupling._collide(shards, anchor, t_col, seed, m_s)

            def collide_whole():
                return coupling._collide(*whole_in, t_col, seed, m_s)

            got, want = collide_shards(), collide_whole()
            torch.cuda.synchronize()
            errs = []
            for part, g, w in (("solvent", az.mpcd._joined(got[1][1], dev), want[1][1][0]),
                               ("colloids", gather_dense(got[0], dev).velocity,
                                want[0][0].velocity)):
                err = float((g - w).abs().max()) / float(w.abs().max())
                if not torch.isfinite(g).all() or err > SPATIAL_OPS_COLLISION_BAR:
                    raise AssertionError(f"spatial_ops: colloid: the sharded joint collision's "
                                         f"{part} velocities differ by {err:.3e} of max|v|")
                errs.append(f"{part} {err:.3e}")
            col = {}
            for key, fn in (("whole", collide_whole), ("shards", collide_shards)):
                col[key] = (_cuda_time_ms(fn, 10), *_profile_call(fn, 5))
            extra = (f"; on shards: total momentum {P.round(4).tolist()} against "
                     f"{P_want.round(4).tolist()}, solvent kT relative to its mean {kT_s:.4f} "
                     f"(1.0 +- {COLLOID_KT_BAND}), solvent in {n} blocks; one joint collision "
                     f"on shards against the whole one: {', '.join(errs)} of max|v| (bar "
                     f"{SPATIAL_OPS_COLLISION_BAR}); its ms a call, operations and busy ms: "
                     + "; ".join(f"{k} {t:.4f} ms, {o:.1f} ops, {b:.4f} ms busy"
                                 for k, (t, o, b) in col.items()))
        prof = {key: _profile(sim, PROFILE_STEPS) for key, (sim, _) in runs.items()}
        f = next(f for f in forces if f._needs_nlist)
        _windowed_on_path(az, D, K, sharded, next(g for g in runs["shards"][1]
                                                  if g._needs_nlist), label, record)
        held = ("the solvent and colloid limits on shards" if label == "colloid" else
                "bit for bit the whole run after each stretch")
        print(f"[spatial_ops] {label} on {n} shards ({f._evaluator_name}; {held}) on {card}: "
              + "; ".join(f"{key} ms/step {' / '.join(f'{m:.4f}' for m in ms[key])}, "
                          f"{prof[key][0]:.1f} device operations and {prof[key][1]:.4f} ms "
                          f"device-busy a step, {prof[key][3]:.2f} synchronising calls a step"
                          for key in runs)
              + f"; {runs['shards'][0].n_builds} builds, grid {runs['shards'][0]._grid_spec.dims}"
              f", cap {runs['shards'][0]._grid_spec.cap}{extra}; {time.perf_counter() - t0:.1f} s",
              flush=True)
        del runs, whole, sharded
    print(f"[spatial_ops] launches {launched}; the phase took "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    return launched


PHASES = ("rebin", "integrate_step1", "verlet_drift_check", "forces", "integrate_step2",
          "updaters", "mpcd_joint_collision")


def _phase_split(trace):
    """A ``Simulation.profile`` trace (Chrome JSON) -> (ranges by phase,
    device operations by phase, device-busy us by phase). A device operation
    belongs to the phase whose range encloses, on the same host thread, the
    runtime call that launched it (matched by correlation id); "outside"
    holds the rest of the run (its host reads, the solvent's advance)."""
    import bisect
    from collections import Counter, defaultdict

    events = json.loads(Path(trace).read_text())["traceEvents"]
    spans = defaultdict(list)
    ranges = Counter()
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in PHASES:
            ranges[e["name"]] += 1
            spans[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for v in spans.values():
        v.sort()
    phase_of = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            v = spans.get((e["pid"], e["tid"]), [])
            i = bisect.bisect_right(v, (e["ts"], float("inf"), "")) - 1
            if i >= 0 and v[i][0] <= e["ts"] <= v[i][1]:
                phase_of[corr] = v[i][2]
    ops, busy = Counter(), Counter()
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            phase = phase_of.get(e.get("args", {}).get("correlation"), "outside")
            ops[phase] += 1
            busy[phase] += e.get("dur", 0)
    return ranges, ops, busy


def run_profile(sim, label, steps, card, collisions=0):
    """[profile]: ``steps`` steps of ``sim`` under ``sim.profile`` into a
    directory inside the checkout (removed afterwards); the trace's ranges
    must count one of each step phase a step (the force evaluations'
    count, so a replayed step counts again), ``rebin`` once a build in the
    window and ``mpcd_joint_collision`` ``collisions`` times (at least, and
    at least once a build, when a replay or a capacity growth fell in the
    window). Prints the device operations and device-busy ms a step under
    each phase, and ms/step (``steps`` steps timed just before, unprofiled)
    over the operations a step: the host's us an operation (not traced: the
    host work between launches is not split). On the headline each of
    ``integrate_step1``, ``verlet_drift_check`` and ``integrate_step2`` must
    issue at most 2 device operations a step (K7+K6, the drift check's
    none on a whole layout, K8)."""
    sim._eager = True  # the eager loop's ms/step, as the profile runs it
    try:
        ms_step = _timed_run(sim, steps)[0]
    finally:
        sim._eager = False
    evals0, builds0, replays0 = sim.force_evaluations, sim.n_builds, sim.viol_replays
    spec0 = sim._grid_spec
    n_forces = len(sim.operations.integrator.forces)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_profile_") as logdir:
        with sim.profile(logdir):
            sim.run(steps)
        traces = list(Path(logdir).glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile: {label}: {len(traces)} trace files in {logdir}")
        ranges, ops, busy = _phase_split(traces[0])
    evaluated = (sim.force_evaluations - evals0) // n_forces
    builds, replays = sim.n_builds - builds0, sim.viol_replays - replays0
    exact = replays == 0 and sim._grid_spec == spec0
    want = {"integrate_step1": evaluated, "verlet_drift_check": evaluated, "forces": evaluated,
            "integrate_step2": evaluated, "updaters": 0}
    if exact:
        want.update(rebin=builds, mpcd_joint_collision=collisions)
    got = {k: ranges[k] for k in want}
    if (got != want or evaluated < steps or ranges["rebin"] < (builds if exact else 1)
            or ranges["mpcd_joint_collision"] < collisions):
        raise AssertionError(f"profile: {label}: ranges {dict(ranges)} against {want} "
                             f"({replays} violation replays)")
    split = "; ".join(f"{p} {ops[p] / steps:.1f} ops {busy[p] / 1000.0 / steps:.4f} ms"
                      for p in (*PHASES, "outside") if ops[p] or ranges[p])
    per_step = sum(ops.values()) / steps
    if label == "headline":
        over = {p: ops[p] / steps for p in ("integrate_step1", "verlet_drift_check",
                                             "integrate_step2") if ops[p] > 2 * steps}
        if over:
            raise AssertionError(f"profile: headline: device operations a step {over}, at most 2 "
                                 f"each expected")
    print(f"[profile] {label}: {steps} steps under sim.profile on {card}: ranges "
          f"{dict(ranges)}; device operations and device-busy ms a step by phase: {split}; "
          f"in all {per_step:.1f} ops {sum(busy.values()) / 1000.0 / steps:.4f} ms; "
          f"{ms_step:.4f} ms/step just before (unprofiled, eager): "
          f"{1000.0 * ms_step / per_step:.1f} host us an operation (not traced)", flush=True)


# ---------------------------------------------------------------------------
# [graph]: rebuild segments as CUDA graphs against the eager loop
# ---------------------------------------------------------------------------


def _layout_diff(a, b):
    """(bitwise equal, max |difference|) of two simulations' slot layouts
    over GRAPH_FIELDS."""
    same, worst = True, 0.0
    for k in GRAPH_FIELDS:
        x, y = getattr(a._dense, k), getattr(b._dense, k)
        if x.shape != y.shape:
            return False, float("inf")
        same = same and torch.equal(x.view(torch.int32), y.view(torch.int32))
        worst = max(worst, float((x - y).abs().nan_to_num(float("inf")).max()))
    return same, worst


def _turn(sim, steps):
    """``steps`` steps of ``sim`` between CUDA events: (ms a step, host us a
    step outside the chunks' one wait for the device, in _chunk_flags)."""
    waited = [0.0]
    flags = sim._chunk_flags

    def timed_flags(meta, violated):
        t = time.perf_counter()
        try:
            return flags(meta, violated)
        finally:
            waited[0] += time.perf_counter() - t

    sim._chunk_flags = timed_flags
    try:
        ms, wall = _timed_run(sim, steps)
    finally:
        del sim._chunk_flags
    return ms, (wall - waited[0]) / steps * 1e6


def _graph_turn(K, sim, label, forces, steps=GRAPH_STEPS):
    """One turn: ``steps`` steps with the launch counts set to 0 before and
    held after to what the steps run (K6-K9 exactly, the pair kernels once
    a pair-force evaluation), replays counted. Returns (ms a step, host us
    a step, {captures, replays, eager_segments} of the turn)."""
    totals0 = dict(sim._graph_totals)
    steps0, evals0 = sim.steps_run, sim.force_evaluations
    _reset_counts(K)
    ms, host_us = _turn(sim, steps)
    integ = sim.operations.integrator
    _integrator_launches(K, f"graph {label}", sim.steps_run - steps0, len(integ.methods),
                         rotational=integ.integrate_rotational_dof)
    n_pair = sum(1 for f in forces if f._needs_nlist)
    pair_evals = (sim.force_evaluations - evals0) * n_pair // len(forces)
    launched = K.PK.launches + K.DK.launches + K.AK.launches
    if launched != pair_evals:
        raise AssertionError(f"graph {label}: {launched} pair-kernel launches for {pair_evals} "
                             f"pair-force evaluations")
    counted = ("captures", "capture_seconds", "replays", "eager_segments")
    return ms, host_us, {k: sim._graph_totals.get(k, 0) - totals0.get(k, 0) for k in counted}


def _clock_forms(sim, label, forces):
    """K2, K4 (at the droplet's pick too), K8 and K9 keyed on the card's
    clock (core/rng.py's device_clock, the clock 3 steps behind at offset 3) against their
    host-int forms on the path's state, bitwise, at CLOCK_STEPS; K8 and K9
    (Langevin's step2, with the path's flow field) in their device-kT form
    (kT a 0-d float32 on the card, as a run's schedule gives it) against
    their host-kT form at DEVICE_KTS, and the DPD sigma table from a
    device kT against the one from the host float. Returns the forms
    checked."""
    from azplugins_tpu_torch.core import rng
    from azplugins_tpu_torch.ops import dense as D
    from azplugins_tpu_torch.ops import integrate_kernel as IK

    from azplugins_tpu_torch.core.variant import scheduled

    dense, dt, seed = sim._dense, sim.dt_ref(), sim.seed
    m = sim.operations.integrator.methods[0]
    variants = sim._step_variants()

    def at(t, s, draw):
        """``draw(s)`` with the variants' values at timestep ``t`` (as a
        graph's schedule gives them, 0-d tensors on the card)."""
        rows = (None if not variants else
                torch.from_numpy(np.stack([v.values(t, 1) for v in variants])).to(dense.device))
        with scheduled(variants, rows, s):
            return draw(s)

    draws = {}
    if label == "dpd":
        f, (tbl,) = forces[0], sim._force_tables()
        draws["K2"] = lambda s: f._compute_dense(dense, sim._grid_spec, sim._meta.slot_of, s,
                                                 sim._ctx(), tbl[0], want="all")
    else:
        draws["K8/K9" if m._rotational else "K8"] = lambda s: m.step2(dense, dt, s, seed)
    if label == "headline":
        draws["K4"] = lambda s: rng.particle_uniform3(rng.Stream.BROWNIAN, seed, s, dense.tag)
    if label == "droplet":
        evap = sim._step_updaters()[0]

        def pick(s):
            typeid = dense.typeid.clone()
            evap._pick(typeid, dense, None, s, seed)
            return typeid

        draws["K4 at the pick"] = pick
    for name, draw in draws.items():
        for t in CLOCK_STEPS:
            want = at(t, t, draw)
            clock = torch.tensor(t - 3, dtype=torch.int64, device=dense.device)
            with rng.device_clock(clock, 1000):
                got = at(t, 1003, draw)
            pairs = ([(got, want)] if isinstance(got, torch.Tensor) else
                     [(getattr(got, k), getattr(want, k)) for k in (
                         "force", "energy", "virial", "velocity", "acceleration", "angmom",
                         "net_torque") if hasattr(got, k) and getattr(got, k) is not None])
            for a, b in pairs:
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"graph {label}: {name}'s clock form differs from its "
                                         f"host form at timestep {t}")
    forms = [f"clock forms of {', '.join(draws)}"]
    if label == "dpd":
        gamma = sim._force_tables()[0][0]["params"]["gamma"]
        for kT in DEVICE_KTS:
            want = D.dpd_sigma_table(gamma, kT, dt)
            got = D.dpd_sigma_table(gamma, _on_card(kT, dense.device), dt)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"graph dpd: the sigma table from a device kT {kT} differs")
        forms.append("the DPD sigma table from a device kT")
    elif hasattr(m, "kT"):
        flow = None if m.flow_field is None else m.flow_field(dense.box.wrap(dense.position)[0])
        sel = m._selection(dense)
        for kT in DEVICE_KTS:
            for t in CLOCK_STEPS:
                out = []
                for form in (kT, _on_card(kT, dense.device)):
                    noise = IK.Noise(m._table_on("_gamma_table", dense.device), m._rng_stream,
                                     seed, t, form, True)
                    got = list(IK.step2(dense.tag, sel, dense.typeid, dense.velocity,
                                        dense.acceleration, dense.net_force, dense.mass, dt,
                                        noise, flow))
                    if m._rotational:
                        noise = IK.Noise(m._table_on("_gamma_r_table", dense.device),
                                         rng.Stream.LANGEVIN_ANGULAR, seed, t, form, True)
                        got += IK.no_squish(2, dense.tag, sel, dense.typeid, dense.orientation,
                                            dense.angmom, dense.moment_inertia,
                                            dense.net_torque, dt, noise)
                    out.append(got)
                for a, b in zip(*out, strict=True):
                    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                        raise AssertionError(f"graph {label}: K8/K9's device-kT form differs "
                                             f"from the host form at kT {kT}, timestep {t}")
        forms.append(f"device-kT forms of {'K8, K9' if m._rotational else 'K8'} at kT "
                     f"{', '.join(map(str, DEVICE_KTS))}")
    return forms


def _on_card(kT: float, device) -> torch.Tensor:
    """kT as a run's schedule gives it: a 0-d float32 tensor on the card,
    copied from pinned memory (no synchronising call)."""
    return torch.tensor(np.float32(kT)).pin_memory().to(device, non_blocking=True)


def build_ramp(az, device):
    """[graph]'s small Ramp-kT case: the headline's liquid at RAMP_SIDE^3,
    its Langevin kT ramped from RAMP_KT[0] to RAMP_KT[1] over the steps the
    phase runs it."""
    sim, forces = build_headline(az, device, N_side=RAMP_SIDE)
    sim.operations.integrator.methods[0].kT = az.variant.Ramp(*RAMP_KT, 0, 6 * GRAPH_STEPS)
    return sim, forces


def _masked_updaters(sim, reps=20):
    """Device operations and busy ms of the masked updaters a step (each
    updater's ``_update_masked`` at the graph run's state, unfired), and
    whether loading a chunk's schedule makes a synchronising call (it must
    not: set_sync_debug_mode("error"))."""
    dense, t, seed = sim._dense, sim.timestep, sim.seed
    fire = torch.zeros((), dtype=torch.bool, device=dense.device)
    ops = busy = 0.0
    for u in sim._step_updaters():
        o, b = _profile_call(lambda u=u: u._update_masked(dense, fire, t, seed), reps)
        ops, busy = ops + o, busy + b
    runner = sim._runner
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.load(sim._dense, sim._meta, t, sim._variant_values(t, sim.max_chunk),
                    sim._trigger_masks(t, sim.max_chunk))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return ops, busy


def _stream_diff(a, b):
    """(bitwise equal, max |difference|) of two simulations' MPCD streams:
    position, velocity and the anchor's."""
    same, worst = True, 0.0
    x, y = a._mpcd, b._mpcd
    pairs = [(x["position"], y["position"]), (x["velocity"], y["velocity"]),
             (x["_srd_anchor"][0], y["_srd_anchor"][0]),
             (x["_srd_anchor"][1], y["_srd_anchor"][1])]
    if x["_srd_anchor"][2] != y["_srd_anchor"][2]:
        return False, float("inf")
    for p, q in pairs:
        p, q = torch.cat(p), torch.cat(q)
        same = same and torch.equal(p.view(torch.int32), q.view(torch.int32))
        worst = max(worst, float((p - q).abs().nan_to_num(float("inf")).max()))
    return same, worst


def _advance_turns(az, K, label, card):
    """[graph]'s MPCD-only turns: ``label`` (pure SRD or the Poiseuille
    slit) built three times from one seed, two on the eager loop
    (``_eager``), one on the SRD advance graphs; ADVANCE_GRAPH_STEPS[label]
    steps each, then turns of as many (eager, graph, graph, eager), the
    second eager run keeping pace. The streams (position, velocity, the
    anchor) must be bitwise equal after the warm-up and after turns 2 and 4,
    eager against eager too (the cell sums are deterministic); K5 (either
    form) and K10 exactly once a collision in every turn. Returns the
    figures."""
    build = {"srd": build_srd, "poiseuille": build_poiseuille}[label]
    steps = ADVANCE_GRAPH_STEPS[label]
    sims = {}
    for name in ("eager", "eager2", "graph"):
        sims[name] = sim = build(az, "cuda")
        sim._eager = name != "graph"
    E, E2, G = sims["eager"], sims["eager2"], sims["graph"]
    for sim in (E, E2, G):
        sim.run(steps)
    diffs = [(_stream_diff(E, E2), _stream_diff(G, E))]
    ms, host = {"eager": [], "graph": []}, {"eager": [], "graph": []}
    turns = {"captures": 0, "replays": 0, "eager_segments": 0}
    period = G.mpcd_dynamics.period
    for k, name in enumerate(("eager", "graph", "graph", "eager")):
        sim = sims[name]
        totals0 = dict(sim._advance_totals)
        _reset_counts(K)
        m, h = _turn(sim, steps)
        collisions = steps // period
        clock_form = "jax_normal_axis_clock" if name == "graph" else "jax_normal_axis"
        _draws(K, f"graph {label} {name}", {clock_form: collisions, "cell_sums": collisions},
               exact=True)
        ms[name].append(m)
        host[name].append(h)
        if name == "eager":
            E2.run(steps)
        else:
            got, _ = _advance_line(sim, totals0)
            turns = {c: turns[c] + got[c] for c in turns}
        if k in (1, 3):
            diffs.append((_stream_diff(E, E2), _stream_diff(G, E)))
    for (ee_same, ee_diff), (ge_same, ge_diff) in diffs:
        if not (ee_same and ge_same):
            raise AssertionError(f"graph {label}: eager/eager max |diff| {ee_diff:.3e}, "
                                 f"graph/eager {ge_diff:.3e}: the advance is not bitwise")
    if turns["replays"] < 2 * steps // period:
        raise AssertionError(f"graph {label}: {turns['replays']} replays in the graph turns")
    g_ops, g_busy, _, g_syncs = _profile(G)
    e_ops, e_busy, _, _ = _profile(E)
    pool_mb = G._advance_graphs.pool_bytes / 2**20
    print(f"[graph] {label} (SRD advance graphs; N={G._mpcd['position'][0].shape[0]}, a "
          f"collision every {period} steps): ms/step eager "
          f"{' / '.join(f'{x:.4f}' for x in ms['eager'])}, graph "
          f"{' / '.join(f'{x:.4f}' for x in ms['graph'])} (turns of {steps}: eager, graph, "
          f"graph, eager); host us a step eager {' / '.join(f'{x:.1f}' for x in host['eager'])}, "
          f"graph {' / '.join(f'{x:.1f}' for x in host['graph'])}; device operations and busy "
          f"ms a step (20 steps profiled): graph {g_ops:.1f} / {g_busy:.4f} ({g_syncs:.2f} "
          f"synchronising calls a step), eager {e_ops:.1f} / {e_busy:.4f}; graph turns: "
          f"{turns['captures']} captures, {turns['replays']} replays, {turns['eager_segments']} "
          f"first runs eagerly; keys {G._advance_graphs.graph_keys()}; pool {pool_mb:.1f} MB; "
          f"eager == eager == graph bitwise after the warm-up and turns 2 and 4; K5 and K10 "
          f"once a collision every turn", flush=True)
    return {"ms_eager": ms["eager"], "ms_graph": ms["graph"], "host_us_eager": host["eager"],
            "host_us_graph": host["graph"], "ops_graph": g_ops, "busy_graph": g_busy,
            "ops_eager": e_ops, "busy_eager": e_busy, **turns, "pool_mb": pool_mb}


def run_graph(az, K, card, paths=("headline", "polymer", "dpd", "patchy", "droplet", "ramp",
                                  "srd", "poiseuille")):
    """[graph]: BASELINE configs 1-5 at full size and a small Ramp-kT
    liquid, each built three times from one seed: two run the eager loop
    (``_eager``), one the CUDA graphs (the droplet's updater masked every
    step, its barrier's SphereArea and the ramp's kT from the chunk's
    schedule on the card). All three run GRAPH_STEPS (across the tune at
    step 200), then the eager and the graph simulations take turns (eager,
    graph, graph, eager) of GRAPH_STEPS, the second eager one keeping pace
    with the first. After the warm-up and after turns 2 and 4 the graph run
    must equal the eager run bit for bit (GRAPH_FIELDS, typeid among them)
    where the two eager runs do (the differences printed either way); every
    turn holds its launch counts exact; the graph simulation replays at
    least GRAPH_LEAST_REPLAYS segments in its turns. Prints ms/step both
    ways, host us a step, device operations and busy ms a step under the
    graphs and eagerly, captures, replays, the pool's MB; for the droplet
    the masked updaters' operations and busy ms a step and their share of
    its busy step; checks the clock forms of K2, K4, K8 and K9 and the
    device-kT forms of K8 and K9 against their host forms. Then pure SRD
    and the Poiseuille slit on the SRD advance graphs (``_advance_turns``).
    Returns {label: figures}."""
    t0 = time.perf_counter()
    out = {}
    builds = {"headline": build_headline, "polymer": build_polymer, "dpd": build_dpd,
              "patchy": build_patchy, "droplet": build_droplet, "ramp": build_ramp}
    for label in paths:
        t_label = time.perf_counter()
        if label in ADVANCE_GRAPH_STEPS:
            out[label] = _advance_turns(az, K, label, card)
            print(f"[graph] {label}: {time.perf_counter() - t_label:.1f} s", flush=True)
            torch.cuda.empty_cache()
            continue
        build = builds[label]
        sims = {}
        for name in ("eager", "eager2", "graph"):
            sim, forces = build(az, "cuda")
            sim._eager = name != "graph"
            sims[name] = sim
        E, E2, G = sims["eager"], sims["eager2"], sims["graph"]
        for sim in (E, E2, G):
            sim.run(GRAPH_STEPS)
        diffs = [(_layout_diff(E, E2), _layout_diff(G, E))]
        ms = {"eager": [], "graph": []}
        host = {"eager": [], "graph": []}
        turns = {"captures": 0, "capture_seconds": 0.0, "replays": 0, "eager_segments": 0}
        for k, name in enumerate(("eager", "graph", "graph", "eager")):
            m, h, counted = _graph_turn(K, sims[name], label, forces)
            ms[name].append(m)
            host[name].append(h)
            if name == "eager":
                E2.run(GRAPH_STEPS)
            else:
                turns = {c: turns[c] + counted[c] for c in turns}
            if k in (1, 3):
                diffs.append((_layout_diff(E, E2), _layout_diff(G, E)))
        for (ee_same, ee_diff), (ge_same, ge_diff) in diffs:
            if ee_same and not ge_same:
                raise AssertionError(f"graph {label}: the graph run differs from the eager run "
                                     f"(max |diff| {ge_diff:.3e}) where two eager runs agree")
            if not np.isfinite(ge_diff) and ee_same:
                raise AssertionError(f"graph {label}: non-finite differences")
        if turns["replays"] < GRAPH_LEAST_REPLAYS:
            raise AssertionError(f"graph {label}: {turns['replays']} replays in the graph turns")
        _check_wrapped(G, f"graph {label}")
        forms = _clock_forms(G, label, forces)
        g_ops, g_busy, _, g_syncs = _profile(G)
        e_ops, e_busy, _, _ = _profile(E)
        pool_mb = G._runner.pool_bytes / 2**20
        fig = {"ms_eager": ms["eager"], "ms_graph": ms["graph"], "host_us_eager": host["eager"],
               "host_us_graph": host["graph"], "ops_graph": g_ops, "busy_graph": g_busy,
               "ops_eager": e_ops, "busy_eager": e_busy, **turns, "pool_mb": pool_mb,
               "totals": dict(G._graph_totals)}
        extra = ""
        if label == "droplet":
            m_ops, m_busy = _masked_updaters(G)
            share = m_busy / g_busy
            fig.update(masked_ops=m_ops, masked_busy=m_busy, masked_share=share)
            extra = (f"; the masked updaters a step: {m_ops:.1f} device operations, "
                     f"{m_busy:.4f} ms busy, {share:.3f} of the graph run's busy step; the "
                     f"chunk's schedule loaded with no synchronising call")
        out[label] = fig
        agree = "; ".join(
            f"{when}: eager/eager {'bitwise' if ee[0] else f'max |diff| {ee[1]:.3e}'}, "
            f"graph/eager {'bitwise' if ge[0] else f'max |diff| {ge[1]:.3e}'}"
            for when, (ee, ge) in zip(("warm-up", "turns 1-2", "turns 3-4"), diffs))
        print(f"[graph] {label} (N={G.state.N_particles}, cap {G._grid_spec.cap}, rebuild interval "
              f"{G._seg_len}): ms/step eager {' / '.join(f'{x:.4f}' for x in ms['eager'])}, "
              f"graph {' / '.join(f'{x:.4f}' for x in ms['graph'])} (turns of {GRAPH_STEPS}: "
              f"eager, graph, graph, eager); host us a step eager "
              f"{' / '.join(f'{x:.1f}' for x in host['eager'])}, graph "
              f"{' / '.join(f'{x:.1f}' for x in host['graph'])}; device operations and busy ms "
              f"a step (20 steps profiled): graph {g_ops:.1f} / {g_busy:.4f} ({g_syncs:.2f} "
              f"synchronising calls a step), eager {e_ops:.1f} / {e_busy:.4f}; graph turns: "
              f"{turns['captures']} captures ({turns['capture_seconds']:.3f} s of host time), "
              f"{turns['replays']} replays, {turns['eager_segments']} first segments run "
              f"eagerly; whole run {fig['totals']}; pool {pool_mb:.1f} MB; {agree}; launch "
              f"counts exact every turn; {'; '.join(forms)} bitwise their host forms at "
              f"{', '.join(map(str, CLOCK_STEPS))}{extra}; "
              f"{time.perf_counter() - t_label:.1f} s", flush=True)
        del sims, E, E2, G, sim
        torch.cuda.empty_cache()
    print(f"[graph] the phase took {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return out


def _build_report(cuda_build, sources):
    for src in sources:
        info = cuda_build.build_info[cuda_build.CSRC / src]
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(a) + int(b) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info["log"])]
        print(f"[build] {src}: nvcc {info['seconds']:.2f} s; ptxas: {len(regs)} kernels, "
              f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
              f"max spill {max(spills, default=0)} bytes", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    az = _import_port()
    from azplugins_tpu_torch.ops import aniso_kernel as AK
    from azplugins_tpu_torch.ops import cellsum_kernel as CK
    from azplugins_tpu_torch.ops import cuda_build
    from azplugins_tpu_torch.ops import dense as D
    from azplugins_tpu_torch.ops import dpd_kernel as DK
    from azplugins_tpu_torch.ops import integrate_kernel as IK
    from azplugins_tpu_torch.ops import pair_kernel as PK
    from azplugins_tpu_torch.ops import pick_kernel as EK
    from azplugins_tpu_torch.ops import rng_kernel as RK

    K = types.SimpleNamespace(PK=PK, DK=DK, AK=AK, RK=RK, IK=IK, EK=EK, CK=CK)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    sources = (PK._SOURCE, DK._SOURCE, AK._SOURCE, RK._SOURCE, IK._SOURCE, EK._SOURCE,
               CK._SOURCE)
    cuda_build.load_libraries(*sources)
    for k in (PK, DK, AK, RK, IK, EK, CK):
        k._library()
    print(f"[build] {len(sources)} kernels in {time.perf_counter() - t0:.2f} s (parallel nvcc)",
          flush=True)
    _build_report(cuda_build, sources)

    max_err: dict[str, float] = {}

    def record(name, err):
        max_err[name] = max(max_err.get(name, 0.0), err)

    pair_timing = check_pair_kernel(az, D, PK, record)
    dpd_timing = check_dpd_kernel(az, D, DK, record)
    aniso_timing = check_aniso_kernel(az, D, AK, record)
    rng_timing, rng_err = check_rng(az, RK)
    cellsum_timing = check_cellsum(az, RK, CK)

    launches = {}

    def count(path):
        launched, sim = path
        for name, n in launched.items():
            launches[name] = launches.get(name, 0) + n
        return sim

    # caps: the headline's own 72 and its tuned 48; the DPD fluid's own 40
    # and the capacity its occupancy asks for (8 here: grown to the smallest
    # multiple of 8 that fits); the patchy colloids' own 16 and twice that;
    # the droplet's before and after its tune
    plj = {"cell_pair_force[PerturbedLennardJones]":
           lambda: PK.launches_by_potential.get("PerturbedLennardJones", 0)}
    # Langevin draws inside K8 (and K9 with rotation), so K4 launches no
    # time a step: thermalize once a setup, the droplet's evaporator at
    # least once a fire (once a step on the graphs: masked)
    integrate_timing: dict = {}
    headline = count(run_path(az, D, K, card, record, "headline", build_headline, 2000, 1000,
                              plj, {"particle_bits": 0}, caps=(48, 72)))
    check_integrate(az, D, K, headline, "headline", integrate_timing, record)
    run_profile(headline, "headline", PROFILE_STEPS, card)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_io_") as workdir:
        count((run_io(az, K, card, headline, Path(workdir)), None))
    del headline
    count((run_spatial(az, K, card), None))
    count((run_spatial_sharded(az, D, K, card, record), None))
    count((run_spatial_ops(az, D, K, card, record), None))
    count(run_path(az, D, K, card, record, "dpd", build_dpd, 2000, 1000,
                   {"cell_dpd_force": lambda: DK.launches}, extra_check=_dpd_momentum,
                   caps=(8, 40)))
    # the rods melt over ~8,000 steps, releasing pair energy faster than the
    # thermostat removes it (kT peaked at 1.24 near step 5,000 on an H100;
    # PERF.md), so the polymer warms up for 10,000
    count(run_path(az, D, K, card, record, "polymer", build_polymer, 10000, 1000,
                   {"cell_pair_force[ExpandedYukawa]":
                    lambda: PK.launches_by_potential.get("ExpandedYukawa", 0)},
                   {"particle_bits": 0}, extra_check=_bond_lengths))
    patchy = count(run_path(az, D, K, card, record, "patchy", build_patchy, PATCHY_WARM, 1000,
                            {"cell_aniso_force": lambda: AK.launches}, {"particle_bits": 0},
                            extra_check=_unit_quaternions,
                            kT=0.3, kT_band=PATCHY_KT_BAND, caps=(16, 32)))
    check_integrate(az, D, K, patchy, "patchy", integrate_timing, record)
    del patchy
    run_graph(az, K, card)
    # the droplet's lab-frame temperature contains the flow: its own check
    # reads the evaporated particles' temperature relative to it
    droplet = count(run_path(az, D, K, card, record, "droplet", build_droplet, 2000, 1000, plj,
                             {"evaporator_pick": 2000},
                             extra_check=_droplet_check, kT=None, caps="tune"))
    time_pair_on_state(az, D, PK, droplet, droplet.operations.integrator.forces[0], "droplet")
    check_integrate(az, D, K, droplet, "droplet", integrate_timing, record)
    pick_timing = check_pick(droplet, RK, EK)
    del droplet
    for pot, n in run_potential_sweep(az, K).items():
        launches[f"cell_pair_force[{pot}]"] = n
    count((run_colloid(az, D, K, card, record), None))
    count((run_poiseuille(az, K, card), None))
    count((run_srd(az, K, card), None))
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_examples_") as workdir:
        run_examples(az, K, card, Path(workdir))

    def entry(name, source, replaces, timing):
        ms, plain_ms, _, (bound_ms, bound_by), candidates = timing
        return {
            "name": name, "route": "cuda", "source": f"azplugins_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a cell-stencil pair force
            "library_ms": None,
            # candidate pairs a call tests at the shape it was timed at
            "candidates": candidates,
        }

    kernels = [entry(f"cell_pair_force[{pot}]", PK._SOURCE, PAIR_REPLACES, pair_timing[pot])
               for pot in PK.KERNEL_POTENTIALS]
    kernels.append(entry("cell_dpd_force", DK._SOURCE, DPD_REPLACES, dpd_timing))
    kernels.append(entry("cell_aniso_force", AK._SOURCE, ANISO_REPLACES, aniso_timing))
    # the random draws: timed where the paths draw most (K4 at the headline's
    # slots, K5 at pure SRD's grid); no PyTorch call computes these Threefry
    # streams (torch.rand and torch.randn are other generators)
    for name, timed, replaces in (("particle_bits", "particle_uniform3", RNG_BITS_REPLACES),
                                  ("jax_normal_axis", "jax_normal_axis[srd]",
                                   RNG_NORMAL_REPLACES)):
        ms, plain_ms, (bound_ms, bound_by) = rng_timing[timed]
        kernels.append({
            "name": name, "route": "cuda", "source": f"azplugins_tpu_torch/csrc/{RK._SOURCE}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": rng_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    # K5's clock form (the SRD advance graphs' collisions) at pure SRD's
    # grid, its launches the advance graphs' (pure SRD, Poiseuille); K10 at
    # pure SRD's rows and cells, its library call CUDA index_add_ (atomic)
    clock = cellsum_timing["clock[srd]"]
    kernels.append({
        "name": "jax_normal_axis_clock", "route": "cuda",
        "source": f"azplugins_tpu_torch/csrc/{RK._SOURCE}", "replaces": RNG_CLOCK_REPLACES,
        "launches": launches["jax_normal_axis_clock"], "max_abs_err": 0.0, "ms": clock["ms"],
        "plain_ms": clock["plain_ms"], "bound_ms": clock["bound"][0],
        "bound_by": clock["bound"][1], "library_ms": None,
    })
    sums = cellsum_timing["srd"]
    kernels.append({
        "name": "cell_sums", "route": "cuda", "source": f"azplugins_tpu_torch/csrc/{CK._SOURCE}",
        "replaces": CELLSUM_REPLACES, "launches": launches["cell_sums"], "max_abs_err": 0.0,
        "ms": sums["ms"], "plain_ms": sums["plain_ms"], "bound_ms": sums["bound"][0],
        "bound_by": sums["bound"][1], "library_ms": sums["library_ms"],
    })
    # K4 at the pick, fired (the droplet's 10 of its slots), its launches the
    # scan's and the select's; its library call: torch.topk(k=10) over the
    # slots' keys, which the plain pick runs twice
    ms, plain_ms, (bound_ms, bound_by), library_ms = pick_timing["fired"]
    kernels.append({
        "name": "evaporator_pick", "route": "cuda",
        "source": f"azplugins_tpu_torch/csrc/{EK._SOURCE}", "replaces": PICK_REPLACES,
        "launches": launches["evaporator_pick"], "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    })
    # the integrator and the drift check: timed at the headline's slots (K6-K8)
    # and the patchy colloids' (K9); no PyTorch call computes a masked Verlet
    # half step, a top-two drift criterion or a NO_SQUISH rotation
    for name, timed in (("drift_check", "drift_check"), ("step1", "step1"),
                        ("step1_drift", "step1_drift"), ("step2", "step2"),
                        ("no_squish", "no_squish")):
        ms, plain_ms, (bound_ms, bound_by) = integrate_timing[timed]
        kernels.append({
            "name": name, "route": "cuda", "source": f"azplugins_tpu_torch/csrc/{IK._SOURCE}",
            "replaces": INTEGRATE_REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })
    print(f"[time] chip_smoke.py took {time.perf_counter() - t_start:.1f} s, builds included",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
