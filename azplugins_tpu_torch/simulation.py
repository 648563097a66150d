"""Simulation: owns the state and operations and drives the step loop.

Port of ``azplugins_tpu/simulation.py`` (state management, attach, the
dense layout, the step loop with its rebuild schedule, transactional
replays, updaters, the capacity tune, the MPCD solvent stream and its
collisional coupling, and the force observables; writers and spatial
decomposition are later slices). Pair, DPD,
anisotropic and bond forces all take the dense state and the tag->slot
map; a run without pair forces keeps tag order, with the identity map.
With ``integrate_rotational_dof``, ``net_torque`` is set every step, beside
the net force, to the sum of the torques of the forces that produce them.

The simulation runs on the device it is given, and on the GPU
(``"cuda"``) by default: without CUDA the default raises, and the CPU is
used only when asked for (``device="cpu"``).

Each step runs, as the reference's: methods.step1 -> Verlet drift check ->
forces -> methods.step2 -> the updaters whose trigger fires at the step,
in the dense cell-slot layout of ops/dense.py. The tag-ordered State is
rebuilt from the slots only when something reads it. Triggers are
evaluated on the host from the timestep, and an updater is a pure device
function of (state, timestep, seed), so a firing neither splits the chunk
nor waits for the device; a replayed chunk re-applies the same firings.

MPCD. ``snapshot.mpcd`` becomes the solvent stream ``_mpcd`` (position,
velocity, typeid, mass, types, and the SRD anchor once it streams). With
``mpcd_dynamics`` set, each accepted chunk advances it (``SRD._advance``);
a replayed chunk never does. A ``mpcd.CollisionCoupling`` updater applies
the joint solvent-solute collision inside the chunk, after the step its
trigger names, with the solvent's anchor carried through the chunk and
adopted only when the chunk is accepted, so a replay starts again from the
untouched stream.

Rebuild control. The neighbour grid is rebuilt on the absolute schedule
``t % seg_len == 0``; in between, every step only *checks* the Verlet
drift (ops/dense.needs_rebin) and ORs a violation flag that stays on the
device. The host reads that flag and the capacity-overflow flag once per
chunk, in one transfer, so the step loop itself never waits for the
device. A violation replays the chunk from its saved starting state with
a shorter interval (re-derived from the fastest particle); an overflow
replays it with a larger cell capacity. States are immutable dataclasses,
so the saved state costs nothing.

Capacity tune. At the absolute timestep ``auto_tune_after`` (200 by
default) the run right-sizes the cell capacity to the equilibrated
occupancy and resets the rebuild interval from the fastest particle
(:meth:`Simulation.tune_cell_capacity`); the chunk is split there, so the
tune point, and the trajectory after it, do not depend on how ``run`` is
called.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .core.snapshot import Snapshot
from .core.state import State, state_from_snapshot, state_to_snapshot, thermalize_momenta
from .md.force import ForceResult, SimContext
from .ops import dense as D

__all__ = ["Simulation", "Operations"]

# absolute-timestep quantum for rebuild-interval adaptation: the interval
# changes only at multiples of this, so the rebuild schedule is a pure
# function of the timestep, whatever the run() chunking
_GROW_QUANTUM = 100


class Operations:
    def __init__(self):
        self.integrator = None
        self.updaters: list = []
        self.computes: list = []

    def add(self, op):
        """hoomd-style routing: forces go to the integrator, updaters and
        computes to their lists."""
        from .compute import Compute
        from .md.force import Force
        from .update import Updater

        if isinstance(op, Force):
            if self.integrator is None:
                raise RuntimeError("set an integrator before adding forces")
            self.integrator.forces.append(op)
        elif isinstance(op, Updater):
            self.updaters.append(op)
        elif isinstance(op, Compute):
            self.computes.append(op)
        elif callable(getattr(op, "write", None)):
            raise NotImplementedError("writers are not ported yet (ROADMAP queue A5)")
        else:
            raise TypeError(f"cannot add {op!r}")

    def __iadd__(self, op):
        self.add(op)
        return self


class _StateView:
    """hoomd-like ``sim.state`` accessor (always tag-ordered)."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    @property
    def N_particles(self) -> int:
        return self._sim._synced_state().N

    @property
    def particle_types(self) -> list[str]:
        return list(self._sim._particle_types)

    @property
    def bond_types(self) -> list[str]:
        return list(self._sim._bond_types)

    @property
    def box(self):
        return self._sim._synced_state().box

    def get_snapshot(self) -> Snapshot:
        sim = self._sim
        snap = state_to_snapshot(sim._synced_state(), sim._particle_types, sim._bond_types)
        mpcd = sim._mpcd
        if mpcd is not None:
            snap.mpcd.resize(mpcd["position"].shape[0])
            snap.mpcd.position[:] = mpcd["position"].cpu().numpy()
            snap.mpcd.velocity[:] = mpcd["velocity"].cpu().numpy()
            snap.mpcd.typeid[:] = mpcd["typeid"].cpu().numpy()
            snap.mpcd.mass = mpcd["mass"]
            snap.mpcd.types = list(mpcd["types"])
        return snap

    def set_snapshot(self, snapshot: Snapshot):
        self._sim._set_snapshot(snapshot)

    def thermalize_particle_momenta(self, filter=None, kT: float = 1.0):
        sim = self._sim
        state = sim._synced_state()
        mask = None
        if filter is not None:
            typeids = state.typeid.cpu().numpy()
            mask = torch.as_tensor(filter.mask(typeids, sim._particle_types), device=sim.device)
        sim._state = thermalize_momenta(state, kT, sim.seed, mask)
        sim._drop_dense()


class Simulation:
    """Owns state and operations on one device and drives the step loop."""

    def __init__(self, device=None, seed: int = 0):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Simulation() runs on the GPU by default and no CUDA device is available; "
                    'pass device="cpu" to run on the CPU'
                )
            device = "cuda"
        self.device = torch.device(device)
        self.seed = int(seed) & 0xFFFF
        self.operations = Operations()
        self._state: State | None = None  # tag order (may be stale vs dense)
        self._particle_types: list[str] = []
        self._bond_types: list[str] = []
        self._timestep = 0
        self._attached = False
        self._prepared = False
        self._grid_spec: D.GridSpec | None = None
        self._dense: State | None = None  # slot order
        self._meta: D.GridMeta | None = None
        self._state_stale = False
        self._fields: tuple = D.ALL_FIELDS  # rebin payload columns
        self._ops_fp = None
        # rebuild interval: the grid rebuilds at every timestep divisible by
        # _seg_len. A violation lowers it and replays; clean quanta grow it
        # back by 1 up to the ceiling, which itself relaxes after 10 quanta
        self._seg_len = 10
        self._seg_ceiling = 50
        self._clean_quanta = 0
        # set by a violation replay: the restored state's rebuild reference
        # belongs to the old schedule, so the unaligned prefix up to the next
        # point of the new schedule rebuilds every step
        self._realign = False
        # longest chunk between host synchronisations
        self.max_chunk = 1000
        # False pins the rebuild interval (violation replays still lower
        # it; quantum regrowth and the chunk splits at quanta stop)
        self._seg_adapt = True
        # the capacity tune fires the first time the absolute timestep
        # reaches auto_tune_after (None: never); a manual
        # tune_cell_capacity() or a timestep set past it cancels it
        self.auto_tune_after: int | None = 200
        self._auto_tuned = False
        # diagnostics: violation replays, and force evaluations (one per
        # force per step, replayed steps included)
        self.viol_replays = 0
        self.force_evaluations = 0
        # the MPCD solvent stream (snapshot.mpcd) and its dynamics
        # (mpcd.SRD), which advances it beside the MD trajectory
        self._mpcd: dict | None = None
        self.mpcd_dynamics = None
        self._coupling = None  # the mpcd.CollisionCoupling updater of this run
        self._warned_divisor_collapse = False

    # -- state management ------------------------------------------------
    def create_state_from_snapshot(self, snapshot: Snapshot):
        if self._state is not None:
            raise RuntimeError("state already created")
        self._set_snapshot(snapshot)

    def _set_snapshot(self, snapshot: Snapshot):
        self._state, self._particle_types, self._bond_types = state_from_snapshot(
            snapshot, self.device
        )
        mpcd = getattr(snapshot, "mpcd", None)
        if mpcd is not None and mpcd.N > 0:
            self._mpcd = {
                "position": torch.as_tensor(np.asarray(mpcd.position, np.float32),
                                            device=self.device),
                "velocity": torch.as_tensor(np.asarray(mpcd.velocity, np.float32),
                                            device=self.device),
                "typeid": torch.as_tensor(np.asarray(mpcd.typeid, np.int32), device=self.device),
                "mass": float(mpcd.mass),
                "types": list(mpcd.types),
            }
        else:
            self._mpcd = None
        self._drop_dense()
        self._invalidate()

    def _drop_dense(self):
        self._dense = None
        self._meta = None
        self._state_stale = False
        self._prepared = False

    def _synced_state(self) -> State:
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        if self._state_stale and self._dense is not None:
            if self._grid_spec is None:
                self._state = self._dense
            else:
                self._state = D.undensify(self._dense, N=self._state.N, fields=self._fields)
            self._state_stale = False
        return self._state

    @property
    def state(self) -> _StateView:
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        return _StateView(self)

    @property
    def timestep(self) -> int:
        return self._timestep

    @timestep.setter
    def timestep(self, value: int):
        self._timestep = int(value)
        # a clock set at or past the tune point (a resume) declares the tune
        # done in the earlier run
        if self.auto_tune_after is not None and self._timestep >= self.auto_tune_after:
            self._auto_tuned = True

    @property
    def n_builds(self) -> int:
        """Neighbour-grid builds since the dense layout was made (a host sync)."""
        return int(self._meta.n_builds) if self._meta is not None else 0

    def _invalidate(self):
        self._attached = False
        self._prepared = False

    # -- attach ------------------------------------------------------------
    def _forces(self):
        integ = self.operations.integrator
        return integ.forces if integ is not None else []

    def _attach(self):
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        integ = self.operations.integrator
        if integ is not None:
            integ._attach(self)
        for u in self.operations.updaters:
            u._attach(self)
        for c in self.operations.computes:
            c._attach(self)

        # one grid sized by the largest pair cutoff and the largest buffer
        r_cut = buffer = 0.0
        has_pair = False
        for f in self._forces():
            if f._needs_nlist:
                has_pair = True
                r_cut = max(r_cut, f._max_r_cut())
                buffer = max(buffer, f.nlist.buffer)
        if has_pair:
            state = self._synced_state()
            new_spec = D.GridSpec.create(state.box, state.N, r_cut, buffer)
            # size cap for the actual starting configuration: commensurate
            # lattices concentrate particles far above the mean
            occ_cap = self._max_occupancy_cap(state, new_spec)
            if occ_cap > new_spec.cap:
                new_spec = new_spec.replace(cap=occ_cap)
            old = self._grid_spec
            if old is None or (
                new_spec.dims != old.dims
                or new_spec.r_cut != old.r_cut
                or new_spec.buffer != old.buffer
                or new_spec.cap > old.cap
            ):
                self._grid_spec = new_spec
                self._drop_dense()
        else:
            if self._grid_spec is not None:
                self._synced_state()
                self._drop_dense()
            self._grid_spec = None
        new_fields = self._select_fields()  # syncs the tag-order state
        if new_fields != self._fields:
            self._fields = new_fields
            self._drop_dense()
        self._attached = True
        self._prepared = False

    def _select_fields(self) -> tuple:
        """The optional rebin payload columns this run needs.

        A column rides the rebin if some attached operation reads or moves
        it (quaternions for an anisotropic force; orientations, angular
        momenta, inertia and the stored torque when rotational DOF are
        integrated, even from their defaults; diameters for a force that
        reads them) or the state carries non-default values; dropped
        columns are rebuilt from defaults.
        """
        state = self._synced_state()
        fields = []
        if bool((state.mass != 1.0).any()):
            fields.append("mass")
        quat0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=state.device)
        need_quat = any(f._needs_quat_j for f in self._forces())
        if need_quat or bool((state.orientation != quat0).any()):
            fields.append("quat")
        if (
            self._rotational()
            or bool((state.angmom != 0.0).any())
            or bool((state.moment_inertia != 0.0).any())
        ):
            fields.append("rotation")
            if "quat" not in fields:
                fields.insert(fields.index("rotation"), "quat")
        if bool((state.charge != 0.0).any()):
            fields.append("charge")
        need_diam = any(f._needs_diameter for f in self._forces())
        if need_diam or bool((state.diameter != 1.0).any()):
            fields.append("diameter")
        return tuple(fields)

    def _rotational(self) -> bool:
        integ = self.operations.integrator
        return bool(integ is not None and integ.integrate_rotational_dof)

    def _ctx(self) -> SimContext:
        return SimContext(dt=self.dt_ref(), seed=self.seed)

    def dt_ref(self) -> float:
        integ = self.operations.integrator
        return float(integ.dt) if integ is not None else 0.0

    def _ops_fingerprint(self):
        """Structural identity of the operation set.

        Scalars are compared by value, nested objects (variants, filters,
        flow fields) by identity; replace the object to change it. Forces
        and updaters are compared by identity. Returns ``(fp, refs)``,
        where ``refs`` pins every object whose id() is in ``fp``.
        """
        refs = []

        def obj_fp(o):
            refs.append(o)
            items = []
            for k, v in sorted(vars(o).items()):
                if k.startswith("_") or k == "forces":
                    continue
                if isinstance(v, (int, float, bool, str, type(None))):
                    items.append((k, v))
                else:
                    refs.append(v)
                    items.append((k, type(v).__name__, id(v)))
            return (type(o).__name__, id(o), tuple(items))

        integ = self.operations.integrator
        if integ is None:
            return ("none",), ()
        refs.extend(integ.forces)
        refs.extend(self.operations.updaters)
        fp = (
            self.seed,
            obj_fp(integ),
            tuple(obj_fp(m) for m in integ.methods),
            tuple((type(f).__name__, id(f)) for f in integ.forces),
            tuple((type(u).__name__, id(u)) for u in self.operations.updaters),
        )
        return fp, tuple(refs)

    # -- dense layout management ---------------------------------------------
    def _identity_meta(self, state: State) -> D.GridMeta:
        dev = state.device
        return D.GridMeta(
            ref_position=state.position,
            slot_of=torch.arange(state.N, dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            n_builds=torch.zeros((), dtype=torch.int32, device=dev),
            max_occ=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _densify(self, state: State):
        return D.densify(
            state, self._grid_spec, fields=self._fields, need_slot_of=state.n_bonds > 0
        )

    def _ensure_dense(self):
        if self._dense is not None:
            return
        state = self._synced_state()
        if self._grid_spec is None:
            self._dense = state
            self._meta = self._identity_meta(state)
            return
        self._dense, self._meta = self._densify(state)
        if bool(self._meta.overflow):
            self._grow_and_rebuild(int(self._meta.max_occ))

    @staticmethod
    def _max_occupancy_cap(state: State, spec: D.GridSpec, slack: int = 8) -> int:
        """Host-side max cell occupancy of a configuration -> cap."""
        pos = state.position.cpu().numpy()
        frac = pos / state.box.L + 0.5
        frac -= np.floor(frac)
        idx = [
            np.clip((frac[:, k] * spec.dims[k]).astype(np.int64), 0, spec.dims[k] - 1)
            for k in range(3)
        ]
        cid = (idx[0] * spec.dims[1] + idx[1]) * spec.dims[2] + idx[2]
        max_occ = int(np.bincount(cid, minlength=spec.n_cells).max())
        return int(math.ceil((max_occ + slack) / 8.0) * 8)

    def _interval_from_vmax(self, velocity: torch.Tensor, safety: float = 1.0) -> int | None:
        """Rebuild interval from the fastest particle: the pairwise drift
        criterion leaves each particle half the buffer, consumed at up to
        vmax * dt per step. None when no estimate exists."""
        if self._grid_spec is None:
            return None
        vmax = float(torch.sqrt(torch.sum(velocity * velocity, dim=-1).max()))
        dt = self.dt_ref()
        if vmax <= 0 or dt <= 0:
            return None
        margin = 0.5 * self._grid_spec.buffer
        return max(1, min(50, int(margin / (vmax * dt * safety))))

    def tune_cell_capacity(self, slack: int = 0, safety: float = 1.0):
        """Right-size the cell capacity and the rebuild interval.

        A melt transient (a commensurate start concentrating particles in a
        few cells, a lattice heating up) leaves both sized for the
        transient. After warm-up this sets the interval, and its ceiling,
        from the fastest particle, and the capacity to the 8-multiple
        ``slack`` above the measured max cell occupancy; a capacity change
        drops the dense layout, which the next run rebuilds. An overflow
        after the tune grows the capacity by one 8-slot quantum
        (:meth:`_grow_and_rebuild`). A manual call cancels the scheduled
        tune; trajectories are chunking-reproducible between tunes, not
        across an explicit one.
        """
        self._auto_tuned = True
        if self._grid_spec is None or self._state is None:
            return
        state = self._synced_state()
        spec = self._grid_spec
        est = self._interval_from_vmax(state.velocity, safety)
        if est is not None:
            # the vmax estimate is also the ceiling: growing past it would
            # only buy a violation replay
            self._seg_len = est
            self._seg_ceiling = est
            self._clean_quanta = 0
        cap = self._max_occupancy_cap(state, spec, slack)
        if cap != spec.cap:
            self._grid_spec = spec.replace(cap=cap)
            self._drop_dense()

    def _grow_and_rebuild(self, needed: int = 0):
        """Grow the slot capacity until the current configuration fits.

        ``needed`` is the failed chunk's recorded max cell occupancy. Before
        the tune the capacity jumps straight past it (plus one 8-slot
        quantum of melt headroom) before any 1.25x steps; after the tune the
        capacity sits one quantum above the equilibrated occupancy, so it
        grows by one quantum at a time.
        """
        state = self._synced_state()
        if not self._auto_tuned and needed > self._grid_spec.cap:
            cap = int(math.ceil((needed + 8) / 8.0) * 8)
            self._grid_spec = self._grid_spec.replace(cap=cap)
            self._dense, self._meta = self._densify(state)
            if not bool(self._meta.overflow):
                return
        for _ in range(8):
            self._grid_spec = self._grid_spec.grow(gentle=self._auto_tuned)
            self._dense, self._meta = self._densify(state)
            if not bool(self._meta.overflow):
                return
        raise RuntimeError("cell capacity growth did not converge")

    def _force_tables(self) -> tuple:
        for f in self._forces():
            f._build_tables(self)
        return tuple(f._device_tables(self.device) for f in self._forces())

    def _compute_net(self, dense: State, meta: D.GridMeta, t: int, tbls):
        """The net force, and, when rotational DOF are integrated, the net
        torque summed over the forces that produce one (zeros if none does;
        else None). Resetting it every step matters even without a torque
        force: Langevin stores its effective torque there, which must not
        carry into the next step's sum."""
        net = torch.zeros((dense.N, 3), dtype=torch.float32, device=dense.device)
        need_torque = self._rotational()
        ntq = torch.zeros_like(net) if need_torque else None
        ctx = self._ctx()
        for f, tbl in zip(self._forces(), tbls):
            r = f._compute_dense(dense, self._grid_spec, meta.slot_of, t, ctx, tbl, want="force")
            net = net + r.force
            if need_torque and r.torque is not None:
                ntq = ntq + r.torque
            self.force_evaluations += 1
        return net, ntq

    @staticmethod
    def _set_net(dense: State, net, ntq) -> State:
        if ntq is None:
            return dense.replace(net_force=net)
        return dense.replace(net_force=net, net_torque=ntq)

    def _prepare(self):
        """Compute initial forces, accelerations and torques (HOOMD's pre-run prep)."""
        self._ensure_dense()
        net, ntq = self._compute_net(self._dense, self._meta, self._timestep,
                                     self._force_tables())
        accel = net / self._dense.mass[:, None]
        self._dense = self._set_net(self._dense, net, ntq).replace(acceleration=accel)
        self._state_stale = True
        self._prepared = True

    # -- running -------------------------------------------------------------
    def _run_chunk(self, dense: State, meta: D.GridMeta, t0: int, n_steps: int,
                   seg_len: int, tbls, rebin_first: bool = True, solv=None):
        """Run ``n_steps`` steps from timestep ``t0``; no host synchronisation.

        With ``rebin_first`` (a chunk that starts on the rebuild schedule),
        the grid rebuilds before chunk-relative steps 0, seg_len, 2*seg_len,
        ...; otherwise the chunk continues the previous chunk's segment.
        With an MPCD coupling, ``solv`` is the solvent's anchor ``(position,
        velocity, t_a)``; the joint collision after step t (when the
        coupling's trigger holds at t, at MD clock t + 1) moves it.
        Returns ``(dense, meta, violated, solv)`` with ``violated`` a device
        bool.
        """
        spec = self._grid_spec
        integ = self.operations.integrator
        methods = integ.methods if integ is not None else []
        updaters = [u for u in self.operations.updaters
                    if not getattr(u, "_updates_mpcd", False)]
        coupling = self._coupling
        mass_s = self._mpcd["mass"] if coupling is not None else None
        dt = self.dt_ref()
        seed = self.seed
        N_tags = self._state.N
        need_slot_of = self._state.n_bonds > 0
        viol = torch.zeros((), dtype=torch.bool, device=dense.device)
        for j in range(n_steps):
            t = t0 + j
            if spec is not None and rebin_first and j % seg_len == 0:
                dense, meta = D.rebin(dense, meta, spec, N_tags, self._fields, need_slot_of)
            for m in methods:
                dense = m.step1(dense, dt, t, seed)
            if spec is not None:
                viol = viol | D.needs_rebin(dense, meta, spec)
            dense = self._set_net(dense, *self._compute_net(dense, meta, t, tbls))
            for m in methods:
                dense = m.step2(dense, dt, t, seed)
            for u in updaters:
                if u.trigger(t):
                    dense = u._update(dense, t, seed)
            if coupling is not None and coupling.trigger(t):
                dense, solv = coupling._collide(dense, solv, t + 1, seed, mass_s)
        return dense, meta, viol, solv

    def _find_coupling(self):
        """The MPCD coupling updater (at most one) and whether it keeps its
        default trigger: collisions at MD clocks divisible by the period,
        on which the rebuild interval is snapped to a divisor."""
        from .md.trigger import Periodic

        couplings = [u for u in self.operations.updaters if getattr(u, "_updates_mpcd", False)]
        if len(couplings) > 1:
            raise ValueError("only one MPCD coupling updater is supported")
        coupling = couplings[0] if couplings else None
        if coupling is not None:
            trig = coupling.trigger
            coupling._ingraph = bool(
                self._mpcd is not None
                and type(trig) is Periodic
                and trig.period == coupling.srd.period
                and trig.phase == coupling.srd.period - 1
            )
        return coupling

    def _snap_to_period(self, seg_base: int, P: int) -> int:
        """The rebuild interval snapped down to a divisor of the collision
        period P, so every collision clock is a rebuild point and the
        rebuild schedule is the reference's; warns once when that more than
        halves it."""
        while P % seg_base != 0:
            seg_base -= 1
        if seg_base * 2 <= self._seg_len and not self._warned_divisor_collapse:
            # a period with no divisor near the adapted interval (a prime
            # period) snaps to a tiny divisor: near per-step rebuilds
            self._warned_divisor_collapse = True
            warnings.warn(
                f"in-graph MPCD coupling: collision period {P} has "
                f"no divisor near the adapted rebuild interval "
                f"{self._seg_len}, so rebuilds snap to every "
                f"{seg_base} step(s). Choose a collision period "
                "with divisors near the natural rebuild interval "
                "(or a composite period) to avoid the extra "
                "rebuild cost.",
                stacklevel=3,
            )
        return seg_base

    def run(self, n_steps: int):
        n_steps = int(n_steps)
        fp, fp_refs = self._ops_fingerprint()
        if self._ops_fp != fp:
            # integrator, methods or forces changed since the last attach
            self._ops_fp = fp
            self._ops_fp_refs = fp_refs
            self._invalidate()
        if not self._attached:
            self._attach()
        if not self._prepared:
            self._prepare()
        for c in self.operations.computes:
            c._attach(self)
        self._coupling = self._find_coupling()
        if self._mpcd is not None and self.mpcd_dynamics is not None:
            self.mpcd_dynamics._ensure_built(self._state.box, self.seed)
        remaining = n_steps
        tbls = self._force_tables()
        while remaining > 0:
            # the scheduled tune fires the first time the absolute timestep
            # reaches auto_tune_after, so its point does not depend on the
            # run() chunking
            auto_pending = not self._auto_tuned and self.auto_tune_after is not None
            if auto_pending and self._timestep >= self.auto_tune_after:
                self.tune_cell_capacity()
                if not self._prepared:
                    self._prepare()
                auto_pending = False
            chunk = min(remaining, self.max_chunk)
            if auto_pending:
                chunk = min(chunk, self.auto_tune_after - self._timestep)
            # while the interval adapts, chunks end at quantum boundaries so
            # interval changes land at the same timestep whatever the chunking
            if self._seg_adapt and (self._seg_len < self._seg_ceiling or self._seg_ceiling < 50):
                chunk = min(chunk, _GROW_QUANTUM - self._timestep % _GROW_QUANTUM)
            # align to the absolute rebuild schedule: an unaligned start runs
            # a no-rebuild continuation up to the next schedule point
            seg_base = self._seg_len
            if self._coupling is not None and self._coupling._ingraph:
                seg_base = self._snap_to_period(seg_base, self._coupling.srd.period)
            off = self._timestep % seg_base
            rebin_first = off == 0
            if off:
                chunk = min(chunk, seg_base - off)
            seg_arg = seg_base
            if off and self._realign:
                seg_arg = 1
                rebin_first = True
            elif not off:
                self._realign = False

            solv = None
            if self._coupling is not None:
                solv = self._mpcd.get("_srd_anchor") or (
                    self._mpcd["position"], self._mpcd["velocity"], self._timestep)
            backup_dense, backup_meta = self._dense, self._meta
            dense, meta, violated, solv = self._run_chunk(
                backup_dense, backup_meta, self._timestep, chunk, seg_arg, tbls, rebin_first, solv
            )
            # the one host synchronisation of the chunk
            overflow, violated, max_occ = torch.stack(
                [meta.overflow.to(torch.int32), violated.to(torch.int32), meta.max_occ]
            ).tolist()
            if self._grid_spec is not None and overflow:
                if not bool(torch.isfinite(dense.position).all()):
                    raise RuntimeError(
                        "simulation diverged: non-finite particle positions at timestep "
                        f"~{self._timestep} (cell overflow requested capacity {max_occ}). "
                        "Typical causes: overlapping initial coordinates, dt too large, "
                        "or a potential evaluated inside its divergence."
                    )
                # transactional replay with a capacity sized by the failed
                # chunk's recorded max occupancy
                self._dense, self._meta = backup_dense, backup_meta
                self._state_stale = True
                self._synced_state()
                self._grow_and_rebuild(max_occ)
                continue
            if violated:
                if seg_arg > 1:
                    # a particle out-drifted the Verlet margin inside a
                    # segment: re-derive the interval from the peak speed at
                    # the chunk start (safety 1.5: the violation shows the
                    # estimate was optimistic here) and replay
                    est = self._interval_from_vmax(backup_dense.velocity, safety=1.5)
                    est_opt = self._interval_from_vmax(backup_dense.velocity)
                    if est is None:
                        est = max(self._seg_len // 2, 1)
                        est_opt = est
                    new_seg = max(1, min(self._seg_len - 1, est))
                    self._seg_ceiling = max(new_seg, min(est_opt, 50))
                    self._clean_quanta = 0
                    self._dense, self._meta = backup_dense, backup_meta
                    self._seg_len = new_seg
                    self._realign = True
                    self.viol_replays += 1
                    continue
                # seg_len == 1: a particle crossed more than the buffer in
                # one step (HOOMD's "dangerous build"); accept with a warning
                warnings.warn(
                    "dangerous neighbor rebuild: a particle moved more than the Verlet "
                    "buffer in a single step; increase the nlist buffer or reduce dt",
                    stacklevel=2,
                )
            self._dense, self._meta = dense, meta
            self._state_stale = True
            self._timestep += chunk
            remaining -= chunk
            if solv is not None:
                # the chunk's joint collisions moved the solvent's anchor
                self._mpcd = {**self._mpcd, "position": solv[0], "velocity": solv[1],
                              "_srd_anchor": solv}
            if self._mpcd is not None and self.mpcd_dynamics is not None:
                # advance the stream over the accepted chunk only (a replay
                # must not advance it twice); collisions key on the absolute
                # timestep, so this does not depend on the chunking
                self._mpcd = self.mpcd_dynamics._advance(
                    self._mpcd, self._state.box, self._timestep - chunk, self._timestep, self.seed)
            if self._seg_adapt and self._timestep % _GROW_QUANTUM == 0:
                self._clean_quanta += 1
                if self._seg_len < self._seg_ceiling:
                    self._seg_len += 1
                elif self._seg_ceiling < 50 and self._clean_quanta % 10 == 0:
                    self._seg_ceiling += 1
                    self._seg_len = min(self._seg_len + 1, self._seg_ceiling)

    # -- observables -----------------------------------------------------------
    def _compute_single_force(self, force) -> ForceResult:
        """One force with energy, virial and (anisotropic) torque, in tag order."""
        if not self._attached:
            self._attach()
        if not self._prepared:
            self._prepare()
        i = self._forces().index(force)
        tbl = self._force_tables()[i]
        dense = self._dense
        r = force._compute_dense(dense, self._grid_spec, self._meta.slot_of, self._timestep,
                                 self._ctx(), tbl, want="all")
        N = self._state.N
        dest = torch.where(dense.tag >= 0, dense.tag, N).to(torch.int64)

        def back(x):
            if x is None:
                return None
            out = torch.zeros((N + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            out[dest] = x
            return out[:N]

        return ForceResult(force=back(r.force), energy=back(r.energy), virial=back(r.virial),
                           torque=back(r.torque))
