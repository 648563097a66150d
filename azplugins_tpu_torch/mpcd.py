"""MPCD-SRD solvent dynamics: ballistic streaming and stochastic rotation.

Port of ``azplugins_tpu/mpcd.py``: the multi-particle collision dynamics
solvent (Malevanets & Kapral 1999) on the stream ``snapshot.mpcd``.

* **Streaming** is ballistic between collisions: the solvent moves from
  its anchor (the last collision) in one jump (x += v t, exact under a
  constant body force), so where ``run`` is cut does not change the
  float32 result. Between no-slip plates it substeps at ``dt`` with one
  bounce a substep.
* **Collisions** (stochastic rotation dynamics) happen at the absolute
  timesteps divisible by ``period``; their random grid shift (Galilean
  invariance, Ihle & Kroll 2001), rotation axes and virtual-particle
  momenta are drawn from a key derived from (seed, timestep) as the
  reference's ``jax.random`` derives it (``core/rng.py``): the shift and
  the cell ids bitwise, the axes within a few ulp.
* **Cell sums** (:func:`_cell_sums`) are six columns (count, mass,
  momentum, m v^2) over the cells, each cell's rows added in ascending row
  order from +0.0: ``index_add_`` on the CPU, K10 (``csrc/cell_sums.cu``)
  on the card, where ``index_add_`` would add with atomics in an order that
  varies. A collision is bitwise reproducible on either device, as the
  reference's, and trajectories are bitwise independent of the ``run``
  chunking. Empty MD slots of a mixed stream go to a trash cell whose sums
  nothing reads.
* An optional cell-level rescale thermostat to ``kT`` (without it SRD
  conserves energy exactly and heats only through the body force).

All of it is device work with no host read: the collision times are the
host's integers, and every per-axis constant reaches the device by a fill,
never by a copy that would wait for the stream. On the eager loop the
collision keys and the grid shift are formed on the host; under the device
clock (``core/rng.py::device_clock``) they are formed on the device from
the clock (``core/rng.py::collision_draws``, on the card K5's clock form),
bitwise the same.

The reference compiles the advance of an uncoupled stream into one program
(``SRD._build``'s jitted ``advance``). The port's counterpart runs each
collision of a whole uncoupled stream as one CUDA graph
(``graph.py::AdvanceGraphs``, when the simulation says graphs apply): a
stream of ``lead`` steps from the anchor and the collision, keyed by
``lead``, then the observation stream keyed by its length; bitwise the
eager advance.

The stream's position and velocity (and its anchor's) are tuples of
contiguous particle blocks: one block for a whole stream, one on each
shard's device on a sharded mesh whose size divides the particle count
(:func:`_place_solvent`). Streaming runs once a block. A collision
scatters each block's rows into a partial cell table on its device; the
partials are added in block order on the first block's device, every
per-cell quantity (grid shift, axes, thermostat) comes from that one
table, and it goes back to every block, which gathers and rotates its own
rows. With one block this is the whole collision. The sums regroup, so a sharded
collision matches the whole one within float32 round-off (~1e-7 relative),
not bitwise; the stream and the cell ids stay bitwise, and on the CPU the
sharded run is as independent of the ``run`` chunking as the whole one.

By default the solvent does not act on MD solutes; the velocity computes
with ``include_mpcd_particles=True`` read the advanced stream.
:class:`CollisionCoupling` embeds the solutes in the collisions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core import rng as _rng
from .ops import cellsum_kernel

__all__ = ["SRD", "CollisionCoupling"]

_F32 = np.float32
# fold_in datum of the collision stream (the reference's 0x6D70, "mp")
_COLLISION_STREAM = 0x6D70


def _row(values, device) -> torch.Tensor:
    """A float32 row of host values, filled on the device one value at a
    time: a host-to-device copy would make the host wait for the stream."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(float(v))
    return out


def _joined(blocks: tuple, device) -> torch.Tensor:
    """A solvent array's blocks joined whole on ``device``, in order: the
    particles' own order, since solvent rows never migrate."""
    return torch.cat([b.to(device) for b in blocks])


def _place_solvent(mpcd: dict | None, device, devices=None) -> dict | None:
    """The stream's position and velocity, and its anchor's, joined on
    ``device`` and cut into one contiguous particle block a device of
    ``devices`` when given and their number divides the particle count (as
    the reference shards the solvent only when the mesh size divides it);
    otherwise one block on ``device``."""
    if mpcd is None:
        return None
    anchor = mpcd.get("_srd_anchor")
    arrays = [mpcd["position"], mpcd["velocity"]] + (list(anchor[:2]) if anchor else [])
    arrays = [_joined(a, device) for a in arrays]
    N = arrays[0].shape[0]
    if devices is None or N % len(devices):
        devices = (device,)
    n_loc = N // len(devices)
    arrays = [tuple(a[d * n_loc:(d + 1) * n_loc].to(dev, copy=True)
                    for d, dev in enumerate(devices)) for a in arrays]
    out = {**mpcd, "position": arrays[0], "velocity": arrays[1]}
    if anchor:
        out["_srd_anchor"] = (arrays[2], arrays[3], anchor[2])
    return out


def _rotate(v, axis, cos_a: float, sin_a: float, one_minus_cos: float):
    """Rodrigues rotation of the rows of v around the unit rows of axis."""
    dot = torch.sum(v * axis, dim=1, keepdim=True)
    cross = torch.linalg.cross(axis, v, dim=1)
    return v * cos_a + cross * sin_a + axis * dot * one_minus_cos


def _inner_key(seed: int) -> tuple[int, int]:
    """The collision stream's key under ``seed``: ``fold_in(key(seed),
    0x6D70)``, into which each collision folds its timestep."""
    return _rng.jax_fold_in(_rng.jax_key(seed), _COLLISION_STREAM)


def _collision_keys(seed: int, t_col: int):
    """The (shift, axis, virtual-fill) keys of the collision at t_col."""
    return _rng.jax_split(_rng.jax_fold_in(_inner_key(seed), t_col), 3)


def _payload(vel: torch.Tensor, mass: torch.Tensor | None) -> torch.Tensor:
    """float32 ``[n, 6]``, each row's (1, m, m v, m v^2): what a cell sum
    adds (``mass`` None: 1 a row)."""
    n, dev = vel.shape[0], vel.device
    m = (torch.ones(n, dtype=torch.float32, device=dev) if mass is None
         else mass.to(torch.float32))
    mv = vel * m[:, None]
    mv2 = torch.sum(vel * mv, dim=1)
    return torch.cat([torch.ones((n, 1), dtype=torch.float32, device=dev), m[:, None], mv,
                      mv2[:, None]], dim=1)


def _cell_sums(cid: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor | None,
               cells: int) -> torch.Tensor:
    """float32 ``[cells, 6]``: each cell's :func:`_payload` sums over the
    rows with ``cid == c``, in ascending row order from +0.0; ``cid`` lies in
    ``[0, cells]``, ``cells`` being the trash cell, left out. CPU tensors
    take ``index_add_`` (which adds in that order there), CUDA tensors K10
    (``ops/cellsum_kernel.py``, which raises on failure); any other device
    raises."""
    if _rng._on_card(vel.device):
        return cellsum_kernel.cell_sums(
            cid, vel.contiguous(), None if mass is None else mass.to(torch.float32).contiguous(),
            cells)
    pay = _payload(vel, mass)
    return torch.zeros((cells + 1, 6), dtype=torch.float32, device=vel.device).index_add_(
        0, cid, pay)[:cells]


def _cell_sums_plain(cid: torch.Tensor, pay: torch.Tensor, cells: int) -> torch.Tensor:
    """The plain version of :func:`_cell_sums` on a payload ``pay`` ([n,
    6]): an explicit ordered sum on any device. The rows sorted stably by
    cell; round r adds to every cell its r-th row, so each cell adds its
    rows in ascending row order from +0.0. Rows outside ``[0, cells)`` are
    left out. One host read: the deepest cell's row count."""
    dev = pay.device
    n = cid.numel()
    key = torch.where((cid >= 0) & (cid < cells), cid, cells)
    sorted_cid, order = torch.sort(key, stable=True)
    rows = pay[order]
    ids = torch.arange(cells, dtype=sorted_cid.dtype, device=dev)
    first = torch.searchsorted(sorted_cid, ids)
    count = torch.searchsorted(sorted_cid, ids, right=True) - first
    sums = torch.zeros((cells, 6), dtype=torch.float32, device=dev)
    for r in range(int(count.max()) if n else 0):
        at = torch.clamp(first + r, max=n - 1)
        sums = torch.where((count > r)[:, None], sums + rows[at], sums)
    return sums


class SRD:
    """Stochastic rotation dynamics for the MPCD solvent stream.

    Parameters
    ----------
    dt : float
        MD timestep (streaming time per MD step); collisions occur every
        ``period`` MD steps, i.e. the MPCD collision time is period*dt.
    period : int
        MD steps between collisions.
    angle : float
        Rotation angle in degrees (130 is the common choice).
    cell_size : float
        Collision cell edge; every box edge must be an integer multiple.
    kT : float or None
        Cell-level rescale thermostat target; None for microcanonical SRD.
        Required with ``plates``: the no-slip virtual-particle fill samples
        wall momenta at kT.
    body_force : 3-sequence or None
        Constant acceleration (force per unit mass) applied while streaming.
    shift : bool
        Random collision-grid shift (Galilean invariance). On by default.
    plates : (axis, H) or None
        No-slip bounce-back walls at +-H/2 along ``axis`` ('x', 'y', 'z').
    """

    def __init__(self, dt, period=1, angle=130.0, cell_size=1.0, kT=None,
                 body_force=None, shift=True, plates=None):
        self.dt = float(dt)
        self.period = int(period)
        self.angle = float(angle)
        self.cell_size = float(cell_size)
        self.kT = None if kT is None else float(kT)
        self.body_force = (
            None if body_force is None else tuple(float(f) for f in body_force)
        )
        self.shift = bool(shift)
        self._coupled = False  # set by CollisionCoupling
        if plates is not None:
            axis, H = plates
            axis = {"x": 0, "y": 1, "z": 2}.get(axis, axis)
            self.plates = (int(axis), float(H))
            if self.body_force is not None and self.body_force[int(axis)]:
                raise ValueError("body force must be tangential to the plates")
            if self.kT is None:
                raise ValueError(
                    "plates require kT: the no-slip virtual-particle "
                    "fill samples phantom wall momenta at kT (the walls "
                    "are a thermal boundary, not microcanonical)"
                )
        else:
            self.plates = None
        self._dims = None
        self._L = None  # host float32 box edges of the last build
        self._built_key = None  # (L, seed) of the last build
        self._rows = {}

    # -- wiring ------------------------------------------------------------
    def _validate(self, box):
        if any(abs(float(t)) > 1e-12 for t in box.tilt):
            raise ValueError("MPCD-SRD supports orthorhombic boxes only")
        dims = []
        for L in box.L:
            n = float(L) / self.cell_size
            if abs(n - round(n)) > 1e-4:
                raise ValueError(
                    f"box edge {float(L)} is not a multiple of cell_size {self.cell_size}"
                )
            dims.append(max(1, int(round(n))))
        self._dims = tuple(dims)

    def _grid_dims(self):
        """Collision-grid cell counts, per axis.

        The wall axis (plates) is not periodic: with a grid shift the
        topmost layer bins into an extra boundary cell, never across the
        seam into the bottom layer, which would rotate momentum through the
        plates. The shifted grid along that axis has D+1 cells spanning
        [-L/2 - s, L/2 + a - s).
        """
        dims = list(self._dims)
        if self.plates is not None:
            dims[self.plates[0]] += 1
        return dims

    @staticmethod
    def _box_key(box, seed):
        return (float(box.L[0]), float(box.L[1]), float(box.L[2]), int(seed))

    def _build(self, box, seed):
        """Validate the box and keep its edges for this box and seed."""
        self._validate(box)
        self._built_key = self._box_key(box, seed)
        self._L = np.asarray(box.L, dtype=_F32)
        self._rows = {}

    def _ensure_built(self, box, seed):
        if self._built_key != self._box_key(box, seed):
            self._build(box, seed)

    def _const(self, values, device) -> torch.Tensor:
        """A per-axis constant row on ``device``, filled once per build."""
        key = (tuple(float(v) for v in values), str(device))
        if key not in self._rows:
            self._rows[key] = _row(values, device)
        return self._rows[key]

    def _cell_ids(self, pos, shift, scaled=None):
        """Collision cell of each position under the grid ``shift`` (host
        float32 [3]), or under the shift whose quotient by the cell size is
        ``scaled`` (a float32 [3] on the device; ``shift`` then unused).
        Periodic axes wrap; the plates axis, if any, bins unwrapped into the
        extended grid (see _grid_dims)."""
        Dx, Dy, Dz = self._grid_dims()
        a = _F32(self.cell_size)
        dev = pos.device
        dims0 = np.asarray(self._dims, dtype=_F32)
        scaled = (_row(np.asarray(shift, _F32) / a, dev) if scaled is None
                  else scaled.to(dev))
        su = pos / float(a) + scaled
        su = su + self._const(dims0 * _F32(0.5), dev)
        dims_row = self._const(dims0, dev)
        su_wrapped = su - torch.floor(su / dims_row) * dims_row
        if self.plates is not None:
            ax = self.plates[0]
            su_wrapped[:, ax] = su[:, ax]
        i = torch.floor(su_wrapped).to(torch.int64)
        ix = torch.clamp(i[:, 0], 0, Dx - 1)
        iy = torch.clamp(i[:, 1], 0, Dy - 1)
        iz = torch.clamp(i[:, 2], 0, Dz - 1)
        return (ix * Dy + iy) * Dz + iz

    # -- physics -----------------------------------------------------------
    def _stream(self, pos: tuple, vel: tuple, n_steps: int, L) -> tuple:
        """Ballistic jump over n_steps MD steps (exact under constant f) of
        the stream's blocks, once a block (it is elementwise)."""
        out = [self._stream_block(p, v, n_steps, L) for p, v in zip(pos, vel, strict=True)]
        return tuple(p for p, _ in out), tuple(v for _, v in out)

    def _stream_block(self, pos, vel, n_steps: int, L):
        """One block's ballistic jump.

        With plates, substeps at dt with a single-bounce no-slip reflection
        per substep (full velocity reversal at the wall).
        """
        dev = pos.device
        L_row = self._const(L, dev)
        if self.plates is None:
            t = float(_F32(n_steps) * _F32(self.dt))
            if self.body_force is not None:
                f = np.asarray(self.body_force, dtype=_F32)
                half_f_t2 = (_F32(0.5) * f) * (_F32(t) * _F32(t))
                pos = pos + vel * t + _row(half_f_t2, dev)
                vel = vel + _row(f * _F32(t), dev)
            else:
                pos = pos + vel * t
            return pos - torch.round(pos / L_row) * L_row, vel

        ax, H = self.plates
        dt = _F32(self.dt)
        half = float(_F32(H / 2.0))
        f = np.asarray(self.body_force or (0.0, 0.0, 0.0), dtype=_F32)  # f[ax] == 0
        f_row = self._const(f, dev)
        half_f = self._const(_F32(0.5) * f, dev)
        half_f_dt2 = self._const((_F32(0.5) * f) * dt * dt, dev)
        f_dt = self._const(f * dt, dev)
        wrap = self._const([1.0 if k != ax else 0.0 for k in range(3)], dev)
        dt = float(dt)
        for _ in range(int(n_steps)):
            new = pos + vel * dt + half_f_dt2
            w = new[:, ax]
            crossed = (torch.abs(w) > half)[:, None]
            zw = torch.sign(w) * half
            vz = vel[:, ax]
            moving = torch.abs(vz) > 1e-12
            # wall-normal motion is force-free: the exact hit time
            t_hit = torch.where(moving, (zw - pos[:, ax]) / torch.where(moving, vz, 1.0), 0.0)
            t_hit = torch.clamp(t_hit, 0.0, dt)[:, None]
            tau = dt - t_hit
            v_hit = vel + f_row * t_hit  # the velocity at the wall
            x_hit = pos + vel * t_hit + half_f * t_hit**2
            # no-slip bounce-back: full reversal, then stream the rest
            v_b = -v_hit
            x_b = x_hit + v_b * tau + half_f * tau**2
            v_b = v_b + f_row * tau
            pos = torch.where(crossed, x_b, new)
            vel = torch.where(crossed, v_b, vel + f_dt)
            # wrap the periodic (in-plane) axes only
            pos = pos - torch.round(pos / L_row) * L_row * wrap
        return pos, vel

    def _collide(self, pos: tuple, vel: tuple, t_col: int, L, seed: int, mass=None,
                 invalid=None, n_fill=None, mass_fill=1.0) -> tuple:
        """One SRD collision at the absolute timestep t_col of the stream's
        blocks; returns the new velocities as blocks.

        ``mass``/``invalid`` generalise to mixed streams (collisional
        coupling of MD solutes): cell averages are mass-weighted, and
        ``invalid`` rows (empty MD slots) are binned to a trash cell and
        returned unchanged. ``n_fill``/``mass_fill`` set the virtual-fill
        density from the solvent count when the arrays also carry solutes.
        ``pos``, ``vel`` (and ``mass``, ``invalid``, when given) are tuples
        of blocks on their devices: the cell sums are each block's partial
        sums added in block order on the first block's device.
        """
        n = len(pos)
        mass_b = mass if mass is not None else (None,) * n
        inval_b = invalid if invalid is not None else (None,) * n
        N = sum(p.shape[0] for p in pos)
        dev = pos[0].device
        dims = self._grid_dims()
        Dx, Dy, Dz = dims
        C = Dx * Dy * Dz
        a = _F32(self.cell_size)
        plates = self.plates is not None
        # a random unit axis per cell, the same draw whatever the occupancy,
        # and with plates the virtual fill's normals: one launch on the card
        if _rng._clock_on(dev) is None:
            # the keys and the grid shift on the host
            kshift, kaxis, kvirt = _collision_keys(seed, t_col)
            shift = (_rng.jax_uniform_host(kshift, 3) * a if self.shift
                     else np.zeros(3, dtype=_F32))
            axis, virt = _rng.jax_normal_axis(kaxis, C, dev, kvirt if plates else None)
            scaled = None
        else:
            # under the device clock (a CUDA graph): keys, draws and shift
            # from the clock on the device, bitwise the host's
            axis, virt, shift, scaled = _rng.collision_draws(
                _inner_key(seed), t_col, C, dev, self.cell_size, self.shift, plates)

        # every per-cell sum at once, a block's partial sums each: count,
        # mass, momentum xyz, m v^2
        cids, sums = [], None
        for p, v, m, inv in zip(pos, vel, mass_b, inval_b, strict=True):
            cid = self._cell_ids(p, shift, scaled)
            if inv is not None:
                cid = torch.where(inv, C, cid)  # the trash cell, left out of the sums
            part = _cell_sums(cid, v, m, C)
            sums = part if sums is None else sums + part.to(dev)
            cids.append(cid)
        cnt = sums[:, 0]
        msum = sums[:, 1]
        vsum = sums[:, 2:5]
        sum_mv2 = sums[:, 5]
        vsum_real = vsum

        m_cell = msum
        if self.plates is not None:
            # virtual-particle fill of wall-clipped cells (no-slip): the
            # part of a cell beyond the plates holds phantom solvent at
            # rest (Lamura et al. 2001); its sampled momentum
            # ~ Normal(0, Nv kT m) joins the cell average, dragging u toward
            # zero at the wall. Bulk cells get Nv = 0 exactly.
            pax, H = self.plates
            D_ax = dims[pax]  # extended: D+1 shifted cells on the wall axis
            Lax = _F32(L[pax])
            # the shift's component: a host float, or a 0-d tensor under the
            # clock (the same IEEE subtraction)
            shift_ax = float(shift[pax]) if scaled is None else shift[pax]
            lo = (torch.arange(D_ax, dtype=torch.float32, device=dev) * float(a)
                  - float(Lax / _F32(2.0)) - shift_ax)
            hi = lo + float(a)
            h2 = float(_F32(H / 2.0))
            inside = torch.clamp(torch.clamp_max(hi, h2) - torch.clamp_min(lo, -h2), 0.0, float(a))
            # mean fill of a full cell at the confined solvent density
            n_f = _F32(n_fill if n_fill is not None else N)
            L32 = np.asarray(L, dtype=_F32)
            rho_cell = n_f * (a * a * a) / (L32[0] * L32[1] * L32[2] * _F32(H) / Lax)
            nv_ax = float(rho_cell) * (1.0 - inside / float(a))  # [D_ax]
            cell = torch.arange(C, dtype=torch.int64, device=dev)
            if pax == 2:
                idx_ax = cell % Dz
            elif pax == 1:
                idx_ax = (cell // Dz) % Dy
            else:
                idx_ax = cell // (Dy * Dz)
            n_virt = nv_ax[idx_ax]
            mf = float(_F32(mass_fill))
            sigma = torch.sqrt(torch.clamp_min(n_virt, 0.0) * float(_F32(self.kT)) * mf)
            pv = virt * sigma[:, None]
            vsum = vsum + pv
            m_cell = msum + n_virt * mf  # the fill joins the mass sum

        u = vsum / torch.clamp_min(m_cell, 1e-12)[:, None]  # [C, 3] centre of mass

        cols = [u, axis]
        if self.kT is not None:
            # cell-level rescale to the relative equipartition value
            # <K_rel> = 3/2 (n_c - 1) kT; the relative kinetic energy of the
            # real particles about u, in its general form (with the virtual
            # fill or mixed masses u is not their momentum mean):
            # sum m|v-u|^2 = sum m v^2 - 2 (sum m v).u + (sum m) |u|^2
            k_rel = 0.5 * (sum_mv2 - 2.0 * torch.sum(vsum_real * u, dim=1)
                           + msum * torch.sum(u * u, dim=1))
            target = 1.5 * torch.clamp_min(cnt - 1.0, 0.0) * float(_F32(self.kT))
            scale = torch.sqrt(torch.where(k_rel > 1e-12,
                                           target / torch.clamp_min(k_rel, 1e-12), 1.0))
            cols.append(torch.where(cnt > 1.5, scale, 1.0)[:, None])

        # one gather of every per-cell quantity; the appended row C is the
        # trash cell: invalid rows gather zeros and are restored below
        table = torch.cat(cols, dim=1)
        table = torch.cat([table, table.new_zeros((1, table.shape[1]))], dim=0)
        rad = math.radians(self.angle)
        cos_a, sin_a = _F32(math.cos(rad)), _F32(math.sin(rad))
        out = []
        for v, inv, cid in zip(vel, inval_b, cids, strict=True):
            g = table.to(v.device)[cid]
            u_i, ax_i = g[:, 0:3], g[:, 3:6]
            vrel = _rotate(v - u_i, ax_i, float(cos_a), float(sin_a), float(_F32(1.0) - cos_a))
            if self.kT is not None:
                vrel = vrel * g[:, 6:7]
            vnew = u_i + vrel
            if inv is not None:
                vnew = torch.where(inv[:, None], v, vnew)
            out.append(vnew)
        return tuple(out)

    def _fingerprint(self) -> tuple:
        """Every parameter a collision or a stream bakes in (an advance
        graph is bound to it)."""
        return (self.dt, self.period, self.angle, self.cell_size, self.kT, self.body_force,
                self.shift, self.plates, self._coupled)

    def _advance(self, mpcd: dict, box, t0: int, t1: int, seed: int, graphs=None) -> dict:
        """Advance the anchored stream to the absolute MD timestep t1.

        The state is anchored at the last collision (or where the stream
        started): positions between collisions are always streamed in one
        jump from the anchor, never in chunk-sized pieces, since float32
        addition is not associative. Uncoupled, the collisions at
        ``t % period == 0`` within (t_a, t1] run here; coupled, the
        CollisionCoupling owns every collision and this only streams the
        observable state. The anchor's time is a host int. ``graphs``: an
        uncoupled whole stream's ``graph.AdvanceGraphs``, on which each
        collision and the observation stream replay CUDA graphs (None: the
        eager loop).
        """
        if t1 <= t0 or mpcd is None:
            return mpcd
        self._ensure_built(box, seed)
        L = self._L
        # a fresh stream (or a restart) anchors here; a restart at a
        # timestep that is not a collision differs from the continuous run
        # only by the float32 addition order
        pos_a, vel_a, t_a = mpcd.get("_srd_anchor") or (mpcd["position"], mpcd["velocity"],
                                                        int(t0))
        if graphs is not None:
            return self._advance_graphed(mpcd, graphs, pos_a, vel_a, t_a, t1, seed)
        if not self._coupled:
            t_next = (t_a // self.period + 1) * self.period
            while t_next <= t1:
                pos, vel = self._stream(pos_a, vel_a, t_next - t_a, L)
                vel_a = self._collide(pos, vel, t_next, L, seed)
                pos_a, t_a = pos, t_next
                t_next += self.period
        pos, vel = self._stream(pos_a, vel_a, t1 - t_a, L)
        return {**mpcd, "position": pos, "velocity": vel, "_srd_anchor": (pos_a, vel_a, t_a)}

    def _advance_graphed(self, mpcd: dict, g, pos_a: tuple, vel_a: tuple, t_a: int, t1: int,
                         seed: int) -> dict:
        """:meth:`_advance` of an uncoupled whole stream on the advance
        graphs ``g``: the anchor into its buffers and the clock at ``t_a``;
        each collision one graph keyed ``("collide", lead)``, which streams
        ``lead`` steps from the anchor, collides at the clock's timestep +
        ``lead`` (the keys and shift drawn from the clock) and moves the
        anchor and the clock; then the observation stream, keyed
        ``("stream", n)``. The same operations as the eager loop, so the
        same bits. The observable position and velocity are clones (the
        next replay overwrites the buffers); the anchor is the buffers,
        which only the next advance reads."""
        if self._coupled or len(pos_a) != 1:
            raise ValueError("the advance graphs take an uncoupled stream in one block")
        g.load(pos_a[0], vel_a[0], t_a)
        t_next = (t_a // self.period + 1) * self.period
        while t_next <= t1:
            lead = t_next - t_a
            g.run(("collide", lead), lambda t_a=t_a, lead=lead: self._collide_body(
                g, t_a, lead, seed))
            t_a, t_next = t_next, t_next + self.period
        n = t1 - t_a
        g.run(("stream", n), lambda: self._stream_body(g, n))
        return {**mpcd, "position": (g.pos.clone(),), "velocity": (g.vel.clone(),),
                "_srd_anchor": ((g.pos_a,), (g.vel_a,), t_a)}

    def _collide_body(self, g, t_a: int, lead: int, seed: int):
        """What a ``("collide", lead)`` graph runs on ``g``'s buffers, the
        clock holding the anchor's timestep: it makes no host read."""

        def body():
            with _rng.device_clock(g.clock, t_a):
                pos, vel = self._stream((g.pos_a,), (g.vel_a,), lead, self._L)
                (vel,) = self._collide(pos, vel, t_a + lead, self._L, seed)
            g.pos_a.copy_(pos[0])
            g.vel_a.copy_(vel)
            g.clock.add_(lead)

        return body

    def _stream_body(self, g, n: int):
        """What a ``("stream", n)`` graph runs: the observable state ``n``
        steps after the anchor, into ``g``'s observation buffers."""

        def body():
            (pos,), (vel,) = self._stream((g.pos_a,), (g.vel_a,), n, self._L)
            g.pos.copy_(pos)
            g.vel.copy_(vel)

        return body


class CollisionCoupling:
    """Embed the MD solutes in the SRD collisions (collisional coupling,
    Malevanets & Kapral 1999): momentum exchanges between solvent and
    solutes give the solutes hydrodynamic drag, advection and a thermal
    bath, with no explicit solvent-solute pair potential.

    Registers as an updater. The joint collision runs inside the step loop
    after the step its trigger names (by default the steps t with
    (t + 1) % period == 0, so solvent and solutes collide at MD clocks
    divisible by the period), as device work with no host wait; a replaced
    trigger fires at its own steps the same way.

        srd = az.mpcd.SRD(dt=dt, period=20, cell_size=1.0, kT=1.0)
        sim.mpcd_dynamics = srd
        sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))

    Cell averages become mass-weighted over the solvent and the real MD
    particles; both streams' relative velocities rotate.
    """

    _updates_mpcd = True

    def __init__(self, srd: SRD):
        from .md.trigger import Periodic

        self.srd = srd
        # a trigger at step t fires after step t completes (MD clock t+1):
        # phase period-1 lands the joint collision at MD clock multiples
        # of the period
        self.trigger = Periodic(srd.period, phase=srd.period - 1)
        srd._coupled = True
        self._ingraph = False  # set by Simulation.run: the default trigger
        self._attached = False

    def _attach(self, sim):
        if sim._mpcd is None:
            raise ValueError(
                "CollisionCoupling needs an MPCD stream in the snapshot "
                "(Snapshot(mpcd_N=...))"
            )
        if sim.mpcd_dynamics is not self.srd:
            raise ValueError(
                "set sim.mpcd_dynamics to the same SRD object the "
                "CollisionCoupling wraps"
            )
        self._attached = True

    def _collide(self, shards: tuple, solv, t_col: int, seed: int, mass_s: float):
        """The joint collision at the MD clock t_col.

        The solvent streams from its anchor ``solv = (pos, vel, t_a)`` in
        one jump, and both streams' velocities rotate about the
        mass-weighted cell centre of mass; empty MD slots are trash-binned
        with zero mass and come back untouched. ``shards``: the dense
        layout as a tuple of States (one for a whole layout). The solvent's
        block d collides with its share of the shards, joined after it:
        shard d when there is a block a shard, every shard when the solvent
        is one block (the whole run's collision). Returns the shards with
        their new velocities and the solvent's new anchor at t_col.
        """
        srd = self.srd
        pos_a, vel_a, t_a = solv
        pos_s, vel_s = srd._stream(pos_a, vel_a, t_col - t_a, srd._L)
        if len(shards) % len(pos_s):
            raise ValueError(f"{len(pos_s)} solvent blocks for {len(shards)} shards")
        k = len(shards) // len(pos_s)
        groups = [(p, v, shards[d * k:(d + 1) * k])
                  for d, (p, v) in enumerate(zip(pos_s, vel_s, strict=True))]
        N_s = sum(p.shape[0] for p in pos_s)
        pos, vel, mass, invalid = [], [], [], []
        for p, v, group in groups:
            dev = p.device
            inval = [s.tag.to(dev) < 0 for s in group]
            pos.append(torch.cat([p] + [s.position.to(dev) for s in group]))
            vel.append(torch.cat([v] + [s.velocity.to(dev) for s in group]))
            mass.append(torch.cat(
                [torch.full((p.shape[0],), mass_s, dtype=torch.float32, device=dev)]
                + [torch.where(i, 0.0, s.mass.to(dev)) for i, s in zip(inval, group)]))
            invalid.append(torch.cat([torch.zeros(p.shape[0], dtype=torch.bool, device=dev)]
                                     + inval))
        vnew = srd._collide(tuple(pos), tuple(vel), t_col, srd._L, seed, mass=tuple(mass),
                            invalid=tuple(invalid), n_fill=N_s, mass_fill=mass_s)
        out, vel_new = [], []
        for (p, _, group), vn in zip(groups, vnew, strict=True):
            n_p = p.shape[0]
            vel_new.append(vn[:n_p])
            for s in group:
                out.append(s.replace(velocity=vn[n_p:n_p + s.N].to(s.device)))
                n_p += s.N
        return tuple(out), (pos_s, tuple(vel_new), t_col)
