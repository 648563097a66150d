"""Dense cell-grid engine: slot layout, rebin and the plain pair force.

Port of ``azplugins_tpu/ops/dense.py``.

  * Particles live in a cell-dense slot layout: ``S = n_cells * cap``
    slots, cell-major. Empty slots carry ``tag = -1`` and a far sentinel x.
  * Rebinning (the Verlet-buffer rebuild) is one fused-key sort plus row
    gathers of a packed int32 payload. The slot layout is bitwise the
    reference's: same keys, same stable order, same float32 cell ids.
  * :func:`dense_pair_force` is the plain PyTorch pair force over the
    stencil (half stencil with Newton's third law on grids with >= 3 cells
    per axis, full stencil with minimum image otherwise). It serves CPU
    tensors and is what the CUDA kernel (ops/pair_kernel.py) is held
    against on the card.

TPU-only machinery of the reference (the cell-minor transposed stencil
rows, subtile heights, lane blocks, the incremental rebin ablation) is not
ported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.box import Box
from ..core.state import State
from ..utils import frozen_dataclass
from .pair_force import ForceResult, _xplor_smooth

__all__ = [
    "GridSpec",
    "GridMeta",
    "JBlocks",
    "densify",
    "undensify",
    "rebin",
    "needs_rebin",
    "make_jblocks",
    "dense_pair_force",
]


# ---------------------------------------------------------------------------
# Grid specification
# ---------------------------------------------------------------------------
@frozen_dataclass
class GridSpec:
    """Static geometry of the cell grid."""

    dims: tuple  # (Dx, Dy, Dz)
    cap: int  # slots per cell
    r_cut: float
    buffer: float

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def S(self) -> int:
        return self.n_cells * self.cap

    @property
    def r_list(self) -> float:
        return self.r_cut + self.buffer

    def stencil(self) -> np.ndarray:
        offs = []
        for D in self.dims:
            if D >= 3:
                offs.append((-1, 0, 1))
            elif D == 2:
                offs.append((0, 1))
            else:
                offs.append((0,))
        out = [(ox, oy, oz) for ox in offs[0] for oy in offs[1] for oz in offs[2]]
        return np.asarray(out, dtype=np.int32)

    @property
    def newton_ok(self) -> bool:
        """Half stencil (Newton's third law) needs >= 3 cells on every axis:
        with 1 or 2 cells an offset and its negative alias to the same cell
        pairing, which would double-count pairs."""
        return all(D >= 3 for D in self.dims)

    def half_stencil(self) -> np.ndarray:
        """The 13 lexicographically-positive offsets (self cell excluded)."""
        keep = [o for o in self.stencil() if tuple(o) > (0, 0, 0)]
        return np.asarray(keep, dtype=np.int32)

    @classmethod
    def create(cls, box: Box, N: int, r_cut: float, buffer: float):
        """Size the grid as the reference does: cells at least r_cut + buffer
        wide, the whole cell width claimed as Verlet margin, and cap the
        8-multiple above ``1.18 * mean occupancy + 4`` (a dense liquid's
        repulsion keeps occupancy far below the Poisson tail)."""
        npd = box.nearest_plane_distance()
        r_list = r_cut + buffer
        dims = tuple(int(max(1, math.floor(l / r_list))) for l in npd)
        # pairs stay covered while 2 * max_disp < min_edge - r_cut; axes
        # with <= 2 cells impose no constraint (the stencil sees the axis)
        edges = [npd[k] / dims[k] for k in range(3) if dims[k] >= 3]
        min_edge = float(min(edges)) if edges else float("inf")
        eff_buffer = max(float(buffer), min(min_edge - float(r_cut), 1e6))
        n_cells = dims[0] * dims[1] * dims[2]
        want = N / n_cells * 1.18 + 4.0
        cap = int(math.ceil(want / 8.0) * 8)
        cap = min(cap, N) if N > 0 else 8
        return cls(dims=dims, cap=max(cap, 1), r_cut=float(r_cut), buffer=eff_buffer)

    def grow(self) -> "GridSpec":
        """1.25x capacity, rounded up to a multiple of 8."""
        new_cap = max(int(math.ceil(self.cap * 1.25 / 8.0) * 8), self.cap + 8)
        return self.replace(cap=new_cap)


@frozen_dataclass
class GridMeta:
    """Per-layout bookkeeping carried through the step loop (device tensors)."""

    ref_position: torch.Tensor  # [S, 3] positions at last rebin
    slot_of: torch.Tensor  # [N] slot index of each tag
    overflow: torch.Tensor  # bool
    n_builds: torch.Tensor  # int32
    max_occ: torch.Tensor  # int32: max cell occupancy seen since densify


# ---------------------------------------------------------------------------
# Binning: sort + row gathers
# ---------------------------------------------------------------------------
def _cell_id(x, y, z, box: Box, dims):
    """Cell index of each position; the reference's float32 ops in order."""
    xyLy, xzLz, yzLz = box.lattice_products()
    fz = z / box.Lz
    fy = (y - yzLz * fz) / box.Ly
    fx = (x - xyLy * fy - xzLz * fz) / box.Lx

    def idx(f, D):
        f = f + 0.5
        f = f - torch.floor(f)
        return torch.clamp(torch.floor(f * D).to(torch.int32), 0, D - 1)

    cx, cy, cz = idx(fx, dims[0]), idx(fy, dims[1]), idx(fz, dims[2])
    return (cx * dims[1] + cy) * dims[2] + cz


# The rebin payload is a list of (name, width, fill) blocks, each a State
# field. It travels as int32 with floats bitcast to int32, never the other
# way around: tag and typeid -1 are NaN bit patterns as float32.
ALL_FIELDS = ("mass", "quat", "charge", "diameter", "rotation")

_OPT_BLOCKS = {
    "mass": (("mass", 1, 1.0),),
    "quat": (("orientation", 4, (1.0, 0.0, 0.0, 0.0)),),
    "charge": (("charge", 1, 0.0),),
    "diameter": (("diameter", 1, 1.0),),
    "rotation": (
        ("angmom", 4, 0.0),
        ("moment_inertia", 3, 0.0),
        ("net_torque", 3, 0.0),
    ),
}
_CORE_BLOCKS = (
    ("position", 3, 0.0),
    ("velocity", 3, 0.0),
    ("acceleration", 3, 0.0),
    ("typeid", 1, -1),
    ("tag", 1, -1),
    ("image", 3, 0),
)
_INT_BLOCKS = frozenset({"typeid", "tag", "image"})


def _payload_layout(fields: tuple) -> tuple:
    blocks = list(_CORE_BLOCKS)
    for f in fields:
        blocks.extend(_OPT_BLOCKS[f])
    return tuple(blocks)


def _pack_payload(state: State, layout: tuple) -> torch.Tensor:
    """State -> [n, K] int32 (floats bitcast)."""
    parts = []
    for name, _w, _ in layout:
        a = getattr(state, name)
        if a.ndim == 1:
            a = a[:, None]
        if name not in _INT_BLOCKS:
            a = a.view(torch.int32)
        parts.append(a)
    return torch.cat(parts, dim=1)


@functools.lru_cache(maxsize=16)
def _payload_default_row(layout: tuple, device) -> torch.Tensor:
    """[1, K] int32 default row for empty slots (x sentinel spliced later).

    Cached per layout and device: a host-to-device copy at every rebuild
    would stall the stream.
    """
    vals = []
    for name, w, fill in layout:
        fills = fill if isinstance(fill, tuple) else (fill,) * w
        for v in fills:
            if name in _INT_BLOCKS:
                vals.append(np.int32(v))
            else:
                vals.append(np.float32(v).view(np.int32))
    return torch.as_tensor(np.asarray(vals, dtype=np.int32)[None, :], device=device)


def _sentinel_x(S: int, box: Box, spec: GridSpec, device) -> torch.Tensor:
    """Far-away x coordinates for empty slots: ``Lx + (slot+1)(Lx + 2 r_list)``."""
    stride = float(box.L[0] + np.float32(2.0 * spec.r_list))
    slot = torch.arange(S, dtype=torch.float32, device=device)
    return box.Lx + (slot + 1.0) * stride


def _state_from_payload(out: torch.Tensor, layout: tuple, template: State, box: Box) -> State:
    """[S, K] int32 payload -> State of contiguous tensors."""
    S = out.shape[0]
    dev = out.device
    arrs = {}
    off = 0
    for name, w, _ in layout:
        a = out[:, off : off + w]
        if name not in _INT_BLOCKS:
            a = a.view(torch.float32)
        arrs[name] = (a[:, 0] if w == 1 else a).contiguous()
        off += w
    mass = arrs.get("mass")
    if mass is None:
        mass = torch.ones((S,), dtype=torch.float32, device=dev)
    accel = arrs["acceleration"]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    quat = arrs.get("orientation")
    if quat is None:
        quat = zeros(S, 4)
        quat[:, 0] = 1.0
    return State(
        position=arrs["position"],
        tag=arrs["tag"],
        velocity=arrs["velocity"],
        typeid=arrs["typeid"],
        image=arrs["image"],
        orientation=quat,
        mass=mass,
        diameter=arrs.get("diameter", torch.ones((S,), dtype=torch.float32, device=dev)),
        charge=arrs.get("charge", zeros(S)),
        net_force=accel * mass[:, None],
        acceleration=accel,
        angmom=arrs.get("angmom", zeros(S, 4)),
        moment_inertia=arrs.get("moment_inertia", zeros(S, 3)),
        net_torque=arrs.get("net_torque", zeros(S, 3)),
        bond_typeid=template.bond_typeid,
        bond_group=template.bond_group,
        box=box,
    )


def _global_assembly(packed_in, cid, n: int, spec: GridSpec, layout: tuple, n_valid: int):
    """Sort all n rows by cell -> ([S, K] payload, valid, overflow, max_occ).

    Rows sort by (cell, input row): one fused int key ``cid << idx_bits |
    idx`` when it fits the reference's int32 key, else a stable sort on the
    cell id alone; both give the reference's order. Slot (c, r) then takes
    sorted row ``start[c] + r`` while ``r < count[c]``. Rows with cid == C
    are invalid and sort to the tail, so only the first ``n_valid`` sorted
    rows are gathered; exceeding that bound trips the overflow flag.
    """
    C, cap, S = spec.n_cells, spec.cap, spec.S
    dev = cid.device
    cid = cid.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    idx_bits = max(1, (n - 1).bit_length())
    if (C + 1) << idx_bits < 2**31:
        key_s, _ = torch.sort((cid << idx_bits) | idx)
        cid_s = key_s >> idx_bits
        perm = key_s & ((1 << idx_bits) - 1)
    else:
        cid_s, perm = torch.sort(cid, stable=True)

    head = min(n, n_valid)
    start = torch.searchsorted(cid_s, torch.arange(C + 1, dtype=torch.int64, device=dev))
    counts = start[1:] - start[:-1]
    overflow = (counts > cap).any() | (start[C] > head)
    max_occ = counts.max().to(torch.int32)

    rank = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    valid_slot = rank < torch.clamp(counts, max=cap)[:, None]
    src = torch.where(valid_slot, start[:C, None] + rank, head).reshape(S)
    packed_pad = torch.cat([packed_in[perm[:head]], _payload_default_row(layout, dev)], dim=0)
    return packed_pad[src], valid_slot.reshape(S), overflow, max_occ


def _bin_to_slots(state: State, spec: GridSpec, N_tags: int, fields: tuple,
                  need_slot_of: bool = True):
    """Any-order state (n rows) -> slot-order state (S rows) and its meta.

    Positions are wrapped into the box here, and only here: between
    rebuilds the integrators leave them unwrapped, so the stencil's lattice
    shifts subtract exactly.
    """
    S, C = spec.S, spec.n_cells
    dev = state.device
    valid = state.tag >= 0
    pos_w, image_w = state.box.wrap(state.position, state.image)
    state = state.replace(position=pos_w, image=image_w)
    cid = _cell_id(pos_w[:, 0], pos_w[:, 1], pos_w[:, 2], state.box, spec.dims)
    cid = torch.where(valid, cid, C)

    layout = _payload_layout(fields)
    out, valid_slot, overflow, max_occ = _global_assembly(
        _pack_payload(state, layout), cid, state.N, spec, layout, N_tags
    )
    # empty-slot x sentinels are per-slot values; splice them into column 0
    x = torch.where(valid_slot, out[:, 0].view(torch.float32),
                    _sentinel_x(S, state.box, spec, dev))
    out = torch.cat([x.view(torch.int32)[:, None], out[:, 1:]], dim=1)
    dense = _state_from_payload(out, layout, state, state.box)

    if need_slot_of:
        # tag -> slot map; rows of empty slots land on a dropped extra entry
        slot_of = torch.zeros((N_tags + 1,), dtype=torch.int32, device=dev)
        dest = torch.where(dense.tag >= 0, dense.tag, N_tags).to(torch.int64)
        slot_of[dest] = torch.arange(S, dtype=torch.int32, device=dev)
        slot_of = slot_of[:N_tags]
    else:
        slot_of = torch.zeros((0,), dtype=torch.int32, device=dev)
    meta = GridMeta(
        ref_position=dense.position,
        slot_of=slot_of,
        overflow=overflow,
        n_builds=torch.ones((), dtype=torch.int32, device=dev),
        max_occ=max_occ,
    )
    return dense, meta


def densify(state: State, spec: GridSpec, fields: tuple = ALL_FIELDS,
            need_slot_of: bool = True):
    """User (tag) order -> slot order. state must have N == number of tags."""
    return _bin_to_slots(state, spec, state.N, fields, need_slot_of)


def rebin(dense: State, meta: GridMeta, spec: GridSpec, N_tags: int,
          fields: tuple = ALL_FIELDS, need_slot_of: bool = True):
    new_dense, new_meta = _bin_to_slots(dense, spec, N_tags, fields, need_slot_of)
    new_meta = new_meta.replace(
        overflow=new_meta.overflow | meta.overflow,
        n_builds=meta.n_builds + 1,
        max_occ=torch.maximum(new_meta.max_occ, meta.max_occ),
    )
    return new_dense, new_meta


def undensify(dense: State, N: int, fields: tuple = ALL_FIELDS) -> State:
    """Slot order -> user (tag) order via one packed row scatter.

    Positions come back wrapped into the box.
    """
    pos_w, image_w = dense.box.wrap(dense.position, dense.image)
    dense = dense.replace(position=pos_w, image=image_w)
    layout = _payload_layout(fields)
    packed = _pack_payload(dense, layout)
    dest = torch.where(dense.tag >= 0, dense.tag, N).to(torch.int64)
    out = torch.zeros((N + 1, packed.shape[1]), dtype=torch.int32, device=packed.device)
    out[dest] = packed
    return _state_from_payload(out[:N], layout, dense, dense.box)


def needs_rebin(dense: State, meta: GridMeta, spec: GridSpec) -> torch.Tensor:
    """Exact pair-drift rebuild criterion, as a device bool.

    A pair binned within the stencil stays covered while
    ``drift_i + drift_j <= buffer``; the worst pair is the two largest
    single-particle drifts (ties counted), so the check is
    ``sqrt(max1) + sqrt(max2) > buffer``.
    """
    d = dense.position - meta.ref_position
    dispsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    dispsq = torch.where(dense.tag >= 0, dispsq, 0.0)
    m1 = dispsq.max()
    at_max = dispsq == m1
    tied = at_max.sum() > 1
    m2 = torch.where(tied, m1, torch.where(at_max, -math.inf, dispsq).max())
    m2 = torch.clamp_min(m2, 0.0)
    return torch.sqrt(m1) + torch.sqrt(m2) > float(np.float32(spec.buffer))


# ---------------------------------------------------------------------------
# Stencil J-blocks (neighbour-cell data, pre-shifted)
# ---------------------------------------------------------------------------
@frozen_dataclass
class JBlocks:
    """Neighbour data per stencil offset: [n_offsets, n_cells, cap] tensors.

    With >= 3 cells per axis (``preshifted``) the coordinates carry the
    periodic lattice shift of each wrapped neighbour cell, so ``xi - jx``
    is the true separation; otherwise pairs need minimum-image math.
    """

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    typeid: torch.Tensor  # int32, -1 for empty slots
    half: bool
    preshifted: bool


def _halo_pad(g: torch.Tensor, axis: int, shift_hi) -> torch.Tensor:
    """Wrap-pad one cell axis with its periodic images.

    Prepends the last cell (shifted by ``-shift_hi``) and appends the first
    (shifted by ``+shift_hi``); padding the axes in order composes corner
    shifts as n1*a1 + n2*a2 + n3*a3, added axis by axis.
    """
    D = g.shape[axis]
    lo = g.narrow(axis, D - 1, 1)
    hi = g.narrow(axis, 0, 1)
    if shift_hi is not None:
        lo = lo - shift_hi
        hi = hi + shift_hi
    return torch.cat([lo, g, hi], dim=axis)


def _roll_concat(arr: torch.Tensor, spec: GridSpec, offsets, axis_shifts=None):
    """[S] -> [n_offsets, n_cells, cap]: occupants of every stencil cell."""
    Dx, Dy, Dz = spec.dims
    g = arr.reshape(Dx, Dy, Dz, spec.cap)
    for ax in range(3):
        g = _halo_pad(g, ax, axis_shifts[ax] if axis_shifts is not None else None)
    blocks = []
    for o in offsets:
        o0, o1, o2 = int(o[0]) + 1, int(o[1]) + 1, int(o[2]) + 1
        blocks.append(g[o0 : o0 + Dx, o1 : o1 + Dy, o2 : o2 + Dz])
    return torch.stack(blocks, dim=0).reshape(len(blocks), spec.n_cells, spec.cap)


def _axis_shift_tables(box: Box):
    """Per-component, per-axis lattice shifts for the halo pad.

    Lattice vectors a1=(Lx,0,0), a2=(xy*Ly, Ly, 0), a3=(xz*Lz, yz*Lz, Lz);
    crossing grid axis a upward adds a_{a+1}.
    """
    xyLy, xzLz, yzLz = box.lattice_products()
    return (box.Lx, xyLy, xzLz), (None, box.Ly, yzLz), (None, None, box.Lz)


def _roll_cells(a: torch.Tensor, shift) -> torch.Tensor:
    """``roll(a, +shift)`` over the three leading cell axes."""
    return torch.roll(a, shifts=tuple(int(s) for s in shift), dims=(0, 1, 2))


def make_jblocks(dense: State, spec: GridSpec, half: bool = False) -> JBlocks:
    offsets = spec.half_stencil() if half else spec.stencil()
    preshifted = spec.newton_ok
    sx, sy, sz = _axis_shift_tables(dense.box) if preshifted else (None, None, None)
    return JBlocks(
        x=_roll_concat(dense.position[:, 0], spec, offsets, sx),
        y=_roll_concat(dense.position[:, 1], spec, offsets, sy),
        z=_roll_concat(dense.position[:, 2], spec, offsets, sz),
        typeid=_roll_concat(dense.typeid, spec, offsets),
        half=half,
        preshifted=preshifted,
    )


# ---------------------------------------------------------------------------
# Plain pair force
# ---------------------------------------------------------------------------
def _pair_params(tables: dict, t_i, t_j, T: int) -> dict:
    """Per-pair parameter values: scalars for one type, else a table gather.

    Empty slots (typeid -1) read row/column 0; they are masked anyway.
    """
    if T == 1:
        return {k: v.reshape(()) for k, v in tables.items()}
    ti = torch.clamp_min(t_i, 0).to(torch.int64)
    tj = torch.clamp_min(t_j, 0).to(torch.int64)
    return {k: v[ti, tj] for k, v in tables.items()}


def _n_acc(want: str) -> int:
    """Accumulators per slot: force 3, plus energy 1 and virial 6 for "all"."""
    return {"force": 3, "all": 10}[want]


def _pair_accumulate(carry, dx, dy, dz, e, f_divr, mask, want="all"):
    """Add one offset's masked contributions to (fx, fy, fz[, en, v0..v5])."""
    f_divr = torch.where(mask, f_divr, 0.0)
    out = [
        carry[0] + torch.sum(f_divr * dx, dim=-1),
        carry[1] + torch.sum(f_divr * dy, dim=-1),
        carry[2] + torch.sum(f_divr * dz, dim=-1),
    ]
    if want == "all":
        e = torch.where(mask, e, 0.0)
        w = 0.5 * f_divr
        out += [
            carry[3] + 0.5 * torch.sum(e, dim=-1),
            carry[4] + torch.sum(w * dx * dx, dim=-1),
            carry[5] + torch.sum(w * dx * dy, dim=-1),
            carry[6] + torch.sum(w * dx * dz, dim=-1),
            carry[7] + torch.sum(w * dy * dy, dim=-1),
            carry[8] + torch.sum(w * dy * dz, dim=-1),
            carry[9] + torch.sum(w * dz * dz, dim=-1),
        ]
    return tuple(out)


def _finish_pair(carry, S: int) -> ForceResult:
    parts = tuple(a.reshape(S) for a in carry)
    force = torch.stack(parts[:3], dim=-1)
    if len(parts) == 3:
        return ForceResult(force=force, energy=None, virial=None)
    return ForceResult(force=force, energy=parts[3], virial=torch.stack(parts[4:10], dim=-1))


def _eval_pair_mode(energy_force_fn, rsq, rcut, rcutsq, p, mode, r_on=None):
    """Evaluate one pair batch with HOOMD shift-mode semantics."""
    e, f = energy_force_fn(rsq, rcutsq, p)
    if mode == "shift":
        e_cut, _ = energy_force_fn(rcutsq, rcutsq, p)
        e = e - e_cut
    elif mode == "xplor":
        smooth = r_on < rcut
        e_s, f_s = _xplor_smooth(e, f, rsq, rcutsq, r_on * r_on)
        e_cut, _ = energy_force_fn(rcutsq, rcutsq, p)
        e = torch.where(smooth, e_s, e - e_cut)
        f = torch.where(smooth, f_s, f)
    elif mode != "none":
        raise ValueError(f"unknown shift mode {mode!r}")
    return e, f


def dense_pair_force(
    energy_force_fn,
    dense: State,
    jb: JBlocks,
    spec: GridSpec,
    tables: dict,
    r_cut_table: torch.Tensor,
    r_on_table: torch.Tensor | None = None,
    mode: str = "none",
    want: str = "all",
) -> ForceResult:
    """Isotropic pair potential over the dense stencil (plain PyTorch).

    Every pair is masked by slot validity, so one path serves orthorhombic
    and tilted boxes (the reference's maskless sentinel path gives the same
    sums: sentinel pairs fall outside every cutoff). Work runs one stencil
    offset at a time, so memory is bounded by one ``[C, cap, cap]`` batch.
    """
    T = r_cut_table.shape[0]
    C, cap = spec.n_cells, spec.cap

    def v(a):
        return a.reshape(C, cap, 1)

    xi, yi, zi = v(dense.position[:, 0]), v(dense.position[:, 1]), v(dense.position[:, 2])
    t_i = v(dense.typeid)
    valid_i = v(dense.tag >= 0)

    def eval_batch(rsq, mask, t_j):
        p = _pair_params(tables, t_i, t_j, T)
        rcut = _pair_params({"r": r_cut_table}, t_i, t_j, T)["r"]
        rcutsq = rcut * rcut
        mask = mask & (rsq < rcutsq)
        r_on = (
            _pair_params({"r": r_on_table}, t_i, t_j, T)["r"] if mode == "xplor" else None
        )
        e, f = _eval_pair_mode(energy_force_fn, rsq, rcut, rcutsq, p, mode, r_on)
        return e, f, mask

    n_acc = _n_acc(want)
    carry = tuple(
        torch.zeros((C, cap), dtype=torch.float32, device=dense.device) for _ in range(n_acc)
    )
    if not jb.half:
        for k in range(jb.x.shape[0]):
            dx = xi - jb.x[k][:, None, :]
            dy = yi - jb.y[k][:, None, :]
            dz = zi - jb.z[k][:, None, :]
            if not jb.preshifted:
                dx, dy, dz = dense.box.min_image_components(dx, dy, dz)
            rsq = dx * dx + dy * dy + dz * dz
            t_j = jb.typeid[k][:, None, :]
            mask = (rsq > 0) & valid_i & (t_j >= 0)
            e, f, mask = eval_batch(rsq, mask, t_j)
            carry = _pair_accumulate(carry, dx, dy, dz, e, f, mask, want)
        return _finish_pair(carry, spec.S)

    # Newton half stencil: each unordered pair is evaluated once and its
    # terms go to both members (the j side in the neighbour-cell frame,
    # rolled back to its true cell afterwards).
    def jside(e, f, mask, dx, dy, dz):
        fm = torch.where(mask, f, 0.0)
        cols = [
            -torch.sum(fm * dx, dim=1),
            -torch.sum(fm * dy, dim=1),
            -torch.sum(fm * dz, dim=1),
        ]
        if want == "all":
            em = torch.where(mask, e, 0.0)
            w = 0.5 * fm
            cols += [
                0.5 * torch.sum(em, dim=1),
                torch.sum(w * dx * dx, dim=1),
                torch.sum(w * dx * dy, dim=1),
                torch.sum(w * dx * dz, dim=1),
                torch.sum(w * dy * dy, dim=1),
                torch.sum(w * dy * dz, dim=1),
                torch.sum(w * dz * dz, dim=1),
            ]
        return torch.stack(cols, dim=-1)  # [C, cap, n_acc]

    Dx, Dy, Dz = spec.dims
    rolled = []
    for k, o in enumerate(spec.half_stencil()):
        dx = xi - jb.x[k][:, None, :]
        dy = yi - jb.y[k][:, None, :]
        dz = zi - jb.z[k][:, None, :]
        rsq = dx * dx + dy * dy + dz * dz
        t_j = jb.typeid[k][:, None, :]
        e, f, mask = eval_batch(rsq, valid_i & (t_j >= 0), t_j)
        carry = _pair_accumulate(carry, dx, dy, dz, e, f, mask, want)
        g = jside(e, f, mask, dx, dy, dz).reshape(Dx, Dy, Dz, cap, n_acc)
        rolled.append(_roll_cells(g, o).reshape(C, cap, n_acc))

    # self cell: strict upper triangle (i < j within the cell)
    ar = torch.arange(cap, device=dense.device)
    tri = ar[None, None, :] > ar[None, :, None]
    dx = xi - dense.position[:, 0].reshape(C, 1, cap)
    dy = yi - dense.position[:, 1].reshape(C, 1, cap)
    dz = zi - dense.position[:, 2].reshape(C, 1, cap)
    rsq = dx * dx + dy * dy + dz * dz
    mask0 = valid_i & (dense.tag >= 0).reshape(C, 1, cap) & tri
    e, f, mask0 = eval_batch(rsq, mask0, dense.typeid.reshape(C, 1, cap))
    carry = _pair_accumulate(carry, dx, dy, dz, e, f, mask0, want)
    jacc = jside(e, f, mask0, dx, dy, dz)
    for r in rolled:
        jacc = jacc + r

    total = tuple(carry[i] + jacc[..., i] for i in range(n_acc))
    return _finish_pair(total, spec.S)
