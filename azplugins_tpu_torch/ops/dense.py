"""Dense cell-grid engine: slot layout, rebin and the plain pair force.

Port of ``azplugins_tpu/ops/dense.py``.

  * Particles live in a cell-dense slot layout: ``S = n_cells * cap``
    slots, cell-major. Empty slots carry ``tag = -1`` and a far sentinel x.
  * Rebinning (the Verlet-buffer rebuild) is one fused-key sort plus row
    gathers of a packed int32 payload. The slot layout is bitwise the
    reference's: same keys, same stable order, same float32 cell ids.
  * :func:`dense_pair_force`, :func:`dense_dpd_force` and
    :func:`dense_aniso_force` are the plain PyTorch pair, DPD and
    anisotropic (force and torque) forces over the stencil (half stencil
    with Newton's third law on grids with >= 3 cells per axis, full stencil
    with minimum image otherwise), all through one stencil loop,
    ``_stencil_drive``. They serve CPU tensors and are what the CUDA kernels
    (ops/pair_kernel.py, ops/dpd_kernel.py, ops/aniso_kernel.py) are held
    against on the card.
  * :func:`dense_bond_force` is the bond force (gather plus ``index_add_``
    through the tag->slot map) on every device.

TPU-only machinery of the reference (the cell-minor transposed stencil
rows, subtile heights, lane blocks, the incremental rebin ablation) is not
ported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core import rng as _rng
from ..core.box import Box
from ..core.state import State
from ..utils import frozen_dataclass, sqrt
from .pair_force import ForceResult, _xplor_smooth

__all__ = [
    "GridSpec",
    "GridMeta",
    "Window",
    "JBlocks",
    "densify",
    "undensify",
    "rebin",
    "needs_rebin",
    "make_jblocks",
    "dense_pair_force",
    "dpd_sigma_table",
    "dense_dpd_force",
    "dense_aniso_force",
    "dense_bond_force",
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
    def create(cls, box: Box, N: int, r_cut: float, buffer: float, strip_devices: int = 1):
        """Size the grid as the reference does: cells at least r_cut + buffer
        wide, the whole cell width claimed as Verlet margin, and cap the
        8-multiple above ``1.18 * mean occupancy + 4`` (a dense liquid's
        repulsion keeps occupancy far below the Poisson tail).

        ``strip_devices`` snaps (Dx, Dy) down to the largest product
        divisible by it (whole z cell columns per spatial block). Fewer,
        wider cells still cover every pair within r_list.
        """
        npd = box.nearest_plane_distance()
        r_list = r_cut + buffer
        dims = tuple(int(max(1, math.floor(l / r_list))) for l in npd)
        if strip_devices > 1 and (dims[0] * dims[1]) % strip_devices != 0:
            n = strip_devices
            best = None
            for dx in range(dims[0], 0, -1):
                for dy in range(dims[1], 0, -1):
                    if (dx * dy) % n == 0:
                        # the largest dy for this dx; a smaller one only shrinks
                        if best is None or dx * dy > best[0] * best[1]:
                            best = (dx, dy)
                        break
            if best is None:
                raise ValueError(
                    f"cannot give each of {n} spatial strips a whole z "
                    f"cell column: the box fits only {dims[0]}x{dims[1]} "
                    f"columns of width >= r_cut + buffer (use fewer "
                    "devices or a larger box)"
                )
            dims = (best[0], best[1], dims[2])
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

    def grow(self, gentle: bool = False) -> "GridSpec":
        """1.25x capacity, rounded up to a multiple of 8; ``gentle`` adds one
        8-slot quantum instead (after the capacity tune, a fluctuation needs
        exactly one: Simulation._grow_and_rebuild)."""
        if gentle:
            new_cap = self.cap + 8
        else:
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


@frozen_dataclass
class Window:
    """The slots one spatial shard's stencil reads, and the ones it owns.

    ``state`` holds ``n_cols`` whole z cell columns in ring order: window
    column k is the grid's column ``(w0 + k) mod (Dx*Dy)`` (a column is
    ``cx * Dy + cy``), each column ``Dz * cap`` slots, cell-major as in the
    grid. The shard owns the ``n_own`` columns from column ``c0``, which lie
    inside the window; a windowed force is computed, and returned, for the
    own slots only (``n_own * Dz * cap`` of them). The whole grid is
    ``w0 = 0`` and ``n_cols = Dx*Dy`` (parallel/spatial.py::halo_window).
    """

    state: State
    w0: int
    n_cols: int
    c0: int
    n_own: int

    def own_range(self, spec: GridSpec) -> tuple:
        """(first, end) of the own slots among the window's."""
        cols = spec.dims[0] * spec.dims[1]
        per_col = spec.dims[2] * spec.cap
        first = ((self.c0 - self.w0) % cols) * per_col
        return first, first + self.n_own * per_col

    def whole(self, spec: GridSpec) -> bool:
        """The window is the grid in its own order."""
        return self.w0 == 0 and self.n_cols == spec.dims[0] * spec.dims[1]


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


def _sentinel_x(S: int, box: Box, spec: GridSpec, device, first: int = 0) -> torch.Tensor:
    """Far-away x coordinates for empty slots: ``Lx + (slot+1)(Lx + 2 r_list)``,
    for the ``S`` slots from global slot ``first`` (a shard's slice of the
    grid's sentinels, value for value)."""
    stride = float(box.L[0] + np.float32(2.0 * spec.r_list))
    slot = torch.arange(first, first + S, dtype=torch.float32, device=device)
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


def _drift_sq(dense: State, meta: GridMeta) -> torch.Tensor:
    """Each slot's squared drift since the last rebuild (0 for empty slots)."""
    d = dense.position - meta.ref_position
    dispsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    return torch.where(dense.tag >= 0, dispsq, 0.0)


def _top_two(v: torch.Tensor) -> tuple:
    """The largest value of ``v`` and the second largest, ties counted (the
    largest again when it occurs twice)."""
    m1 = v.max()
    at_max = v == m1
    tied = at_max.sum() > 1
    return m1, torch.where(tied, m1, torch.where(at_max, -math.inf, v).max())


def _drift_exceeds(m1, m2, spec: GridSpec) -> torch.Tensor:
    m2 = torch.clamp_min(m2, 0.0)
    return sqrt(m1) + sqrt(m2) > float(np.float32(spec.buffer))


def _drift_kernels():
    from . import integrate_kernel  # imported here: it imports this module

    return integrate_kernel


def needs_rebin(dense: State, meta: GridMeta, spec: GridSpec, viol: torch.Tensor) -> torch.Tensor:
    """Exact pair-drift rebuild criterion, as a device bool.

    A pair binned within the stencil stays covered while
    ``drift_i + drift_j <= buffer``; the worst pair is the two largest
    single-particle drifts (ties counted), so the check is
    ``sqrt(max1) + sqrt(max2) > buffer``, ORed into ``viol`` (the chunk's
    0-d bool violation flag). A CUDA layout takes K6 (one launch, the OR
    inside), a CPU one :func:`_needs_rebin_plain`; any other device raises.
    """
    if _rng._on_card(dense.device):
        return _drift_kernels().drift_check(dense.position, meta.ref_position, dense.tag,
                                            spec.buffer, viol)
    return viol | _needs_rebin_plain(dense, meta, spec)


def _needs_rebin_plain(dense: State, meta: GridMeta, spec: GridSpec) -> torch.Tensor:
    return _drift_exceeds(*_top_two(_drift_sq(dense, meta)), spec)


def drift_top_two(dense: State, meta: GridMeta) -> torch.Tensor:
    """[2]: one shard's two largest squared drifts, ties counted; the two of
    every shard hold the grid's two, so :func:`needs_rebin_of` on them all
    is :func:`needs_rebin` on the whole grid. K6 on a CUDA shard."""
    if _rng._on_card(dense.device):
        return _drift_kernels().drift_top_two(dense.position, meta.ref_position, dense.tag)
    return _drift_top_two_plain(dense, meta)


def _drift_top_two_plain(dense: State, meta: GridMeta) -> torch.Tensor:
    return torch.stack(_top_two(_drift_sq(dense, meta)))


def needs_rebin_of(top_twos: torch.Tensor, spec: GridSpec, viol: torch.Tensor) -> torch.Tensor:
    """:func:`needs_rebin` from the shards' :func:`drift_top_two`,
    concatenated (``viol |`` it, as there); K6 over the values on CUDA."""
    if _rng._on_card(top_twos.device):
        return _drift_kernels().needs_rebin_of(top_twos, spec.buffer, viol)
    return viol | _needs_rebin_of_plain(top_twos, spec)


def _needs_rebin_of_plain(top_twos: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    return _drift_exceeds(*_top_two(top_twos), spec)


# ---------------------------------------------------------------------------
# Stencil J-blocks (neighbour-cell data, pre-shifted)
# ---------------------------------------------------------------------------
@frozen_dataclass
class JBlocks:
    """Neighbour data per stencil offset: [n_offsets, n_cells, cap] tensors.

    With >= 3 cells per axis (``preshifted``) the coordinates carry the
    periodic lattice shift of each wrapped neighbour cell, so ``xi - jx``
    is the true separation; otherwise pairs need minimum-image math.
    Velocities and tags ride along only for the forces that read them
    (DPD), quaternions only for the anisotropic force; else they are None.
    """

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    typeid: torch.Tensor  # int32, -1 for empty slots
    half: bool
    preshifted: bool
    tag: torch.Tensor | None = None  # int32, -1 for empty slots
    vx: torch.Tensor | None = None
    vy: torch.Tensor | None = None
    vz: torch.Tensor | None = None
    qw: torch.Tensor | None = None
    qx: torch.Tensor | None = None
    qy: torch.Tensor | None = None
    qz: torch.Tensor | None = None


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


@functools.lru_cache(maxsize=64)
def _window_map(dims: tuple, w0: int, n_cols: int, offsets: tuple, sign: int) -> tuple:
    """Host tables of a window's stencil: for each offset o and window cell,
    the window cell holding the neighbour at ``sign * o`` (-1 where the
    window does not hold it) and that neighbour's wrap on each grid axis
    (-1, 0, 1). The neighbour is the grid's cell, wrapped as the halo pad
    wraps it, and found through the same global-to-window column map the
    kernels use."""
    Dx, Dy, Dz = dims
    cols = Dx * Dy
    q = (w0 + np.arange(n_cols)) % cols
    cx, cy, cz = (q // Dy)[:, None], (q % Dy)[:, None], np.arange(Dz)[None, :]
    cells, wraps = [], []
    for o in offsets:
        n = [cx + sign * o[0], cy + sign * o[1], cz + sign * o[2]]
        w = [np.broadcast_to((a >= D).astype(np.int8) - (a < 0), (n_cols, Dz))
             for a, D in zip(n, dims)]
        nx, ny, nz = (a % D for a, D in zip(n, dims))
        wcol = (nx * Dy + ny - w0) % cols
        cells.append(np.where(wcol < n_cols, wcol * Dz + nz, -1).reshape(-1))
        wraps.append(np.stack(w, axis=-1).reshape(-1, 3))
    return np.stack(cells), np.stack(wraps)


def _window_tables(window: Window, spec: GridSpec, offsets, sign: int, device) -> tuple:
    cells, wraps = _window_map(tuple(spec.dims), window.w0, window.n_cols,
                               tuple(tuple(int(v) for v in o) for o in offsets), sign)
    return (torch.as_tensor(cells, dtype=torch.int64, device=device),
            torch.as_tensor(wraps, device=device))


def _window_concat(arr: torch.Tensor, spec: GridSpec, cells, wraps, fill,
                   axis_shifts=None) -> torch.Tensor:
    """[S_window] -> [n_offsets, window cells, cap]: the occupants of every
    stencil cell (``fill`` where the window does not hold it), shifted axis
    by axis where the neighbour wraps, as :func:`_halo_pad` shifts them."""
    g = arr.reshape(-1, spec.cap)
    held = (cells >= 0)[..., None]
    out = torch.where(held, g[cells.clamp_min(0)], fill)
    if axis_shifts is not None:
        for ax, s in enumerate(axis_shifts):
            if s is not None:
                w = wraps[..., ax][..., None]
                out = torch.where(w > 0, out + s, torch.where(w < 0, out - s, out))
    return out


def _drive_window(window: Window | None, spec: GridSpec) -> Window | None:
    """The window the plain stencil walks: None (the grid's own roll) for a
    window that is the whole grid in its order."""
    return None if window is None or window.whole(spec) else window


def make_jblocks(dense: State, spec: GridSpec, half: bool = False,
                 need_velocity: bool = False, need_tag: bool = False,
                 need_quat: bool = False, window: Window | None = None) -> JBlocks:
    """The stencil's neighbour data; with a ``window`` (``dense`` is then
    ``window.state``), for every cell of the window, gathered through the
    window's column map."""
    offsets = spec.half_stencil() if half else spec.stencil()
    preshifted = spec.newton_ok
    sx, sy, sz = _axis_shift_tables(dense.box) if preshifted else (None, None, None)
    window = _drive_window(window, spec)
    if window is not None:
        cells, wraps = _window_tables(window, spec, offsets, 1, dense.device)

    def roll(a, shifts=None, fill=0):
        if window is None:
            return _roll_concat(a, spec, offsets, shifts)
        return _window_concat(a, spec, cells, wraps, fill, shifts)

    kw = {}
    if need_tag:
        kw["tag"] = roll(dense.tag, fill=-1)
    if need_velocity:
        kw.update(vx=roll(dense.velocity[:, 0]), vy=roll(dense.velocity[:, 1]),
                  vz=roll(dense.velocity[:, 2]))
    if need_quat:
        kw.update(qw=roll(dense.orientation[:, 0]), qx=roll(dense.orientation[:, 1]),
                  qy=roll(dense.orientation[:, 2]), qz=roll(dense.orientation[:, 3]))
    return JBlocks(
        x=roll(dense.position[:, 0], sx),
        y=roll(dense.position[:, 1], sy),
        z=roll(dense.position[:, 2], sz),
        typeid=roll(dense.typeid, fill=-1),
        half=half,
        preshifted=preshifted,
        **kw,
    )


# ---------------------------------------------------------------------------
# Plain stencil driver: one pair batch per stencil offset
# ---------------------------------------------------------------------------
def _pair_params(tables: dict, t_i, t_j, T: int) -> dict:
    """Per-pair parameter values: scalars for one type, else a table gather.

    Empty slots (typeid -1) read row/column 0; they are masked anyway.
    """
    if T == 1:
        return {k: v.reshape(()) for k, v in tables.items()}
    # one flat index for every table: a 1-D take is ~3x faster on the CPU
    # than a 2-D gather per table
    idx = (torch.clamp_min(t_i, 0) * T + torch.clamp_min(t_j, 0)).to(torch.int64)
    return {k: torch.take(v, idx) for k, v in tables.items()}


def _n_acc(want: str) -> int:
    """Accumulators per slot: force 3, plus energy 1 and virial 6 for "all"."""
    return {"force": 3, "all": 10}[want]


# j-side fields the stencil driver hands to a pair evaluation, by name:
# the JBlocks attribute and the State field (with its component) it rolls
_J_FIELDS = {
    "typeid": ("typeid", None),
    "tag": ("tag", None),
    "vx": ("velocity", 0),
    "vy": ("velocity", 1),
    "vz": ("velocity", 2),
    "qw": ("orientation", 0),
    "qx": ("orientation", 1),
    "qy": ("orientation", 2),
    "qz": ("orientation", 3),
}


def _n_cells(spec: GridSpec, window: Window | None) -> int:
    """The cells a plain stencil sums for: the grid's, or a window's."""
    window = _drive_window(window, spec)
    return spec.n_cells if window is None else window.n_cols * spec.dims[2]


def _stencil_drive(dense: State, jb: JBlocks, spec: GridSpec, n_acc: int, pair_terms,
                   j_fields=("typeid",), window: Window | None = None) -> tuple:
    """Sum per-pair terms over the dense stencil (plain PyTorch).

    ``pair_terms(dx, dy, dz, rsq, mask, j, newton)`` receives one batch of
    pairs ([C, cap, cap] separations, i minus j, and the base mask of valid
    slot pairs) and the j-side fields named in ``j_fields`` as [C, 1, cap]
    tensors. It returns ``(i_terms, j_terms)``: ``n_acc`` masked
    [C, cap, cap] tensors each, what the pair adds to its i and to its j
    member. ``j_terms`` is read only with ``newton`` (the half stencil) and
    may be None otherwise. Returns ``n_acc`` per-slot sums, each [C, cap].

    Every pair is masked by slot validity, so one path serves orthorhombic
    and tilted boxes (the reference's maskless sentinel path gives the same
    sums: sentinel pairs fall outside every cutoff). Work runs one stencil
    offset at a time, so memory is bounded by one ``[C, cap, cap]`` batch.
    With the Newton half stencil each unordered pair is evaluated once and
    its terms go to both members (the j side in the neighbour-cell frame,
    rolled back to its true cell afterwards); otherwise the full stencil
    pairs every slot with every neighbour under minimum image.

    With a ``window`` (``dense`` is ``window.state`` and ``jb`` its
    :func:`make_jblocks`), the sums run over the window's cells and the j
    side goes back to its true cell through the window's column map in
    place of the roll: each cell the window holds with its whole stencil
    (the own cells, by construction) sums the same pairs in the same order
    as on the whole grid, so its sums are the whole grid's, bit for bit.
    """
    C, cap = _n_cells(spec, window), spec.cap
    window = _drive_window(window, spec)

    def i_view(a):
        return a.reshape(C, cap, 1)

    def self_view(a):
        return a.reshape(C, 1, cap)

    def dense_field(name):
        field, comp = _J_FIELDS[name]
        a = getattr(dense, field)
        return a if comp is None else a[:, comp]

    xi, yi, zi = (i_view(dense.position[:, k]) for k in range(3))
    valid_i = i_view(dense.tag >= 0)

    def isum(carry, t):
        return tuple(c + torch.sum(a, dim=-1) for c, a in zip(carry, t))

    def jsum(t):
        return torch.stack([torch.sum(a, dim=1) for a in t], dim=-1)  # [C, cap, n_acc]

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
            j = {name: getattr(jb, name)[k][:, None, :] for name in j_fields}
            mask = (rsq > 0) & valid_i & (j["typeid"] >= 0)
            carry = isum(carry, pair_terms(dx, dy, dz, rsq, mask, j, False)[0])
        return carry

    Dx, Dy, Dz = spec.dims
    half = spec.half_stencil()
    if window is not None:
        back, _ = _window_tables(window, spec, half, -1, dense.device)
    rolled = []
    for k, o in enumerate(half):
        dx = xi - jb.x[k][:, None, :]
        dy = yi - jb.y[k][:, None, :]
        dz = zi - jb.z[k][:, None, :]
        rsq = dx * dx + dy * dy + dz * dz
        j = {name: getattr(jb, name)[k][:, None, :] for name in j_fields}
        ti, tj = pair_terms(dx, dy, dz, rsq, valid_i & (j["typeid"] >= 0), j, True)
        carry = isum(carry, ti)
        if window is None:
            g = jsum(tj).reshape(Dx, Dy, Dz, cap, n_acc)
            rolled.append(_roll_cells(g, o).reshape(C, cap, n_acc))
        else:
            # the j side of the pairs homed at cell c - o, moved to cell c
            b = back[k]
            rolled.append(torch.where((b >= 0)[:, None, None], jsum(tj)[b.clamp_min(0)], 0.0))

    # self cell: strict upper triangle (i < j within the cell)
    ar = torch.arange(cap, device=dense.device)
    tri = ar[None, None, :] > ar[None, :, None]
    dx = xi - self_view(dense.position[:, 0])
    dy = yi - self_view(dense.position[:, 1])
    dz = zi - self_view(dense.position[:, 2])
    rsq = dx * dx + dy * dy + dz * dz
    mask0 = valid_i & self_view(dense.tag >= 0) & tri
    j0 = {name: self_view(dense_field(name)) for name in j_fields}
    ti, tj = pair_terms(dx, dy, dz, rsq, mask0, j0, True)
    carry = isum(carry, ti)
    jacc = jsum(tj)
    for r in rolled:
        jacc = jacc + r
    return tuple(carry[i] + jacc[..., i] for i in range(n_acc))


def _stencil_sum(dense: State, jb: JBlocks, spec: GridSpec, want: str, eval_pair,
                 j_fields=("typeid",), window: Window | None = None) -> ForceResult:
    """Sum a central pair evaluation over the dense stencil.

    ``eval_pair(dx, dy, dz, rsq, mask, j)`` (the arguments of
    ``_stencil_drive``'s ``pair_terms``) returns ``(f_divr, energy,
    f_virial_divr, mask)``. Each slot gets the masked sums of ``f_divr * d``
    (force), ``energy / 2`` and ``f_virial_divr * d d / 2`` (virial, "all"
    only); the j member of a pair gets the force negated, the energy and
    virial equal.
    """

    def terms(dx, dy, dz, rsq, mask, j, newton):
        f, e, fv, mask = eval_pair(dx, dy, dz, rsq, mask, j)
        f = torch.where(mask, f, 0.0)
        out = [f * dx, f * dy, f * dz]
        if want == "all":
            w = 0.5 * torch.where(mask, fv, 0.0)
            out += [0.5 * torch.where(mask, e, 0.0), w * dx * dx, w * dx * dy, w * dx * dz,
                    w * dy * dy, w * dy * dz, w * dz * dz]
        return out, ([-a for a in out[:3]] + out[3:] if newton else None)

    carry = _stencil_drive(dense, jb, spec, _n_acc(want), terms, j_fields, window)
    return _own(_finish(carry, _n_cells(spec, window) * spec.cap), window, spec)


def _finish(carry, S: int) -> ForceResult:
    parts = tuple(a.reshape(S) for a in carry)
    force = torch.stack(parts[:3], dim=-1)
    if len(parts) == 3:
        return ForceResult(force=force, energy=None, virial=None)
    return ForceResult(force=force, energy=parts[3], virial=torch.stack(parts[4:10], dim=-1))


def _own(r: ForceResult, window: Window | None, spec: GridSpec) -> ForceResult:
    """A windowed result cut to the window's own slots (whole-grid results
    pass through)."""
    if window is None:
        return r
    lo, hi = window.own_range(spec)

    def cut(a):
        return None if a is None else a[lo:hi]

    return ForceResult(force=cut(r.force), energy=cut(r.energy), virial=cut(r.virial),
                       torque=cut(r.torque))


# ---------------------------------------------------------------------------
# Plain pair force
# ---------------------------------------------------------------------------
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
    window: Window | None = None,
) -> ForceResult:
    """Isotropic pair potential over the dense stencil (plain PyTorch); with
    a ``window`` (``dense`` is ``window.state``), for its own slots."""
    T = r_cut_table.shape[0]
    t_i = dense.typeid.reshape(_n_cells(spec, window), spec.cap, 1)

    def eval_pair(dx, dy, dz, rsq, mask, j):
        radii = {"_r_cut": r_cut_table} | ({"_r_on": r_on_table} if mode == "xplor" else {})
        p = _pair_params(tables | radii, t_i, j["typeid"], T)
        rcut, r_on = p.pop("_r_cut"), p.pop("_r_on", None)
        rcutsq = rcut * rcut
        mask = mask & (rsq < rcutsq)
        e, f = _eval_pair_mode(energy_force_fn, rsq, rcut, rcutsq, p, mode, r_on)
        return f, e, f, mask

    return _stencil_sum(dense, jb, spec, want, eval_pair, window=window)


# ---------------------------------------------------------------------------
# Plain DPD force
# ---------------------------------------------------------------------------
def dpd_sigma_table(gamma: torch.Tensor, kT, dt: float) -> torch.Tensor:
    """The random-force coefficient ``sqrt(6 gamma kT / dt)`` per type pair
    (0 when dt <= 0), in float32 as the reference forms it per pair. ``kT``
    is a float or a 0-d float32 tensor on gamma's device (a run's schedule
    of a variant kT): a float32 product either way, and the division stays
    one by the Python scalar dt."""
    if not isinstance(kT, torch.Tensor):
        kT = float(np.float32(kT))
    dt = float(np.float32(dt))
    if dt <= 0:
        return torch.zeros_like(gamma)
    return sqrt(6.0 * gamma * kT / max(dt, 1e-20))


def dense_dpd_force(
    dense: State,
    jb: JBlocks,
    spec: GridSpec,
    tables: dict,
    r_cut_table: torch.Tensor,
    kT,
    dt: float,
    seed: int,
    timestep: int,
    want: str = "all",
    window: Window | None = None,
) -> ForceResult:
    """DPD general-weight thermostat over the dense stencil (plain PyTorch);
    with a ``window`` (``dense`` is ``window.state``), for its own slots.

    Port of the reference ``dense_dpd_force`` (reference plugin
    DPDPairEvaluatorGeneralWeight.h:198-255): conservative ``A (1/r -
    1/rc)``, drag ``-gamma w_R^2 (r . v_ij)`` and random ``sigma w_R
    alpha`` per pair, with ``w_R = (1 - r/rc)^(s/2) / r`` and alpha the
    pair-symmetric Threefry-13 uniform keyed on the sorted true tags, so
    the noise is bitwise the reference's and independent of the stencil.
    ``jb`` must carry velocities and tags. The virial is conservative-only
    (reference :239); the energy goes e/2 to each side.
    """
    T = r_cut_table.shape[0]
    C, cap = _n_cells(spec, window), spec.cap

    def i_view(a):
        return a.reshape(C, cap, 1)

    t_i, tag_i = i_view(dense.typeid), i_view(dense.tag)
    vxi, vyi, vzi = (i_view(dense.velocity[:, k]) for k in range(3))
    sigma_t = dpd_sigma_table(tables["gamma"], kT, dt)

    def eval_dpd(dx, dy, dz, rsq, mask, j):
        t_j = j["typeid"]
        p = _pair_params(
            {"A": tables["A"], "gamma": tables["gamma"], "s": tables["s"], "r": r_cut_table,
             "sigma": sigma_t}, t_i, t_j, T,
        )
        rcut = p["r"]
        rcutsq = rcut * rcut
        mask = mask & (rsq > 0) & (rsq < rcutsq)
        rsq_safe = torch.where(mask, rsq, 1.0)
        rcut_safe = torch.where(rcut > 0, rcut, 2.0)

        rinv = 1.0 / sqrt(rsq_safe)
        r = rsq_safe * rinv
        rcutinv = 1.0 / rcut_safe
        f_cons = p["A"] * (rinv - rcutinv)
        e = p["A"] * (rcut_safe - r) - 0.5 * p["A"] * rcutinv * (rcutsq - rsq_safe)

        rdotv = dx * (vxi - j["vx"]) + dy * (vyi - j["vy"]) + dz * (vzi - j["vz"])
        w_R = torch.clamp_min(1.0 - r * rcutinv, 0.0) ** (0.5 * p["s"]) * rinv
        f_drag = -p["gamma"] * w_R * w_R * rdotv
        alpha = _rng.pair_uniform(_rng.Stream.DPD_GENERAL_WEIGHT, seed, timestep, tag_i,
                                  j["tag"], rounds=_rng.FAST_ROUNDS)
        f_rand = p["sigma"] * w_R * alpha
        return f_cons + f_drag + f_rand, e, f_cons, mask

    return _stencil_sum(dense, jb, spec, want, eval_dpd,
                        j_fields=("typeid", "tag", "vx", "vy", "vz"), window=window)


# ---------------------------------------------------------------------------
# Plain anisotropic force (force and per-side torques)
# ---------------------------------------------------------------------------
def dense_aniso_force(
    energy_force_torque_fn,
    dense: State,
    jb: JBlocks,
    spec: GridSpec,
    tables: dict,
    r_cut_table: torch.Tensor,
    mode: str = "none",
    want: str = "all",
    window: Window | None = None,
) -> ForceResult:
    """Anisotropic pair potential (force and torque) over the dense stencil;
    with a ``window`` (``dense`` is ``window.state``), for its own slots.

    Port of the reference ``dense_aniso_force``. ``jb`` must carry the
    quaternions (``make_jblocks(..., need_quat=True)``). ``want="force"``
    keeps force AND torque (the integrator reads both) and drops energy and
    virial. With ``jb.half`` each unordered pair is evaluated once, in its
    i member's frame: the j member gets ``-f`` (Newton) and its OWN torque
    ``tj`` from the evaluator (torques are not antisymmetric; reference
    plugin AnisoPairEvaluatorTwoPatchMorse.h:179-192); the virial ``0.5 dx
    f`` is the same for both members (dx and f both flip). Modes none and
    shift; the shift subtracts the raw Morse energy at the cutoff scaled by
    both alignments, so it is no constant offset.
    """
    if mode not in ("none", "shift"):
        raise ValueError(f"unknown shift mode {mode!r} for an anisotropic potential")
    if want not in ("force", "all"):
        raise ValueError(f"want must be 'force' or 'all', got {want!r}")
    T = r_cut_table.shape[0]
    C, cap = _n_cells(spec, window), spec.cap

    def i_view(a):
        return a.reshape(C, cap, 1)

    t_i = i_view(dense.typeid)
    quat_i = tuple(i_view(dense.orientation[:, k]) for k in range(4))

    def terms(dx, dy, dz, rsq, mask, j, newton):
        t_j = j["typeid"]
        p = _pair_params(tables, t_i, t_j, T)
        rcut = _pair_params({"r": r_cut_table}, t_i, t_j, T)["r"]
        rcutsq = rcut * rcut
        mask = mask & (rsq > 0) & (rsq < rcutsq)
        dxyz = (torch.where(mask, dx, 1.0), torch.where(mask, dy, 0.0),
                torch.where(mask, dz, 0.0))
        quat_j = (j["qw"], j["qx"], j["qy"], j["qz"])
        e, f, ti, tj = energy_force_torque_fn(
            dxyz, quat_i, quat_j, torch.where(rcut > 0, rcutsq, 4.0), p, mode == "shift"
        )

        def m(v):
            return torch.where(mask, v, 0.0)

        fx, fy, fz = m(f[0]), m(f[1]), m(f[2])
        shared = []
        if want == "all":
            shared = [0.5 * m(e), 0.5 * (dx * fx), 0.5 * (dx * fy), 0.5 * (dx * fz),
                      0.5 * (dy * fy), 0.5 * (dy * fz), 0.5 * (dz * fz)]
        i_out = [fx, fy, fz, m(ti[0]), m(ti[1]), m(ti[2])] + shared
        if not newton:
            return i_out, None
        return i_out, [-fx, -fy, -fz, m(tj[0]), m(tj[1]), m(tj[2])] + shared

    n_acc = 6 if want == "force" else 13
    carry = _stencil_drive(dense, jb, spec, n_acc, terms,
                           j_fields=("typeid", "qw", "qx", "qy", "qz"), window=window)
    parts = tuple(a.reshape(C * cap) for a in carry)
    force = torch.stack(parts[:3], dim=-1)
    torque = torch.stack(parts[3:6], dim=-1)
    if want == "force":
        r = ForceResult(force=force, energy=None, virial=None, torque=torque)
    else:
        r = ForceResult(force=force, energy=parts[6], virial=torch.stack(parts[7:13], dim=-1),
                        torque=torque)
    return _own(r, window, spec)


# ---------------------------------------------------------------------------
# Bond force (PyTorch on every device, as the reference's is XLA)
# ---------------------------------------------------------------------------
def dense_bond_force(energy_force_fn, dense: State, slot_of: torch.Tensor,
                     bond_group: torch.Tensor, params: dict,
                     want: str = "all", positions: torch.Tensor | None = None,
                     first: int = 0) -> ForceResult:
    """Bond force in slot space: endpoints resolved through the tag->slot map.

    Port of the reference ``dense_bond_force``. ``params`` holds one value
    per bond (each ``[NB]``, gathered by bond type once per run). Each bond
    adds ``+f dr`` to its first member, then each adds ``-f dr`` to its
    second, so each row adds its terms in bond order, first members first,
    from +0.0 (the reference's ``.at[a].add`` is deterministic):
    ``index_add_`` on the CPU, which adds in that order there, and on the
    card K10 (``ops/cellsum_kernel.py``, :func:`_bond_scatter`) in the same
    order (CUDA's ``index_add_`` would add with atomics in an order that
    varies when a slot is a member of several bonds). With
    ``want="force"`` (the step loop) the energy and virial scatters are
    skipped.

    On a shard, ``slot_of`` maps to global slots, ``positions`` holds every
    slot's position (all shards joined) and ``first`` is the shard's first
    global slot: each bond is evaluated from the joined positions and its
    terms go to the rows the shard owns (the others to a dropped row), so
    each own slot sums the whole run's terms in the whole run's order.
    """
    S = dense.N
    a = slot_of[bond_group[:, 0]].to(torch.int64)
    b = slot_of[bond_group[:, 1]].to(torch.int64)
    pos = dense.position if positions is None else positions
    d = pos[a] - pos[b]
    ddx, ddy, ddz = dense.box.min_image_components(d[:, 0], d[:, 1], d[:, 2])
    rsq = ddx * ddx + ddy * ddy + ddz * ddz
    e, f_divr = energy_force_fn(torch.where(rsq > 0, rsq, 1.0), params)

    rows = S
    if positions is not None:
        rows = S + 1
        a, b = (torch.where((i >= first) & (i < first + S), i - first, S) for i in (a, b))
    fvec = torch.stack([f_divr * ddx, f_divr * ddy, f_divr * ddz], dim=-1)
    card = _rng._on_card(dense.device)
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=dense.device)
    if card:
        force = _bond_scatter(a, b, fvec, -fvec, S)
    else:
        force = zeros((rows, 3)).index_add_(0, a, fvec).index_add_(0, b, -fvec)[:S]
    if want == "force":
        return ForceResult(force=force, energy=None, virial=None)
    he = 0.5 * e
    w = 0.5 * f_divr
    vir = torch.stack([w * ddx * ddx, w * ddx * ddy, w * ddx * ddz,
                       w * ddy * ddy, w * ddy * ddz, w * ddz * ddz], dim=-1)
    if card:
        # the energy and the six virial components, three columns a call
        terms = torch.cat([he[:, None], vir, zeros((he.shape[0], 2))], dim=1)
        sums = torch.cat([_bond_scatter(a, b, terms[:, k:k + 3], terms[:, k:k + 3], S)
                          for k in (0, 3, 6)], dim=1)
        return ForceResult(force=force, energy=sums[:, 0], virial=sums[:, 1:7])
    energy = zeros((rows,)).index_add_(0, a, he).index_add_(0, b, he)[:S]
    virial = zeros((rows, 6)).index_add_(0, a, vir).index_add_(0, b, vir)[:S]
    return ForceResult(force=force, energy=energy, virial=virial)


def _bond_scatter(a: torch.Tensor, b: torch.Tensor, at_a: torch.Tensor, at_b: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """float32 ``[rows, 3]``: the rows of ``at_a`` added at ``a``, then those
    of ``at_b`` at ``b`` (each ``[NB, 3]``), each row's terms in that order
    from +0.0, by K10 on the card (one call over ``cat([a, b])``, its
    momentum columns at unit mass). Ids outside ``[0, rows)`` (a shard's
    dropped row) are K10's trash."""
    from . import cellsum_kernel  # imported here: it imports this module (via pair_kernel)

    vals = torch.cat([at_a, at_b]).to(torch.float32).contiguous()
    return cellsum_kernel.cell_sums(torch.cat([a, b]), vals, None, rows)[:, 2:5]
