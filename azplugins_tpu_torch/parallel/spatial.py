"""Spatial domain decomposition on shards: the block-local rebin with
migration, and the halo windows of the force stencil.

Port of ``azplugins_tpu/parallel/spatial.py``. The dense slot layout is
cell-major, so cutting the slot axis into contiguous blocks is a spatial
decomposition: block d owns ``cols_loc = Dx*Dy / n`` whole z cell columns
from column ``d * cols_loc`` (a column is ``cx * Dy + cy``), whole x planes
(slabs) when n divides Dx, (x, y) strips otherwise. On a sharded mesh
(parallel/mesh.py) each block is a State of its own on its device, and one
Python process drives them all, as one JAX controller drives every device
of the reference's mesh:

- :func:`spatial_rebin` rebuilds each shard from its own slots and the
  migrants of the shards up to ``H = _hop_bound(dims, n)`` ring hops away,
  each hop distance one buffer pair of ``migrate_cap`` rows; the
  reference's ``ppermute`` is a move of the packed buffer to the shard
  ``(d +- h) mod n`` (``.to(device)``). The local sort keys on (cell in the
  block, GLOBAL input row), the global rebin's order restricted to the
  block, so the layout is ``ops.dense.rebin``'s bit for bit, and the run
  does not depend on the decomposition.
- :func:`halo_window` gives a shard the slots its stencil reads: whole x
  planes from the plane before its first own column to the plane after
  its last, copied from the shards that own them. The kernels
  (csrc/cell_stencil.cuh) and the plain stencil (ops/dense.py) take that
  window and compute each pair from both sides, so a shard writes forces
  for its own slots only and no force travels back.
- :func:`shard_dense` and :func:`gather_dense` split and join the slot
  axis at the block boundaries (:func:`shard_meta` and :func:`gather_meta`
  the rebuild state with it).

With bonds the tag->slot map is the whole system's, in global slots, and
every shard holds a copy on its device (the reference's replicated
``slot_of``): a bond partner may lie in any shard.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.state import State
from ..ops import dense as D

__all__ = ["spatial_rebin", "slab_migrate_capacity", "shard_dense", "gather_dense",
           "halo_window", "halo_runs"]

# the fused local sort key (cell in block << bits | global row) is used where
# it fits a signed 32-bit integer, as the reference's int32 key; else the
# two-operand sort gives the same order
_FUSED_KEY_LIMIT = 2**31

# the State fields that ride with every shard's slots (the bonds and the box
# are the whole system's and shared)
_SLOT_FIELDS = ("position", "tag", "velocity", "typeid", "image", "orientation", "mass",
                "diameter", "charge", "net_force", "acceleration", "angmom", "moment_inertia",
                "net_torque")


def slab_migrate_capacity(spec: D.GridSpec, n_devices: int) -> int:
    """Default per-direction migrant buffer: one face layer of cells at
    half capacity (capped at the block size), rounded up to 8. Particles
    cross a block face only by drifting less than the Verlet margin, so a
    face layer is generous."""
    Dy, Dz = spec.dims[1], spec.dims[2]
    c_loc = spec.n_cells // max(1, n_devices)
    m = max(8, (min(Dy * Dz, c_loc) * spec.cap) // 2)
    return int((m + 7) // 8 * 8)


def _hop_bound(dims, n: int) -> int:
    """Exact max ring-hop distance a one-cell-per-axis drift can produce.

    Blocks are contiguous runs of cols_loc = Dx*Dy/n whole z columns in
    (cx, cy)-lexicographic order; a drift of at most one cell per axis
    (periodic wraps included) moves a particle's column, hence its block, a
    bounded ring distance, enumerated exactly on the host over all columns
    and the 9 moves: whole-plane slabs give 1, sub-plane strips more (the y
    wrap hops most of a plane).
    """
    Dx, Dy, _ = dims
    cols = Dx * Dy
    cols_loc = cols // n
    q = np.arange(cols)
    cx, cy = q // Dy, q % Dy
    b = q // cols_loc
    h = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            q2 = ((cx + dx) % Dx) * Dy + ((cy + dy) % Dy)
            off = (q2 // cols_loc - b) % n
            h = max(h, int(np.minimum(off, n - off).max()))
    return h


def _check_blocks(spec: D.GridSpec, n: int) -> int:
    """cols_loc, the z columns of a block; Dx*Dy must divide by n."""
    Dx, Dy, _ = spec.dims
    if (Dx * Dy) % n != 0:
        raise ValueError(f"Dx*Dy={Dx * Dy} must be divisible by the mesh size {n} "
                         "(blocks align to whole z cell columns)")
    return Dx * Dy // n


# ---------------------------------------------------------------------------
# Splitting and joining the slot axis
# ---------------------------------------------------------------------------
def shard_dense(dense: State, mesh) -> tuple:
    """A dense (slot-order) state -> one State per block of ``mesh``: block
    d's slots, copied to ``mesh.devices[d]`` (the bonds and the box ride
    along whole)."""
    n = mesh.size
    S_loc = dense.N // n
    shards = []
    for d, dev in enumerate(mesh.devices):
        lo, hi = d * S_loc, (d + 1) * S_loc
        kw = {f: getattr(dense, f)[lo:hi].to(dev, copy=True) for f in _SLOT_FIELDS}
        shards.append(dense.replace(bond_typeid=dense.bond_typeid.to(dev),
                                    bond_group=dense.bond_group.to(dev), **kw))
    return tuple(shards)


def shard_meta(meta: D.GridMeta, shards: tuple) -> tuple:
    """A whole grid's meta -> each shard's: its slice of the rebuild
    positions, a copy of the global tag->slot map, and the flags and
    counters (each shard carries them; the run reads their OR and max)."""
    S_loc = shards[0].N
    out = []
    for d, shard in enumerate(shards):
        dev = shard.device
        out.append(D.GridMeta(
            ref_position=meta.ref_position[d * S_loc:(d + 1) * S_loc].to(dev, copy=True),
            slot_of=meta.slot_of.to(dev),
            overflow=meta.overflow.to(dev),
            n_builds=meta.n_builds.to(dev),
            max_occ=meta.max_occ.to(dev),
        ))
    return tuple(out)


def gather_meta(metas: tuple, device) -> D.GridMeta:
    """The shards' metas joined into the whole grid's on ``device``: the
    rebuild positions in block order, the overflow flags' OR, the largest
    ``max_occ`` (what the whole grid's rebuilds would have seen), the build
    count and the tag->slot map (every shard's are the same)."""
    return D.GridMeta(
        ref_position=torch.cat([m.ref_position.to(device) for m in metas]),
        slot_of=metas[0].slot_of.to(device),
        overflow=torch.stack([m.overflow.to(device) for m in metas]).any(),
        n_builds=metas[0].n_builds.to(device),
        max_occ=torch.stack([m.max_occ.to(device) for m in metas]).max(),
    )


def gather_dense(shards: tuple, device) -> State:
    """The shards' slots joined in block order on ``device``: the whole
    grid's dense state."""
    kw = {f: torch.cat([getattr(s, f).to(device) for s in shards]) for f in _SLOT_FIELDS}
    s0 = shards[0]
    return s0.replace(bond_typeid=s0.bond_typeid.to(device), bond_group=s0.bond_group.to(device),
                      **kw)


# ---------------------------------------------------------------------------
# Halo windows
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def halo_runs(dims: tuple, n: int, d: int) -> tuple:
    """Shard d's window: ``(w0, n_cols, runs)``. The window is whole x
    planes, from the plane before the shard's first own column to the plane
    after its last (x wraps), as a ring of columns from column ``w0`` (the
    grid itself, ``w0 = 0``, when that covers Dx planes or more). Whole
    planes, since the y wrap takes a neighbour of column (cx, Dy - 1) to
    (cx +- 1, 0), up to 2 Dy - 1 columns away. ``runs`` lists the window's
    consecutive pieces, each ``(shard, first local column, columns)``."""
    Dx, Dy, _ = dims
    cols = Dx * Dy
    cols_loc = cols // n
    c0 = d * cols_loc
    x_first, x_last = c0 // Dy, (c0 + cols_loc - 1) // Dy
    planes = x_last - x_first + 3
    if planes >= Dx:
        w0, n_cols = 0, cols
    else:
        w0, n_cols = ((x_first - 1) % Dx) * Dy, planes * Dy
    runs = []
    for k in range(n_cols):
        q = (w0 + k) % cols
        e, lq = divmod(q, cols_loc)
        if runs and runs[-1][0] == e and runs[-1][1] + runs[-1][2] == lq:
            runs[-1][2] += 1
        else:
            runs.append([e, lq, 1])
    return w0, n_cols, tuple(tuple(r) for r in runs)


def _empty_like(a: torch.Tensor) -> torch.Tensor:
    return a.new_empty((0,) + tuple(a.shape[1:]))


def halo_window(shards: tuple, d: int, spec: D.GridSpec,
                fields: tuple = ("position", "typeid", "tag")) -> D.Window:
    """Shard d's stencil window (:func:`halo_runs`) on shard d's device.

    Carries only ``fields``, the State fields the stencil forces read
    (position, typeid and tag, the occupancy; velocity for DPD, orientation
    for an anisotropic force); the window State's other fields are empty.
    The columns other shards own are copied from them with an explicit
    ``.to(device)``.
    """
    n = len(shards)
    cols_loc = _check_blocks(spec, n)
    w0, n_cols, runs = halo_runs(tuple(spec.dims), n, d)
    per_col = spec.dims[2] * spec.cap
    dev = shards[d].device

    def window_of(name):
        parts = [getattr(shards[e], name)[lq * per_col:(lq + k) * per_col].to(dev)
                 for e, lq, k in runs]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    own = shards[d]
    kw = {f: (window_of(f) if f in fields else _empty_like(getattr(own, f)))
          for f in _SLOT_FIELDS}
    return D.Window(state=own.replace(**kw), w0=w0, n_cols=n_cols, c0=d * cols_loc,
                    n_own=cols_loc)


# ---------------------------------------------------------------------------
# The block-local rebin
# ---------------------------------------------------------------------------
def _pack_migrants(mask, mig_data, empty_row, M: int):
    """The rows of ``mig_data`` under ``mask``, in row order, in a buffer of
    M rows (empty rows after them), and whether more than M wanted in."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (rank < M), rank, M)
    buf = empty_row.expand(M + 1, -1).clone()
    buf[slot] = mig_data  # row M collects the rejects and every unmasked row
    return buf[:M], mask.sum() > M


def spatial_rebin(shards: tuple, metas: tuple, spec: D.GridSpec, N_tags: int,
                  fields: tuple = D.ALL_FIELDS, need_slot_of: bool = False, *, mesh,
                  migrate_cap: int | None = None):
    """Block-local rebin with ring migration: ``ops.dense.rebin`` for a
    sharded layout, the reference's ``shard_body`` run once per shard.

    ``shards``, ``metas``: one State and one GridMeta per block of ``mesh``.
    Returns the new shards and metas: the slot layout the global rebin
    would produce, each block's share on its own device. A shard's overflow
    flag is raised by a cell above capacity, a full migrant buffer, or a
    migrant farther than ``H`` hops (lost); its ``max_occ`` is what the
    shard saw (a lower bound once a migrant is lost). With
    ``need_slot_of`` each meta carries the global tag->slot map
    (:func:`_global_slot_of`); without it the metas' maps pass through.
    """
    n = mesh.size
    if len(shards) != n or len(metas) != n:
        raise ValueError(f"{len(shards)} shards and {len(metas)} metas for a mesh of {n} "
                         "blocks: the layout was split for another mesh")
    C, S, cap = spec.n_cells, spec.S, spec.cap
    _check_blocks(spec, n)
    C_loc, S_loc = C // n, S // n
    H = _hop_bound(spec.dims, n)
    M = migrate_cap if migrate_cap is not None else slab_migrate_capacity(spec, n)
    layout = D._payload_layout(fields)
    K = sum(w for _, w, _ in layout)
    gbits = max(1, (S - 1).bit_length())
    fused = (C_loc + 1) << gbits < _FUSED_KEY_LIMIT
    box = shards[0].box

    # each shard: its stays, and its migrants packed into one buffer pair a hop
    stays, sends, flags = [], [], []
    for d, shard in enumerate(shards):
        dev = shard.device
        pos_w, image_w = box.wrap(shard.position, shard.image)
        cid = D._cell_id(pos_w[:, 0], pos_w[:, 1], pos_w[:, 2], box, spec.dims)
        cid = torch.where(shard.tag >= 0, cid, C).to(torch.int64)
        packed = D._pack_payload(shard.replace(position=pos_w, image=image_w), layout)
        gidx = d * S_loc + torch.arange(S_loc, dtype=torch.int64, device=dev)
        is_real = cid < C
        dest = torch.where(is_real, cid // C_loc, d)
        stay = is_real & (dest == d)
        # ring routing: a migrant rides exactly one buffer; distances are
        # measured both ways round the ring and a tie (the shard opposite,
        # both neighbours with n == 2) goes left; with n == 1 all stay
        off = (dest - d) % n
        hop_r = off
        hop_l = torch.where(off == 0, n, n - off)
        mig = is_real & ~stay
        use_l = mig & (hop_l <= H) & (hop_l <= hop_r)
        use_r = mig & (hop_r <= H) & (hop_r < hop_l)
        lost = mig & ~(use_l | use_r)
        # rows: payload, cell, global row (cell C marks an empty row)
        row = gidx.to(torch.int32)[:, None]
        mig_data = torch.cat([packed, cid.to(torch.int32)[:, None], row], dim=1)
        # fills, not a copy of a host list (which would wait for the stream)
        empty_row = torch.cat([D._payload_default_row(layout, dev)[0],
                               torch.full((1,), C, dtype=torch.int32, device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev)])
        ov = lost.any()
        out = {}
        for h in range(1, H + 1):
            out[("l", h)], ovl = _pack_migrants(use_l & (hop_l == h), mig_data, empty_row, M)
            out[("r", h)], ovr = _pack_migrants(use_r & (hop_r == h), mig_data, empty_row, M)
            ov = ov | ovl | ovr
        stay_cid = torch.where(stay, cid, C).to(torch.int32)[:, None]
        stays.append(torch.cat([packed, stay_cid, row], dim=1))
        sends.append(out)
        flags.append(ov)

    new_shards, new_metas = [], []
    for d, (shard, meta) in enumerate(zip(shards, metas)):
        dev = shard.device
        # the reference's ppermute: shard d takes the left buffer of shard
        # d + h and the right buffer of shard d - h (the exchange from
        # block j + h is a roll by -h)
        recvs = []
        for h in range(1, H + 1):
            recvs.append(sends[(d + h) % n][("l", h)].to(dev))
            recvs.append(sends[(d - h) % n][("r", h)].to(dev))
        cand = torch.cat([stays[d]] + recvs, dim=0) if recvs else stays[d]
        n_cand = cand.shape[0]
        cand_cid = cand[:, K].to(torch.int64)
        gidx = cand[:, K + 1].to(torch.int64)
        crel = torch.where(cand_cid < C, cand_cid - d * C_loc, C_loc).clamp(0, C_loc)
        if fused:
            _, perm = torch.sort((crel << gbits) | gidx, stable=True)
        else:
            _, by_row = torch.sort(gidx, stable=True)
            _, by_cell = torch.sort(crel[by_row], stable=True)
            perm = by_row[by_cell]
        crel_s = crel[perm]
        start = torch.searchsorted(crel_s, torch.arange(C_loc + 1, dtype=torch.int64, device=dev))
        counts = start[1:] - start[:-1]
        overflow = (counts > cap).any() | flags[d]
        max_occ = counts.max().to(torch.int32)

        rank = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
        valid_slot = rank < torch.clamp(counts, max=cap)[:, None]
        src = torch.where(valid_slot, start[:C_loc, None] + rank, n_cand).reshape(S_loc)
        packed_pad = torch.cat([cand[perm, :K], D._payload_default_row(layout, dev)], dim=0)
        out = packed_pad[src]
        # empty-slot x sentinels keyed on the GLOBAL slot: the grid's own
        x = torch.where(valid_slot.reshape(S_loc), out[:, 0].view(torch.float32),
                        D._sentinel_x(S_loc, box, spec, dev, first=d * S_loc))
        out = torch.cat([x.view(torch.int32)[:, None], out[:, 1:]], dim=1)
        new = D._state_from_payload(out, layout, shard, box)
        new_shards.append(new)
        new_metas.append(D.GridMeta(
            ref_position=new.position,
            slot_of=meta.slot_of,
            overflow=overflow | meta.overflow,
            n_builds=meta.n_builds + 1,
            max_occ=torch.maximum(max_occ, meta.max_occ),
        ))
    if need_slot_of:
        slot_of = _global_slot_of(new_shards, N_tags)
        new_metas = [m.replace(slot_of=slot_of.to(m.ref_position.device)) for m in new_metas]
    return tuple(new_shards), tuple(new_metas)


def _global_slot_of(shards: tuple, N_tags: int) -> torch.Tensor:
    """The tag->slot map of the whole layout, in global slots, on the first
    shard's device: each shard's tags name its first slot plus their local
    slot (empty slots land on a dropped extra entry), as ``ops.dense``'s
    rebin builds it."""
    dev0 = shards[0].device
    slot_of = torch.zeros((N_tags + 1,), dtype=torch.int32, device=dev0)
    first = 0
    for s in shards:
        dest = torch.where(s.tag >= 0, s.tag, N_tags).to(torch.int64)
        slot = first + torch.arange(s.N, dtype=torch.int32, device=s.device)
        slot_of[dest.to(dev0)] = slot.to(dev0)
        first += s.N
    return slot_of[:N_tags]

