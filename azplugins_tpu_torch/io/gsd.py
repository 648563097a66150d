"""GSD v2 export: one-way aztraj -> GSD (HOOMD schema) conversion.

A copy of ``azplugins_tpu/io/gsd.py``. HOOMD's ecosystem reads/writes
trajectories and checkpoints through GSD files; aztraj is this engine's
native container (io/aztraj.py). This module closes the interop gap:
``export_gsd`` converts an aztraj trajectory into a GSD 2.0 file with the
``hoomd`` schema (version 1.4) so an azplugins user's analysis stack
(gsd.hoomd, freud, ovito, ...) can read the output. The header's
application field names this package (``azplugins_tpu_torch``); a file
otherwise has the bytes the JAX package writes for the same frames.

The GSD container is implemented natively from the published file layout
(gsd.readthedocs.io "File layout", GSD spec v2):

  * 256-byte header: magic ``0x65DF65DF65DF65DF``, index/namelist
    locations + allocated sizes, schema + gsd versions, application and
    schema name fields.
  * data chunks appended anywhere in the file;
  * index: array of 32-byte entries (frame, N rows, file location,
    M columns, name id, type enum, flags), sorted by frame; the header
    records the ALLOCATED slab size and unused slots are zero — frames
    commit in place and a full slab relocates doubled to the file tail
    (crash-safe appends; see GSDWriter);
  * v2 namelist: tightly packed null-terminated UTF-8 names, zero-padded
    to a multiple of the 64-byte name segment size.

No third-party ``gsd`` package is needed: conformance is asserted
structurally (magic/layout/round-trip through the independent reader
below) rather than against the C implementation.

HOOMD-schema chunks written per frame: configuration/{step,dimensions,
box}, particles/{N,position,velocity,image,typeid,types,mass,charge,
diameter,orientation,angmom,moment_inertia}, bonds/{N,typeid,group,types}.
Frame 0 is complete; later frames carry only the dynamic chunks present
in the source aztraj frame (GSD readers fall back to frame 0 for the
rest, matching hoomd.write.GSD's ``dynamic`` behavior). The hoomd schema
has no MPCD solvent: a GSD file carries none (an aztraj checkpoint does).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["GSDWriter", "GSDReader", "export_gsd", "read_gsd"]

_MAGIC = 0x65DF65DF65DF65DF
_GSD_VERSION = (2 << 16) | 0  # 2.0
_HOOMD_SCHEMA_VERSION = (1 << 16) | 4  # hoomd schema 1.4
_NAME_SIZE = 64
_HEADER = struct.Struct("<QQQQQII64s64s80s")
_INDEX_ENTRY = struct.Struct("<QQqIHBB")

# GSD type enum (spec) -> numpy dtype
_TYPES = {
    1: np.dtype("<u1"),
    2: np.dtype("<u2"),
    3: np.dtype("<u4"),
    4: np.dtype("<u8"),
    5: np.dtype("<i1"),
    6: np.dtype("<i2"),
    7: np.dtype("<i4"),
    8: np.dtype("<i8"),
    9: np.dtype("<f4"),
    10: np.dtype("<f8"),
}
_TYPE_CODES = {v: k for k, v in _TYPES.items()}


def _as_gsd_array(arr) -> np.ndarray:
    a = np.ascontiguousarray(arr)
    if a.ndim == 0:
        a = a.reshape(1)
    if a.ndim > 2:
        raise ValueError("GSD chunks are at most 2-D")
    dt = a.dtype.newbyteorder("<")
    if dt not in _TYPE_CODES:
        raise TypeError(f"unsupported GSD dtype {a.dtype}")
    return a.astype(dt, copy=False)


class GSDWriter:
    """Append frames of named (<= 2-D) arrays to a GSD 2.0 file.

    Crash-safe by the same discipline as the reference GSD C library:
    the header always points at a fully-written namelist and index, and
    committed bytes are never overwritten or truncated. Index entries
    live in a preallocated slab (unused slots are zero, which readers —
    including ours — skip per the spec); each ``end_frame`` commits the
    new entries into free slots in place and flushes. When a slab fills,
    a doubled slab is written at the end of the file and the header is
    repointed only after it is flushed — the old slab becomes a dead
    region (geometric growth bounds the waste at ~2x the final index
    size). A kill at ANY point leaves every previously committed frame
    readable; at worst the frame being committed is lost.
    """

    _INIT_INDEX_CAP = 128  # preallocated index entries (32 B each)
    _INIT_NAME_SEGS = 16  # preallocated namelist segments (64 B each)

    def __init__(self, path: str, application: str = "azplugins_tpu_torch",
                 schema: str = "hoomd",
                 schema_version: int = _HOOMD_SCHEMA_VERSION,
                 mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError("mode must be 'w' or 'a'")
        self._application = application
        self._schema = schema
        self._schema_version = schema_version
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._index: list[tuple] = []  # (frame, N, loc, M, id, type)
        self._frame = 0
        self._closed = False
        self._n_committed = 0  # index entries already on disk
        self._names_committed = 0  # packed namelist bytes already on disk
        import os as _os

        if mode == "a" and _os.path.exists(path) and _os.path.getsize(path):
            self._open_append(path)
            return
        # fresh file: header + empty namelist slab + empty index slab,
        # all flushed before the first data byte — the file is a valid
        # (zero-frame) GSD from the first commit on
        self._f = open(path, "w+b")
        self._name_loc = _HEADER.size
        self._name_segs = self._INIT_NAME_SEGS
        self._index_loc = self._name_loc + self._name_segs * _NAME_SIZE
        self._index_cap = self._INIT_INDEX_CAP
        self._data_pos = self._index_loc + self._index_cap * _INDEX_ENTRY.size
        self._f.write(b"\x00" * self._data_pos)
        self._write_header()
        self._f.flush()

    def _open_append(self, path: str) -> None:
        """Resume appending to an existing GSD v2 file.

        Reads the committed namelist/index and continues writing data at
        the end of the file. Nothing committed is truncated or
        overwritten: new index entries go into the slab's free slots, and
        a full slab (always the case for files our close() exact-sized)
        relocates to a doubled slab at the tail on the next commit."""
        with open(path, "rb") as f:
            hdr = f.read(_HEADER.size)
            (magic, index_loc, n_idx, name_loc, n_seg, sv, gv, app, sch,
             _r) = _HEADER.unpack(hdr)
            if magic != _MAGIC:
                raise OSError(f"{path} is not a GSD file")
            if (gv >> 16) != 2:
                raise OSError(
                    f"cannot append to GSD v{gv >> 16} files; rewrite with "
                    "mode='w'"
                )
            size = f.seek(0, 2)
            if index_loc + n_idx * _INDEX_ENTRY.size > size or (
                name_loc and name_loc + n_seg * _NAME_SIZE > size
            ):
                raise OSError(f"{path}: GSD header points past end of file")
            packed_end = 0
            if name_loc:
                f.seek(name_loc)
                raw = f.read(n_seg * _NAME_SIZE)
                off = 0
                while off < len(raw):
                    end = raw.index(b"\x00", off) if b"\x00" in raw[off:] else -1
                    if end <= off:
                        break
                    name = raw[off:end].decode()
                    self._name_ids[name] = len(self._names)
                    self._names.append(name)
                    off = end + 1
                packed_end = off
            f.seek(index_loc)
            for _ in range(n_idx):
                frame, N, loc, M, nid, tc, _fl = _INDEX_ENTRY.unpack(
                    f.read(_INDEX_ENTRY.size)
                )
                if loc != 0:  # spec: unused slots have location 0
                    self._index.append((frame, N, loc, M, nid, tc))
        self._schema_version = sv
        self._application = app.split(b"\x00")[0].decode()
        self._schema = sch.split(b"\x00")[0].decode()
        self._frame = 1 + max((e[0] for e in self._index), default=-1)
        self._name_loc = name_loc
        self._name_segs = n_seg
        self._index_loc = index_loc
        self._index_cap = n_idx
        self._n_committed = len(self._index)
        self._names_committed = packed_end
        self._f = open(path, "r+b")
        self._data_pos = size

    @property
    def nframes(self) -> int:
        return self._frame

    def _name_id(self, name: str) -> int:
        nid = self._name_ids.get(name)
        if nid is None:
            nid = len(self._names)
            if nid > 0xFFFF:
                raise ValueError("too many chunk names for GSD (uint16 id)")
            self._name_ids[name] = nid
            self._names.append(name)
        return nid

    def write_chunk(self, name: str, data) -> None:
        a = _as_gsd_array(data)
        N = a.shape[0]
        M = a.shape[1] if a.ndim == 2 else 1
        loc = self._data_pos
        self._f.seek(loc)
        self._f.write(a.tobytes())
        self._data_pos = self._f.tell()
        self._index.append(
            (self._frame, N, loc, M, self._name_id(name), _TYPE_CODES[a.dtype])
        )

    def end_frame(self) -> None:
        # the GSD v2 reference reader binary-searches the index on
        # (frame, id): commit this frame's entries in ascending name-id
        # order, not write_chunk call order, so a name introduced
        # mid-stream stays findable by the C library. Frames commit in
        # increasing order, so the whole in-memory index stays
        # (frame, id)-sorted and disk order keeps matching memory order.
        tail = sorted(
            self._index[self._n_committed:], key=lambda e: (e[0], e[4])
        )
        self._index[self._n_committed:] = tail
        self._frame += 1
        self._commit()

    def _write_header(self) -> None:
        header = _HEADER.pack(
            _MAGIC,
            self._index_loc,
            self._index_cap,
            self._name_loc,
            self._name_segs,
            self._schema_version,
            _GSD_VERSION,
            self._application.encode()[:63],
            self._schema.encode()[:63],
            b"",
        )
        self._f.seek(0)
        self._f.write(header)

    def _commit(self) -> None:
        """Flush new names + index entries; file is valid afterwards.

        Write order keeps every intermediate state consistent: slab
        relocations land in fresh space at the tail and are flushed
        BEFORE the header repoints at them; in-place writes touch only
        zero (free) slots / the zero tail of the namelist slab.
        """
        header_dirty = False
        # --- namelist ---
        raw = b"".join(n.encode() + b"\x00" for n in self._names)
        if len(raw) > self._names_committed:
            # start doubling from at least one segment: a legacy/foreign
            # file with namelist_location == 0 resumes with _name_segs == 0,
            # and 0 * 2 == 0 would loop forever (and name_loc == 0 must
            # relocate to the tail, never append over the header) — same
            # guard the index branch applies with max(self._index_cap, 1)
            segs = max(self._name_segs, 1)
            while len(raw) > segs * _NAME_SIZE:
                segs *= 2
            if segs != self._name_segs:  # relocate doubled slab to tail
                self._name_loc = self._data_pos
                self._name_segs = segs
                self._f.seek(self._name_loc)
                self._f.write(raw + b"\x00" * (segs * _NAME_SIZE - len(raw)))
                self._data_pos = self._f.tell()
                header_dirty = True
            else:  # append new names onto the slab's zero tail
                self._f.seek(self._name_loc + self._names_committed)
                self._f.write(raw[self._names_committed:])
            self._names_committed = len(raw)
        # --- index ---
        if len(self._index) > self._index_cap:  # relocate doubled slab
            cap = max(self._index_cap, 1)
            while len(self._index) > cap:
                cap *= 2
            # a relocation rewrites every entry into fresh space: the one
            # chance to (frame, id)-sort entries inherited from a foreign
            # appended file (ours are already sorted; see end_frame)
            self._index.sort(key=lambda e: (e[0], e[4]))
            self._index_loc = self._data_pos
            self._index_cap = cap
            self._f.seek(self._index_loc)
            for frame, N, loc, M, nid, tc in self._index:
                self._f.write(_INDEX_ENTRY.pack(frame, N, loc, M, nid, tc, 0))
            pad = (cap - len(self._index)) * _INDEX_ENTRY.size
            self._f.write(b"\x00" * pad)
            self._data_pos = self._f.tell()
            header_dirty = True
        elif len(self._index) > self._n_committed:  # fill free slots
            self._f.seek(
                self._index_loc + self._n_committed * _INDEX_ENTRY.size
            )
            for frame, N, loc, M, nid, tc in self._index[self._n_committed:]:
                self._f.write(_INDEX_ENTRY.pack(frame, N, loc, M, nid, tc, 0))
        self._n_committed = len(self._index)
        if header_dirty:
            self._f.flush()  # slabs fully on disk before the header points
            self._write_header()
        self._f.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._commit()
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GSDReader:
    """Minimal independent GSD v2 reader (round-trip validation + interop
    with files other tools wrote; supports the fixed-slot v1 namelist
    too)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        head = self._f.read(_HEADER.size)
        (magic, index_loc, index_n, name_loc, name_n, schema_ver, gsd_ver,
         app, schema, _res) = _HEADER.unpack(head)
        if magic != _MAGIC:
            raise OSError("not a GSD file (bad magic)")
        self.application = app.split(b"\x00")[0].decode()
        self.schema = schema.split(b"\x00")[0].decode()
        self.schema_version = (schema_ver >> 16, schema_ver & 0xFFFF)
        self.gsd_version = (gsd_ver >> 16, gsd_ver & 0xFFFF)
        # namelist
        self._names: list[str] = []
        if name_loc:
            self._f.seek(name_loc)
            raw = self._f.read(name_n * _NAME_SIZE)
            if self.gsd_version[0] >= 2:
                off = 0
                while off < len(raw):
                    end = raw.index(b"\x00", off)
                    if end == off:
                        break
                    self._names.append(raw[off:end].decode())
                    off = end + 1
            else:  # v1: fixed 64-byte slots
                for k in range(name_n):
                    s = raw[k * _NAME_SIZE:(k + 1) * _NAME_SIZE]
                    s = s.split(b"\x00")[0]
                    if s:
                        self._names.append(s.decode())
        # index (unused slots have location 0)
        self._index = []
        self._f.seek(index_loc)
        for _ in range(index_n):
            e = _INDEX_ENTRY.unpack(self._f.read(_INDEX_ENTRY.size))
            if e[2] != 0:
                self._index.append(e)
        self.n_frames = 1 + max((e[0] for e in self._index), default=-1)

    def chunks(self, frame: int) -> list[str]:
        return [self._names[e[4]] for e in self._index if e[0] == frame]

    def read_chunk(self, frame: int, name: str) -> np.ndarray:
        for f, N, loc, M, nid, tc, _fl in self._index:
            if f == frame and self._names[nid] == name:
                dt = _TYPES[tc]
                self._f.seek(loc)
                a = np.frombuffer(self._f.read(N * M * dt.itemsize), dtype=dt)
                return a.reshape(N, M) if M > 1 else a
        raise KeyError(f"chunk {name!r} not in frame {frame}")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _encode_typenames(types: list[str]) -> np.ndarray:
    """hoomd-schema type names: int8 [K, max_len+1], zero padded UTF-8."""
    if not types:
        types = ["A"]
    width = max(len(t.encode()) for t in types) + 1
    out = np.zeros((len(types), width), np.int8)
    for k, t in enumerate(types):
        b = t.encode()
        out[k, : len(b)] = np.frombuffer(b, np.int8)
    return out


def _hoomd_frame_chunks(timestep: int, chunks: dict, complete: bool) -> dict:
    """Map an aztraj frame's named arrays to hoomd-schema GSD chunks."""
    from . import _decode_types

    pos = np.asarray(chunks["particles/position"], np.float32)
    N = pos.shape[0]
    out = {
        "configuration/step": np.asarray([timestep], np.uint64),
        "configuration/box": np.asarray(
            chunks["configuration/box"], np.float32
        ).reshape(6),
        "particles/N": np.asarray([N], np.uint32),
        "particles/position": pos,
        "particles/velocity": np.asarray(chunks["particles/velocity"], np.float32),
        "particles/image": np.asarray(chunks["particles/image"], np.int32),
    }
    if not complete:
        return out
    out["configuration/dimensions"] = np.asarray([3], np.uint8)
    out["particles/typeid"] = np.asarray(chunks["particles/typeid"], np.uint32)
    out["particles/types"] = _encode_typenames(
        _decode_types(chunks["particles/types"])
    )
    out["particles/mass"] = np.asarray(chunks["particles/mass"], np.float32)
    out["particles/charge"] = np.asarray(chunks["particles/charge"], np.float32)
    out["particles/diameter"] = np.asarray(chunks["particles/diameter"], np.float32)
    out["particles/orientation"] = np.asarray(
        chunks["particles/orientation"], np.float32
    )
    if "particles/angmom" in chunks:
        out["particles/angmom"] = np.asarray(chunks["particles/angmom"], np.float32)
        out["particles/moment_inertia"] = np.asarray(
            chunks["particles/moment_inertia"], np.float32
        )
    group = np.asarray(chunks.get("bonds/group", np.zeros((0, 2), np.int32)))
    out["bonds/N"] = np.asarray([group.shape[0]], np.uint32)
    if group.shape[0]:
        out["bonds/group"] = group.astype(np.uint32)
        out["bonds/typeid"] = np.asarray(chunks["bonds/typeid"], np.uint32)
    bt = _decode_types(chunks.get("bonds/types", np.zeros(0, np.uint8)))
    if bt:
        out["bonds/types"] = _encode_typenames(bt)
    return out


def _decode_typenames(arr) -> list[str]:
    """Inverse of _encode_typenames: int8 [K, width] rows -> names."""
    out = []
    for row in np.asarray(arr).astype(np.uint8):
        out.append(bytes(row.tobytes()).split(b"\x00")[0].decode())
    return out


def _read_gsd_frame(gsd_path: str, frame: int = -1):
    """Load one hoomd-schema GSD frame -> (Snapshot, timestep).

    Dynamic frames fall back to frame 0 for chunks they omit (the
    hoomd.write.GSD convention); chunks absent from both frames keep the
    Snapshot's hoomd-schema defaults (mass/diameter 1, identity
    orientation, ...).
    """
    from ..core.snapshot import Snapshot

    with GSDReader(gsd_path) as r:
        if r.schema != "hoomd":
            raise OSError(f"GSD schema {r.schema!r} is not 'hoomd'")
        nf = r.n_frames
        if nf == 0:
            raise OSError("GSD file has no frames")
        if frame < 0:
            frame += nf
        if not 0 <= frame < nf:
            raise IndexError(f"frame {frame} out of range (0..{nf - 1})")
        names0 = set(r.chunks(0))
        namesf = set(r.chunks(frame))

        def chunk(name):
            if name in namesf:
                return r.read_chunk(frame, name)
            if name in names0:
                return r.read_chunk(0, name)
            return None

        n_arr = chunk("particles/N")
        N = int(n_arr[0]) if n_arr is not None else 0
        group = chunk("bonds/group")
        bond_N = 0 if group is None else int(np.asarray(group).shape[0])
        snap = Snapshot(N=N, bond_N=bond_N)
        box = chunk("configuration/box")
        if box is not None:
            snap.configuration.box = [
                float(v) for v in np.asarray(box, np.float64).reshape(-1)[:6]
            ]
        types = chunk("particles/types")
        snap.particles.types = (
            _decode_typenames(types) if types is not None else ["A"]
        )
        for field, name in (
            ("position", "particles/position"),
            ("velocity", "particles/velocity"),
            ("image", "particles/image"),
            ("typeid", "particles/typeid"),
            ("mass", "particles/mass"),
            ("charge", "particles/charge"),
            ("diameter", "particles/diameter"),
            ("orientation", "particles/orientation"),
            ("angmom", "particles/angmom"),
            ("moment_inertia", "particles/moment_inertia"),
            ("body", "particles/body"),
        ):
            a = chunk(name)
            if a is not None:
                tgt = getattr(snap.particles, field)
                tgt[:] = np.asarray(a).reshape(tgt.shape)
        if bond_N:
            snap.bonds.group[:] = np.asarray(group).reshape(bond_N, 2)
            tid = chunk("bonds/typeid")
            if tid is not None:
                snap.bonds.typeid[:] = np.asarray(tid).reshape(bond_N)
        bt = chunk("bonds/types")
        if bt is not None:
            snap.bonds.types = _decode_typenames(bt)
        step = chunk("configuration/step")
        return snap, (int(step[0]) if step is not None else 0)


def read_gsd(gsd_path: str, frame: int = -1):
    """Load a hoomd-schema GSD frame into a Snapshot.

    The migration entry point for azplugins users bringing existing GSD
    configurations: reads files written by HOOMD's gsd package or by
    export_gsd (HOOMD's ecosystem checkpoints through GSD). ``frame`` may
    be negative (from the end); dynamic frames fall back to frame 0, the
    hoomd.write.GSD convention. See also Simulation.create_state_from_gsd, which also
    restores the timestep.
    """
    snap, _ = _read_gsd_frame(gsd_path, frame)
    return snap


def export_gsd(aztraj_path: str, gsd_path: str) -> int:
    """Convert an aztraj trajectory to a GSD (hoomd schema) file.

    Frame 0 is written complete; later frames carry the chunks the source
    frame carried (dynamic-only aztraj frames stay dynamic-only — GSD
    readers fall back to frame 0). Returns the number of frames written.
    """
    from .aztraj import TrajectoryReader

    with TrajectoryReader(aztraj_path) as r, GSDWriter(gsd_path) as w:
        for i in range(len(r)):
            ts, chunks = r.read_frame(i)
            complete = "particles/typeid" in chunks
            if i == 0 and not complete:
                raise OSError(
                    "aztraj frame 0 is not complete; cannot seed the GSD file"
                )
            for name, data in _hoomd_frame_chunks(ts, chunks, complete).items():
                w.write_chunk(name, data)
            w.end_frame()
        n = len(r)
    return n
