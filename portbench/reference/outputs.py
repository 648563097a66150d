"""The writers' files read back, independent of the program: the last row
of a ``Table`` and the last frame of a GSD file (GSD 2.0's published file
layout: a 256-byte header, an index of 32-byte entries, a namelist of
null-terminated names in 64-byte segments)."""

from __future__ import annotations

import struct

import numpy as np

_HEADER = struct.Struct("<QQQQQII64s64s80s")
_ENTRY = struct.Struct("<QQqIHBB")
_MAGIC = 0x65DF65DF65DF65DF
_TYPES = {1: "<u1", 2: "<u2", 3: "<u4", 4: "<u8", 5: "<i1", 6: "<i2", 7: "<i4", 8: "<i8",
          9: "<f4", 10: "<f8"}


def table_last_row(path: str) -> dict:
    """The last row of a whitespace-delimited table with a header line, as
    ``{column: float}``."""
    with open(path) as fh:
        lines = [ln.split() for ln in fh if ln.strip()]
    head, last = lines[0], lines[-1]
    return {k: float(v) for k, v in zip(head, last)}


def gsd_last(path: str, names: tuple[str, ...]) -> dict:
    """The newest value of each chunk in ``names`` in a GSD file, and under
    ``"frame"`` the newest frame holding the first of them."""
    with open(path, "rb") as fh:
        raw = fh.read()
    magic, index_loc, index_n, name_loc, name_segs, *_ = _HEADER.unpack_from(raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path} is not a GSD file")
    ids = raw[name_loc:name_loc + 64 * name_segs].split(b"\0")
    ids = [n.decode() for n in ids if n]
    out: dict = {}
    newest: dict = {}
    for k in range(index_n):
        frame, N, loc, M, nid, typ, _ = _ENTRY.unpack_from(raw, index_loc + k * _ENTRY.size)
        if loc == 0 or nid >= len(ids) or ids[nid] not in names:
            continue
        if frame >= newest.get(ids[nid], -1):
            newest[ids[nid]] = frame
            count = N * M
            arr = np.frombuffer(raw, dtype=_TYPES[typ], count=count, offset=loc).copy()
            out[ids[nid]] = arr.reshape(N, M) if M > 1 else arr
    out["frame"] = newest.get(names[0])
    return out
