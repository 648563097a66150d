"""aztraj container: chunked, CRC-checked binary trajectory format.

A copy of ``azplugins_tpu/io/aztraj.py`` (numpy, struct, zlib, ctypes):
the two packages write the same bytes. Two interchangeable backends
write/read them:

* the native C++ engine (``_native/aztraj.cpp``) via ctypes — default;
* a pure-numpy fallback (no compiler required; forced by setting
  ``AZPLUGINS_TPU_PURE_PYTHON_IO``, the reference's switch).

Format (version 1, little-endian) — see the C++ source for the layout.
HOOMD's ecosystem uses GSD for this role (``io/gsd.py`` writes it); aztraj
is an original format, not GSD byte-compatible.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

__all__ = ["TrajectoryWriter", "TrajectoryReader", "native_available"]

_FILE_MAGIC = 0x4A545A41  # "AZTJ"
_FRAME_MAGIC = 0x4D415246  # "FRAM"
_VERSION = 1

_DTYPES = {
    0: np.dtype("<f4"),
    1: np.dtype("<f8"),
    2: np.dtype("<i4"),
    3: np.dtype("<i8"),
    4: np.dtype("<u4"),
    5: np.dtype("<u1"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

_lib = None
_lib_tried = False


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("AZPLUGINS_TPU_PURE_PYTHON_IO"):
        return None
    from .._native import build_library

    path = build_library("aztraj")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.azt_open_write.restype = ctypes.c_void_p
    lib.azt_open_write.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.azt_write_frame.restype = ctypes.c_int
    lib.azt_write_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.azt_flush.restype = ctypes.c_int
    lib.azt_flush.argtypes = [ctypes.c_void_p]
    lib.azt_close_write.restype = ctypes.c_int
    lib.azt_close_write.argtypes = [ctypes.c_void_p]
    lib.azt_open_read.restype = ctypes.c_void_p
    lib.azt_open_read.argtypes = [ctypes.c_char_p]
    lib.azt_n_frames.restype = ctypes.c_int64
    lib.azt_n_frames.argtypes = [ctypes.c_void_p]
    lib.azt_frame_timestep.restype = ctypes.c_int64
    lib.azt_frame_timestep.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.azt_frame_info.restype = ctypes.c_int
    lib.azt_frame_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.azt_read_chunk.restype = ctypes.c_int
    lib.azt_read_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.azt_close_read.restype = ctypes.c_int
    lib.azt_close_read.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def _as_chunk(arr) -> np.ndarray:
    a = np.ascontiguousarray(arr)
    if a.dtype == np.float32:
        a = a.astype("<f4", copy=False)
    if a.dtype not in _DTYPE_CODES:
        for np_dt in (np.float32, np.float64, np.int32, np.int64):
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype("<f4" if a.dtype.itemsize <= 4 else "<f8")
                break
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype("<i4" if a.dtype.itemsize <= 4 else "<i8")
                break
        if a.dtype == np.bool_:
            a = a.astype("<u1")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {arr.dtype}")
    return a


class TrajectoryWriter:
    """Append frames of named arrays to an aztraj file."""

    def __init__(self, path: str, mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError("mode must be 'w' or 'a'")
        self._path = str(path)
        self._lib = _load_native()
        self._closed = False
        if self._lib is not None:
            self._h = self._lib.azt_open_write(
                self._path.encode(), 1 if mode == "a" else 0
            )
            if not self._h:
                raise OSError(f"cannot open {path}")
        else:
            self._index = []
            if mode == "a" and os.path.exists(self._path):
                r = TrajectoryReader(self._path)
                self._index = [(off, ts) for off, ts in r._index]
                end = r._index_offset
                r.close()
                self._f = open(self._path, "r+b")
                self._f.seek(end)
            else:
                self._f = open(self._path, "w+b")
                self._write_header_py(0, 0)

    # -- pure-python backend helpers --
    def _write_header_py(self, index_offset, n_frames):
        head = struct.pack("<IIQQ", _FILE_MAGIC, _VERSION, index_offset, n_frames)
        crc = zlib.crc32(head) & 0xFFFFFFFF
        self._f.seek(0)
        self._f.write(head + struct.pack("<I", crc) + b"\x00" * 4)

    def write_frame(self, timestep: int, chunks: dict):
        if self._closed:
            raise RuntimeError("writer closed")
        items = [(str(k), _as_chunk(v)) for k, v in chunks.items()]
        if self._lib is not None:
            n = len(items)
            names = (ctypes.c_char_p * n)(*[k.encode() for k, _ in items])
            dtypes = (ctypes.c_uint8 * n)(*[_DTYPE_CODES[a.dtype] for _, a in items])
            ndims = (ctypes.c_uint8 * n)(*[a.ndim for _, a in items])
            flat_shapes = []
            for _, a in items:
                flat_shapes.extend(a.shape)
            shapes = (ctypes.c_uint64 * len(flat_shapes))(*flat_shapes)
            data = (ctypes.c_void_p * n)(
                *[a.ctypes.data_as(ctypes.c_void_p).value for _, a in items]
            )
            nbytes = (ctypes.c_uint64 * n)(*[a.nbytes for _, a in items])
            rc = self._lib.azt_write_frame(
                self._h, int(timestep), n, names, dtypes, ndims, shapes, data, nbytes
            )
            if rc != 0:
                raise OSError(f"aztraj write failed ({rc})")
            return
        # pure-python path
        pos = self._f.tell()
        self._index.append((pos, int(timestep)))
        self._f.write(struct.pack("<IQI", _FRAME_MAGIC, int(timestep), len(items)))
        for name, a in items:
            nb = name.encode()
            self._f.write(struct.pack("<H", len(nb)) + nb)
            self._f.write(struct.pack("<BB", _DTYPE_CODES[a.dtype], a.ndim))
            for s in a.shape:
                self._f.write(struct.pack("<Q", s))
            raw = a.tobytes()
            self._f.write(struct.pack("<Q", len(raw)))
            self._f.write(raw)
            self._f.write(struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF))

    def flush(self):
        if self._closed:
            return
        if self._lib is not None:
            rc = self._lib.azt_flush(self._h)
            if rc != 0:
                raise OSError(f"aztraj flush failed ({rc})")
            return
        pos = self._f.tell()
        raw = b"".join(struct.pack("<QQ", off, ts) for off, ts in self._index)
        self._f.write(raw)
        self._f.write(struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF))
        self._write_header_py(pos, len(self._index))
        self._f.seek(pos)
        self._f.flush()

    def close(self):
        if self._closed:
            return
        if self._lib is not None:
            self._lib.azt_close_write(self._h)
        else:
            self.flush()
            self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrajectoryReader:
    """Random access to frames of an aztraj file."""

    def __init__(self, path: str):
        self._path = str(path)
        self._lib = _load_native()
        self._closed = False
        if self._lib is not None:
            self._h = self._lib.azt_open_read(self._path.encode())
            if not self._h:
                raise OSError(f"cannot open {path} (missing or corrupt)")
            n = self._lib.azt_n_frames(self._h)
            self._timesteps = [
                int(self._lib.azt_frame_timestep(self._h, i)) for i in range(n)
            ]
        else:
            self._f = open(self._path, "rb")
            head = self._f.read(32)
            magic, version, index_offset, n_frames = struct.unpack("<IIQQ", head[:24])
            (crc_stored,) = struct.unpack("<I", head[24:28])
            if magic != _FILE_MAGIC or version != _VERSION:
                raise OSError("not an aztraj file")
            if zlib.crc32(head[:24]) & 0xFFFFFFFF != crc_stored:
                raise OSError("corrupt header")
            self._index_offset = index_offset
            self._f.seek(index_offset)
            raw = self._f.read(16 * n_frames)
            (crc_stored,) = struct.unpack("<I", self._f.read(4))
            if zlib.crc32(raw) & 0xFFFFFFFF != crc_stored:
                raise OSError("corrupt index")
            self._index = [
                struct.unpack_from("<QQ", raw, 16 * i) for i in range(n_frames)
            ]
            self._timesteps = [ts for _, ts in self._index]

    def __len__(self):
        return len(self._timesteps)

    @property
    def timesteps(self):
        return list(self._timesteps)

    def read_frame(self, i: int) -> tuple[int, dict]:
        """Return (timestep, {name: array}) for frame i."""
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        if self._lib is not None:
            return self._read_frame_native(i)
        return self._read_frame_py(i)

    def _read_frame_native(self, i):
        buf = ctypes.create_string_buffer(65536)
        max_chunks = 256
        dtypes = (ctypes.c_uint8 * max_chunks)()
        ndims = (ctypes.c_uint8 * max_chunks)()
        shapes = (ctypes.c_uint64 * (max_chunks * 8))()
        nbytes = (ctypes.c_uint64 * max_chunks)()
        nc = self._lib.azt_frame_info(
            self._h, i, buf, len(buf), dtypes, ndims, shapes, nbytes
        )
        if nc < 0:
            raise OSError(f"aztraj frame info failed ({nc})")
        names = buf.raw.split(b"\x00")[:nc]
        out = {}
        spos = 0
        for c in range(nc):
            shape = tuple(int(shapes[spos + d]) for d in range(ndims[c]))
            spos += ndims[c]
            a = np.empty(int(nbytes[c]) // _DTYPES[dtypes[c]].itemsize,
                         dtype=_DTYPES[dtypes[c]])
            rc = self._lib.azt_read_chunk(
                self._h, i, c, a.ctypes.data_as(ctypes.c_void_p)
            )
            if rc != 0:
                raise OSError(f"aztraj chunk read failed ({rc})")
            out[names[c].decode()] = a.reshape(shape)
        return int(self._timesteps[i]), out

    def _read_frame_py(self, i):
        off, ts = self._index[i]
        f = self._f
        f.seek(off)
        magic, timestep, nc = struct.unpack("<IQI", f.read(16))
        if magic != _FRAME_MAGIC:
            raise OSError("corrupt frame")
        out = {}
        for _ in range(nc):
            (nl,) = struct.unpack("<H", f.read(2))
            name = f.read(nl).decode()
            dt, nd = struct.unpack("<BB", f.read(2))
            shape = struct.unpack(f"<{nd}Q", f.read(8 * nd)) if nd else ()
            (nb,) = struct.unpack("<Q", f.read(8))
            raw = f.read(nb)
            (crc_stored,) = struct.unpack("<I", f.read(4))
            if zlib.crc32(raw) & 0xFFFFFFFF != crc_stored:
                raise OSError(f"corrupt chunk {name}")
            out[name] = np.frombuffer(raw, dtype=_DTYPES[dt]).reshape(shape)
        return int(ts), out

    def close(self):
        if self._closed:
            return
        if self._lib is not None:
            self._lib.azt_close_read(self._h)
        else:
            self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
