"""IO: trajectory files and checkpoint/restart.

A copy of ``azplugins_tpu/io/__init__.py`` on the port's
``core/snapshot.py`` (its ``mpcd`` block included): a file written by
either package reads back in the other. azplugins delegates this
subsystem to HOOMD's GSD machinery; here it is first-class: the aztraj
container (native C++ engine, pure-python fallback) stores frames of named
arrays; snapshots map to/from frames; a checkpoint is a one-frame
trajectory carrying the full restart payload (positions, velocities,
images, types, bonds, box, the MPCD solvent, timestep). RNG needs no
state — streams are counter-based on (seed, timestep, tags) so a restart
resumes bitwise-identically.
"""

from __future__ import annotations

import numpy as np

from ..core.snapshot import Snapshot
from .aztraj import TrajectoryReader, TrajectoryWriter, native_available

__all__ = [
    "TrajectoryWriter",
    "TrajectoryReader",
    "native_available",
    "snapshot_to_chunks",
    "chunks_to_snapshot",
    "save_checkpoint",
    "load_checkpoint",
    "export_gsd",
    "read_gsd",
    "GSDReader",
    "GSDWriter",
]


def __getattr__(name):  # lazy: keep gsd.py off the hot import path
    if name in ("export_gsd", "read_gsd", "GSDReader", "GSDWriter"):
        from . import gsd as _gsd

        return getattr(_gsd, name)
    raise AttributeError(name)


def snapshot_to_chunks(snapshot: Snapshot, dynamic_only: bool = False) -> dict:
    """Flatten a Snapshot into named arrays for an aztraj frame.

    ``dynamic_only`` writes just the per-step quantities (positions,
    velocities, images) for compact trajectories; the first frame of a file
    should always be written complete.
    """
    p = snapshot.particles
    chunks = {
        "particles/position": np.asarray(p.position, np.float32),
        "particles/velocity": np.asarray(p.velocity, np.float32),
        "particles/image": np.asarray(p.image, np.int32),
        "configuration/box": np.asarray(snapshot.configuration.box, np.float32),
    }
    if not dynamic_only:
        chunks.update(
            {
                "particles/typeid": np.asarray(p.typeid, np.int32),
                "particles/orientation": np.asarray(p.orientation, np.float32),
                "particles/mass": np.asarray(p.mass, np.float32),
                "particles/diameter": np.asarray(p.diameter, np.float32),
                "particles/charge": np.asarray(p.charge, np.float32),
                "particles/angmom": np.asarray(p.angmom, np.float32),
                "particles/moment_inertia": np.asarray(p.moment_inertia, np.float32),
                "particles/types": _encode_types(p.types),
                "bonds/typeid": np.asarray(snapshot.bonds.typeid, np.int32),
                "bonds/group": np.asarray(snapshot.bonds.group, np.int32),
                "bonds/types": _encode_types(snapshot.bonds.types),
            }
        )
        mpcd = getattr(snapshot, "mpcd", None)
        if mpcd is not None and mpcd.N > 0:
            chunks.update(
                {
                    "mpcd/position": np.asarray(mpcd.position, np.float32),
                    "mpcd/velocity": np.asarray(mpcd.velocity, np.float32),
                    "mpcd/typeid": np.asarray(mpcd.typeid, np.int32),
                    "mpcd/mass": np.asarray([mpcd.mass], np.float32),
                    "mpcd/types": _encode_types(mpcd.types),
                }
            )
    return chunks


def _encode_types(types: list[str]) -> np.ndarray:
    raw = "\x00".join(types).encode()
    return np.frombuffer(raw, dtype=np.uint8).copy()


def _decode_types(arr: np.ndarray) -> list[str]:
    raw = bytes(np.asarray(arr, np.uint8).tobytes())
    return raw.decode().split("\x00") if raw else []


def chunks_to_snapshot(chunks: dict, template: Snapshot | None = None) -> Snapshot:
    """Rebuild a Snapshot from frame chunks (static fields may come from an
    earlier complete frame passed as ``template``)."""
    pos = chunks["particles/position"]
    N = pos.shape[0]
    snap = Snapshot(N=N)
    if template is not None:
        t = snapshot_to_chunks(template)
        t.update(chunks)
        chunks = t
    snap.configuration.box = [float(v) for v in chunks["configuration/box"]]
    p = snap.particles
    p.position[:] = chunks["particles/position"]
    p.velocity[:] = chunks["particles/velocity"]
    p.image[:] = chunks["particles/image"]
    if "particles/typeid" in chunks:
        p.typeid[:] = chunks["particles/typeid"]
        p.orientation[:] = chunks["particles/orientation"]
        p.mass[:] = chunks["particles/mass"]
        p.diameter[:] = chunks["particles/diameter"]
        p.charge[:] = chunks["particles/charge"]
        if "particles/angmom" in chunks:  # absent in pre-rotation files
            p.angmom[:] = chunks["particles/angmom"]
            p.moment_inertia[:] = chunks["particles/moment_inertia"]
        p.types = _decode_types(chunks["particles/types"])
        bonds = chunks.get("bonds/group")
        if bonds is not None and len(bonds):
            snap.bonds.resize(len(bonds))
            snap.bonds.group[:] = bonds
            snap.bonds.typeid[:] = chunks["bonds/typeid"]
        snap.bonds.types = _decode_types(chunks.get("bonds/types", np.zeros(0)))
        if "mpcd/position" in chunks:
            snap.mpcd.resize(chunks["mpcd/position"].shape[0])
            snap.mpcd.position[:] = chunks["mpcd/position"]
            snap.mpcd.velocity[:] = chunks["mpcd/velocity"]
            snap.mpcd.typeid[:] = chunks["mpcd/typeid"]
            snap.mpcd.mass = float(chunks["mpcd/mass"][0])
            snap.mpcd.types = _decode_types(chunks["mpcd/types"])
    return snap


def save_checkpoint(sim, path: str):
    """Write the full restart payload of a Simulation to ``path``."""
    snap = sim.state.get_snapshot()
    with TrajectoryWriter(path, mode="w") as w:
        w.write_frame(sim.timestep, snapshot_to_chunks(snap))


def load_checkpoint(path: str) -> tuple[Snapshot, int]:
    """Read (snapshot, timestep) from a checkpoint file.

    Restore by creating the Simulation from the snapshot and setting
    ``sim.timestep``; counter-based RNG then continues bitwise-identically.
    """
    with TrajectoryReader(path) as r:
        ts, chunks = r.read_frame(len(r) - 1)
    return chunks_to_snapshot(chunks), int(ts)
