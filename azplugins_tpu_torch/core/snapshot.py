"""Host-side snapshot: the mutable staging area for building/inspecting state.

Mirrors the role of ``hoomd.Snapshot`` consumed by the reference tests
(reference ``src/pytest/test_compute.py:318-346``): numpy arrays the user
fills in, converted to a ``State`` of tensors on the simulation's device by
``Simulation.create_state_from_snapshot``. Numpy only: a verbatim port of
``azplugins_tpu/core/snapshot.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Snapshot", "ParticleData", "BondData", "MPCDData", "Configuration"]


class Configuration:
    def __init__(self):
        # [Lx, Ly, Lz, xy, xz, yz] like hoomd
        self.box = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0]


class ParticleData:
    def __init__(self, N: int = 0):
        self.N = 0
        self.types: list[str] = []
        self.resize(N)

    def resize(self, N: int):
        old = self.N
        self.N = int(N)

        def grow(name, shape, dtype, fill=0):
            arr = np.zeros((N, *shape), dtype=dtype)
            if fill != 0:
                arr[:] = fill
            if old and hasattr(self, name):
                keep = min(old, N)
                arr[:keep] = getattr(self, name)[:keep]
            setattr(self, name, arr)

        grow("position", (3,), np.float64)
        grow("velocity", (3,), np.float64)
        grow("typeid", (), np.int32)
        grow("image", (3,), np.int32)
        grow("orientation", (4,), np.float64)
        self.orientation[:, 0] = 1.0
        grow("mass", (), np.float64, fill=1.0)
        self.mass[:] = np.where(self.mass[:] == 0, 1.0, self.mass[:])
        grow("diameter", (), np.float64, fill=1.0)
        self.diameter[:] = np.where(self.diameter[:] == 0, 1.0, self.diameter[:])
        grow("charge", (), np.float64)
        grow("body", (), np.int32, fill=-1)
        grow("angmom", (4,), np.float64)
        grow("moment_inertia", (3,), np.float64)


class BondData:
    def __init__(self, N: int = 0):
        self.N = 0
        self.types: list[str] = []
        self.resize(N)

    def resize(self, N: int):
        old = self.N
        self.N = int(N)
        typeid = np.zeros((N,), dtype=np.int32)
        group = np.zeros((N, 2), dtype=np.int32)
        if old:
            keep = min(old, N)
            typeid[:keep] = self.typeid[:keep]
            group[:keep] = self.group[:keep]
        self.typeid = typeid
        self.group = group


class MPCDData:
    """Mesoscale (MPCD) solvent particles: a second particle stream.

    Mirrors the MPCD snapshot block the reference's velocity computes read
    (reference ``src/ParticleDataLoader.h:24-125``,
    ``src/VelocityFieldCompute.h:331-352``). The engine
    stores and exposes this stream for the computes
    (``include_mpcd_particles=True``); MPCD streaming/collision dynamics
    are the host engine's job in the reference (HOOMD's mpcd package) and
    are likewise not integrated here.
    """

    def __init__(self, N: int = 0):
        self.N = 0
        self.types: list[str] = ["A"]
        self.mass = 1.0  # one mass for every MPCD particle (HOOMD MPCD)
        self.resize(N)

    def resize(self, N: int):
        old = self.N
        self.N = int(N)
        position = np.zeros((N, 3), dtype=np.float64)
        velocity = np.zeros((N, 3), dtype=np.float64)
        typeid = np.zeros((N,), dtype=np.int32)
        if old:
            keep = min(old, N)
            position[:keep] = self.position[:keep]
            velocity[:keep] = self.velocity[:keep]
            typeid[:keep] = self.typeid[:keep]
        self.position = position
        self.velocity = velocity
        self.typeid = typeid


class Snapshot:
    """A host-side description of the full system."""

    def __init__(self, N: int = 0, bond_N: int = 0, mpcd_N: int = 0):
        self.configuration = Configuration()
        self.particles = ParticleData(N)
        self.bonds = BondData(bond_N)
        self.mpcd = MPCDData(mpcd_N)

    @property
    def communicator(self):  # parity shim: snapshots are rank-global here
        return None

    def validate(self):
        p = self.particles
        if len(p.types) == 0 and p.N > 0:
            raise ValueError("snapshot.particles.types must name at least one type")
        if p.N > 0 and (p.typeid.min() < 0 or p.typeid.max() >= len(p.types)):
            raise ValueError("particle typeid out of range")
        b = self.bonds
        if b.N > 0:
            if len(b.types) == 0:
                raise ValueError("snapshot.bonds.types must name at least one type")
            if b.typeid.min() < 0 or b.typeid.max() >= len(b.types):
                raise ValueError("bond typeid out of range")
            if b.group.min() < 0 or b.group.max() >= p.N:
                raise ValueError("bond group index out of range")
