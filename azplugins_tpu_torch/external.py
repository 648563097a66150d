"""External potentials: harmonic barriers and wall potentials.

Port of ``azplugins_tpu/external.py``.

  * ``PlanarHarmonicBarrier`` / ``SphericalHarmonicBarrier``: one-sided
    harmonic restraints with a time-dependent (variant) location; per-type
    ``k`` and ``offset`` params. The location is the variant's float32
    value at the step (``core/variant.py::value_at``): inside a run a 0-d
    tensor on the device from the run's schedule, on the eager loop and in
    a CUDA graph alike, a host float outside one; either way the evaluator
    makes the same float32 add ``R + offset``. No
    virial is computed (zeros, and a warning once per force, as in the
    reference plugin).
  * ``wall.LJ93`` / ``wall.Colloid``: integrated LJ wall potentials acting
    on the distance to plane, sphere or cylinder walls, with HOOMD's
    optional linear extrapolation below ``r_extrap``.

Both are per-particle forces: PyTorch ops on every device, the same in the
dense slot layout as in tag order. Empty slots (tag < 0) sit at far
sentinel positions; their positions are zeroed before any arithmetic and
their force and energy are exactly zero.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .core.typeparam import TypeParameter
from .core.variant import Variant, as_variant, value_at
from .md.force import Force
from .ops.evaluators import BARRIERS, WALL_POTENTIALS
from .ops.pair_force import ForceResult
from .utils import sqrt

__all__ = [
    "HarmonicBarrier",
    "PlanarHarmonicBarrier",
    "SphericalHarmonicBarrier",
    "wall",
]


def _f32_tables(host: dict) -> dict:
    return {k: np.asarray(v, dtype=np.float32) for k, v in host.items()}


def _on_device(tables: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in tables.items()}


def _masked(state):
    """(valid slots, wrapped positions with empty slots at the origin,
    typeid with empty slots at type 0 for the table lookups)."""
    valid = state.tag >= 0
    pos, _ = state.box.wrap(state.position, state.image)
    pos = torch.where(valid[:, None], pos, 0.0)
    typeid = torch.clamp_min(state.typeid, 0).to(torch.int64)
    return valid, pos, typeid


def _zero_virial(state):
    return torch.zeros((state.N, 6), dtype=torch.float32, device=state.device)


class HarmonicBarrier(Force):
    """Base: harmonic half-space barrier with variant location."""

    _barrier_name = ""

    def __init__(self, location):
        super().__init__()
        self.location: Variant = as_variant(location)
        self.params = TypeParameter("params", 1, {"k": float, "offset": float})
        self._def = BARRIERS[self._barrier_name]
        self._warned_virial = False

    def _build_tables(self, sim):
        self._tbl = {"params": _f32_tables(self.params.to_dict_tables(sim._particle_types))}
        # the barrier must stay inside the box over its whole range
        box = sim._synced_state().box
        for extreme in self.location.range():
            if math.isfinite(extreme) and not self._def.valid(extreme, box):
                raise ValueError(
                    f"{type(self).__name__}: location {extreme} is outside the global box"
                )
        if not self._warned_virial:
            warnings.warn(
                f"{type(self).__name__} does not compute the virial "
                "(matching reference behavior)",
                stacklevel=2,
            )
            self._warned_virial = True

    def _device_tables(self, device) -> dict:
        return {"params": _on_device(self._tbl["params"], device)}

    def _compute(self, state, timestep, tbl) -> ForceResult:
        loc = value_at(self.location, timestep, state.device)
        valid, pos, typeid = _masked(state)
        k = tbl["params"]["k"][typeid]
        offset = tbl["params"]["offset"][typeid]
        e, force = self._def.energy_force(pos, loc, k, offset)
        return ForceResult(
            force=torch.where(valid[:, None], force, 0.0),
            energy=torch.where(valid, e, 0.0),
            virial=_zero_virial(state),
        )


class PlanarHarmonicBarrier(HarmonicBarrier):
    """Pushes particles with y > H + offset back toward the plane."""

    _barrier_name = "Planar"


class SphericalHarmonicBarrier(HarmonicBarrier):
    """Pushes particles outside radius R + offset back inward."""

    _barrier_name = "Spherical"


# ---------------------------------------------------------------------------
# Wall potentials
# ---------------------------------------------------------------------------
class _Geometry:
    """Float32 constants of a wall, made once per device."""

    def _const(self, name: str, device) -> torch.Tensor:
        cache = self.__dict__.setdefault("_device_consts", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.tensor(getattr(self, name), dtype=torch.float32, device=device)
        return cache[key]


class _Plane(_Geometry):
    """An infinite plane wall: points with dot(r - origin, normal) > 0 feel it."""

    def __init__(self, origin, normal):
        self.origin = tuple(float(x) for x in origin)
        n = np.asarray(normal, dtype=np.float64)
        n = n / np.linalg.norm(n)
        self.normal = tuple(n)

    def __repr__(self):
        return f"wall.Plane(origin={self.origin}, normal={self.normal})"

    def distance(self, pos):
        origin = self._const("origin", pos.device)
        normal = self._const("normal", pos.device)
        d = torch.sum((pos - origin) * normal, dim=-1)
        return d, normal.expand_as(pos)


class _Sphere(_Geometry):
    """A spherical wall of given radius.

    ``inside=True`` confines particles to the interior (the potential acts
    on the gap between the particle and the surface from inside);
    ``inside=False`` keeps them outside.
    """

    def __init__(self, radius, origin=(0.0, 0.0, 0.0), inside=True):
        self.radius = float(radius)
        self.origin = tuple(float(x) for x in origin)
        self.inside = bool(inside)

    def __repr__(self):
        return f"wall.Sphere(radius={self.radius}, origin={self.origin}, inside={self.inside})"

    def distance(self, pos):
        rel = pos - self._const("origin", pos.device)
        rho = sqrt(torch.sum(rel * rel, dim=-1))
        rhat = rel / torch.clamp_min(rho, 1e-12)[:, None]
        if self.inside:
            return self.radius - rho, -rhat
        return rho - self.radius, rhat


class _Cylinder(_Geometry):
    """An infinite cylindrical wall around ``axis`` through ``origin``.

    Same inside/outside semantics as ``Sphere``; distances are measured
    radially from the axis.
    """

    def __init__(self, radius, origin=(0.0, 0.0, 0.0), axis=(0.0, 0.0, 1.0), inside=True):
        self.radius = float(radius)
        self.origin = tuple(float(x) for x in origin)
        a = np.asarray(axis, dtype=np.float64)
        a = a / np.linalg.norm(a)
        self.axis = tuple(a)
        self.inside = bool(inside)

    def __repr__(self):
        return (
            f"wall.Cylinder(radius={self.radius}, origin={self.origin}, "
            f"axis={self.axis}, inside={self.inside})"
        )

    def distance(self, pos):
        axis = self._const("axis", pos.device)
        rel = pos - self._const("origin", pos.device)
        rel_r = rel - torch.sum(rel * axis, dim=-1)[:, None] * axis
        rho = sqrt(torch.sum(rel_r * rel_r, dim=-1))
        rhat = rel_r / torch.clamp_min(rho, 1e-12)[:, None]
        if self.inside:
            return self.radius - rho, -rhat
        return rho - self.radius, rhat


_WALL_GEOMETRIES = (_Plane, _Sphere, _Cylinder)


class _WallPotential(Force):
    """LJ-style potential between particles and a list of walls.

    ``d`` is the signed distance to the wall surface (positive on the
    allowed side) and the force acts along the direction of increasing
    ``d``. Per-type ``r_extrap`` (default 0 = off) enables HOOMD's
    extrapolated mode: for ``d < r_extrap`` (penetrated particles too) the
    potential continues linearly,

        U(d) = U(r_extrap) + (r_extrap - d) * F(r_extrap),
        F(d) = F(r_extrap),

    which keeps forces finite through the wall and pushes violators back.
    Whether any type extrapolates is decided on the host from the tables,
    so the step carries no branch on device data.
    """

    _wall_name = ""

    def __init__(self, walls):
        super().__init__()
        self.walls = list(walls)
        for w in self.walls:
            if not isinstance(w, _WALL_GEOMETRIES):
                raise TypeError("walls must be wall.Plane/wall.Sphere/wall.Cylinder instances")
        self._def = WALL_POTENTIALS[self._wall_name]
        spec = dict(self._def.spec)
        spec["r_cut"] = float
        spec["r_extrap"] = 0.0
        self.params = TypeParameter("params", 1, spec)

    def _build_tables(self, sim):
        host = self.params.to_dict_tables(sim._particle_types)
        r_cut = host.pop("r_cut")
        r_extrap = host.pop("r_extrap")
        self._tbl = {
            "params": _f32_tables(self._def.precompute(host)),
            "r_cut": np.asarray(r_cut, dtype=np.float32),
            "r_extrap": np.asarray(r_extrap, dtype=np.float32),
        }

    def _device_tables(self, device) -> dict:
        return {
            "params": _on_device(self._tbl["params"], device),
            "r_cut": torch.as_tensor(self._tbl["r_cut"], device=device),
            "r_extrap": torch.as_tensor(self._tbl["r_extrap"], device=device),
            "extrap": bool(np.any(self._tbl["r_extrap"] > 0)),
        }

    def _compute(self, state, timestep, tbl) -> ForceResult:
        valid, pos, typeid = _masked(state)
        p = {k: v[typeid] for k, v in tbl["params"].items()}
        rcut = tbl["r_cut"][typeid]
        rcutsq = rcut * rcut
        r_ext = tbl["r_extrap"][typeid]
        extrap = r_ext > 0

        force = torch.zeros((state.N, 3), dtype=torch.float32, device=state.device)
        energy = torch.zeros((state.N,), dtype=torch.float32, device=state.device)
        for w in self.walls:
            d, dhat = w.distance(pos)
            rsq = d * d
            in_range = valid & (d > 0) & (rsq < rcutsq)
            rsq_safe = torch.where(in_range, rsq, 1.0)
            e, f_divr = self._def.energy_force(rsq_safe, rcutsq, p, state.diameter)
            fmag = torch.where(in_range, f_divr * d, 0.0)
            e = torch.where(in_range, e, 0.0)
            if tbl["extrap"]:
                # linear continuation below r_extrap
                ext_sq = r_ext * r_ext
                e_ext, f_divr_ext = self._def.energy_force(
                    torch.where(extrap, ext_sq, 1.0), rcutsq, p, state.diameter
                )
                f_ext = f_divr_ext * r_ext
                below = valid & extrap & (d < r_ext)
                fmag = torch.where(below, f_ext, fmag)
                e = torch.where(below, e_ext + (r_ext - d) * f_ext, e)
            force = force + fmag[:, None] * dhat
            energy = energy + e
        return ForceResult(force=force, energy=energy, virial=_zero_virial(state))


class _LJ93Wall(_WallPotential):
    """9-3 integrated LJ wall."""

    _wall_name = "LJ93"


class _ColloidWall(_WallPotential):
    """Integrated sphere/half-space LJ wall; reads the particle diameter."""

    _wall_name = "Colloid"
    _needs_diameter = True


class _WallNamespace:
    Plane = _Plane
    Sphere = _Sphere
    Cylinder = _Cylinder
    LJ93 = _LJ93Wall
    Colloid = _ColloidWall


wall = _WallNamespace()
