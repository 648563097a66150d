"""Harmonic barrier evaluators (one-sided harmonic restraints).

Port of ``azplugins_tpu/ops/evaluators/barrier.py``:
  * planar: pushes particles with y > H + offset back down;
  * spherical: pushes particles with r > R + offset inward.

Protocol: ``(pos, location, k, offset) -> (energy, force[..., 3])``
evaluated per particle, in the reference's float32 operation order;
``location`` is the variant's value at the current timestep: a Python
float that is an exact float32 value, or a 0-d float32 tensor on the
positions' device (a run's schedule), the same float32 add either way.
Each evaluator also provides a host-side ``valid(location, box)`` check.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ...utils import sqrt

__all__ = ["BarrierDef", "BARRIERS", "planar_barrier", "spherical_barrier"]


@dataclasses.dataclass(frozen=True)
class BarrierDef:
    name: str
    energy_force: Callable  # (pos, location, k, offset) -> (e, force)
    valid: Callable  # (location_value, box) -> bool (host-side)


def planar_barrier(pos, H, k, offset):
    dy = pos[..., 1] - (H + offset)
    on = dy > 0.0
    fy = torch.where(on, -k * dy, 0.0)
    e = torch.where(on, 0.5 * k * dy * dy, 0.0)
    zeros = torch.zeros_like(fy)
    return e, torch.stack([zeros, fy, zeros], dim=-1)


def _planar_valid(H, box) -> bool:
    return bool(-0.5 * box.L[1] <= H < 0.5 * box.L[1])


def spherical_barrier(pos, R, k, offset):
    r = sqrt(torch.sum(pos * pos, dim=-1))
    dr = r - (R + offset)
    on = dr > 0.0
    k_dr = k * dr
    r_safe = torch.where(r > 0, r, 1.0)
    force = torch.where(on[..., None], -(k_dr / r_safe)[..., None] * pos, 0.0)
    e = torch.where(on, 0.5 * k_dr * dr, 0.0)
    return e, force


def _spherical_valid(R, box) -> bool:
    return bool(R >= 0.0 and np.all(box.nearest_plane_distance() >= 2.0 * R))


BARRIERS = {
    "Planar": BarrierDef("Planar", planar_barrier, _planar_valid),
    "Spherical": BarrierDef("Spherical", spherical_barrier, _spherical_valid),
}
