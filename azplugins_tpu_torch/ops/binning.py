"""Binning for the velocity-field computes.

Port of ``azplugins_tpu/ops/binning.py``: particles map to a flat bin id
(:func:`bin_ids`) and their mass and momentum are summed per bin, each
bin's particles added in ascending row order from +0.0, as the
reference's ``.at[idx].add`` is deterministic: ``index_add_`` on the CPU,
which adds in that order there, and on CUDA the MPCD collision's cell-sum
kernel (K10, ``ops/cellsum_kernel.py``), whose mass and momentum columns
are these sums in that order (CUDA's ``index_add_`` would add with atomics
in an order that varies from call to call).

  * Cartesian: bins (x, y, z); the velocity passes through.
  * Cylindrical: bins (r, theta, z) with theta wrapped to [0, 2 pi); the
    velocity rotated to (v_r, v_theta, v_z), in the x basis at r = 0.

Axes with ``num_bins == 0`` are ignored for binning (size 1 in the flat
grid) and collapsed in the user-facing compact shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rng import _on_card
from ..utils import sqrt
from . import cellsum_kernel

__all__ = ["cartesian_coords", "cylindrical_coords", "bin_ids", "bin_particles"]


def cartesian_coords(position, velocity):
    return position, velocity


def cylindrical_coords(position, velocity):
    x, y, z = position[..., 0], position[..., 1], position[..., 2]
    r = sqrt(x * x + y * y)
    theta = torch.atan2(y, x)
    theta = torch.where(theta < 0, theta + 2.0 * math.pi, theta)
    coords = torch.stack([r, theta, z], dim=-1)
    # rotate the velocity into (v_r, v_theta, v_z); at r = 0 use the x basis
    has_r = r > 0
    r_safe = torch.where(has_r, r, 1.0)
    c = torch.where(has_r, x / r_safe, 1.0)
    s = torch.where(has_r, y / r_safe, 0.0)
    vx, vy, vz = velocity[..., 0], velocity[..., 1], velocity[..., 2]
    vel = torch.stack([c * vx + s * vy, -s * vx + c * vy, vz], dim=-1)
    return coords, vel


def bin_ids(coords, select, num_bins, lower, upper) -> tuple:
    """``(idx, B)``: each particle's flat bin id (int64 ``[N]``) over the
    bin grid of B = prod(max(bins, 1)) bins; a particle not selected or
    outside the bounds takes the dump id B. Arguments as
    :func:`bin_particles`'s."""
    sizes = tuple(max(int(b), 1) for b in num_bins)
    total = sizes[0] * sizes[1] * sizes[2]
    idx = torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
    ok = select
    for ax in range(3):
        nb = int(num_bins[ax])
        idx = idx * sizes[ax]
        if nb == 0:
            continue
        lo, hi = np.float32(lower[ax]), np.float32(upper[ax])
        x = coords[:, ax]
        b = torch.floor((x - float(lo)) / float(hi - lo) * nb).to(torch.int32)
        ok = ok & (x >= float(lo)) & (b >= 0) & (b < nb)
        idx = idx + torch.clamp(b, 0, nb - 1)
    return torch.where(ok, idx, total), total


def bin_particles(coords, velocity, mass, select, num_bins, lower, upper):
    """Histogram mass and momentum over the flattened bin grid.

    Args:
        coords: ``[N, 3]`` binning coordinates.
        velocity: ``[N, 3]`` velocity in the output basis.
        mass: ``[N]``.
        select: ``[N]`` bool, the particles to include.
        num_bins: 3-tuple; 0 disables an axis (treated as size 1).
        lower/upper: 3-tuples of bounds (ignored for disabled axes).

    Returns:
        ``(mass_grid [B], momentum_grid [B, 3])`` with B = prod(max(bins, 1)),
        each bin's particles added in ascending row order: ``index_add_``
        on a CPU tensor, K10's mass and momentum columns on a CUDA one.
    """
    idx, total = bin_ids(coords, select, num_bins, lower, upper)
    if _on_card(coords.device):
        sums = cellsum_kernel.cell_sums(idx, velocity.to(torch.float32).contiguous(),
                                        mass.to(torch.float32).contiguous(), total)
        return sums[:, 1], sums[:, 2:5]
    ok = idx < total
    m = torch.where(ok, mass, 0.0)
    mom = torch.where(ok[:, None], velocity * mass[:, None], 0.0)
    mass_grid = torch.zeros(total + 1, dtype=torch.float32, device=coords.device)
    mom_grid = torch.zeros((total + 1, 3), dtype=torch.float32, device=coords.device)
    return mass_grid.index_add_(0, idx, m)[:total], mom_grid.index_add_(0, idx, mom)[:total]
