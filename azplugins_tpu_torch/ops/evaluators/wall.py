"""Wall potential evaluators (distance-to-wall forms).

Port of ``azplugins_tpu/ops/evaluators/wall.py``:
  * LJ 9-3 integrated point/half-space wall, lj1 = (2/15) eps sigma^9,
    lj2 = eps sigma^3;
  * Colloid (sphere/half-space integrated LJ), C1 = A sigma^6 / 7560,
    C2 = A / 6; needs the particle radius a = d/2.

Protocol: ``(rsq, rcutsq, params, diameter) -> (energy, force_div_r)``
where r is the distance to the wall surface, in the reference's float32
operation order (``r3inv = r2inv * sqrt(r2inv)``). The wall force
(``external._WallPotential``) masks r >= rcut and applies the force
along the wall normal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ...utils import sqrt

__all__ = ["WallPotentialDef", "WALL_POTENTIALS", "lj93", "colloid_wall"]


@dataclasses.dataclass(frozen=True)
class WallPotentialDef:
    name: str
    spec: dict
    precompute: Callable[[dict], dict]
    energy_force: Callable  # (rsq, rcutsq, params, diameter) -> (e, f_div_r)


def _lj93_precompute(t: dict) -> dict:
    sigma_3 = t["sigma"] ** 3
    return {
        "lj1": (2.0 / 15.0) * t["epsilon"] * sigma_3**3,
        "lj2": t["epsilon"] * sigma_3,
    }


def lj93(rsq, rcutsq, p, diameter=None):
    r2inv = 1.0 / rsq
    r3inv = r2inv * sqrt(r2inv)
    r6inv = r3inv * r3inv
    f = r2inv * r3inv * (9.0 * p["lj1"] * r6inv - 3.0 * p["lj2"])
    e = r3inv * (p["lj1"] * r6inv - p["lj2"])
    active = p["lj1"] != 0
    return torch.where(active, e, 0.0), torch.where(active, f, 0.0)


def _colloid_wall_precompute(t: dict) -> dict:
    sigma_6 = t["sigma"] ** 6
    return {"C1": t["A"] * sigma_6 / 7560.0, "C2": t["A"] / 6.0}


def colloid_wall(rsq, rcutsq, p, diameter):
    a = 0.5 * diameter
    r = sqrt(rsq)
    arinv = a / r
    rma = r - a
    rma = torch.where(rma == 0, 1e-20, rma)
    rma_inv = 1.0 / rma
    rpa_inv = 1.0 / (r + a)
    r2ma2_inv = rma_inv * rpa_inv
    rma_inv2 = rma_inv * rma_inv
    rma_inv6 = rma_inv2 * rma_inv2 * rma_inv2
    rpa_inv2 = rpa_inv * rpa_inv
    rpa_inv6 = rpa_inv2 * rpa_inv2 * rpa_inv2

    arinv8 = 8.0 * arinv
    f = 6.0 * p["C1"] * (
        (arinv8 - 1.0) * rma_inv2 * rma_inv6 + (arinv8 + 1.0) * rpa_inv2 * rpa_inv6
    )
    f = f - p["C2"] * (4.0 * a * a * arinv * r2ma2_inv * r2ma2_inv)

    a7 = 7.0 * a
    e = p["C1"] * ((a7 - r) * rma_inv * rma_inv6 + (a7 + r) * rpa_inv * rpa_inv6)
    ratio = rpa_inv / rma_inv  # = (r-a)/(r+a)
    ratio = torch.where(ratio > 0, ratio, 1.0)
    e = e - p["C2"] * (2.0 * a * r * r2ma2_inv + torch.log(ratio))

    active = (p["C2"] != 0) & (a > 0)
    return torch.where(active, e, 0.0), torch.where(active, f, 0.0)


WALL_POTENTIALS = {
    "LJ93": WallPotentialDef(
        name="LJ93",
        spec={"epsilon": float, "sigma": float},
        precompute=_lj93_precompute,
        energy_force=lj93,
    ),
    "Colloid": WallPotentialDef(
        name="Colloid",
        spec={"A": float, "sigma": float},
        precompute=_colloid_wall_precompute,
        energy_force=colloid_wall,
    ),
}
