"""Bond potential evaluators as plain tensor functions.

Port of ``azplugins_tpu/ops/evaluators/bond.py``. Protocol:
``(rsq, params) -> (energy, force_div_r)``, elementwise over the bond
table; ops/dense.py::dense_bond_force scatters +/- f*dr to the two
endpoints. The reference computes bonds in XLA outside any Pallas kernel,
and so they stay PyTorch ops on every device here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ...utils import sqrt

__all__ = [
    "BondPotentialDef", "BOND_POTENTIALS", "double_well", "quartic", "harmonic", "fenewca",
]


@dataclasses.dataclass(frozen=True)
class BondPotentialDef:
    name: str
    spec: dict
    precompute: Callable[[dict], dict]
    energy_force: Callable  # (rsq, params) -> (energy, force_div_r)


# ---------------------------------------------------------------------------
# Double well: two minima at r_0 and 2 r_1 - r_0, barrier U_1 at r_1,
# optional tilt U_tilt (reference plugin: src/BondEvaluatorDoubleWell.h:96-113).
# ---------------------------------------------------------------------------
def _dw_precompute(t: dict) -> dict:
    return {"r_1": t["r_1"], "r_diff": t["r_1"] - t["r_0"], "U_1": t["U_1"],
            "U_tilt": t["U_tilt"]}


def double_well(rsq, p):
    r_diff = p["r_diff"]
    valid = r_diff != 0
    r_diff = torch.where(valid, r_diff, 1.0)
    r = sqrt(rsq)
    x = (p["r_1"] - r) / r_diff
    x2 = x * x
    y = 1.0 - x2
    y2 = y * y
    e = p["U_1"] * y2 + p["U_tilt"] * (1.0 - x - y2)
    f = (4.0 * x * y * (p["U_tilt"] - p["U_1"]) - p["U_tilt"]) / (r_diff * r)
    return torch.where(valid, e, 0.0), torch.where(valid, f, 0.0)


# ---------------------------------------------------------------------------
# Quartic scissile bond with optional WCA core and delta shift
# (reference plugin: src/BondEvaluatorQuartic.h:129-200).
# ---------------------------------------------------------------------------
def _quartic_precompute(t: dict) -> dict:
    sigma_6 = t["sigma"] ** 6
    eps4 = 4.0 * t["epsilon"]
    return {
        "k": t["k"], "r_0": t["r_0"], "b_1": t["b_1"], "b_2": t["b_2"], "U_0": t["U_0"],
        "delta": t["delta"], "lj1": eps4 * sigma_6 * sigma_6, "lj2": eps4 * sigma_6,
        "epsilon": t["epsilon"],
    }


def quartic(rsq, p):
    valid = p["r_0"] != 0
    r = sqrt(rsq)
    rs = r - p["delta"]  # shifted distance (delta=0 reduces to r)
    rs_safe = torch.where(rs == 0, 1e-20, rs)

    # WCA on the shifted distance, cut at 2^(1/6) sigma
    r2inv = 1.0 / (rs_safe * rs_safe)
    r6inv = r2inv * r2inv * r2inv
    lj1 = p["lj1"]
    lj1_safe = torch.where(lj1 == 0, 1.0, lj1)
    sigma6inv = p["lj2"] / lj1_safe
    wca_on = (lj1 != 0) & (r6inv > sigma6inv / 2.0)
    f_wca = r6inv * (12.0 * lj1 * r6inv - 6.0 * p["lj2"]) / rs_safe / r
    e_wca = r6inv * (lj1 * r6inv - p["lj2"]) + p["epsilon"]
    f = torch.where(wca_on, f_wca, 0.0)
    e = torch.where(wca_on, e_wca, 0.0)

    # quartic well, active while rs < r_0; plateau U_0 beyond (broken bond)
    r_red = rs - p["r_0"]
    quart_on = r_red < 0.0
    denom = r_red + p["r_0"] + p["delta"]  # = rs + delta = r
    denom = torch.where(denom == 0, 1e-20, denom)
    f_q = -p["k"] * r_red * (
        4.0 * r_red * r_red - 3.0 * (p["b_1"] + p["b_2"]) * r_red + 2.0 * p["b_1"] * p["b_2"]
    ) / denom
    e_q = p["k"] * (r_red - p["b_1"]) * (r_red - p["b_2"]) * r_red * r_red
    f = f + torch.where(quart_on, f_q, 0.0)
    e = e + torch.where(quart_on, e_q, 0.0) + p["U_0"]
    return torch.where(valid, e, 0.0), torch.where(valid, f, 0.0)


# ---------------------------------------------------------------------------
# HOOMD-core substrate bonds: harmonic spring and Kremer-Grest FENE + WCA.
# ---------------------------------------------------------------------------
def _harmonic_precompute(t: dict) -> dict:
    return {"k": t["k"], "r0": t["r0"]}


def harmonic(rsq, p):
    r = sqrt(rsq)
    dr = r - p["r0"]
    e = 0.5 * p["k"] * dr * dr
    f = -p["k"] * dr / r  # F_a = f * (r_a - r_b): negative = attractive
    active = p["k"] != 0
    return torch.where(active, e, 0.0), torch.where(active, f, 0.0)


def _fenewca_precompute(t: dict) -> dict:
    sigma_6 = t["sigma"] ** 6
    eps4 = 4.0 * t["epsilon"]
    return {
        "k": t["k"], "R0": t["R0"], "delta": t["delta"], "lj1": eps4 * sigma_6 * sigma_6,
        "lj2": eps4 * sigma_6, "epsilon": t["epsilon"],
        "rwcasq": np.cbrt(2.0) * np.asarray(t["sigma"]) ** 2,
    }


def fenewca(rsq, p):
    valid = p["R0"] != 0
    R0 = torch.where(valid, p["R0"], 1.0)
    r = sqrt(rsq)
    rs = r - p["delta"]
    rs_safe = torch.where(rs == 0, 1e-20, rs)

    # FENE spring on the shifted distance, diverging at rs = R0
    x2 = (rs / R0) ** 2
    one_m = torch.clamp_min(1.0 - x2, 1e-7)
    e = -0.5 * p["k"] * R0 * R0 * torch.log(one_m)
    f = -p["k"] * rs / one_m / r

    # WCA core on the shifted distance, cut at 2^(1/6) sigma
    rs2 = rs_safe * rs_safe
    r2inv = 1.0 / rs2
    r6inv = r2inv * r2inv * r2inv
    wca_on = (p["lj1"] != 0) & (rs2 < p["rwcasq"])
    f_wca = r6inv * (12.0 * p["lj1"] * r6inv - 6.0 * p["lj2"]) / rs_safe / r
    e_wca = r6inv * (p["lj1"] * r6inv - p["lj2"]) + p["epsilon"]
    e = e + torch.where(wca_on, e_wca, 0.0)
    f = f + torch.where(wca_on, f_wca, 0.0)
    return torch.where(valid, e, 0.0), torch.where(valid, f, 0.0)


BOND_POTENTIALS = {
    "DoubleWell": BondPotentialDef(
        name="DoubleWell",
        spec={"r_0": float, "r_1": float, "U_1": float, "U_tilt": float},
        precompute=_dw_precompute,
        energy_force=double_well,
    ),
    "Quartic": BondPotentialDef(
        name="Quartic",
        spec={"k": float, "r_0": float, "b_1": float, "b_2": float, "U_0": float,
              "sigma": float, "epsilon": float, "delta": 0.0},
        precompute=_quartic_precompute,
        energy_force=quartic,
    ),
    "Harmonic": BondPotentialDef(
        name="Harmonic",
        spec={"k": float, "r0": float},
        precompute=_harmonic_precompute,
        energy_force=harmonic,
    ),
    "FENEWCA": BondPotentialDef(
        name="FENEWCA",
        spec={"k": float, "R0": float, "epsilon": float, "sigma": float, "delta": 0.0},
        precompute=_fenewca_precompute,
        energy_force=fenewca,
    ),
}
