"""Isotropic pair potential evaluators as plain tensor functions.

Port of ``azplugins_tpu/ops/evaluators/pair.py``: each potential is a
stateless function ``(rsq, rcutsq, params) -> (energy, force_div_r)``
evaluated elementwise by the plain pair force (ops/dense.py), plus a
``precompute`` that turns user parameters into the per-type-pair tables
the plain pair force and the CUDA kernel read. Cutoff and padding masks are
applied by the caller, so these functions need only be algebraically safe for
garbage inputs. The CUDA kernel (csrc/cell_pair_force.cu) carries the same
formulas, operation for operation, as one device function per potential.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ...utils import sqrt

__all__ = [
    "PairPotentialDef",
    "PAIR_POTENTIALS",
    "perturbed_lennard_jones",
    "colloid",
    "expanded_yukawa",
    "hertz",
    "dpd_general_weight_conservative",
    "lennard_jones",
    "morse",
    "gauss",
    "yukawa",
]


@dataclasses.dataclass(frozen=True)
class PairPotentialDef:
    """Registry entry for an isotropic pair potential."""

    name: str
    spec: dict  # user-facing param spec (for TypeParameter)
    precompute: Callable[[dict], dict]  # host tables -> kernel tables
    energy_force: Callable  # (rsq, rcutsq, params) -> (energy, force_div_r)


def _active(p0, e, f):
    """Zero energy and force where the potential's scale parameter is 0."""
    active = p0 != 0
    return torch.where(active, e, 0.0), torch.where(active, f, 0.0)


# ---------------------------------------------------------------------------
# Perturbed Lennard-Jones: WCA core + lambda-scaled attractive tail.
# (reference plugin: src/PairEvaluatorPerturbedLennardJones.h:117-155)
# ---------------------------------------------------------------------------
def _plj_precompute(t: dict) -> dict:
    sigma_6 = t["sigma"] ** 6
    eps4 = 4.0 * t["epsilon"]
    return {
        "lj1": eps4 * sigma_6 * sigma_6,
        "lj2": eps4 * sigma_6,
        "lam": t["attraction_scale_factor"],
        "rwcasq": np.cbrt(2.0) * t["sigma"] ** 2,
        "wca_shift": t["epsilon"] * (1.0 - t["attraction_scale_factor"]),
    }


def perturbed_lennard_jones(rsq, rcutsq, p):
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    f = r2inv * r6inv * (12.0 * p["lj1"] * r6inv - 6.0 * p["lj2"])
    e = r6inv * (p["lj1"] * r6inv - p["lj2"])
    in_core = rsq < p["rwcasq"]
    e = torch.where(in_core, e + p["wca_shift"], e * p["lam"])
    f = torch.where(in_core, f, f * p["lam"])
    return _active(p["lj1"], e, f)


# ---------------------------------------------------------------------------
# Colloid: integrated LJ (Hamaker); three regimes selected by radii.
# (reference plugin: src/PairEvaluatorColloid.h:101-269)
# ---------------------------------------------------------------------------
def _colloid_precompute(t: dict) -> dict:
    return {"A": t["A"], "a_1": t["a_1"], "a_2": t["a_2"], "sigma_3": t["sigma"] ** 3}


def _colloid_solvent_solvent(rsq, A, sigma_3):
    """Both radii zero: plain LJ with Hamaker A/36 prefactor."""
    sigma_6 = sigma_3 * sigma_3
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    c1 = A * sigma_6 / 36.0
    f = 6.0 * c1 * r2inv * r6inv * (2.0 * sigma_6 * r6inv - 1.0)
    e = c1 * r6inv * (sigma_6 * r6inv - 1.0)
    return e, f


def _colloid_sphere_point(rsq, A, sigma_3, a):
    """One radius zero: point particle vs sphere of radius a."""
    sigma_6 = sigma_3 * sigma_3
    asq = a * a
    am = asq - rsq
    am = torch.where(am == 0, 1e-20, am)  # contact singularity guard
    am3 = am * am * am
    am6 = am3 * am3
    rsqsq = rsq * rsq
    fR = sigma_3 * A * a * asq / am3
    f = (
        (4.0 / 15.0)
        * fR
        * (2.0 * (asq + rsq) * (asq * (5.0 * asq + 22.0 * rsq) + 5.0 * rsqsq) * sigma_6 / am6 - 5.0)
        / am
    )
    e = (2.0 / 9.0) * fR * (
        1.0
        - (asq * (asq * (asq / 3.0 + 3.0 * rsq) + 4.2 * rsqsq) + rsq * rsqsq) * sigma_6 / am6
    )
    return e, f


def _colloid_sphere_sphere(rsq, A, sigma_3, ai, aj):
    """Both radii nonzero: Everaers-Ejtehadi sphere-sphere form."""
    sigma_6 = sigma_3 * sigma_3
    r = sqrt(rsq)
    k0 = ai * aj
    k1 = ai + aj
    k2 = ai - aj
    k3 = k1 + r
    k4 = k1 - r
    k5 = k2 + r
    k6 = k2 - r
    # overlap / degenerate guards (padded or touching spheres)
    tiny = 1e-20
    k3 = torch.where(k3 == 0, tiny, k3)
    k4 = torch.where(k4 == 0, tiny, k4)
    k5 = torch.where(k5 == 0, tiny, k5)
    k6 = torch.where(k6 == 0, tiny, k6)
    k7 = 1.0 / (k3 * k4)
    k8 = 1.0 / (k5 * k6)

    def pow7inv(x):
        xi = 1.0 / x
        x2 = xi * xi
        return x2 * x2 * x2 * xi

    g0 = pow7inv(k3)
    g1 = pow7inv(k4)
    g2 = pow7inv(k5)
    g3 = pow7inv(k6)

    h0 = ((k3 + 5.0 * k1) * k3 + 30.0 * k0) * g0
    h1 = ((k4 + 5.0 * k1) * k4 + 30.0 * k0) * g1
    h2 = ((k5 + 5.0 * k2) * k5 - 30.0 * k0) * g2
    h3 = ((k6 + 5.0 * k2) * k6 - 30.0 * k0) * g3

    g0 = g0 * (42.0 * k0 / k3 + 6.0 * k1 + k3)
    g1 = g1 * (42.0 * k0 / k4 + 6.0 * k1 + k4)
    g2 = g2 * (-42.0 * k0 / k5 + 6.0 * k2 + k5)
    g3 = g3 * (-42.0 * k0 / k6 + 6.0 * k2 + k6)

    fR = A * sigma_6 / r / 37800.0
    e_rep = fR * (h0 - h1 - h2 + h3)
    dUR = e_rep / r + 5.0 * fR * (g0 + g1 - g2 - g3)
    dUA = -A / 3.0 * r * ((2.0 * k0 * k7 + 1.0) * k7 + (2.0 * k0 * k8 - 1.0) * k8)
    f = (dUR + dUA) / r
    ratio = torch.where(k8 / k7 > 0, k8 / k7, 1.0)
    e = e_rep + A / 6.0 * (2.0 * k0 * (k7 + k8) - torch.log(ratio))
    return e, f


def colloid(rsq, rcutsq, p):
    A, s3, ai, aj = p["A"], p["sigma_3"], p["a_1"], p["a_2"]
    e_ss, f_ss = _colloid_solvent_solvent(rsq, A, s3)
    e_cs, f_cs = _colloid_sphere_point(rsq, A, s3, torch.maximum(ai, aj))
    e_cc, f_cc = _colloid_sphere_sphere(rsq, A, s3, ai, aj)
    both_zero = (ai == 0) & (aj == 0)
    both_set = (ai != 0) & (aj != 0)
    e = torch.where(both_zero, e_ss, torch.where(both_set, e_cc, e_cs))
    f = torch.where(both_zero, f_ss, torch.where(both_set, f_cc, f_cs))
    return _active(A, e, f)


# ---------------------------------------------------------------------------
# Expanded Yukawa: U = eps exp(-kappa (r - delta)) / (r - delta)
# (reference plugin: src/PairEvaluatorExpandedYukawa.h:92-115)
# ---------------------------------------------------------------------------
def _yukawa_precompute(t: dict) -> dict:
    return {"epsilon": t["epsilon"], "kappa": t["kappa"], "delta": t["delta"]}


def expanded_yukawa(rsq, rcutsq, p):
    r = sqrt(rsq)
    rd = r - p["delta"]
    rd = torch.where(rd == 0, 1e-20, rd)
    rd_inv = 1.0 / rd
    e = p["epsilon"] * torch.exp(-p["kappa"] * rd) * rd_inv
    f = e * (p["kappa"] + rd_inv) / r
    return _active(p["epsilon"], e, f)


# ---------------------------------------------------------------------------
# Hertz: U = eps (1 - r/rcut)^{5/2}
# (reference plugin: src/PairEvaluatorHertz.h:93-110)
# ---------------------------------------------------------------------------
def _hertz_precompute(t: dict) -> dict:
    return {"epsilon": t["epsilon"]}


def hertz(rsq, rcutsq, p):
    r = sqrt(rsq)
    rcut = sqrt(rcutsq)
    x = torch.clamp_min(1.0 - r / rcut, 0.0)
    ex32 = p["epsilon"] * x * sqrt(x)
    e = ex32 * x
    f = 2.5 * ex32 / (r * rcut)
    return _active(p["epsilon"], e, f)


# ---------------------------------------------------------------------------
# DPD general weight: conservative branch (the thermostat is
# ops/dense.py::dense_dpd_force and csrc/cell_dpd_force.cu).
# (reference plugin: src/DPDPairEvaluatorGeneralWeight.h:165-183)
# ---------------------------------------------------------------------------
def _dpd_precompute(t: dict) -> dict:
    return {"A": t["A"], "gamma": t["gamma"], "s": t["s"]}


def dpd_general_weight_conservative(rsq, rcutsq, p):
    rinv = torch.where(rsq > 0, 1.0 / sqrt(rsq), 0.0)
    r = sqrt(rsq)
    rcut = sqrt(rcutsq)
    rcutinv = 1.0 / rcut
    f = p["A"] * (rinv - rcutinv)
    e = p["A"] * (rcut - r) - 0.5 * p["A"] * rcutinv * (rcutsq - rsq)
    return e, f


# ---------------------------------------------------------------------------
# HOOMD-core substrate potentials: LJ, Morse, Gaussian core, screened
# Coulomb (Yukawa), as the reference registers them.
# ---------------------------------------------------------------------------
def _lj_precompute(t: dict) -> dict:
    sigma_6 = t["sigma"] ** 6
    eps4 = 4.0 * t["epsilon"]
    return {"lj1": eps4 * sigma_6 * sigma_6, "lj2": eps4 * sigma_6}


def lennard_jones(rsq, rcutsq, p):
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    f = r2inv * r6inv * (12.0 * p["lj1"] * r6inv - 6.0 * p["lj2"])
    e = r6inv * (p["lj1"] * r6inv - p["lj2"])
    return _active(p["lj1"], e, f)


def _morse_precompute(t: dict) -> dict:
    return {"D0": t["D0"], "alpha": t["alpha"], "r0": t["r0"]}


def morse(rsq, rcutsq, p):
    r = sqrt(rsq)
    ea = torch.exp(-p["alpha"] * (r - p["r0"]))
    e = p["D0"] * ea * (ea - 2.0)
    f = 2.0 * p["D0"] * p["alpha"] * ea * (ea - 1.0) / r
    return _active(p["D0"], e, f)


def _gauss_precompute(t: dict) -> dict:
    s2 = np.asarray(t["sigma"]) ** 2
    sig2inv = np.where(s2 != 0, 1.0 / np.where(s2 != 0, s2, 1.0), 0.0)
    return {"epsilon": t["epsilon"], "sig2inv": sig2inv}


def gauss(rsq, rcutsq, p):
    e = p["epsilon"] * torch.exp(-0.5 * rsq * p["sig2inv"])
    f = e * p["sig2inv"]
    return _active(p["epsilon"], e, f)


def _plain_yukawa_precompute(t: dict) -> dict:
    return {"epsilon": t["epsilon"], "kappa": t["kappa"]}


def yukawa(rsq, rcutsq, p):
    r = sqrt(rsq)
    rinv = 1.0 / r
    e = p["epsilon"] * torch.exp(-p["kappa"] * r) * rinv
    f = e * (p["kappa"] + rinv) * rinv
    return _active(p["epsilon"], e, f)


PAIR_POTENTIALS = {
    "PerturbedLennardJones": PairPotentialDef(
        "PerturbedLennardJones",
        {"epsilon": float, "sigma": float, "attraction_scale_factor": float},
        _plj_precompute, perturbed_lennard_jones,
    ),
    "Colloid": PairPotentialDef(
        "Colloid", {"A": float, "a_1": float, "a_2": float, "sigma": float},
        _colloid_precompute, colloid,
    ),
    "ExpandedYukawa": PairPotentialDef(
        "ExpandedYukawa", {"epsilon": float, "kappa": float, "delta": float},
        _yukawa_precompute, expanded_yukawa,
    ),
    "Hertz": PairPotentialDef("Hertz", {"epsilon": float}, _hertz_precompute, hertz),
    "DPDGeneralWeight": PairPotentialDef(
        "DPDGeneralWeight", {"A": float, "gamma": float, "s": float},
        _dpd_precompute, dpd_general_weight_conservative,
    ),
    "LJ": PairPotentialDef(
        "LJ", {"epsilon": float, "sigma": float}, _lj_precompute, lennard_jones,
    ),
    "Morse": PairPotentialDef(
        "Morse", {"D0": float, "alpha": float, "r0": float}, _morse_precompute, morse,
    ),
    "Gaussian": PairPotentialDef(
        "Gaussian", {"epsilon": float, "sigma": float}, _gauss_precompute, gauss,
    ),
    "Yukawa": PairPotentialDef(
        "Yukawa", {"epsilon": float, "kappa": float}, _plain_yukawa_precompute, yukawa,
    ),
}
