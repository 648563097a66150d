"""Isotropic pair potential evaluators as plain tensor functions.

Port of ``azplugins_tpu/ops/evaluators/pair.py``: each potential is a
stateless function ``(rsq, rcutsq, params) -> (energy, force_div_r)``
evaluated elementwise by the plain pair force (ops/dense.py), plus a
``precompute`` that turns user parameters into the per-type-pair tables
the plain pair force and the CUDA kernel read. Cutoff and padding masks are
applied by the caller, so these functions need only be algebraically safe for
garbage inputs.

This slice ports PerturbedLennardJones; the other potentials follow with
ROADMAP slice 3.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["PairPotentialDef", "PAIR_POTENTIALS", "perturbed_lennard_jones"]


@dataclasses.dataclass(frozen=True)
class PairPotentialDef:
    """Registry entry for an isotropic pair potential."""

    name: str
    spec: dict  # user-facing param spec (for TypeParameter)
    precompute: Callable[[dict], dict]  # host tables -> kernel tables
    energy_force: Callable  # (rsq, rcutsq, params) -> (energy, force_div_r)


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
    active = p["lj1"] != 0
    return torch.where(active, e, 0.0), torch.where(active, f, 0.0)


PAIR_POTENTIALS = {
    "PerturbedLennardJones": PairPotentialDef(
        name="PerturbedLennardJones",
        spec={"epsilon": float, "sigma": float, "attraction_scale_factor": float},
        precompute=_plj_precompute,
        energy_force=perturbed_lennard_jones,
    ),
}
