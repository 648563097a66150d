"""Anisotropic pair evaluators: force, energy and both torques.

Port of ``azplugins_tpu/ops/evaluators/aniso.py``. All pair-shaped values
are separate tensors per component. Protocol::

    (dxyz, quat_i, quat_j, rcutsq, params, energy_shift)
        -> (energy, force_xyz, torque_i_xyz, torque_j_xyz)

where dxyz/force/torque are 3-tuples of tensors and quat_* are 4-tuples
(w, x, y, z). The separation is i minus j; the force is the one on i.

TwoPatchMorse (reference plugin AnisoPairEvaluatorTwoPatchMorse.h:127-216):
a Morse radial well modulated by the patch alignment of each particle,
Omega(gamma) = 1 / (1 + exp(-omega (gamma^2 - alpha))), gamma = rhat . n
with n the body x axis rotated by the particle's quaternion; analytic
torques from dU/dgamma. The CUDA kernel (csrc/cell_aniso_force.cu)
carries the same formulas, operation for operation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ...utils.quaternion import rotate_x_parts
from ...utils import sqrt

__all__ = ["AnisoPairPotentialDef", "ANISO_PAIR_POTENTIALS", "two_patch_morse", "morse_cut"]


@dataclasses.dataclass(frozen=True)
class AnisoPairPotentialDef:
    name: str
    spec: dict
    precompute: Callable[[dict], dict]
    energy_force_torque: Callable


def _tpm_precompute(t: dict) -> dict:
    return {
        "M_d": t["M_d"],
        "M_rinv": 1.0 / t["M_r"],
        "r_eq": t["r_eq"],
        "omega": t["omega"],
        "alpha": t["alpha"],
        "repulsion": t["repulsion"],
    }


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _morse(r, p):
    """Morse energy and radial derivative, with the optional flat bottom."""
    morse_exp = torch.exp(-(r - p["r_eq"]) * p["M_rinv"])
    one_minus = 1.0 - morse_exp
    U = p["M_d"] * (one_minus * one_minus - 1.0)
    dU_dr = 2.0 * p["M_d"] * p["M_rinv"] * morse_exp * one_minus
    # flat bottom: the purely attractive branch clamps U = -M_d, dU = 0 for r < r_eq
    flat = (r < p["r_eq"]) & (p["repulsion"] == 0)
    U = torch.where(flat, -p["M_d"], U)
    dU_dr = torch.where(flat, 0.0, dU_dr)
    return U, dU_dr


def morse_cut(rcutsq, p):
    """The raw Morse energy at the cutoff (no flat-bottom clamp), which the
    shift mode subtracts scaled by Omega_i Omega_j (reference plugin
    AnisoPairEvaluatorTwoPatchMorse.h:194-207)."""
    rcut = sqrt(rcutsq)
    exp_cut = torch.exp(-(rcut - p["r_eq"]) * p["M_rinv"])
    one_minus_cut = 1.0 - exp_cut
    return p["M_d"] * (one_minus_cut * one_minus_cut - 1.0)


def two_patch_morse(dxyz, quat_i, quat_j, rcutsq, p, energy_shift: bool):
    dx, dy, dz = dxyz
    rsq = dx * dx + dy * dy + dz * dz
    rsq_safe = torch.where(rsq > 0, rsq, 1.0)
    rinv = 1.0 / sqrt(rsq_safe)
    r = rsq_safe * rinv
    ux, uy, uz = dx * rinv, dy * rinv, dz * rinv

    nix, niy, niz = rotate_x_parts(*quat_i)
    njx, njy, njz = rotate_x_parts(*quat_j)

    U, dU_dr_radial = _morse(r, p)

    def omega_terms(gamma):
        g_exp = torch.exp(-p["omega"] * (gamma * gamma - p["alpha"]))
        Om = 1.0 / (1.0 + g_exp)
        dOm_dg = 2.0 * p["omega"] * gamma * g_exp * Om * Om
        return Om, dOm_dg

    gamma_i = ux * nix + uy * niy + uz * niz
    gamma_j = ux * njx + uy * njy + uz * njz
    Om_i, dOmi = omega_terms(gamma_i)
    Om_j, dOmj = omega_terms(gamma_j)

    e = U * Om_i * Om_j
    dU_dr = dU_dr_radial * Om_i * Om_j
    dU_dgi = dOmi * U * Om_j
    dU_dgj = dOmj * U * Om_i

    # n_perp = -u x (u x n) = n - (u . n) u: n's component perpendicular to u
    nipx, nipy, nipz = nix - gamma_i * ux, niy - gamma_i * uy, niz - gamma_i * uz
    njpx, njpy, njpz = njx - gamma_j * ux, njy - gamma_j * uy, njz - gamma_j * uz

    fx = -dU_dr * ux - rinv * (dU_dgi * nipx + dU_dgj * njpx)
    fy = -dU_dr * uy - rinv * (dU_dgi * nipy + dU_dgj * njpy)
    fz = -dU_dr * uz - rinv * (dU_dgi * nipz + dU_dgj * njpz)

    cix, ciy, ciz = _cross(ux, uy, uz, nix, niy, niz)
    cjx, cjy, cjz = _cross(ux, uy, uz, njx, njy, njz)
    ti = (dU_dgi * cix, dU_dgi * ciy, dU_dgi * ciz)
    tj = (dU_dgj * cjx, dU_dgj * cjy, dU_dgj * cjz)

    if energy_shift:
        e = e - morse_cut(rcutsq, p) * Om_i * Om_j

    return e, (fx, fy, fz), ti, tj


ANISO_PAIR_POTENTIALS = {
    "TwoPatchMorse": AnisoPairPotentialDef(
        name="TwoPatchMorse",
        spec={
            "M_d": float,
            "M_r": float,
            "r_eq": float,
            "omega": float,
            "alpha": float,
            "repulsion": bool,
        },
        precompute=_tpm_precompute,
        energy_force_torque=two_patch_morse,
    ),
}
