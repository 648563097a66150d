"""Force results and shift-mode helpers shared by the pair forces.

Port of the shared part of ``azplugins_tpu/ops/pair_force.py``
(``ForceResult`` and the xplor smoothing). The reference's padded
neighbour-list pair force in that file is a test oracle only and is not ported
(ROADMAP queue A, "Not to port").
"""

from __future__ import annotations

import torch

from ..utils import frozen_dataclass

__all__ = ["ForceResult"]


@frozen_dataclass
class ForceResult:
    force: torch.Tensor  # [N, 3]
    energy: torch.Tensor | None  # [N] per-particle (half per pair)
    virial: torch.Tensor | None  # [N, 6] (xx, xy, xz, yy, yz, zz), half per pair
    torque: torch.Tensor | None = None  # [N, 3] for anisotropic potentials


def _xplor_smooth(e, f, rsq, rcutsq, r_onsq):
    denom = (rcutsq - r_onsq) ** 3
    denom = torch.where(denom == 0, 1.0, denom)
    s_val = (rcutsq - rsq) ** 2 * (rcutsq + 2.0 * rsq - 3.0 * r_onsq) / denom
    ds_dr_divr = 12.0 * (rsq - r_onsq) * (rcutsq - rsq) / denom
    in_smooth = rsq > r_onsq
    f_new = torch.where(in_smooth, f * s_val + e * ds_dr_divr, f)
    e_new = torch.where(in_smooth, e * s_val, e)
    return e_new, f_new
