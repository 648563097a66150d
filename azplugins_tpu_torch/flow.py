"""Flow fields: position-dependent background velocity u(r).

Port of ``azplugins_tpu/flow.py``: ConstantFlow and ParabolicFlow, used by
the Langevin and Brownian flow integrators to drag particles relative to a
moving solvent. A flow field is a callable ``u(position[..., 3]) ->
velocity[..., 3]`` on tensors, evaluated every step in float32 in the
reference's operation order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FlowField", "ConstantFlow", "ParabolicFlow"]


class FlowField:
    """Base class: a velocity field evaluated inside the step."""

    def __call__(self, position):  # pragma: no cover - interface
        raise NotImplementedError


class ConstantFlow(FlowField):
    """Uniform flow u(r) = U."""

    def __init__(self, velocity):
        self.velocity = tuple(float(v) for v in velocity)
        if len(self.velocity) != 3:
            raise ValueError("velocity must have 3 components")
        self._on_device = {}

    def __call__(self, position):
        key = str(position.device)
        u = self._on_device.get(key)
        if u is None:
            u = self._on_device[key] = torch.tensor(
                self.velocity, dtype=torch.float32, device=position.device
            )
        return u.expand(position.shape)


class ParabolicFlow(FlowField):
    """Poiseuille flow between parallel plates separated along y:

    u_x(y) = 1.5 U (1 - (y / L)^2) with L = separation / 2.
    """

    def __init__(self, mean_velocity: float, separation: float):
        self.mean_velocity = float(mean_velocity)
        self.separation = float(separation)

    def __call__(self, position):
        U_max = float(np.float32(1.5 * self.mean_velocity))
        L = float(np.float32(0.5 * self.separation))
        yr = position[..., 1] / L
        ux = U_max * (1.0 - yr * yr)
        zeros = torch.zeros_like(ux)
        return torch.stack([ux, zeros, zeros], dim=-1)
