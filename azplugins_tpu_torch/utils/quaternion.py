"""Quaternion rotations (w, x, y, z convention, HOOMD-compatible).

Port of ``azplugins_tpu/utils/quaternion.py``, and the one home of the
port's rotations: the rotational integrator (md/rotation.py) rotates
torques and body-frame vectors with :func:`rotate` and
:func:`rotate_inv`, and the anisotropic pair evaluator turns each
particle's body x axis into its patch direction with
:func:`rotate_x_parts`. :func:`rotate` uses the integrator's formula,
``t = 2 u x v; v + w t + u x t`` (the reference's md/rotation.py), which
agrees with the reference's ``v + 2 u x (u x v + w v)`` to float32
round-off.
"""

from __future__ import annotations

import torch

__all__ = ["rotate", "rotate_inv", "rotate_x", "rotate_x_parts"]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, as jnp.cross forms it."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _rotate(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4] (body -> lab)."""
    return _rotate(q[..., 0:1], q[..., 1:4], v)


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate by the conjugate of q (lab -> body)."""
    return _rotate(q[..., 0:1], -q[..., 1:4], v)


def rotate_x_parts(w, x, y, z):
    """The body-frame x axis (1, 0, 0) rotated by the quaternion with
    components (w, x, y, z), as its three components; a cheaper closed form."""
    nx = 1.0 - 2.0 * (y * y + z * z)
    ny = 2.0 * (x * y + w * z)
    nz = 2.0 * (x * z - w * y)
    return nx, ny, nz


def rotate_x(q: torch.Tensor) -> torch.Tensor:
    """The body-frame x axis rotated by unit quaternions q [..., 4]: [..., 3]."""
    return torch.stack(rotate_x_parts(*q.unbind(-1)), dim=-1)
