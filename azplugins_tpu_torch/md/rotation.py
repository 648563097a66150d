"""Rigid-rotor integration: symplectic NO_SQUISH quaternion dynamics.

Port of ``azplugins_tpu/md/rotation.py``, the rotational half of HOOMD's
two-step integrators that the anisotropic TwoPatchMorse potential relies on.

Representation (HOOMD convention): orientation quaternion ``q`` (w, x, y, z)
and angular-momentum quaternion ``p = 2 q (0, I w_body)``. Free rotation
uses the NO_SQUISH splitting of Miller et al., J. Chem. Phys. 116, 8649
(2002): per-axis permutation rotations in the sequence P3(dt/2) P2(dt/2)
P1(dt) P2(dt/2) P3(dt/2); torque kicks advance ``p`` by ``dt * q * (0,
t_body)`` per half step (the factor 2 of dp/dt = 2 q (0, t) times dt/2).
Axes with zero moment of inertia are frozen: their torque component is
dropped and their permutation rotation skipped.

Every function is elementwise PyTorch over ``[N, 4]`` quaternions and
``[N, 3]`` vectors, the same operations in the same order as the reference.
``rotate`` and ``rotate_inv`` are the port's one pair of vector rotations,
from utils/quaternion.py.
"""

from __future__ import annotations

import torch

from ..utils.quaternion import rotate, rotate_inv
from ..utils import sqrt

__all__ = [
    "quat_mul",
    "rotate",
    "rotate_inv",
    "angmom_kick",
    "free_rotation",
    "body_angular_momentum",
    "rotational_kinetic_energy",
]

_EPS = 1e-12


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of [N, 4] quaternions (w, x, y, z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _mul_vec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a * (0, v): a quaternion times a pure-vector quaternion."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            -ax * vx - ay * vy - az * vz,
            aw * vx + ay * vz - az * vy,
            aw * vy - ax * vz + az * vx,
            aw * vz + ax * vy - ay * vx,
        ],
        dim=-1,
    )


def _conj(q: torch.Tensor) -> torch.Tensor:
    """The conjugate quaternion (w, -x, -y, -z), formed on the device."""
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def _active(inertia: torch.Tensor) -> torch.Tensor:
    """Per-axis activity mask [N, 3]: zero-inertia axes are frozen."""
    return inertia > _EPS


def angmom_kick(q, p, torque_lab, inertia, dt: float) -> torch.Tensor:
    """Half-step torque kick: p += dt * q * (0, t_body).

    ``dt`` is the full timestep (the 1/2 of the kick cancels the 2 of
    dp/dt = 2 q (0, t)). Torque components on frozen axes are dropped in
    the body frame, as in HOOMD.
    """
    t_body = rotate_inv(q, torque_lab)
    t_body = torch.where(_active(inertia), t_body, 0.0)
    return p + dt * _mul_vec(q, t_body)


# Permutation operators P1, P2, P3 on (w, x, y, z)
def _perm1(a):
    return torch.stack([-a[..., 1], a[..., 0], a[..., 3], -a[..., 2]], dim=-1)


def _perm2(a):
    return torch.stack([-a[..., 2], -a[..., 3], a[..., 0], a[..., 1]], dim=-1)


def _perm3(a):
    return torch.stack([-a[..., 3], a[..., 2], -a[..., 1], a[..., 0]], dim=-1)


def _axis_rotation(q, p, inertia_k, active_k, perm, dt_k: float):
    """One NO_SQUISH axis rotation: angle = dt_k * p.(Pk q) / (4 I_k)."""
    qk = perm(q)
    pk = perm(p)
    inv_i = torch.where(active_k, 1.0 / torch.clamp_min(inertia_k, _EPS), 0.0)
    phi = 0.25 * inv_i * torch.sum(p * qk, dim=-1)
    ang = dt_k * phi
    c = torch.cos(ang)[..., None]
    s = torch.sin(ang)[..., None]
    q_new = c * q + s * qk
    p_new = c * p + s * pk
    act = active_k[..., None]
    return torch.where(act, q_new, q), torch.where(act, p_new, p)


def free_rotation(q, p, inertia, dt: float):
    """Torque-free rotation of (q, p) for one timestep.

    NO_SQUISH sequence P3(dt/2) P2(dt/2) P1(dt) P2(dt/2) P3(dt/2); q is
    renormalised at the end to control float32 drift.
    """
    act = _active(inertia)
    Ix, Iy, Iz = inertia[..., 0], inertia[..., 1], inertia[..., 2]
    half = 0.5 * dt
    q, p = _axis_rotation(q, p, Iz, act[..., 2], _perm3, half)
    q, p = _axis_rotation(q, p, Iy, act[..., 1], _perm2, half)
    q, p = _axis_rotation(q, p, Ix, act[..., 0], _perm1, dt)
    q, p = _axis_rotation(q, p, Iy, act[..., 1], _perm2, half)
    q, p = _axis_rotation(q, p, Iz, act[..., 2], _perm3, half)
    norm = sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), _EPS))
    return q / norm, p


def body_angular_momentum(q, p) -> torch.Tensor:
    """L_body [N, 3] from the quaternion pair: (0, L) = conj(q) p / 2."""
    lq = 0.5 * quat_mul(_conj(q), p)
    return lq[..., 1:4]


def rotational_kinetic_energy(q, p, inertia) -> torch.Tensor:
    """Sum over particles of L_k^2 / (2 I_k) on active axes."""
    L = body_angular_momentum(q, p)
    inv_i = torch.where(_active(inertia), 1.0 / torch.clamp_min(inertia, _EPS), 0.0)
    return 0.5 * torch.sum(L * L * inv_i)
