"""Triclinic periodic simulation box.

Port of ``azplugins_tpu/core/box.py``. Conventions (HOOMD-compatible):

  * box is centered on the origin: lo = -L/2, hi = +L/2
  * cell matrix h = [[Lx, xy*Ly, xz*Lz], [0, Ly, yz*Lz], [0, 0, Lz]]
  * ``wrap`` folds positions into the box updating image flags
  * ``min_image_components`` returns the minimum-image displacement

The box is fixed for a run (no barostat), so it lives on the host as six
float32 numbers rather than as device tensors: every operation multiplies
tensors by Python floats that are exact float32 values, and every product
of two box numbers (``xy * Ly`` and the like) is formed in float32 by
numpy first. The device then sees the same float32 operations, in the same
order, as the reference's jnp code, with no device scalars to launch or
synchronise on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import frozen_dataclass

__all__ = ["Box"]

_F32 = np.float32


@frozen_dataclass
class Box:
    """Periodic triclinic box.

    Attributes:
        L: box edge lengths ``[Lx, Ly, Lz]`` (numpy float32).
        tilt: tilt factors ``[xy, xz, yz]`` (numpy float32, HOOMD convention).
    """

    L: np.ndarray
    tilt: np.ndarray

    @classmethod
    def from_lengths(
        cls, Lx: float, Ly: float, Lz: float, xy: float = 0.0, xz: float = 0.0, yz: float = 0.0
    ) -> "Box":
        return cls(
            L=np.asarray([Lx, Ly, Lz], dtype=_F32),
            tilt=np.asarray([xy, xz, yz], dtype=_F32),
        )

    # -- float32 scalars (exact float32 values held as Python floats) --------
    @property
    def Lx(self) -> float:
        return float(self.L[0])

    @property
    def Ly(self) -> float:
        return float(self.L[1])

    @property
    def Lz(self) -> float:
        return float(self.L[2])

    @property
    def xy(self) -> float:
        return float(self.tilt[0])

    @property
    def xz(self) -> float:
        return float(self.tilt[1])

    @property
    def yz(self) -> float:
        return float(self.tilt[2])

    def lattice_products(self) -> tuple[float, float, float]:
        """``(xy*Ly, xz*Lz, yz*Lz)``, each rounded to float32."""
        L, t = self.L, self.tilt
        return float(t[0] * L[1]), float(t[1] * L[2]), float(t[2] * L[2])

    def matrix(self) -> np.ndarray:
        """Upper-triangular cell matrix h (columns are lattice vectors)."""
        xyLy, xzLz, yzLz = self.lattice_products()
        return np.asarray(
            [[self.Lx, xyLy, xzLz], [0.0, self.Ly, yzLz], [0.0, 0.0, self.Lz]], dtype=_F32
        )

    def volume(self) -> float:
        return float(self.L[0] * self.L[1] * self.L[2])

    def fraction(self, r: torch.Tensor) -> torch.Tensor:
        """Map cartesian positions to fractional coordinates in [-0.5, 0.5)."""
        xyLy, xzLz, yzLz = self.lattice_products()
        fz = r[..., 2] / self.Lz
        fy = (r[..., 1] - yzLz * fz) / self.Ly
        fx = (r[..., 0] - xyLy * fy - xzLz * fz) / self.Lx
        return torch.stack([fx, fy, fz], dim=-1)

    def _lattice_shift(self, s: torch.Tensor) -> torch.Tensor:
        """``s @ h.T`` written componentwise (exactly rounded float32)."""
        xyLy, xzLz, yzLz = self.lattice_products()
        sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
        return torch.stack(
            [
                sx * self.Lx + sy * xyLy + sz * xzLz,
                sy * self.Ly + sz * yzLz,
                sz * self.Lz,
            ],
            dim=-1,
        )

    # -- periodic operations ------------------------------------------------
    def wrap(self, r: torch.Tensor, image: torch.Tensor | None = None):
        """Fold positions into the primary box.

        Returns ``(wrapped, image)``; ``image`` is updated if given, else the
        shift count is returned as a fresh int32 image array.
        """
        f = self.fraction(r)
        shift = torch.floor(f + 0.5).to(torch.int32)
        wrapped = r - self._lattice_shift(shift.to(r.dtype))
        image = shift if image is None else image + shift
        return wrapped, image

    def min_image_components(self, dx, dy, dz):
        """Minimum image on separate x/y/z component tensors (triclinic)."""
        Lx, Ly, Lz = self.Lx, self.Ly, self.Lz
        xyLy, xzLz, yzLz = self.lattice_products()
        fz = dz / Lz
        fy = (dy - yzLz * fz) / Ly
        fx = (dx - xyLy * fy - xzLz * fz) / Lx
        sx = torch.round(fx)
        sy = torch.round(fy)
        sz = torch.round(fz)
        # the reference multiplies (sy * xy) * Ly and (sz * xz) * Lz here
        dx = dx - (sx * Lx + sy * self.xy * Ly + sz * self.xz * Lz)
        dy = dy - (sy * Ly + sz * self.yz * Lz)
        dz = dz - sz * Lz
        return dx, dy, dz

    def nearest_plane_distance(self) -> np.ndarray:
        """Distance between nearest periodic image planes along each axis."""
        h = self.matrix()
        a, b, c = h[:, 0], h[:, 1], h[:, 2]

        def dist(u, v, w):
            n = np.cross(v, w).astype(_F32)
            return np.abs(np.sum(u * n, dtype=_F32)) / np.sqrt(np.sum(n * n, dtype=_F32))

        return np.stack([dist(a, b, c), dist(b, c, a), dist(c, a, b)]).astype(_F32)
