"""The MD integrator: owns dt, methods, and forces.

Port of ``azplugins_tpu/md/integrate.py``; the step loop itself is driven
by ``Simulation`` (simulation.py).
"""

from __future__ import annotations

from .methods import Method

__all__ = ["Integrator"]


class Integrator:
    def __init__(self, dt: float, methods=None, forces=None, integrate_rotational_dof=False):
        if dt < 0:
            raise ValueError("dt must be non-negative")
        self.dt = float(dt)
        self.methods: list[Method] = list(methods) if methods is not None else []
        self.forces = list(forces) if forces is not None else []
        self.integrate_rotational_dof = bool(integrate_rotational_dof)

    def _attach(self, sim):
        for m in self.methods:
            m._attach(sim)
        for f in self.forces:
            f._attach(sim)
