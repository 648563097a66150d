"""Spatial domain decomposition of the slot layout.

Port of ``azplugins_tpu/parallel/``. The reference runs one controller
over a JAX device mesh; the port's mesh is n blocks of the cell-major slot
axis that all lie on the simulation's device, which is the form the
reference's own suite runs (virtual devices in one process). See mesh.py.
"""

from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
