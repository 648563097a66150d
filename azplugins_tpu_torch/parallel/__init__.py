"""Spatial domain decomposition of the slot layout.

Port of ``azplugins_tpu/parallel/``. The reference runs one controller
over a JAX device mesh; the port runs one Python process over a mesh of
blocks of the cell-major slot axis: views of one slot axis on the
simulation's device, or shards with slot storage of their own, each on
its device (see mesh.py and spatial.py).
"""

from .mesh import Mesh, make_mesh
from .spatial import gather_dense, halo_window, shard_dense, slab_migrate_capacity, spatial_rebin

__all__ = ["Mesh", "make_mesh", "spatial_rebin", "slab_migrate_capacity", "shard_dense",
           "gather_dense", "halo_window"]
