"""The block mesh of a spatial decomposition.

Port of ``azplugins_tpu/parallel/mesh.py``. A :class:`Mesh` names one
device per block of the cell-major slot axis, along the axis ``"d"``, and
says how the blocks are held:

- **Views** (``sharded=False``; every block on one device, the simulation's):
  the grid snaps to whole z cell columns a block, and the rebuilds, the
  force kernels and the integrators run on the whole slot axis, which is
  the blocks' layout, bit for bit.
- **Shards** (``sharded=True``): each block has slot storage of its own on
  its device; the rebuild is the block-local rebin with migration
  (parallel/spatial.py), and each block's force kernels read a halo window
  of whole x planes around it. A mesh over distinct devices is always
  sharded. ``make_mesh(n, device=d, sharded=True)`` puts n shards on one
  device. It is a testing seam and nothing more: it stands in for the
  reference's virtual devices, and is the way the sharded path runs where
  one device is present (the CPU tests, a one-card check of the multi-card
  mechanics); on one device it buys nothing over views. One Python process
  drives every shard, as one JAX controller drives every device; on one
  card the shards' segments run as CUDA graphs (graph.py), as the
  reference compiles its sharded chunk, and a mesh over distinct devices
  runs them eagerly.

A mesh puts every block on one device, or each block on a device of its
own; a mesh that mixes the two is refused.

The reference's ``particle_sharding`` returns a JAX ``NamedSharding`` and
``shard_state`` places arrays on one; neither has a counterpart here
(``parallel.spatial.shard_dense`` splits a dense state into shards).
"""

from __future__ import annotations

import torch

from ..utils import frozen_dataclass

__all__ = ["Mesh", "make_mesh"]


def _key(d) -> tuple:
    """A device's identity (``"cuda"`` is ``"cuda:0"``)."""
    d = torch.device(d)
    return d.type, d.index or 0


def same_device(a, b) -> bool:
    """Whether two devices name the same one."""
    return _key(a) == _key(b)


@frozen_dataclass
class Mesh:
    """``devices``: one ``torch.device`` per block, in block order.
    ``sharded``: each block holds slot storage of its own; true whenever
    the devices are distinct (None takes that default)."""

    devices: tuple
    sharded: bool | None = None

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devices)
        if 1 < len({_key(d) for d in devices}) < len(devices):
            raise ValueError("a mesh puts every block on one device or each on a device of "
                             f"its own, not {[str(d) for d in devices]}")
        if self.sharded is None:
            object.__setattr__(self, "sharded", self.distinct)
        elif self.distinct and not self.sharded:
            raise ValueError("a mesh over distinct devices holds its blocks as shards: "
                             "sharded must be True")

    @property
    def shape(self) -> dict:
        """``{"d": number of blocks}``, as the reference reads ``mesh.shape["d"]``."""
        return {"d": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> bool:
        """Whether the blocks lie on distinct devices, one a block (a
        one-block mesh does not)."""
        return len({_key(d) for d in self.devices}) > 1


def make_mesh(n_devices: int | None = None, device=None, sharded: bool = False) -> Mesh:
    """A mesh of one block per device, or of ``n_devices`` blocks on one.

    Without ``device``, as the reference takes ``jax.devices()[:n]``: one
    block on each of the first ``n_devices`` CUDA devices (every one by
    default), sharded when there are several; it raises without CUDA, as
    ``Simulation()`` does, and when fewer devices are present. With
    ``device``, ``n_devices`` blocks all on that device (``n_devices`` is
    then required), as views of one slot axis, or with ``sharded=True`` as
    shards of their own: the testing seam that runs the sharded path on one
    device.
    """
    if device is not None:
        if n_devices is None:
            raise ValueError("make_mesh(device=...) puts every block on one device: "
                             "pass n_devices, the number of blocks")
        if n_devices < 1:
            raise ValueError(f"a mesh needs at least one block, got {n_devices}")
        return Mesh(devices=(torch.device(device),) * int(n_devices), sharded=bool(sharded))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() puts its blocks on the GPUs by default and no CUDA device is "
            'available; pass n_devices and device="cpu" to decompose a simulation on the CPU'
        )
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh({n_devices}) asks for {n} CUDA devices and {count} "
                         f"are present; pass device=... to put {n} blocks on one device")
    devices = tuple(torch.device("cuda", i) for i in range(n))
    return Mesh(devices=devices, sharded=bool(sharded) or None)

