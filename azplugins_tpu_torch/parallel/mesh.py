"""The block mesh of a spatial decomposition.

Port of ``azplugins_tpu/parallel/mesh.py``. A :class:`Mesh` names one
device per block of the cell-major slot axis, along the axis ``"d"``. The
port decomposes only a mesh whose blocks all lie on the simulation's
device: the grid snaps to whole z cell columns a block, and the rebuilds,
the force kernels and the integrators run on the whole slot axis, which
is the blocks' layout, bit for bit. A mesh over several distinct devices
(slot blocks on separate cards, a halo exchange into the kernels,
migration between cards) is not ported;
``Simulation.enable_spatial_decomposition`` refuses one.

The reference's ``particle_sharding`` returns a JAX ``NamedSharding`` and
``shard_state`` places arrays on one; neither has a counterpart here.
"""

from __future__ import annotations

import torch

from ..utils import frozen_dataclass

__all__ = ["Mesh", "make_mesh"]


@frozen_dataclass
class Mesh:
    """``devices``: one ``torch.device`` per block, in block order."""

    devices: tuple

    @property
    def shape(self) -> dict:
        """``{"d": number of blocks}``, as the reference reads ``mesh.shape["d"]``."""
        return {"d": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def same_device(a, b) -> bool:
    """Whether two devices name the same one (``"cuda"`` is ``"cuda:0"``)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh of one block per device, or of ``n_devices`` blocks on one.

    Without ``device``, as the reference takes ``jax.devices()[:n]``: one
    block on each of the first ``n_devices`` CUDA devices (every one by
    default); it raises without CUDA, as ``Simulation()`` does, and when
    fewer devices are present. With ``device``, ``n_devices`` blocks all on
    that device (``n_devices`` is then required).
    """
    if device is not None:
        if n_devices is None:
            raise ValueError("make_mesh(device=...) puts every block on one device: "
                             "pass n_devices, the number of blocks")
        if n_devices < 1:
            raise ValueError(f"a mesh needs at least one block, got {n_devices}")
        return Mesh(devices=(torch.device(device),) * int(n_devices))
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
    return Mesh(devices=tuple(torch.device("cuda", i) for i in range(n)))
