"""Writers: periodic output driven by the run loop.

Port of ``azplugins_tpu/write.py``, the HOOMD writer/logging layer
(loggable quantities via ``@hoomd.logging.log``): a ``Logger`` names
quantities pulled from attached operations, ``Table`` prints them on a
trigger, ``Trajectory`` appends aztraj frames (io/aztraj.py) and ``GSD``
hoomd-schema GSD frames (io/gsd.py).

Writers run on the host: ``Simulation.run`` ends a chunk at the next
timestep a writer's trigger names and fires the writers after the chunk is
accepted (never after a replayed one), so device state is read at a fire
and the chunks in between keep their one host synchronisation. The chunk
split leaves the trajectory unchanged: the rebuild schedule is absolute.
"""

from __future__ import annotations

import sys


from .io import TrajectoryWriter, snapshot_to_chunks
from .md.trigger import Periodic, Trigger, as_trigger

__all__ = ["GSD", "Logger", "Table", "Trajectory", "Writer"]


def _next_fire(trigger: Trigger, t: int) -> int | None:
    """Smallest timestep >= t at which the trigger fires (host-side)."""
    if isinstance(trigger, Periodic):
        return t + (trigger.phase - t) % trigger.period
    nf = getattr(trigger, "next_fire", None)
    if callable(nf):
        return nf(t)
    # generic fallback: probe a bounded window
    for s in range(t, t + 100_000):
        if bool(trigger(s)):
            return s
    return None


class Logger:
    """Named quantities pulled from operations at write time.

    ``logger.add(obj, ["kinetic_temperature"])`` registers attributes;
    ``logger["label"] = callable`` registers custom quantities.
    """

    def __init__(self):
        self._items: dict[str, object] = {}

    def add(self, obj, quantities: list[str] | None = None, prefix: str | None = None):
        """Register quantities of ``obj``.

        With ``quantities=None``, every loggable registered via
        ``azplugins_tpu_torch.logging.log`` with ``default=True`` is added
        (hoomd.logging.Logger.add parity).
        """
        from .logging import loggables

        prefix = prefix if prefix is not None else type(obj).__name__
        if quantities is None:
            quantities = [
                name for name, meta in loggables(obj).items() if meta["default"]
            ]
            if not quantities:
                raise ValueError(
                    f"{type(obj).__name__} exposes no default loggable quantities"
                )
        for q in quantities:
            if not hasattr(type(obj), q) and not hasattr(obj, q):
                raise AttributeError(f"{type(obj).__name__} has no quantity {q!r}")
            self._items[f"{prefix}.{q}"] = (obj, q)

    def __setitem__(self, label: str, fn):
        if not callable(fn):
            raise TypeError("custom quantities must be callable")
        self._items[str(label)] = fn

    def labels(self) -> list[str]:
        return list(self._items)

    def sample(self) -> dict[str, object]:
        out = {}
        for label, item in self._items.items():
            if callable(item):
                out[label] = item()
            else:
                obj, q = item
                out[label] = getattr(obj, q)
        return out


class Writer:
    """Base: subclasses implement ``write(sim, timestep)``."""

    def __init__(self, trigger):
        self.trigger = as_trigger(trigger)

    def _attach(self, sim):
        pass

    def write(self, sim, timestep: int):  # pragma: no cover - interface
        raise NotImplementedError

    def close(self):
        pass


class Table(Writer):
    """Delimited text output of logged quantities (hoomd.write.Table parity)."""

    def __init__(self, trigger, logger: Logger, output=None, delimiter: str = " "):
        super().__init__(trigger)
        self.logger = logger
        self.delimiter = delimiter
        self._own_file = isinstance(output, str)
        self._out = open(output, "w") if self._own_file else (output or sys.stdout)
        self._wrote_header = False

    def write(self, sim, timestep: int):
        row = self.logger.sample()
        if not self._wrote_header:
            self._out.write(self.delimiter.join(["timestep", *row.keys()]) + "\n")
            self._wrote_header = True
        vals = [str(timestep)]
        for v in row.values():
            vals.append(f"{v:.6g}" if isinstance(v, float) else str(v))
        self._out.write(self.delimiter.join(vals) + "\n")
        self._out.flush()

    def close(self):
        if self._own_file:
            self._out.close()


class Trajectory(Writer):
    """Append system frames to an aztraj file (hoomd.write.GSD analog).

    The first frame is complete (types, masses, bonds, ...); subsequent
    frames carry only the dynamic payload (positions, velocities, images,
    box) unless ``dynamic_only=False``.
    """

    def __init__(self, trigger, filename: str, mode: str = "w",
                 dynamic_only: bool = True):
        super().__init__(trigger)
        self.filename = str(filename)
        self._writer = TrajectoryWriter(self.filename, mode=mode)
        self._dynamic_only = bool(dynamic_only)
        self._wrote_complete = mode == "a"

    def write(self, sim, timestep: int):
        snap = sim.state.get_snapshot()
        dynamic = self._dynamic_only and self._wrote_complete
        self._writer.write_frame(
            int(timestep), snapshot_to_chunks(snap, dynamic_only=dynamic)
        )
        self._wrote_complete = True
        self._writer.flush()

    def close(self):
        self._writer.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


def _writer_next_fire(writers, t: int) -> int | None:
    pts = [p for p in (_next_fire(w.trigger, t) for w in writers) if p is not None]
    return min(pts) if pts else None


def _fire_writers(sim, writers, timestep: int):
    for w in writers:
        nf = _next_fire(w.trigger, timestep)
        if nf == timestep:
            w.write(sim, timestep)


class GSD(Writer):
    """Append hoomd-schema GSD frames (hoomd.write.GSD parity).

    The native container is aztraj (faster appends, CRC'd checkpoint
    grade); this writer targets HOOMD's ecosystem directly (azplugins
    users write trajectories via hoomd.write.GSD and analyze them with
    gsd/ovito/freud), so no conversion step is needed. Frame 0 is
    complete; later frames carry only the dynamic payload unless
    ``dynamic_only=False`` (readers fall back to frame 0 for omitted
    chunks, the hoomd convention).
    """

    def __init__(self, trigger, filename: str, mode: str = "w",
                 dynamic_only: bool = True):
        super().__init__(trigger)
        from .io.gsd import GSDWriter

        self.filename = str(filename)
        self._writer = GSDWriter(self.filename, mode=mode)
        self._dynamic_only = bool(dynamic_only)
        self._wrote_complete = mode == "a" and self._writer.nframes > 0

    def write(self, sim, timestep: int):
        from .io.gsd import _hoomd_frame_chunks

        snap = sim.state.get_snapshot()
        complete = not (self._dynamic_only and self._wrote_complete)
        chunks = snapshot_to_chunks(snap, dynamic_only=not complete)
        for name, data in _hoomd_frame_chunks(
            int(timestep), chunks, complete
        ).items():
            self._writer.write_chunk(name, data)
        self._writer.end_frame()
        self._wrote_complete = True

    def close(self):
        self._writer.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass
