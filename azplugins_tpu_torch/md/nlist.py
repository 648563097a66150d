"""User-facing neighbor list configuration.

Mirrors ``hoomd.md.nlist.Cell(buffer)`` consumed by the reference tests
(reference ``src/pytest/test_pair.py:337``). One ``Cell`` object may be
shared by several pair potentials; the Simulation sizes the cell grid from
the max r_cut across its consumers (ops/dense.py does the actual work).
"""

from __future__ import annotations

__all__ = ["Cell"]


class Cell:
    """Cell-list backed Verlet neighbor list.

    Args:
        buffer: Verlet skin distance. Larger values rebuild less often but
            evaluate more out-of-range pairs per step.
    """

    def __init__(self, buffer: float):
        if buffer < 0:
            raise ValueError("buffer must be non-negative")
        self.buffer = float(buffer)
        # filled at attach time
        self._spec = None
        self._data = None

    def __repr__(self):
        return f"Cell(buffer={self.buffer})"
