"""K1, the pair force kernel (``csrc/cell_pair_force.cu``,
``cell_pair_force_kernel``): the least time the card could take for one
call. Copied from ``chip_smoke.py``: ``OPS_PER_PAIR`` (lines 480-483) and
``_bound`` (lines 690-701), with the inputs' sizes as the harness passes
them: 16 bytes read for each occupied slot (position and type), the 4-byte
tag of every slot and 12 bytes of force written to every slot, the
coefficient table once; the pair operations for the unordered pairs inside
the cutoff (the force path counts each pair once a side in its sums, as
``OPS_PER_PAIR`` states)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

_peaks = importlib.util.spec_from_file_location("portbench_roofline_peaks",
                                                Path(__file__).with_name("peaks.py"))
peaks = importlib.util.module_from_spec(_peaks)
_peaks.loader.exec_module(peaks)

# operations of one pair evaluation on the force path, each exp, sqrt,
# divide, pow and log as one: the evaluator, plus the geometry and the
# accumulation (3 subtractions and 5 operations for the separation and its
# square, the compare, 3 products and 3 additions into each member's sums: 18)
OPS_PER_PAIR = {
    "PerturbedLennardJones": 29, "LJ": 27, "Colloid": 33, "ExpandedYukawa": 31,
    "Hertz": 31, "Morse": 32, "Gaussian": 23, "Yukawa": 28, "DPD": 130, "TwoPatchMorse": 170,
}
# rows of the kernel's coefficient table a type pair: r_cut^2, the energy
# offset, the switch radius^2 and the potential's own parameters
TABLE_ROWS = {"PerturbedLennardJones": 8}
IN_BYTES, OUT_BYTES, TAG_BYTES = 16, 12, 4


def bound_s(potential: str, n_occupied: int, n_slots: int, n_types: int, pairs: int) -> float:
    """The larger of the bytes over the memory rate and the pair operations
    over the float32 rate, in seconds, for one call."""
    table = 4 * TABLE_ROWS[potential] * n_types * n_types
    t_bytes = (n_occupied * IN_BYTES + n_slots * (TAG_BYTES + OUT_BYTES) + table) \
        / peaks.MEM_BYTES_PER_S
    t_ops = pairs * OPS_PER_PAIR[potential] / peaks.F32_OPS_PER_S
    return max(t_bytes, t_ops)
