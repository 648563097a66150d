"""K7+K6 (``drift_kernel``: the first half step and the drift check in one
launch) and K8 (``step2_kernel``: the second half step, the Langevin draw
inside) of ``csrc/integrate.cu``: the least time for one call. Copied from
``chip_smoke.py``: ``INTEGRATE_F32_OPS`` (lines 436-439), ``_integrate_bound``
(lines 1902-1914), ``_step2_bytes`` (lines 2232-2236) and the bytes of K7+K6
(``52 n + 24 n_act``, line 2177); n is the layout's slots, n_act the
occupied ones."""

from __future__ import annotations

import importlib.util
from pathlib import Path

_peaks = importlib.util.spec_from_file_location("portbench_roofline_peaks",
                                                Path(__file__).with_name("peaks.py"))
peaks = importlib.util.module_from_spec(_peaks)
_peaks.loader.exec_module(peaks)

# float32 operations an acting slot: K7+K6 K7's 12 and K6's 8; K8's Langevin
# form 40, 3 more for the flow's relative velocity
F32_OPS = {"step1_drift": 20, "step2": 40, "step2[flow]": 43}


def bound(bytes_moved: float, n_act: int, f32_ops: int, hashes: int = 0) -> float:
    """Seconds: the larger of the bytes' time and the operations' (the
    largest of the ALU pipe's, the issue slots' and the float32 rate's) for
    ``n_act`` slots of ``f32_ops`` float32 operations and ``hashes``
    Threefry-2x32-20 calls with their uniforms' 6 integer operations."""
    alu = hashes * (20 * peaks.THREEFRY_ROUND_ALU + 3)
    issued = hashes * (20 * peaks.THREEFRY_ROUND_OPS + 3) + f32_ops
    t_bytes = bytes_moved / peaks.MEM_BYTES_PER_S
    t_ops = n_act * max(alu / peaks.ALU_OPS_PER_S, issued / peaks.ISSUE_OPS_PER_S,
                        f32_ops / peaks.F32_OPS_PER_S)
    return max(t_bytes, t_ops)


def step2_bytes(n: int, n_act: int, langevin: bool = True, flow: bool = False) -> int:
    """Tag, v in, v' and a' out on every slot; force, mass (and type, for
    Langevin; flow where given) on a moving slot; the old acceleration on a
    masked one."""
    return 40 * n + (20 if langevin else 16) * n_act + 12 * (n - n_act) + 12 * n_act * flow


def step1_drift_s(n: int, n_act: int) -> float:
    return bound(52 * n + 24 * n_act, n_act, F32_OPS["step1_drift"])


def step2_s(n: int, n_act: int, flow: bool) -> float:
    ops = F32_OPS["step2[flow]" if flow else "step2"]
    return bound(step2_bytes(n, n_act, flow=flow), n_act, ops, hashes=2)
