"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit), copied from ``chip_smoke.py`` (``MEM_BYTES_PER_S``,
``F32_OPS_PER_S``, ``SM_CLOCKS_PER_S``, ``ALU_OPS_PER_S``,
``ISSUE_OPS_PER_S``, ``THREEFRY_ROUND_ALU``, lines 444-464)."""

# HBM3 bandwidth, and the float32 rate outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# integer work: 132 SMs at the 1.98 GHz boost clock; shifts and logic on the
# ALU pipe, 64 lanes an SM; every instruction an issue slot, 128 an SM
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_OPS_PER_S = 64 * SM_CLOCKS_PER_S
ISSUE_OPS_PER_S = 128 * SM_CLOCKS_PER_S
# a Threefry-2x32 round: an add, a rotate and a xor, two of them on the ALU pipe
THREEFRY_ROUND_ALU, THREEFRY_ROUND_OPS = 2, 3
