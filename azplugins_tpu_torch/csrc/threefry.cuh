// Threefry-2x32 and the mantissa-fill uniform, as device functions.
//
// The rounds are core/rng.py::threefry2x32's (random123's schedule, Salmon
// et al., SC'11): rotations 13, 15, 26, 6, 17, 29, 16, 24; a key injection
// after every 4th round, never after a trailing partial group. The counter
// words are read modulo 2**32, as the plain version masks them, so an
// int32 tag of -1 hashes as 0xFFFFFFFF. Included by cell_dpd_force.cu (13
// rounds) and threefry.cu (20 rounds).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace az {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Both output words of Threefry-2x32 at ROUNDS rounds under the key (k0, k1)
// on the counters (c0, c1).
template <int ROUNDS>
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    x0 += x1;
    x1 = rotl32(x1, rot[i % 8]) ^ x0;
    if (i % 4 == 3) {
      const int inject = i / 4 + 1;
      x0 += ks[inject % 3];
      x1 += ks[(inject + 1) % 3] + (uint32_t)inject;
    }
  }
  return make_uint2(x0, x1);
}

// The key's timestep word (core/rng.py::_step_word): the host's k1, or with
// a device clock (a 0-d int64 on the card, core/rng.py::device_clock) the
// low 32 bits of clock + offset, so a CUDA graph keys each replay on the
// timestep the clock holds then. The same bits as the host's word.
__device__ __forceinline__ uint32_t step_word(uint32_t k1, const long long* clock, int offset) {
  return clock != nullptr ? (uint32_t)(__ldg(clock) + (long long)offset) : k1;
}

// core/rng.py::uniform_from_bits: 23 mantissa bits under exponent 0 give
// [1, 2); then -1, x width, + low, each rounded on its own (no contraction),
// as the plain version's three eager operations. width and low are the
// float32 of what the caller forms in double: high - low, and low.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits, float width, float low) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u);
  return __fadd_rn(__fmul_rn(__fsub_rn(u, 1.0f), width), low);
}

}  // namespace az
