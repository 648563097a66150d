// Counter-based random draws: Threefry-2x32-20 per particle (K4) and
// jax.random.normal's partitionable Threefry with XLA's float32 ErfInv,
// with the MPCD collision's unit axes (K5).
//
// No pallas_call is replaced: the reference draws both as plain jnp code
// that XLA fuses into its compiled step (azplugins_tpu/core/rng.py::
// particle_bits and particle_uniform3; jax.random.normal and the axis's
// normalisation at azplugins_tpu/mpcd.py:314, 323-326). PyTorch runs the
// same work eagerly as ~175-215 small operations a draw (core/rng.py, the
// plain versions), so each of these kernels stands in for that many
// launches. The evaporator's pick, on K4's words, is csrc/pick.cu.
//
// K4 az_particle_bits / az_particle_uniform3: one thread a tag. The key
// (k0, k1) = ((stream << 16) ^ seed, timestep) is formed on the host
// (core/rng.py::_key_words) and passed by value, or its timestep word read
// from a clock on the card (az::step_word: a CUDA graph's replays then key
// on the clock's timestep); the counters are (tag as
// uint32, lane) for lanes 0..ceil(n_words/2)-1. "words" writes n_words
// words of 32 bits as int64 rows [n_words, n] (the plain version's dtype);
// "uniform3" writes the words of lanes 0 (both) and 1 (the first) as three
// float32 uniforms [n, 3] in [low, high).
//
// K5 az_jax_normal_axis: one thread a row of 3 consecutive elements (a
// cell's row of the collision's [C, 3]). Element i hashes the counters
// (0, i) under the key, takes x0 ^ x1, fills the mantissa, maps to
// (nextafter(-1, 0), 1) with clamp_min and applies XLA's ErfInv polynomial
// (core/rng.py::xla_erfinv), times sqrt(2); the row is then divided by its
// norm clamped at 1e-12, as mpcd.py's SRD._collide needs its axis
// (core/rng.py::_jax_normal_axis_plain). With a second key the same thread
// also draws a row of plain normals (the virtual-particle fill of a
// collision between plates), so a collision makes one launch.
//
// Bits: integer hashing is exact, and every float operation is explicitly
// rounded on its own (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), in the
// plain version's order, with its float32 constants passed from the host
// (ops/rng_kernel.py), so the words and uniforms are bitwise the plain
// version's; the normals also depend on log1pf against PyTorch's CUDA
// log1p (measured in chip_smoke.py's [rng] phase). The squared norm is
// torch.sum's order over 3 on the card, (x0^2 + x2^2) + x1^2: its reduce
// puts two threads on a row of 3, the first summing elements 0 and 2.
//
// What bounds them on an H100: the operations, narrowly. A Threefry of 20
// rounds needs 60 32-bit operations (an add, a funnel shift and a xor a
// round; IADD3 fuses the key injections into the adds), 40 of them on the
// ALU pipe, which has half the lanes of the FMA pipe the adds and the float
// work issue to. A particle's uniform3 hashes twice and moves 16 bytes (a
// tag in, three floats out): at 3.35 TB/s its bytes take about as long as
// its ALU work. A normal hashes once and moves 4 bytes: its operations take
// about twice its bytes' time. K5's three (or six) Threefry chains a
// thread are independent, so they are in flight together, and ErfInv's
// rare w >= 5 tail is a branch, not 9 selects and a square root on every
// lane. Staging the rows through shared memory for 16-byte stores on a
// one-wave grid was measured no faster on an H100 (PERF.md, section 6).

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 20;  // jax.random's count (core/rng.py's default)

// XLA's ErfInv coefficients, highest degree first, for w < 5 and w >= 5
// (the float32 of core/rng.py's _ERFINV_LT5 and _ERFINV_GE5), and the
// normal's other float32 constants
struct NormalArgs {
  float lt[9], ge[9];
  float width, lo, sqrt2;
};

__global__ void __launch_bounds__(kThreads)
    particle_bits_kernel(const int* __restrict__ tag, int n, int n_words, uint32_t k0,
                         uint32_t host_k1, const long long* __restrict__ clock, int offset,
                         long long* __restrict__ words) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k1 = az::step_word(host_k1, clock, offset);
  const uint32_t c0 = (uint32_t)__ldg(tag + i);
  for (int w = 0; w < n_words; w += 2) {
    const uint2 x = az::threefry2x32<kRounds>(k0, k1, c0, (uint32_t)(w / 2));
    words[(long long)w * n + i] = x.x;
    if (w + 1 < n_words) words[(long long)(w + 1) * n + i] = x.y;
  }
}

__global__ void __launch_bounds__(kThreads)
    particle_uniform3_kernel(const int* __restrict__ tag, int n, uint32_t k0, uint32_t host_k1,
                             const long long* __restrict__ clock, int offset, float width,
                             float low, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k1 = az::step_word(host_k1, clock, offset);
  const uint32_t c0 = (uint32_t)__ldg(tag + i);
  const uint2 a = az::threefry2x32<kRounds>(k0, k1, c0, 0u);
  const uint2 b = az::threefry2x32<kRounds>(k0, k1, c0, 1u);
  out[3 * (long long)i] = az::uniform_from_bits(a.x, width, low);
  out[3 * (long long)i + 1] = az::uniform_from_bits(a.y, width, low);
  out[3 * (long long)i + 2] = az::uniform_from_bits(b.x, width, low);
}

// core/rng.py::xla_erfinv, one operation at a time: w = -log1p(-x^2); below
// 5, w - 2.5, else sqrt(w) - 3; Horner's c + p w with two roundings a step.
// The tail (w >= 5, or NaN) is a branch: almost no lane takes it.
__device__ __forceinline__ float xla_erfinv(float x, const NormalArgs& c) {
  float w = -log1pf(-__fmul_rn(x, x));
  float p;
  if (w < 5.0f) {
    w = __fsub_rn(w, 2.5f);
    p = c.lt[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) p = __fadd_rn(c.lt[k], __fmul_rn(p, w));
  } else {
    w = __fsub_rn(__fsqrt_rn(w), 3.0f);
    p = c.ge[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) p = __fadd_rn(c.ge[k], __fmul_rn(p, w));
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, FLT_MAX) : __fmul_rn(p, x);
}

// the normal of one hashed pair: its word x0 ^ x1 as a uniform in
// (nextafter(-1, 0), 1), clamp_min'ed, through ErfInv, times sqrt(2)
__device__ __forceinline__ float normal_of(uint2 x, const NormalArgs& c) {
  const float f = __fsub_rn(__uint_as_float(((x.x ^ x.y) >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, c.width), c.lo), c.lo);  // clamp_min
  return __fmul_rn(c.sqrt2, xla_erfinv(u, c));
}

// torch.clamp_min(x, lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// Row r of `rows`: the unit row of the normals under (k0, k1) at elements
// 3r..3r+2 into axis; with TWO, the plain normals under (k0b, k1b) at the
// same elements into normals.
template <bool TWO>
__global__ void __launch_bounds__(kThreads)
    jax_normal_axis_kernel(unsigned rows, uint32_t k0, uint32_t k1, uint32_t k0b, uint32_t k1b,
                           NormalArgs c, float* __restrict__ axis, float* __restrict__ normals) {
  const unsigned r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const uint32_t i = 3u * r;  // the row's first element (3 rows < 2**32)
  uint2 h[3], g[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) h[j] = az::threefry2x32<kRounds>(k0, k1, 0u, i + j);
  if constexpr (TWO) {
#pragma unroll
    for (int j = 0; j < 3; ++j) g[j] = az::threefry2x32<kRounds>(k0b, k1b, 0u, i + j);
  }
  float v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = normal_of(h[j], c);
  // axis / clamp_min(sqrt(sum(axis * axis, dim=1)), 1e-12), the sum in the
  // card's order over 3
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[2], v[2])),
                            __fmul_rn(v[1], v[1]));
  const float norm = clamp_min(__fsqrt_rn(s), 1e-12f);
#pragma unroll
  for (int j = 0; j < 3; ++j) axis[i + j] = __fdiv_rn(v[j], norm);
  if constexpr (TWO) {
#pragma unroll
    for (int j = 0; j < 3; ++j) normals[i + j] = normal_of(g[j], c);
  }
}

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each entry point launches its kernel on `stream` and returns the CUDA
// error (0 = launched). n > 0; the wrapper launches nothing for n = 0.
// K4's `clock` is null (the key's timestep word is k1) or a device int64,
// the word then (uint32)(*clock + offset) (az::step_word).

// K4, words: `words` is int64 [n_words, n], row w the w-th word of each tag.
int az_particle_bits(const int* tag, int n, int n_words, uint32_t k0, uint32_t k1,
                     const long long* clock, int offset, long long* words, void* stream) {
  if (n <= 0 || n_words <= 0) return (int)cudaErrorInvalidValue;
  particle_bits_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, n, n_words, k0, k1, clock, offset, words);
  return (int)cudaGetLastError();
}

// K4, uniform3: `out` is float32 [n, 3]; width = float32(high - low).
int az_particle_uniform3(const int* tag, int n, uint32_t k0, uint32_t k1, const long long* clock,
                         int offset, float width, float low, float* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  particle_uniform3_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, n, k0, k1, clock, offset, width, low, out);
  return (int)cudaGetLastError();
}

// K5: `axis` float32 [rows, 3], the unit rows of the normals under
// (k0, k1); with `two`, also `normals` float32 [rows, 3], the normals under
// (k0b, k1b), in the same launch. `coeffs` is a host array of 18 floats
// (the w < 5 polynomial, then the w >= 5 one), passed by value.
int az_jax_normal_axis(long long rows, uint32_t k0, uint32_t k1, uint32_t k0b, uint32_t k1b,
                       int two, float width, float lo, float sqrt2, const float* coeffs,
                       float* axis, float* normals, void* stream) {
  if (rows <= 0 || 3 * rows >= (1LL << 32) || (two && normals == nullptr))
    return (int)cudaErrorInvalidValue;
  NormalArgs c;
  for (int k = 0; k < 9; ++k) {
    c.lt[k] = coeffs[k];
    c.ge[k] = coeffs[9 + k];
  }
  c.width = width;
  c.lo = lo;
  c.sqrt2 = sqrt2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two)
    jax_normal_axis_kernel<true><<<blocks(rows), kThreads, 0, s>>>(
        (unsigned)rows, k0, k1, k0b, k1b, c, axis, normals);
  else
    jax_normal_axis_kernel<false><<<blocks(rows), kThreads, 0, s>>>(
        (unsigned)rows, k0, k1, 0u, 0u, c, axis, nullptr);
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
