// Counter-based random draws: Threefry-2x32-20 per particle (K4) and
// jax.random.normal's partitionable Threefry with XLA's float32 ErfInv (K5).
//
// No pallas_call is replaced: the reference draws both as plain jnp code
// that XLA fuses into its compiled step (azplugins_tpu/core/rng.py::
// particle_bits and particle_uniform3; jax.random.normal at
// azplugins_tpu/mpcd.py:314, 323). PyTorch runs the same draw eagerly as
// ~175-215 small operations (core/rng.py, the plain versions), so each of
// these kernels stands in for that many launches.
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
// K5 az_jax_normal: one thread an element i < n of the row-major shape.
// It hashes the counters (0, i) under the key, takes x0 ^ x1, fills the
// mantissa, maps to (nextafter(-1, 0), 1) with clamp_min and applies XLA's
// ErfInv polynomial (core/rng.py::xla_erfinv), times sqrt(2).
//
// Bits: integer hashing is exact, and every float operation is explicitly
// rounded on its own (__fmul_rn, __fadd_rn, __fsqrt_rn), in the plain
// version's order, with its float32 constants passed from the host
// (ops/rng_kernel.py), so the words and uniforms are bitwise the plain
// version's; the normals also depend on log1pf against PyTorch's CUDA
// log1p (measured in chip_smoke.py's [rng] phase).
//
// What bounds them on an H100: the operations, narrowly. A Threefry of 20
// rounds needs 60 32-bit operations (an add, a funnel shift and a xor a
// round; IADD3 fuses the key injections into the adds), 40 of them on the
// ALU pipe, which has half the lanes of the FMA pipe the adds and the float
// work issue to. A particle's uniform3 hashes twice and moves 16 bytes (a
// tag in, three floats out): at 3.35 TB/s its bytes take about as long as
// its ALU work. A normal hashes once and moves 4 bytes: its ~93 issued
// operations take about twice its bytes' time. What the design does about
// it: the key, the constants and the counter stay in registers and the
// kernel's parameter bank, each thread reads its tag once, and the words
// leave in rows, so a warp writes contiguous bytes. At the path's sizes
// (2e4-8e5 threads) a call lasts a few microseconds, near the launch's own
// cost: the gain is the ~200 launches a draw it replaces.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 20;  // jax.random's count (core/rng.py's default)

// XLA's ErfInv coefficients, highest degree first, for w < 5 and w >= 5:
// the float32 of core/rng.py's _ERFINV_LT5 and _ERFINV_GE5
struct ErfinvCoeffs {
  float lt[9], ge[9];
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
__device__ __forceinline__ float xla_erfinv(float x, const ErfinvCoeffs& c) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? c.lt[0] : c.ge[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) p = __fadd_rn(lt ? c.lt[k] : c.ge[k], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, FLT_MAX) : __fmul_rn(p, x);
}

__global__ void __launch_bounds__(kThreads)
    jax_normal_kernel(long long n, uint32_t k0, uint32_t k1, float width, float lo, float sqrt2,
                      ErfinvCoeffs coeffs, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint2 x = az::threefry2x32<kRounds>(k0, k1, 0u, (uint32_t)i);
  const float f = __fsub_rn(__uint_as_float(((x.x ^ x.y) >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, width), lo), lo);  // clamp_min
  out[i] = __fmul_rn(sqrt2, xla_erfinv(u, coeffs));
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

// K5: `out` is float32 [n]; `coeffs` is a host array of 18 floats (the
// w < 5 polynomial, then the w >= 5 one), passed to the kernel by value.
int az_jax_normal(long long n, uint32_t k0, uint32_t k1, float width, float lo, float sqrt2,
                  const float* coeffs, float* out, void* stream) {
  if (n <= 0 || n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  ErfinvCoeffs c;
  for (int k = 0; k < 9; ++k) {
    c.lt[k] = coeffs[k];
    c.ge[k] = coeffs[9 + k];
  }
  jax_normal_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, k0, k1, width, lo, sqrt2, c, out);
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
