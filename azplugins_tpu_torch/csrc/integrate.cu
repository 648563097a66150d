// The step's integrator and its Verlet drift check: K6-K9.
//
// No pallas_call is replaced: the reference leaves these pieces to XLA,
// which fuses its jnp code into a few loops of the jitted step
// (azplugins_tpu/simulation.py:632-684). PyTorch runs the same code as
// eager operations, one launch each (md/methods.py, md/rotation.py and
// ops/dense.py keep them as the plain versions), so each kernel stands in
// for 8-330 launches a step.
//
// K6 az_drift_check (ops/dense.py::needs_rebin, drift_top_two and
// needs_rebin_of; reference azplugins_tpu/ops/dense.py:666-686): each
// slot's squared drift since the last rebuild (0 on empty slots), or a
// row of values, reduced to its two largest with ties counted (the
// largest twice when it occurs twice); NaN anywhere makes both NaN. The
// last block to finish (a counter in global memory, reset by that block)
// merges the blocks' pairs and writes them, or writes viol | (sqrt(m1) +
// sqrt(max(m2, 0)) > buffer), which is false for a NaN drift as in the
// plain version.
//
// K7 az_step1 (Method.step1, md/methods.py; reference
// azplugins_tpu/md/methods.py:68-77): v' = v + (dt/2) a, x' = x + dt v'.
//
// K8 az_step2 (Method.step2 and LangevinFlow.step2; reference
// azplugins_tpu/md/methods.py:79-91, 172-192): a' = F / m, or with a gamma
// table the Langevin force: the per-type gamma by the clamped type_id, the
// uniforms of K4 (Threefry-2x32-20 on (tag, lane) under the stream's key,
// threefry.cuh) times sqrt(6 gamma kT / dt), minus gamma (v - u) with u the
// flow velocity where one is given, then a' = (F + F_BD) / m; and
// v' = v + (dt/2) a'. Without noise the random force is +0 and the
// operations stay the same.
//
// K9 az_no_squish (md/rotation.py and Method._rot_step1, _rot_step2,
// LangevinFlow._rot_step2_langevin; reference azplugins_tpu/md/rotation.py:
// 89-146 and md/methods.py:94-115, 194-228): mode 0 kicks p with the stored
// torque and rotates freely (P3 P2 P1 P2 P3, q renormalised), mode 1 kicks
// p, mode 2 forms the body-frame Langevin torque (its LANGEVIN_ANGULAR draw
// inside), adds it to the torque in the lab frame, kicks p and writes the
// torque. Axes of inertia <= 1e-12 stay frozen.
//
// Every kernel takes the step's mask: tag >= 0, and a filter's bool where
// one is given. A masked slot keeps its old bits (the far sentinel
// positions of empty slots among them); the outputs are new arrays, so the
// State a method was given is never written.
//
// Bits: every float operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn, __frcp_rn), in the plain version's
// order, with the float32 scalars that PyTorch forms from the Python ones
// passed in (ops/integrate_kernel.py). On the card PyTorch divides a tensor
// by a Python scalar as a product with its reciprocal (formed in double,
// rounded to float32), so the kernels take that 1/dt. torch.sum over 4 on the card adds (x0 + x2) + (x1 + x3)
// after adding each to its +0 start (Reduce.cuh's block_x_reduce, offsets
// falling); sum4 does the same. cosf and sinf are the accurate ones that
// PyTorch's CUDA cos and sin call (nothing is built with fast math).
//
// What bounds them on an H100: the bytes. Each is one streaming pass over
// a slot's fields, and reads a field only on the slots whose result needs
// it: K6 the tag on every slot and the two positions (24 B) on an occupied
// one; K7 52 B a slot and the acceleration (12 B) on a moving one; K8
// (Langevin) 40 B a slot, the old acceleration (12 B) on a masked one and
// force, mass and type (20 B) on a moving one; K9 in mode 0 68 B a slot
// (tag, q and p in and out) and inertia and torque (24 B) on an acting
// one. A slot does a few dozen float operations (K8 and K9 add two
// Threefry hashes, K9 ten libm calls in mode 0): a few microseconds at the
// paths' 2e4-1e5 slots, near a launch's own cost. What the design does
// about it: one thread a slot reads each field once and writes each output
// once, the mask, the gamma lookup, the keys and the noise stay in
// registers, and K6 reduces in one launch (no second pass, no memset: the
// last block resets the counter). The gain is the launches each kernel
// replaces.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 20;            // the Langevin draws' Threefry rounds (K4's)
constexpr int kDriftPerThread = 4;     // slots a thread reduces, at least
constexpr int kDriftMaxBlocks = 1024;  // the partials' room (ops/integrate_kernel.py)
constexpr float kEps = 1e-12f;         // md/rotation.py's _EPS as float32

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (isnan(x) || x > lo) ? x : lo;
}

// ---------------------------------------------------------------------------
// K6: the drift check
// ---------------------------------------------------------------------------
struct Top2 {
  float m1, m2;  // m1 >= m2, or both NaN
};

__device__ __forceinline__ Top2 top2_of(float v) {
  return isnan(v) ? Top2{v, v} : Top2{v, -INFINITY};
}

// the two largest of two pairs' union, ties counted
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  if (isnan(a.m1)) return a;
  if (isnan(b.m1)) return b;
  return Top2{fmaxf(a.m1, b.m1), fmaxf(fminf(a.m1, b.m1), fmaxf(a.m2, b.m2))};
}

__device__ Top2 block_merge(Top2 t) {
  __shared__ Top2 warps[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o{__shfl_down_sync(0xffffffffu, t.m1, off), __shfl_down_sync(0xffffffffu, t.m2, off)};
    t = merge(t, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < kThreads / 32 ? warps[lane] : Top2{-INFINITY, -INFINITY};
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o{__shfl_down_sync(0xffffffffu, t.m1, off), __shfl_down_sync(0xffffffffu, t.m2, off)};
      t = merge(t, o);
    }
  }
  return t;  // thread 0's is the block's
}

// VALUES: reduce `values` (n floats); else the squared drift of each slot.
// Writes top2_out[0..1] when it is given, else viol_out = viol_in | exceeds.
template <bool VALUES>
__global__ void __launch_bounds__(kThreads)
    drift_kernel(const float* __restrict__ pos, const float* __restrict__ ref,
                 const int* __restrict__ tag, const float* __restrict__ values, int n, float buffer,
                 const bool* __restrict__ viol_in, bool* __restrict__ viol_out,
                 float* __restrict__ top2_out, float2* partials, unsigned int* counter) {
  Top2 t{-INFINITY, -INFINITY};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    float v = 0.0f;  // an empty slot's, read from its tag alone
    if (VALUES) {
      v = values[i];
    } else if (tag[i] >= 0) {
      const float d0 = sub(pos[3 * i], ref[3 * i]);
      const float d1 = sub(pos[3 * i + 1], ref[3 * i + 1]);
      const float d2 = sub(pos[3 * i + 2], ref[3 * i + 2]);
      v = add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
    }
    t = merge(t, top2_of(v));
  }
  t = block_merge(t);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = make_float2(t.m1, t.m2);
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  t = Top2{-INFINITY, -INFINITY};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    const volatile float2* p = partials + b;
    t = merge(t, Top2{p->x, p->y});
  }
  t = block_merge(t);
  if (threadIdx.x == 0) {
    if (top2_out != nullptr) {
      top2_out[0] = t.m1;
      top2_out[1] = t.m2;
    } else {
      const bool exceeds = add(__fsqrt_rn(t.m1), __fsqrt_rn(clamp_min(t.m2, 0.0f))) > buffer;
      *viol_out = *viol_in || exceeds;
    }
    *counter = 0u;
  }
}

// ---------------------------------------------------------------------------
// K7 and K8: the translational half steps
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool acts(const int* tag, const bool* sel, int i) {
  return __ldg(tag + i) >= 0 && (sel == nullptr || sel[i]);
}

__global__ void __launch_bounds__(kThreads)
    step1_kernel(const int* __restrict__ tag, const bool* __restrict__ sel,
                 const float* __restrict__ x, const float* __restrict__ v,
                 const float* __restrict__ a, int n, float half_dt, float dt,
                 float* __restrict__ x_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool m = acts(tag, sel, i);
#pragma unroll
  for (int k = 3 * i; k < 3 * i + 3; ++k) {
    if (m) {
      const float vh = add(v[k], mul(half_dt, a[k]));
      v_out[k] = vh;
      x_out[k] = add(x[k], mul(dt, vh));
    } else {
      v_out[k] = v[k];
      x_out[k] = x[k];
    }
  }
}

// The three uniforms of K4 for one tag: lanes 0 (both words) and 1 (the first)
__device__ __forceinline__ void uniform3(uint32_t k0, uint32_t k1, int tag, float width, float low,
                                         float u[3]) {
  const uint2 w0 = az::threefry2x32<kRounds>(k0, k1, (uint32_t)tag, 0u);
  const uint2 w1 = az::threefry2x32<kRounds>(k0, k1, (uint32_t)tag, 1u);
  u[0] = az::uniform_from_bits(w0.x, width, low);
  u[1] = az::uniform_from_bits(w0.y, width, low);
  u[2] = az::uniform_from_bits(w1.x, width, low);
}

// The Langevin noise's scale: sqrt(6.0 * g * kT / dt), dt's division a
// product with its float32 reciprocal
__device__ __forceinline__ float noise_scale(float g, float kT, float inv_dt) {
  return __fsqrt_rn(mul(mul(mul(g, 6.0f), kT), inv_dt));
}

struct Noise {
  const float* table;  // [T] gamma by type, or null (no Langevin force)
  int n_types;
  int noisy;           // 0: the random force is +0
  uint32_t k0, k1;     // the stream's key (core/rng.py::_key_words)
  float width, low;    // the uniforms' float32 width and low end
  float kT, inv_dt;    // float32 kT and 1/dt
};

__device__ __forceinline__ float gamma_of(const Noise& nz, const int* type_id, int i) {
  const int t = min(max(__ldg(type_id + i), 0), nz.n_types - 1);
  return __ldg(nz.table + t);
}

__global__ void __launch_bounds__(kThreads)
    step2_kernel(const int* __restrict__ tag, const bool* __restrict__ sel,
                 const int* __restrict__ type_id, const float* __restrict__ v,
                 const float* __restrict__ a, const float* __restrict__ force,
                 const float* __restrict__ mass, const float* __restrict__ flow, int n,
                 float half_dt, Noise nz, float* __restrict__ v_out, float* __restrict__ a_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (!acts(tag, sel, i)) {
#pragma unroll
    for (int k = 3 * i; k < 3 * i + 3; ++k) {
      v_out[k] = v[k];
      a_out[k] = a[k];
    }
    return;
  }
  const float m = mass[i];
  float bd[3] = {0.0f, 0.0f, 0.0f};
  const bool langevin = nz.table != nullptr;
  if (langevin) {
    const float g = gamma_of(nz, type_id, i);
    float rand[3] = {0.0f, 0.0f, 0.0f};
    if (nz.noisy) {
      float u[3];
      uniform3(nz.k0, nz.k1, tag[i], nz.width, nz.low, u);
      const float c = noise_scale(g, nz.kT, nz.inv_dt);
#pragma unroll
      for (int k = 0; k < 3; ++k) rand[k] = mul(c, u[k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float rel = flow != nullptr ? sub(v[3 * i + k], flow[3 * i + k]) : v[3 * i + k];
      bd[k] = sub(rand[k], mul(g, rel));
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f = force[3 * i + k];
    const float acc = __fdiv_rn(langevin ? add(f, bd[k]) : f, m);
    a_out[3 * i + k] = acc;
    v_out[3 * i + k] = add(v[3 * i + k], mul(half_dt, acc));
  }
}

// ---------------------------------------------------------------------------
// K9: NO_SQUISH (md/rotation.py, one operation at a time)
// ---------------------------------------------------------------------------
struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x))};
}

// utils/quaternion.py::_rotate: t = 2 u x v; v + w t + u x t
__device__ __forceinline__ V3 rotate_wu(float w, V3 u, V3 v) {
  V3 t = cross(u, v);
  t = V3{mul(t.x, 2.0f), mul(t.y, 2.0f), mul(t.z, 2.0f)};
  const V3 c = cross(u, t);
  return V3{add(add(v.x, mul(w, t.x)), c.x), add(add(v.y, mul(w, t.y)), c.y),
            add(add(v.z, mul(w, t.z)), c.z)};
}

__device__ __forceinline__ V3 rotate(Q4 q, V3 v) { return rotate_wu(q.w, V3{q.x, q.y, q.z}, v); }

__device__ __forceinline__ V3 rotate_inv(Q4 q, V3 v) {
  return rotate_wu(q.w, V3{-q.x, -q.y, -q.z}, v);
}

// a * (0, v)
__device__ __forceinline__ Q4 mul_vec(Q4 a, V3 v) {
  return Q4{sub(sub(mul(-a.x, v.x), mul(a.y, v.y)), mul(a.z, v.z)),
            sub(add(mul(a.w, v.x), mul(a.y, v.z)), mul(a.z, v.y)),
            add(sub(mul(a.w, v.y), mul(a.x, v.z)), mul(a.z, v.x)),
            sub(add(mul(a.w, v.z), mul(a.x, v.y)), mul(a.y, v.x))};
}

// torch.sum over the last axis of 4 on the card: each value added to the
// +0 start (-0 becomes +0), then (x0 + x2) + (x1 + x3)
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  a = add(a, 0.0f);
  b = add(b, 0.0f);
  c = add(c, 0.0f);
  d = add(d, 0.0f);
  return add(add(a, c), add(b, d));
}

__device__ __forceinline__ float dot4(Q4 a, Q4 b) {
  return sum4(mul(a.w, b.w), mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}

// the half-step kick p + dt q (0, t_body), frozen axes' torque dropped
__device__ __forceinline__ Q4 angmom_kick(Q4 q, Q4 p, V3 torque, V3 inertia, float dt) {
  V3 tb = rotate_inv(q, torque);
  tb = V3{inertia.x > kEps ? tb.x : 0.0f, inertia.y > kEps ? tb.y : 0.0f,
          inertia.z > kEps ? tb.z : 0.0f};
  const Q4 mv = mul_vec(q, tb);
  return Q4{add(p.w, mul(mv.w, dt)), add(p.x, mul(mv.x, dt)), add(p.y, mul(mv.y, dt)),
            add(p.z, mul(mv.z, dt))};
}

// the permutations P1, P2, P3 on (w, x, y, z)
__device__ __forceinline__ Q4 perm(int k, Q4 a) {
  if (k == 1) return Q4{-a.x, a.w, a.z, -a.y};
  if (k == 2) return Q4{-a.y, -a.z, a.w, a.x};
  return Q4{-a.z, a.y, -a.x, a.w};
}

// one axis rotation by dt_k * p.(P_k q) / (4 I_k)
__device__ __forceinline__ void axis_rotation(Q4& q, Q4& p, float inertia_k, int k, float dt_k) {
  if (!(inertia_k > kEps)) return;
  const Q4 qk = perm(k, q), pk = perm(k, p);
  const float inv_i = __frcp_rn(clamp_min(inertia_k, kEps));
  const float phi = mul(mul(inv_i, 0.25f), dot4(p, qk));
  const float ang = mul(phi, dt_k);
  const float c = cosf(ang), s = sinf(ang);
  q = Q4{add(mul(c, q.w), mul(s, qk.w)), add(mul(c, q.x), mul(s, qk.x)),
         add(mul(c, q.y), mul(s, qk.y)), add(mul(c, q.z), mul(s, qk.z))};
  p = Q4{add(mul(c, p.w), mul(s, pk.w)), add(mul(c, p.x), mul(s, pk.x)),
         add(mul(c, p.y), mul(s, pk.y)), add(mul(c, p.z), mul(s, pk.z))};
}

__device__ __forceinline__ void free_rotation(Q4& q, Q4& p, V3 inertia, float dt, float half_dt) {
  axis_rotation(q, p, inertia.z, 3, half_dt);
  axis_rotation(q, p, inertia.y, 2, half_dt);
  axis_rotation(q, p, inertia.x, 1, dt);
  axis_rotation(q, p, inertia.y, 2, half_dt);
  axis_rotation(q, p, inertia.z, 3, half_dt);
  const float norm = __fsqrt_rn(clamp_min(dot4(q, q), kEps));
  q = Q4{__fdiv_rn(q.w, norm), __fdiv_rn(q.x, norm), __fdiv_rn(q.y, norm), __fdiv_rn(q.z, norm)};
}

// L_body = (conj(q) p / 2)'s vector part
__device__ __forceinline__ V3 body_angular_momentum(Q4 q, Q4 p) {
  const float ax = -q.x, ay = -q.y, az = -q.z, aw = q.w;
  const float x = sub(add(add(mul(aw, p.x), mul(ax, p.w)), mul(ay, p.z)), mul(az, p.y));
  const float y = add(add(sub(mul(aw, p.y), mul(ax, p.z)), mul(ay, p.w)), mul(az, p.x));
  const float z = add(sub(add(mul(aw, p.z), mul(ax, p.y)), mul(ay, p.x)), mul(az, p.w));
  return V3{mul(0.5f, x), mul(0.5f, y), mul(0.5f, z)};
}

__device__ __forceinline__ Q4 load4(const float* a, int i) {
  return Q4{a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]};
}
__device__ __forceinline__ V3 load3(const float* a, int i) {
  return V3{a[3 * i], a[3 * i + 1], a[3 * i + 2]};
}
__device__ __forceinline__ void store4(float* a, int i, Q4 q) {
  a[4 * i] = q.w;
  a[4 * i + 1] = q.x;
  a[4 * i + 2] = q.y;
  a[4 * i + 3] = q.z;
}
__device__ __forceinline__ void store3(float* a, int i, V3 v) {
  a[3 * i] = v.x;
  a[3 * i + 1] = v.y;
  a[3 * i + 2] = v.z;
}

// mode 0: step1 (q_out, p_out); 1: step2's kick (p_out); 2: Langevin's
// step2 (p_out, torque_out; nz.table holds gamma_r)
__global__ void __launch_bounds__(kThreads)
    no_squish_kernel(int mode, const int* __restrict__ tag, const bool* __restrict__ sel,
                     const int* __restrict__ type_id, const float* __restrict__ q_in,
                     const float* __restrict__ p_in, const float* __restrict__ inertia_in,
                     const float* __restrict__ torque_in, int n, float dt, float half_dt, Noise nz,
                     float* __restrict__ q_out, float* __restrict__ p_out,
                     float* __restrict__ torque_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Q4 q = load4(q_in, i), p = load4(p_in, i);
  const bool m = acts(tag, sel, i);
  // the torque is read where the slot acts, and in mode 2 on every slot
  // (a masked slot's is copied to torque_out)
  V3 torque{0.0f, 0.0f, 0.0f};
  if (m || mode == 2) torque = load3(torque_in, i);
  if (m) {
    const V3 inertia = load3(inertia_in, i);
    if (mode == 2) {
      const bool on[3] = {inertia.x > kEps, inertia.y > kEps, inertia.z > kEps};
      const float I[3] = {inertia.x, inertia.y, inertia.z};
      const V3 L = body_angular_momentum(q, p);
      const float Lk[3] = {L.x, L.y, L.z};
      const float g = gamma_of(nz, type_id, i);
      float rand[3] = {0.0f, 0.0f, 0.0f};
      if (nz.noisy) {
        float u[3];
        uniform3(nz.k0, nz.k1, tag[i], nz.width, nz.low, u);
        const float c = noise_scale(g, nz.kT, nz.inv_dt);
#pragma unroll
        for (int k = 0; k < 3; ++k) rand[k] = mul(c, u[k]);
      }
      float bd[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float omega = on[k] ? __fdiv_rn(Lk[k], clamp_min(I[k], kEps)) : 0.0f;
        bd[k] = on[k] ? sub(rand[k], mul(g, omega)) : 0.0f;
      }
      const V3 r = rotate(q, V3{bd[0], bd[1], bd[2]});
      torque = V3{add(torque.x, r.x), add(torque.y, r.y), add(torque.z, r.z)};
    }
    p = angmom_kick(q, p, torque, inertia, dt);
    if (mode == 0) free_rotation(q, p, inertia, dt, half_dt);
  }
  if (mode == 0) store4(q_out, i, q);
  store4(p_out, i, p);
  if (mode == 2) store3(torque_out, i, torque);
}

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

cudaError_t launched() { return cudaGetLastError(); }

}  // namespace

extern "C" {

// Each entry point launches its kernel on `stream` and returns the CUDA
// error (0 = launched). n > 0: the wrapper launches nothing for no slots.
// Pointers are device pointers but for the gamma table's none (null);
// `sel` is a filter's bool [n] or null (All()).

// K6. values null: the drift of pos [n, 3] from ref [n, 3] on tag [n];
// else n values. top2_out [2] given: write the two largest; else write
// viol_out = viol_in | exceeds. partials holds kDriftMaxBlocks float2 and
// counter one zero word, both reused by every launch on the stream.
int az_drift_check(const float* pos, const float* ref, const int* tag, const float* values, int n,
                   float buffer, const bool* viol_in, bool* viol_out, float* top2_out,
                   float2* partials, unsigned int* counter, void* stream) {
  if (n <= 0 || (top2_out == nullptr && (viol_in == nullptr || viol_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kDriftPerThread;
  const long long wanted = (n + per_block - 1) / per_block;
  const int grid = wanted < kDriftMaxBlocks ? (int)wanted : kDriftMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values != nullptr)
    drift_kernel<true><<<grid, kThreads, 0, s>>>(pos, ref, tag, values, n, buffer, viol_in,
                                                 viol_out, top2_out, partials, counter);
  else
    drift_kernel<false><<<grid, kThreads, 0, s>>>(pos, ref, tag, values, n, buffer, viol_in,
                                                  viol_out, top2_out, partials, counter);
  return (int)launched();
}

int az_drift_max_blocks() { return kDriftMaxBlocks; }

// K7: x_out, v_out [n, 3]; half_dt = float32(0.5 * dt), dt = float32(dt).
int az_step1(const int* tag, const bool* sel, const float* x, const float* v, const float* a, int n,
             float half_dt, float dt, float* x_out, float* v_out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  step1_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, sel, x, v, a, n, half_dt, dt, x_out, v_out);
  return (int)launched();
}

// K8: v_out, a_out [n, 3]. gamma null: NVE (a' = F / m); else Langevin with
// the flow velocity flow [n, 3] (or null) and noise when noisy.
int az_step2(const int* tag, const bool* sel, const int* type_id, const float* v, const float* a,
             const float* force, const float* mass, const float* flow, int n, float half_dt,
             const float* gamma, int n_types, int noisy, uint32_t k0, uint32_t k1, float width,
             float low, float kT, float inv_dt, float* v_out, float* a_out, void* stream) {
  if (n <= 0 || (gamma != nullptr && n_types <= 0)) return (int)cudaErrorInvalidValue;
  const Noise nz{gamma, n_types, noisy, k0, k1, width, low, kT, inv_dt};
  step2_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, sel, type_id, v, a, force, mass, flow, n, half_dt, nz, v_out, a_out);
  return (int)launched();
}

// K9: q, p [n, 4], inertia and torque [n, 3]; mode 0 writes q_out and
// p_out, mode 1 p_out, mode 2 p_out and torque_out (gamma_r: [n_types]).
int az_no_squish(int mode, const int* tag, const bool* sel, const int* type_id, const float* q,
                 const float* p, const float* inertia, const float* torque, int n, float dt,
                 float half_dt, const float* gamma_r, int n_types, int noisy, uint32_t k0,
                 uint32_t k1, float width, float low, float kT, float inv_dt, float* q_out,
                 float* p_out, float* torque_out, void* stream) {
  if (n <= 0 || mode < 0 || mode > 2 || (mode == 2 && (gamma_r == nullptr || n_types <= 0)))
    return (int)cudaErrorInvalidValue;
  const Noise nz{gamma_r, n_types, noisy, k0, k1, width, low, kT, inv_dt};
  no_squish_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, tag, sel, type_id, q, p, inertia, torque, n, dt, half_dt, nz, q_out, p_out,
      torque_out);
  return (int)launched();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
