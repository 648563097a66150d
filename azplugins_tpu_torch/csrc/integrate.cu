// The step's integrator and its Verlet drift check: K6-K9 and K11.
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
// result is the two, or viol | (sqrt(m1) + sqrt(max(m2, 0)) > buffer),
// which is false for a NaN drift as in the plain version.
//
// K7 az_step1 (Method.step1, md/methods.py; reference
// azplugins_tpu/md/methods.py:68-77): v' = v + (dt/2) a, x' = x + dt v'.
//
// K7+K6 az_step1_drift_check (Method.step1 with a drift check, the last
// method's on a grid path): K7's half step inside K6's launch, then K6 on
// the new positions, as the reference's step body runs m.step1 and
// needs_rebin back to back (azplugins_tpu/simulation.py:641-652). One pass
// over the slots where K7 then K6 make two: x' is never read back.
//
// K8 az_step2 (Method.step2 and LangevinFlow.step2; reference
// azplugins_tpu/md/methods.py:79-91, 172-192): a' = F / m, or with a gamma
// table the Langevin force: the per-type gamma by the clamped type_id, the
// uniforms of K4 (Threefry-2x32-20 on (tag, lane) under the stream's key,
// threefry.cuh) times sqrt(6 gamma kT / dt), minus gamma (v - u) with u the
// flow velocity where one is given, then a' = (F + F_BD) / m; and
// v' = v + (dt/2) a'. Without noise the random force is +0 and the
// operations stay the same. Its acceleration-only instance
// (az_step2_accel, BrownianFlow.step2; reference md/methods.py:282-289):
// a' = F / m, v neither read nor written.
//
// K11 az_brownian_step_drift_check (BrownianFlow.step1 with a drift check,
// the last method's on a grid path; reference azplugins_tpu/md/methods.py:
// 262-280, plugin TwoStepBrownianFlow.h:103-182, then needs_rebin): the
// per-type gamma by the clamped type_id, the noise's coefficient
// sqrt(6 gamma kT / dt) (+0 when noiseless or dt <= 0), K4's three uniforms
// in [-1, 1) on (stream, seed, timestep, tag), x' = x + (u + (F + c U) /
// gamma) dt with u the flow velocity (a +0 flow without one, as the plain
// version adds zeros_like), then K6 on x'. Without noise the plain version
// still multiplies the 0 coefficient by U, so the random force is -0 where
// U < 0; the kernel draws and multiplies alike. az_brownian_step is K11
// without the check (an earlier method of several, a layout without a
// grid).
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
// What bounds them on an H100: the bytes, then the latency. Each is one
// streaming pass over a slot's fields and reads a field only on the slots
// whose result needs it: K6 the tag on every slot and the two positions
// (24 B) on an occupied one; K7 52 B a slot and the acceleration (12 B) on
// a moving one; K7+K6 K7's bytes and the reference position (12 B) on an
// occupied slot (the filter's bool, 1 B, where given); K8 (Langevin) 40 B
// a slot, the old acceleration (12 B) on a masked one and force, mass and
// type (20 B) on a moving one; K9 in mode
// 0 68 B a slot (tag, q and p in and out) and inertia and torque (24 B) on
// an acting one; K11 28 B a slot (tag, x in and out), the reference
// position (12 B) on an occupied one and force and type (16 B) on a moving
// one, ~56 B a slot: K7+K6's bytes without the velocity's 24, with the
// type and the two Threefry hashes that K8 already overlaps with its
// loads. A slot does a few dozen float operations (K8, K9 and K11 add two
// Threefry hashes, K9 ten libm calls in mode 0). At the paths' 2e4-2e5
// slots that is 1-4 us of bytes, so a launch's own cost and the round
// trips to memory that follow one another in a thread are what is left.
// What the designs do about it:
//
// - K6 and K8 issue every load of a slot before any use, unconditionally
//   (an empty slot's positions are its far sentinel, memory the layout
//   holds; a NaN there is selected away by the tag, never multiplied by a
//   mask), so a thread waits for one round trip. Their [n, 3] fields are
//   staged through shared memory by coalesced scalar loads (any 4-byte
//   offset, a view x[1:] too) and read back a slot a thread; K8 writes its
//   outputs back the same way.
// - K6 takes one slot a thread (kDriftThreads a block: 324 blocks at the
//   headline's 82,944 slots, every SM busy), a grid stride above
//   kDriftMaxBlocks blocks. It reduces order-preserving integer keys of
//   the drifts: a warp's top two is two redux.sync maxima and a ballot, a
//   pair's merge integer max and min, exact in any order, so the plain
//   version's bits. Each block writes its partial and takes a ticket (one
//   acquire-release atomic) from the counter; the last ticket's warp
//   merges the partials with 16-byte loads, writes the result and resets
//   the counter: one launch, no memset, no second pass. (Merging a thread
//   block cluster's blocks through distributed shared memory first, so
//   that fewer blocks take a ticket, was measured no faster on an H100:
//   the cluster's barrier costs what the fewer tickets save: PERF.md,
//   kernel_variants.py's driftCluster8.)
//   The VALUES path (needs_rebin_of: 2 values a shard) is its own launch
//   of one warp, with no partials and no counter.
// - K8 is instantiated for NVE, noiseless and noisy Langevin, with and
//   without a flow field and a filter's sel: each body is straight-line
//   but for the slot's own mask. Its draws need only the tag and the key,
//   so the two Threefry hashes run while the other loads are in flight;
//   the gamma table (at most kStep2MaxTypes types) is staged in shared
//   memory, its first kStep2Threads types loaded with the slot's fields
//   and the rest after the draw, so no global load waits on the type.
//   kStep2Threads = 128 makes 648 blocks at the headline, 4.9 an SM, so
//   the SMs' shares differ by one block at most (256 made 2.5 an SM).
// - K7+K6 is K6 with a prologue (drift_kernel<kVerlet>): the slice's
//   velocities and accelerations staged with its positions, every load
//   issued first, each thread's half step in shared memory, the drift
//   taken from x' there, x' and v' written back coalesced. From the
//   squared drift on it is K6, its scratch (a CUDA graph's capture
//   allocates nothing) and its two results (the verdict; a shard's top
//   two). So a grid path's step makes one launch and one pass where K7
//   then K6 made two, and K7's serial chain (the tag, then the
//   acceleration under the mask, three strided loads a field) is gone.
// - K11 is K6 with BrownianFlow's step as its prologue
//   (drift_kernel<kBrownian>), so that Brownian dynamics makes one launch
//   where K4, ~19 PyTorch operations and K6 made ~21 (a standalone draw's
//   work at the paths' slot counts is less than a launch's own cost):
//   the slice's forces (and flow velocities) staged with its positions,
//   every load issued first, the draw on the tag while they fly, the gamma
//   table in shared memory as K8 stages it, x' written back coalesced.
//   From the squared drift on it is K6: its scratch and its two results.
// - K7 alone (the earlier methods of several, a layout without a grid), K11
//   alone (the same) and K9 take one thread a slot, the mask, the gamma
//   lookup, the keys and the noise in registers.
// - K8, K9 and K11 key their draws on the host's timestep word, or on a
//   clock on the card (Noise::clock, az::step_word: one more load before
//   the hash), so that a CUDA graph of a rebuild segment draws anew at each
//   replay; K11 takes kT in the host form or the device form as K8 does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;          // K7 and K9: a slot a thread
constexpr int kRounds = 20;            // the Langevin draws' Threefry rounds (K4's)
constexpr int kDriftThreads = 256;     // K6: a slot a thread
constexpr int kDriftMaxBlocks = 1024;  // K6's grid at most, and the partials' room
                                       // (ops/integrate_kernel.py)
constexpr int kStep2Threads = 128;     // K8: a slot a thread
constexpr int kStep2MaxTypes = 8192;   // K8's gamma table in shared memory: 32 KiB at most
constexpr float kEps = 1e-12f;         // md/rotation.py's _EPS as float32

static_assert(kDriftMaxBlocks % 64 == 0, "a lane's loads of two partials each");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (isnan(x) || x > lo) ? x : lo;
}

// ---------------------------------------------------------------------------
// The draws of K8, K9 and K11
// ---------------------------------------------------------------------------
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
  int noisy;           // 0: the random force is +0 (K11: its coefficient, so +-0)
  uint32_t k0, k1;     // the stream's key (core/rng.py::_key_words)
  const long long* clock;  // null, or the card's timestep: k1 = clock + offset
  int offset;              // (az::step_word), so a CUDA graph's replays draw anew
  float width, low;    // the uniforms' float32 width and low end
  float kT;            // float32 kT (the host-kT form)
  const float* kT_dev;  // null, or kT on the card (the device-kT form)
  float inv_dt;        // float32 1/dt
};

// kT as az::step_word takes the timestep: the host's float32, or with a
// device pointer (a 0-d float32 on the card: a run's schedule of a variant
// kT) the value it holds, so a CUDA graph reads each replay's kT. The same
// bits either way: the noise's scale takes the loaded value as it is.
__device__ __forceinline__ float kT_of(const Noise& nz) {
  return nz.kT_dev != nullptr ? __ldg(nz.kT_dev) : nz.kT;
}

__device__ __forceinline__ float gamma_of(const Noise& nz, const int* type_id, int i) {
  const int t = min(max(__ldg(type_id + i), 0), nz.n_types - 1);
  return __ldg(nz.table + t);
}

// BrownianFlow's x' = x + (u + (F + c r) / g) dt of one component: the flow
// velocity u (+0 without a flow: the plain version adds a zeros_like flow),
// the force F, the noise's scale c (+0 when noiseless) times the uniform r,
// the slot's gamma g
__device__ __forceinline__ float brownian_x(float x, float u, float f, float c, float r, float g,
                                            float dt) {
  return add(x, mul(add(u, __fdiv_rn(add(f, mul(c, r)), g)), dt));
}

// ---------------------------------------------------------------------------
// K6: the drift check
// ---------------------------------------------------------------------------
// K6 reduces order-preserving uint32 keys of its values, which are squared
// drifts (+0 or more, never -0), NaN, or -inf for none: -inf -> 0, x >= +0
// -> bits(x) + 1, NaN -> 0xFFFFFFFF. Two pairs merge by integer max and
// min, a warp's by two redux.sync maxima and a ballot; ties are counted,
// and a NaN anywhere gives (NaN, NaN) at the end, as in the plain version.
struct Top2 {
  uint32_t k1, k2;  // the two largest keys, k1 >= k2 (0: none)
};

__device__ __forceinline__ uint32_t key_of(float x) {
  return isnan(x) ? 0xFFFFFFFFu : x == -INFINITY ? 0u : __float_as_uint(x) + 1u;
}

__device__ __forceinline__ float value_of(uint32_t k) {
  return k == 0xFFFFFFFFu ? __int_as_float(0x7FC00000) : k == 0u ? -INFINITY
                                                                  : __uint_as_float(k - 1u);
}

// the two largest of two pairs' union, ties counted
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  return Top2{max(a.k1, b.k1), max(min(a.k1, b.k1), max(a.k2, b.k2))};
}

// the two largest of the warp's pairs, in every lane
__device__ __forceinline__ Top2 warp_top2(Top2 a) {
  const uint32_t k1 = __reduce_max_sync(0xffffffffu, a.k1);
  const bool holds = a.k1 == k1;
  const uint32_t k2 = __reduce_max_sync(0xffffffffu, holds ? a.k2 : a.k1);
  return Top2{k1, __popc(__ballot_sync(0xffffffffu, holds)) > 1 ? k1 : k2};
}

template <int B>
__device__ Top2 block_top2(Top2 t) {
  __shared__ Top2 warps[B / 32];
  t = warp_top2(t);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = t;
  __syncthreads();
  if (warp == 0) t = warp_top2(lane < B / 32 ? warps[lane] : Top2{0u, 0u});
  return t;  // warp 0's is the block's
}

// one more on the counter, released after this thread's writes (the
// partial) and acquiring every earlier holder's: the old count
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// the verdict viol | exceeds, or the two largest where top2_out is given
__device__ __forceinline__ void drift_result(Top2 t, float buffer, bool viol, bool* viol_out,
                                             float* top2_out) {
  const float m1 = value_of(t.k1), m2 = value_of(t.k1 == 0xFFFFFFFFu ? t.k1 : t.k2);
  if (top2_out != nullptr) {
    top2_out[0] = m1;
    top2_out[1] = m2;
  } else {
    const bool exceeds = add(__fsqrt_rn(m1), __fsqrt_rn(clamp_min(m2, 0.0f))) > buffer;
    *viol_out = viol || exceeds;
  }
}

// What a drift_kernel instance does before its drift check: nothing (K6),
// K7's half step (K7+K6) or BrownianFlow's step (K11)
enum Prologue { kCheckOnly, kVerlet, kBrownian };

// The prologue's inputs and outputs: the filter's bool (SEL); K7's v, a,
// dt / 2 and dt, x' and v' out; K11's type, force, flow velocity (FLOW),
// noise and dt, x' out
struct Step {
  const bool* sel;
  const float* vel;
  const float* acc;
  const int* type_id;
  const float* force;
  const float* flow;
  float half_dt, dt;
  Noise nz;
  float* pos_out;
  float* vel_out;
};

// The squared drift of each slot, a slot a thread. A block stages a slice
// of kDriftThreads slots' positions (a grid stride over the slices past
// kDriftMaxBlocks blocks), reduces it, writes its partial and takes a
// ticket; the last ticket merges the partials.
//
// kVerlet (az_step1_drift_check): K7's drift half step first, in the same
// pass. The slice's velocities and accelerations are staged with the
// positions; each thread forms its slot's v' = v + (dt/2) a and x' = x +
// dt v' (a masked slot keeps its bits; SEL: a filter's bool masks too),
// takes the drift from x' in shared memory, and the block writes x' and v'
// back through the staging by coalesced stores.
//
// kBrownian (az_brownian_step_drift_check, K11): BrownianFlow's step
// first. The slice's forces (and flow velocities, FLOW) are staged with
// the positions; each thread draws its slot's three uniforms (K4's, on the
// tag and the key alone, while the loads fly), looks its gamma up in the
// table staged in shared memory (its first kDriftThreads types loaded
// before the first slice's fields, the rest after the draw), forms x'
// (brownian_x; a masked slot keeps its bits), takes the drift from it and
// writes x' back coalesced.
template <int PRO, bool SEL, bool FLOW>
__global__ void __launch_bounds__(kDriftThreads)
    drift_kernel(const float* __restrict__ pos, const float* __restrict__ ref,
                 const int* __restrict__ tag, int n, float buffer,
                 const bool* __restrict__ viol_in, bool* __restrict__ viol_out,
                 float* __restrict__ top2_out, Step st, uint2* partials, unsigned int* counter) {
  constexpr int B = kDriftThreads;
  constexpr bool BROWNIAN = PRO == kBrownian;
  // K7: v and a; K11: F and the flow velocity
  constexpr int SA = PRO == kCheckOnly ? 1 : 3 * B;
  constexpr int SB = PRO == kVerlet || (BROWNIAN && FLOW) ? 3 * B : 1;
  __shared__ float s_pos[3 * B], s_ref[3 * B], s_a[SA], s_b[SB];
  extern __shared__ float s_gamma[];  // K11: the [n_types] gamma table
  const int t = threadIdx.x;
  // the flag the verdict ORs, read now: only the last block needs it
  const bool viol = top2_out == nullptr && t == 0 && *viol_in;
  // K11's launch-wide values, issued before the first slice's loads: the
  // table's first B types (one a thread), kT and the key's timestep word
  const Noise& nz = st.nz;
  float g0 = 0.0f, kT = 0.0f;
  uint32_t k1 = 0u;
  if constexpr (BROWNIAN) {
    g0 = t < nz.n_types ? __ldg(nz.table + t) : 0.0f;
    kT = nz.noisy ? kT_of(nz) : 0.0f;
    k1 = az::step_word(nz.k1, nz.clock, nz.offset);
  }
  Top2 top{0u, 0u};
  const int slices = (n + B - 1) / B;
  for (int slice = blockIdx.x; slice < slices; slice += gridDim.x) {
    const int i0 = slice * B, i = i0 + t, nf = 3 * min(B, n - i0);
    const long long f0 = 3LL * i0;
    const int tg = i < n ? __ldg(tag + i) : -1;
    const bool chosen = !SEL || (i < n && st.sel[i]);
    const int ty = BROWNIAN && i < n ? __ldg(st.type_id + i) : 0;
    float xp[3], xr[3], xa[3], xb[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int f = t + j * B;
      const bool ok = f < nf;
      xp[j] = ok ? __ldg(pos + f0 + f) : 0.0f;
      xr[j] = ok ? __ldg(ref + f0 + f) : 0.0f;
      if constexpr (PRO == kVerlet) {
        xa[j] = ok ? __ldg(st.vel + f0 + f) : 0.0f;
        xb[j] = ok ? __ldg(st.acc + f0 + f) : 0.0f;
      }
      if constexpr (BROWNIAN) {
        xa[j] = ok ? __ldg(st.force + f0 + f) : 0.0f;
        xb[j] = FLOW && ok ? __ldg(st.flow + f0 + f) : 0.0f;
      }
    }
    // K11's draw needs only the tag and the key: it runs while the loads fly
    float u[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (BROWNIAN) uniform3(nz.k0, k1, tg, nz.width, nz.low, u);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s_pos[t + j * B] = xp[j];
      s_ref[t + j * B] = xr[j];
      if constexpr (SA > 1) s_a[t + j * B] = xa[j];
      if constexpr (SB > 1) s_b[t + j * B] = xb[j];
    }
    if constexpr (BROWNIAN) {
      if (slice == (int)blockIdx.x) {  // the table, once: a loop after the draw
        if (t < nz.n_types) s_gamma[t] = g0;
        for (int k = t + B; k < nz.n_types; k += B) s_gamma[k] = __ldg(nz.table + k);
      }
    }
    __syncthreads();
    const int l = 3 * t;
    const bool moves = tg >= 0 && chosen;
    float g = 0.0f, c = 0.0f;
    if constexpr (BROWNIAN) {
      g = s_gamma[min(max(ty, 0), nz.n_types - 1)];
      c = nz.noisy ? noise_scale(g, kT, nz.inv_dt) : 0.0f;
    }
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float x = s_pos[l + k];
      if constexpr (PRO == kVerlet) {
        const float v = s_a[l + k];
        const float vh = add(v, mul(st.half_dt, s_b[l + k]));
        const float xn = add(x, mul(st.dt, vh));
        x = moves ? xn : x;
        s_pos[l + k] = x;
        s_a[l + k] = moves ? vh : v;
      }
      if constexpr (BROWNIAN) {
        const float xn = brownian_x(x, FLOW ? s_b[l + k] : 0.0f, s_a[l + k], c, u[k], g, st.dt);
        x = moves ? xn : x;
        s_pos[l + k] = x;
      }
      d[k] = sub(x, s_ref[l + k]);
    }
    const float dsq = add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2]));
    // an empty slot's drift is 0 whatever its positions hold (NaN too);
    // past n a slot holds none
    top = merge(top, Top2{key_of(i < n ? (tg >= 0 ? dsq : 0.0f) : -INFINITY), 0u});
    __syncthreads();  // the write-back, or the next slice, reads the staging
    if constexpr (PRO != kCheckOnly) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int f = t + j * B;
        if (f < nf) {
          st.pos_out[f0 + f] = s_pos[f];
          if constexpr (PRO == kVerlet) st.vel_out[f0 + f] = s_a[f];
        }
      }
      __syncthreads();  // the next slice reuses the staging
    }
  }
  top = block_top2<B>(top);
  if (t >= 32) return;
  // warp 0 of a block
  const int parts = gridDim.x;
  unsigned ticket = 0;
  if (t == 0) {
    partials[blockIdx.x] = make_uint2(top.k1, top.k2);
    ticket = take_ticket(counter);
  }
  if (__shfl_sync(0xffffffffu, ticket, 0) != parts - 1) return;
  __syncwarp();  // lane 0's acquire before every lane's loads
  // the last: all partials, two a 16-byte load, the loads issued first
  constexpr int Q = kDriftMaxBlocks / 64;  // loads a lane, at most
  const uint4* quads = reinterpret_cast<const uint4*>(partials);
  uint4 q[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int j = t + 32 * k;
    q[k] = 2 * j < parts ? __ldcg(quads + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  top = Top2{0u, 0u};
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int j = t + 32 * k;
    top = merge(top, Top2{q[k].x, q[k].y});
    if (2 * j + 1 < parts) top = merge(top, Top2{q[k].z, q[k].w});
  }
  top = warp_top2(top);
  if (t == 0) {
    drift_result(top, buffer, viol, viol_out, top2_out);
    *counter = 0u;
  }
}

// VALUES: n values (needs_rebin_of: each shard's top two) in one warp
__global__ void __launch_bounds__(32)
    drift_values_kernel(const float* __restrict__ values, int n, float buffer,
                        const bool* __restrict__ viol_in, bool* __restrict__ viol_out,
                        float* __restrict__ top2_out) {
  Top2 top{0u, 0u};
  for (int i = threadIdx.x; i < n; i += 32) top = merge(top, Top2{key_of(__ldg(values + i)), 0u});
  top = warp_top2(top);
  if (threadIdx.x == 0)
    drift_result(top, buffer, top2_out == nullptr && *viol_in, viol_out, top2_out);
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

enum Step2Mode { kNVE, kNoiseless, kNoisy, kAccel };

// K8: a slot a thread, every load issued at the top. MODE kNVE: a' = F / m;
// kNoiseless, kNoisy: the Langevin force (kNoisy: with its draw), the drag
// relative to the flow velocity where FLOW; kAccel (BrownianFlow.step2):
// a' = F / m with v neither read nor written. SEL: the filter's bool masks
// too.
template <int MODE, bool FLOW, bool SEL>
__global__ void __launch_bounds__(kStep2Threads)
    step2_kernel(const int* __restrict__ tag, const bool* __restrict__ sel,
                 const int* __restrict__ type_id, const float* __restrict__ v,
                 const float* __restrict__ a, const float* __restrict__ force,
                 const float* __restrict__ mass, const float* __restrict__ flow, int n,
                 float half_dt, Noise nz, float* __restrict__ v_out, float* __restrict__ a_out) {
  constexpr int B = kStep2Threads;
  constexpr bool LANGEVIN = MODE == kNoiseless || MODE == kNoisy;
  constexpr bool KICK = MODE != kAccel;
  constexpr int SV = KICK ? 3 * B : 1;
  // the block's [n, 3] slices: v, the old a, force (, flow); then v', a'
  __shared__ float s_v[SV], s_a[3 * B], s_f[3 * B], s_u[FLOW ? 3 * B : 1];
  __shared__ float s_vo[SV], s_ao[3 * B];
  extern __shared__ float s_gamma[];  // Langevin: the [n_types] gamma table
  const int t = threadIdx.x, i0 = blockIdx.x * B, i = i0 + t;
  const bool in = i < n;
  const int nf = 3 * min(B, n - i0);
  const long long f0 = 3LL * i0;
  const int tg = in ? __ldg(tag + i) : -1;
  const bool chosen = !SEL || (in && sel[i]);
  const float m = in ? __ldg(mass + i) : 1.0f;
  const int ty = LANGEVIN && in ? __ldg(type_id + i) : 0;
  float xv[3], xa[3], xf[3], xu[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int f = t + j * B;
    const bool ok = f < nf;
    xv[j] = KICK && ok ? __ldg(v + f0 + f) : 0.0f;
    xa[j] = ok ? __ldg(a + f0 + f) : 0.0f;
    xf[j] = ok ? __ldg(force + f0 + f) : 0.0f;
    xu[j] = FLOW && ok ? __ldg(flow + f0 + f) : 0.0f;
  }
  // the table's first B types, one a thread, loaded with the rest (and kT)
  const float g0 = LANGEVIN && t < nz.n_types ? __ldg(nz.table + t) : 0.0f;
  const float kT = MODE == kNoisy ? kT_of(nz) : 0.0f;
  // the draw needs only the tag and the key: it runs while the loads fly
  float u[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (MODE == kNoisy) {
    uniform3(nz.k0, az::step_word(nz.k1, nz.clock, nz.offset), tg, nz.width, nz.low, u);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if constexpr (KICK) s_v[t + j * B] = xv[j];
    s_a[t + j * B] = xa[j];
    s_f[t + j * B] = xf[j];
    if constexpr (FLOW) s_u[t + j * B] = xu[j];
  }
  if constexpr (LANGEVIN) {
    if (t < nz.n_types) s_gamma[t] = g0;
    // a loop after the draw, so that the draw is not held behind it
    for (int k = t + B; k < nz.n_types; k += B) s_gamma[k] = __ldg(nz.table + k);
  }
  __syncthreads();
  float g = 0.0f, rand[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (LANGEVIN) {
    g = s_gamma[min(max(ty, 0), nz.n_types - 1)];
  }
  if constexpr (MODE == kNoisy) {
    const float c = noise_scale(g, kT, nz.inv_dt);
#pragma unroll
    for (int k = 0; k < 3; ++k) rand[k] = mul(c, u[k]);
  }
  const bool moves = tg >= 0 && chosen;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int l = 3 * t + k;
    float f = s_f[l];
    if constexpr (LANGEVIN) {
      float rel = s_v[l];
      if constexpr (FLOW) rel = sub(rel, s_u[l]);
      f = add(f, sub(rand[k], mul(g, rel)));
    }
    const float acc = __fdiv_rn(f, m);
    s_ao[l] = moves ? acc : s_a[l];
    if constexpr (KICK) s_vo[l] = moves ? add(s_v[l], mul(half_dt, acc)) : s_v[l];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int f = t + j * B;
    if (f < nf) {
      if constexpr (KICK) v_out[f0 + f] = s_vo[f];
      a_out[f0 + f] = s_ao[f];
    }
  }
}

using Step2Kernel = decltype(&step2_kernel<kNVE, false, false>);

template <int MODE, bool FLOW>
Step2Kernel step2_instance(bool sel) {
  return sel ? step2_kernel<MODE, FLOW, true> : step2_kernel<MODE, FLOW, false>;
}

// ---------------------------------------------------------------------------
// K11 alone: BrownianFlow's step without the drift check
// ---------------------------------------------------------------------------
// A slot a thread, as K7 alone: the mask, the gamma lookup, the draw and
// x' (brownian_x) in registers; flow null: no flow field.
__global__ void __launch_bounds__(kThreads)
    brownian_kernel(const int* __restrict__ tag, const bool* __restrict__ sel,
                    const int* __restrict__ type_id, const float* __restrict__ x,
                    const float* __restrict__ force, const float* __restrict__ flow, int n,
                    float dt, Noise nz, float* __restrict__ x_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int tg = __ldg(tag + i);
  const bool m = tg >= 0 && (sel == nullptr || sel[i]);
  const float g = gamma_of(nz, type_id, i);
  float u[3];
  uniform3(nz.k0, az::step_word(nz.k1, nz.clock, nz.offset), tg, nz.width, nz.low, u);
  const float c = nz.noisy ? noise_scale(g, kT_of(nz), nz.inv_dt) : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int f = 3 * i + k;
    const float xo = x[f];
    x_out[f] = m ? brownian_x(xo, flow != nullptr ? flow[f] : 0.0f, force[f], c, u[k], g, dt)
                 : xo;
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
        uniform3(nz.k0, az::step_word(nz.k1, nz.clock, nz.offset), tag[i], nz.width, nz.low,
                 u);
        const float c = noise_scale(g, kT_of(nz), nz.inv_dt);
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

// K6's grid: a slice of kDriftThreads slots a block, at most kDriftMaxBlocks
unsigned drift_blocks(long long n) {
  const long long grid = (n + kDriftThreads - 1) / kDriftThreads;
  return (unsigned)(grid < kDriftMaxBlocks ? grid : kDriftMaxBlocks);
}

cudaError_t launched() { return cudaGetLastError(); }

}  // namespace

extern "C" {

// Each entry point launches its kernel on `stream` and returns the CUDA
// error (0 = launched). n > 0: the wrapper launches nothing for no slots.
// Pointers are device pointers but for the gamma table's none (null);
// `sel` is a filter's bool [n] or null (All()); K8's, K9's and K11's
// `clock` is null (the key's timestep word is k1) or a device int64 (the
// word is then (uint32)(*clock + offset)); their `kT_dev` is null (kT is
// the float `kT`) or a device float32 (kT is the value it holds).

// K6. values null: the drift of pos [n, 3] from ref [n, 3] on tag [n];
// else n values (squared drifts, -inf or NaN: the shards' top twos).
// top2_out [2] given: write the two largest; else write viol_out =
// viol_in | exceeds. partials (16-byte aligned) holds kDriftMaxBlocks
// 8-byte slots (two keys each) and counter one zero word, both reused by every launch on
// the stream.
int az_drift_check(const float* pos, const float* ref, const int* tag, const float* values, int n,
                   float buffer, const bool* viol_in, bool* viol_out, float* top2_out,
                   float2* partials, unsigned int* counter, void* stream) {
  if (n <= 0 || (top2_out == nullptr && (viol_in == nullptr || viol_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values != nullptr) {
    drift_values_kernel<<<1, 32, 0, s>>>(values, n, buffer, viol_in, viol_out, top2_out);
    return (int)launched();
  }
  if (reinterpret_cast<uintptr_t>(partials) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  drift_kernel<kCheckOnly, false, false><<<drift_blocks(n), kDriftThreads, 0, s>>>(
      pos, ref, tag, n, buffer, viol_in, viol_out, top2_out, Step{},
      reinterpret_cast<uint2*>(partials), counter);
  return (int)launched();
}

int az_drift_max_blocks() { return kDriftMaxBlocks; }

// K7 and K6 in one launch: x_out, v_out [n, 3] as az_step1 writes them
// (sel: a filter's bool [n] or null), then the drift of x_out from ref
// [n, 3] as az_drift_check takes it, with its result, scratch and error
// contract.
int az_step1_drift_check(const int* tag, const bool* sel, const float* x, const float* v,
                         const float* a, const float* ref, int n, float half_dt, float dt,
                         float buffer, const bool* viol_in, bool* viol_out, float* top2_out,
                         float* x_out, float* v_out, float2* partials, unsigned int* counter,
                         void* stream) {
  if (n <= 0 || (top2_out == nullptr && (viol_in == nullptr || viol_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(partials) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const auto kernel = sel != nullptr ? drift_kernel<kVerlet, true, false>
                                      : drift_kernel<kVerlet, false, false>;
  Step st{};
  st.sel = sel;
  st.vel = v;
  st.acc = a;
  st.half_dt = half_dt;
  st.dt = dt;
  st.pos_out = x_out;
  st.vel_out = v_out;
  kernel<<<drift_blocks(n), kDriftThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ref, tag, n, buffer, viol_in, viol_out, top2_out, st,
      reinterpret_cast<uint2*>(partials), counter);
  return (int)launched();
}

// K11 and K6 in one launch: x_out [n, 3] as az_brownian_step writes it,
// then the drift of x_out from ref [n, 3] as az_drift_check takes it, with
// its result, scratch and error contract; gamma holds 1 to kStep2MaxTypes
// types.
int az_brownian_step_drift_check(const int* tag, const bool* sel, const int* type_id,
                                 const float* x, const float* force, const float* flow,
                                 const float* ref, int n, float dt, float buffer,
                                 const float* gamma, int n_types, int noisy, uint32_t k0,
                                 uint32_t k1, const long long* clock, int offset, float width,
                                 float low, float kT, const float* kT_dev, float inv_dt,
                                 const bool* viol_in, bool* viol_out, float* top2_out,
                                 float* x_out, float2* partials, unsigned int* counter,
                                 void* stream) {
  if (n <= 0 || (top2_out == nullptr && (viol_in == nullptr || viol_out == nullptr)) ||
      gamma == nullptr || n_types <= 0 || n_types > kStep2MaxTypes)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(partials) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const bool s = sel != nullptr, u = flow != nullptr;
  const auto kernel = s ? (u ? drift_kernel<kBrownian, true, true>
                             : drift_kernel<kBrownian, true, false>)
                        : (u ? drift_kernel<kBrownian, false, true>
                             : drift_kernel<kBrownian, false, false>);
  Step st{};
  st.sel = sel;
  st.type_id = type_id;
  st.force = force;
  st.flow = flow;
  st.dt = dt;
  st.nz = Noise{gamma, n_types, noisy, k0, k1, clock, offset, width, low, kT, kT_dev, inv_dt};
  st.pos_out = x_out;
  kernel<<<drift_blocks(n), kDriftThreads, sizeof(float) * n_types,
           static_cast<cudaStream_t>(stream)>>>(x, ref, tag, n, buffer, viol_in, viol_out,
                                                top2_out, st, reinterpret_cast<uint2*>(partials),
                                                counter);
  return (int)launched();
}

// K11 alone: x_out [n, 3], BrownianFlow's step of x [n, 3] under the force
// [n, 3] and the flow velocity flow [n, 3] (or null), gamma [n_types] by
// the clamped type_id, the uniforms drawn under the key (k0, k1) or the
// clock; noisy 0: the noise's coefficient is +0. dt = float32(dt), inv_dt
// = float32(1 / dt).
int az_brownian_step(const int* tag, const bool* sel, const int* type_id, const float* x,
                     const float* force, const float* flow, int n, float dt, const float* gamma,
                     int n_types, int noisy, uint32_t k0, uint32_t k1, const long long* clock,
                     int offset, float width, float low, float kT, const float* kT_dev,
                     float inv_dt, float* x_out, void* stream) {
  if (n <= 0 || gamma == nullptr || n_types <= 0) return (int)cudaErrorInvalidValue;
  const Noise nz{gamma, n_types, noisy, k0, k1, clock, offset, width, low, kT, kT_dev, inv_dt};
  brownian_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, sel, type_id, x, force, flow, n, dt, nz, x_out);
  return (int)launched();
}

// K7: x_out, v_out [n, 3]; half_dt = float32(0.5 * dt), dt = float32(dt).
int az_step1(const int* tag, const bool* sel, const float* x, const float* v, const float* a, int n,
             float half_dt, float dt, float* x_out, float* v_out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  step1_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tag, sel, x, v, a, n, half_dt, dt, x_out, v_out);
  return (int)launched();
}

// K8: v_out, a_out [n, 3]. gamma null: NVE (a' = F / m); else Langevin with
// the flow velocity flow [n, 3] (or null) and noise when noisy; gamma holds
// 1 to kStep2MaxTypes types.
int az_step2(const int* tag, const bool* sel, const int* type_id, const float* v, const float* a,
             const float* force, const float* mass, const float* flow, int n, float half_dt,
             const float* gamma, int n_types, int noisy, uint32_t k0, uint32_t k1,
             const long long* clock, int offset, float width, float low, float kT,
             const float* kT_dev, float inv_dt, float* v_out, float* a_out, void* stream) {
  if (n <= 0 || (gamma != nullptr && (n_types <= 0 || n_types > kStep2MaxTypes)))
    return (int)cudaErrorInvalidValue;
  const Noise nz{gamma, n_types, noisy, k0, k1, clock, offset, width, low, kT, kT_dev, inv_dt};
  const bool s = sel != nullptr, u = flow != nullptr;
  const Step2Kernel kernel =
      gamma == nullptr ? step2_instance<kNVE, false>(s)
      : noisy          ? (u ? step2_instance<kNoisy, true>(s) : step2_instance<kNoisy, false>(s))
                       : (u ? step2_instance<kNoiseless, true>(s)
                            : step2_instance<kNoiseless, false>(s));
  const size_t table_bytes = gamma == nullptr ? 0 : sizeof(float) * n_types;
  kernel<<<(n + kStep2Threads - 1) / kStep2Threads, kStep2Threads, table_bytes,
           static_cast<cudaStream_t>(stream)>>>(tag, sel, type_id, v, a, force, mass, flow, n,
                                                half_dt, nz, v_out, a_out);
  return (int)launched();
}

// K8's acceleration-only instance (BrownianFlow.step2): a_out [n, 3], F / m
// where the slot acts, the old acceleration a elsewhere.
int az_step2_accel(const int* tag, const bool* sel, const float* a, const float* force,
                   const float* mass, int n, float* a_out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Step2Kernel kernel = step2_instance<kAccel, false>(sel != nullptr);
  kernel<<<(n + kStep2Threads - 1) / kStep2Threads, kStep2Threads, 0,
           static_cast<cudaStream_t>(stream)>>>(tag, sel, nullptr, nullptr, a, force, mass,
                                                nullptr, n, 0.0f, Noise{}, nullptr, a_out);
  return (int)launched();
}

// K9: q, p [n, 4], inertia and torque [n, 3]; mode 0 writes q_out and
// p_out, mode 1 p_out, mode 2 p_out and torque_out (gamma_r: [n_types]).
int az_no_squish(int mode, const int* tag, const bool* sel, const int* type_id, const float* q,
                 const float* p, const float* inertia, const float* torque, int n, float dt,
                 float half_dt, const float* gamma_r, int n_types, int noisy, uint32_t k0,
                 uint32_t k1, const long long* clock, int offset, float width, float low,
                 float kT, const float* kT_dev, float inv_dt, float* q_out, float* p_out,
                 float* torque_out, void* stream) {
  if (n <= 0 || mode < 0 || mode > 2 || (mode == 2 && (gamma_r == nullptr || n_types <= 0)))
    return (int)cudaErrorInvalidValue;
  const Noise nz{gamma_r, n_types, noisy, k0, k1, clock, offset, width, low, kT, kT_dev, inv_dt};
  no_squish_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, tag, sel, type_id, q, p, inertia, torque, n, dt, half_dt, nz, q_out, p_out,
      torque_out);
  return (int)launched();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
