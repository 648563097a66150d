// The evaporator's pick on K4's words (K4 at the pick): ParticleEvaporator's
// pick on a whole layout (update.py, _pick), in two launches and with no
// host read. No pallas_call is replaced: the reference's pick
// (ParticleEvaporator._update at azplugins_tpu/update.py:139-172:
// particle_bits, then lax.top_k) is plain jnp code that XLA compiles; the
// port's plain version is ~85 operations, two torch.topk among them.
//
// A candidate is a slot of the solvent type whose wrapped z lies in
// [lo, hi); its key is (priority << 31) | slot, the priority K4's first
// word of its tag (Threefry-2x32-20 of threefry.cuh under the key
// ((stream << 16) ^ seed, timestep), the timestep word from the clock on
// the card under a CUDA graph, az::step_word), every other slot's priority
// 0xFFFFFFFF. The k smallest keys over all slots flip to the evaporated
// type where they are candidates; all candidates flip when there are at
// most k. pick_scan_kernel (a slot a thread) tests each slot, hashes the
// candidates only and compacts their keys into its block's region of the
// scratch, with the block's count; pick_select_kernel (one block) finds the
// k-th smallest candidate key by a radix select over the compacted keys (11
// bits a pass, stopping once the rank's bucket holds one key) and flips the
// candidates at or below it in place. Both return at once when the
// trigger's flag on the card is unset, so typeid keeps its bits. See
// pick_select_kernel for the keys that tie the non-candidates.
//
// Bits: the pick's z is Box.wrap's: f = z * float32(1 / Lz) (PyTorch on
// the card divides by a Python scalar as a product with its reciprocal),
// the shift floor(f + 0.5) through int32, z - shift * Lz, each rounded on
// its own; the rest is integer work, so the flips are the plain pick's.
//
// What bounds it on an H100: its bytes (typeid and the z of each solvent
// slot, the tag of each candidate) and, being a few microseconds, its two
// launches; it hashes only the candidates, and its select touches only
// their keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kRounds = 20;  // K4's count (core/rng.py's default)

// a slot a thread in the scan; the select's one block reads at most
// kPickMaxBlocks counts; radix digits of kRadixBits
constexpr int kPickThreads = 256;
constexpr int kPickMaxBlocks = 1024;
constexpr int kSelectThreads = 1024;
constexpr int kRadixBits = 11;
constexpr int kBins = 1 << kRadixBits;
static_assert(kBins == 2 * kSelectThreads, "the bucket search takes two bins a thread");
static_assert(kPickMaxBlocks <= kSelectThreads, "the offsets take a count a thread");

struct PickArgs {
  int n, solvent;
  float lo, hi, inv_lz, lz;
  uint32_t k0, k1;
  const long long* clock;
  int offset;
};

// The block's inclusive prefix sum of v over its threads (B a multiple of
// 32, at most 1024); `warps` holds B / 32 ints. Every thread must call it.
template <int B>
__device__ __forceinline__ int block_inclusive_sum(int v, int* warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();  // an earlier call's readers are done with `warps`
  if (lane == 31) warps[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < B / 32 ? warps[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < B / 32) warps[lane] = w;
  }
  __syncthreads();
  return warp > 0 ? v + warps[warp - 1] : v;
}

// Each slot of the block's span of `span` slots (per_thread a thread): a
// candidate's key into the block's region of `keys`, in no order, and the
// block's count of candidates into counts[blockIdx.x].
__global__ void __launch_bounds__(kPickThreads)
    pick_scan_kernel(const int* __restrict__ type_ids, const float* __restrict__ pos,
                     const int* __restrict__ tag, PickArgs a, int per_thread,
                     const bool* __restrict__ fire, unsigned long long* __restrict__ keys,
                     int* __restrict__ counts) {
  if (fire != nullptr && !*fire) return;
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const uint32_t k1 = az::step_word(a.k1, a.clock, a.offset);
  const long long base = (long long)blockIdx.x * kPickThreads * per_thread;
  unsigned long long* region = keys + base;
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < per_thread; ++it) {
    const long long i = base + (long long)it * kPickThreads + threadIdx.x;
    bool cand = false;
    unsigned long long key = 0;
    if (i < a.n && __ldg(type_ids + i) == a.solvent) {
      // Box.wrap's z
      const float z = __ldg(pos + 3 * i + 2);
      const float shift = (float)(int)floorf(__fadd_rn(__fmul_rn(z, a.inv_lz), 0.5f));
      const float zw = __fsub_rn(z, __fmul_rn(shift, a.lz));
      if (zw >= a.lo && zw < a.hi) {
        cand = true;
        const uint32_t priority =
            az::threefry2x32<kRounds>(a.k0, k1, (uint32_t)__ldg(tag + i), 0u).x;
        key = ((unsigned long long)priority << 31) | (unsigned long long)i;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, cand);
    if (ballot == 0u) continue;  // uniform over the warp
    const int leader = __ffs(ballot) - 1;
    int first = 0;
    if (lane == leader) first = atomicAdd(&s_count, __popc(ballot));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (cand) region[first + __popc(ballot & ((1u << lane) - 1u))] = key;
  }
  __syncthreads();
  if (threadIdx.x == 0) counts[blockIdx.x] = s_count;
}

// One block: the candidates of pick_scan_kernel's `blocks` regions of
// `span` keys. With at most k of them, every candidate flips. Else the k-th
// smallest candidate key kth is found by a radix select over the keys'
// 63 bits from the top, and the candidates at or below it flip: the k
// smallest keys over all slots, as the plain version's top-k over every
// slot keeps them, because a non-candidate's priority 0xFFFFFFFF is above
// every candidate's but a candidate whose word is 0xFFFFFFFF.
//
// That word ties (the slot breaks the tie), and it is why the plain
// version's k-th smallest key over all slots can be a non-candidate's. By
// construction here: when kth's priority is 0xFFFFFFFF, fewer than k
// candidates (m_lt) have a smaller priority; the k smallest keys over all
// slots are then those m_lt and the k - m_lt lowest slots among those
// whose priority is 0xFFFFFFFF (every non-candidate and the tying
// candidates). A tying candidate at slot s holds rank s + 1 - (candidates
// below 0xFFFFFFFF at slots <= s) among them, and flips when that rank is
// at most k - m_lt. A word of 0xFFFFFFFF comes once in 2**32 draws, so this
// path costs a loop over the candidates for each such key.
__global__ void __launch_bounds__(kSelectThreads)
    pick_select_kernel(const unsigned long long* __restrict__ keys,
                       const int* __restrict__ counts, int blocks, int span, int k,
                       int evaporated, const bool* __restrict__ fire,
                       int* __restrict__ type_ids) {
  if (fire != nullptr && !*fire) return;
  __shared__ int s_off[kPickMaxBlocks + 1];
  __shared__ int s_hist[kBins];
  __shared__ int s_warps[kSelectThreads / 32];
  __shared__ unsigned long long s_kth;
  __shared__ int s_bucket, s_rank, s_left, s_lt;
  constexpr unsigned long long kSlot = 0x7FFFFFFFull, kTie = 0xFFFFFFFFull;
  const int t = threadIdx.x;
  // the regions' offsets: an exclusive prefix of the counts
  const int c = t < blocks ? counts[t] : 0;
  const int incl = block_inclusive_sum<kSelectThreads>(c, s_warps);
  if (t < blocks) s_off[t + 1] = incl;
  if (t == 0) s_off[0] = 0;
  __syncthreads();
  const int m = s_off[blocks];
  // the j-th candidate's key: its region by a binary search of the offsets
  auto key_at = [&](int j) -> unsigned long long {
    int lo = 0, hi = blocks;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] <= j) lo = mid; else hi = mid;
    }
    return keys[(long long)lo * span + (j - s_off[lo])];
  };
  if (m <= k) {
    for (int j = t; j < m; j += kSelectThreads) type_ids[key_at(j) & kSlot] = evaporated;
    return;
  }
  // radix select of the k-th smallest key, 11 bits a pass from bit 62 down
  unsigned long long prefix = 0, fixed = 0;
  int rank = k, shift = 63;
  bool alone = false;
  while (shift > 0 && !alone) {
    const int bits = shift < kRadixBits ? shift : kRadixBits;
    shift -= bits;
    const unsigned long long digit = (1ull << bits) - 1;
    for (int b = t; b < kBins; b += kSelectThreads) s_hist[b] = 0;
    __syncthreads();
    for (int j = t; j < m; j += kSelectThreads) {
      const unsigned long long key = key_at(j);
      if ((key & fixed) == prefix) atomicAdd(&s_hist[(key >> shift) & digit], 1);
    }
    __syncthreads();
    const int h0 = s_hist[2 * t], h1 = s_hist[2 * t + 1];
    const int upto = block_inclusive_sum<kSelectThreads>(h0 + h1, s_warps);
    const int before = upto - h0 - h1;
    if (before < rank && rank <= upto) {
      const bool first = rank <= before + h0;
      s_bucket = first ? 2 * t : 2 * t + 1;
      s_rank = first ? rank - before : rank - before - h0;
      s_left = first ? h0 : h1;
    }
    __syncthreads();
    prefix |= (unsigned long long)s_bucket << shift;
    fixed |= digit << shift;
    rank = s_rank;
    alone = s_left == 1;
    __syncthreads();  // s_bucket and s_hist are rewritten by the next pass
  }
  if (alone && shift > 0) {
    for (int j = t; j < m; j += kSelectThreads) {
      const unsigned long long key = key_at(j);
      if ((key & fixed) == prefix) s_kth = key;
    }
    __syncthreads();
  } else if (t == 0) {
    s_kth = prefix;
  }
  if (t == 0) s_lt = 0;
  __syncthreads();
  const unsigned long long kth = s_kth;
  if ((kth >> 31) != kTie) {
    for (int j = t; j < m; j += kSelectThreads) {
      const unsigned long long key = key_at(j);
      if (key <= kth) type_ids[key & kSlot] = evaporated;
    }
    return;
  }
  // kth ties the non-candidates (see above)
  for (int j = t; j < m; j += kSelectThreads)
    if ((key_at(j) >> 31) != kTie) atomicAdd(&s_lt, 1);
  __syncthreads();
  const int m_lt = s_lt;
  for (int j = t; j < m; j += kSelectThreads) {
    const unsigned long long key = key_at(j);
    const long long slot = (long long)(key & kSlot);
    if ((key >> 31) != kTie) {
      type_ids[slot] = evaporated;
      continue;
    }
    long long below = 0;  // candidates below 0xFFFFFFFF at slots <= slot
    for (int i = 0; i < m; ++i) {
      const unsigned long long other = key_at(i);
      if ((other >> 31) != kTie && (long long)(other & kSlot) <= slot) ++below;
    }
    if (slot + 1 - below <= (long long)(k - m_lt)) type_ids[slot] = evaporated;
  }
}

}  // namespace

extern "C" {

// Each entry point launches its kernel on `stream` and returns the CUDA
// error (0 = launched).

// The pick's scratch for n slots: `blocks` regions of `span` keys (int64)
// and `blocks` counts (int32); the wrapper allocates them.
void az_pick_layout(int n, int* blocks_out, int* span_out) {
  const int per = (int)(((long long)n + (long long)kPickThreads * kPickMaxBlocks - 1) /
                        ((long long)kPickThreads * kPickMaxBlocks));
  const int span = kPickThreads * (per > 0 ? per : 1);
  *span_out = span;
  *blocks_out = (int)(((long long)n + span - 1) / span);
}

// The pick's first launch: each candidate's key into its block's region of
// `keys`, each block's count into `counts` (az_pick_layout's scratch).
// type_ids int32 [n], pos float32 [n, 3], tag int32 [n]; lo, hi the slab's
// float32 bounds; inv_lz = float32(1 / Lz) (the reciprocal formed in
// double), lz = float32(Lz); (k0, k1) K4's key, its timestep word k1 or,
// with a non-null `clock`, (uint32)(*clock + offset); fire a device bool
// or null (fired).
int az_pick_scan(const int* type_ids, const float* pos, const int* tag, int n, int solvent,
                 float lo, float hi, float inv_lz, float lz, uint32_t k0, uint32_t k1,
                 const long long* clock, int offset, const bool* fire, unsigned long long* keys,
                 int* counts, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int n_blocks = 0, span = 0;
  az_pick_layout(n, &n_blocks, &span);
  const PickArgs a{n, solvent, lo, hi, inv_lz, lz, k0, k1, clock, offset};
  pick_scan_kernel<<<n_blocks, kPickThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      type_ids, pos, tag, a, span / kPickThreads, fire, keys, counts);
  return (int)cudaGetLastError();
}

// The pick's second launch: flips, in type_ids [n] (in place), the
// candidates among the k smallest keys of az_pick_scan's scratch; k >= 1.
int az_pick_select(int* type_ids, int n, int k, int evaporated, const bool* fire,
                   const unsigned long long* keys, const int* counts, void* stream) {
  if (n <= 0 || k < 1) return (int)cudaErrorInvalidValue;
  int n_blocks = 0, span = 0;
  az_pick_layout(n, &n_blocks, &span);
  pick_select_kernel<<<1, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, counts, n_blocks, span, k, evaporated, fire, type_ids);
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
