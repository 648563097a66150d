// The evaporator's pick on K4's words (K4 at the pick): ParticleEvaporator's
// pick (update.py, _pick) over a whole layout or over every shard of a mesh
// on one device, in two launches and with no host read. No pallas_call is replaced: the reference's pick
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
// most k. The slots are global: a layout of n_shards shards of n_loc slots
// each (one shard for a whole layout) numbers shard d's local slot i as
// d * n_loc + i, the shards' slot axis joined in block order, and the
// kernels take the shards' arrays through tables of pointers passed by
// value (Shards). pick_scan_kernel (a slot a thread, a shard's blocks
// after the previous shard's) tests each slot, hashes the candidates only
// and compacts their keys into its block's region of the one scratch, with
// the block's count; pick_select_kernel (one block) finds the k-th
// smallest candidate key over every shard by a radix select over the
// compacted keys (11 bits a pass, stopping once the rank's bucket holds one
// key) and flips the candidates at or below it in place, each in its
// shard's typeid. Both return at once when the
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
constexpr int kMaxShards = 64;  // the pointer tables' size (kernel parameters)
constexpr int kSelectThreads = 1024;
constexpr int kRadixBits = 11;
constexpr int kBins = 1 << kRadixBits;
static_assert(kBins == 2 * kSelectThreads, "the bucket search takes two bins a thread");
static_assert(kPickMaxBlocks <= kSelectThreads, "the offsets take a count a thread");

// Each shard's arrays (the first n_shards entries are set)
struct Shards {
  const int* type_ids[kMaxShards];
  const float* pos[kMaxShards];
  const int* tag[kMaxShards];
};

struct Flips {
  int* type_ids[kMaxShards];
};

struct PickArgs {
  int n_loc, blocks_per_shard, solvent;
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

// Each slot of the block's span of `per_thread * kPickThreads` slots of its
// shard (blockIdx.x / blocks_per_shard): a candidate's key, on the global
// slot, into the block's region of `keys`, in no order, and the block's
// count of candidates into counts[blockIdx.x].
__global__ void __launch_bounds__(kPickThreads)
    pick_scan_kernel(const __grid_constant__ Shards sh, PickArgs a, int per_thread,
                     const bool* __restrict__ fire, unsigned long long* __restrict__ keys,
                     int* __restrict__ counts) {
  if (fire != nullptr && !*fire) return;
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const uint32_t k1 = az::step_word(a.k1, a.clock, a.offset);
  const int shard = blockIdx.x / a.blocks_per_shard;
  const int* __restrict__ type_ids = sh.type_ids[shard];
  const float* __restrict__ pos = sh.pos[shard];
  const int* __restrict__ tag = sh.tag[shard];
  const long long span = (long long)kPickThreads * per_thread;
  const long long base = (long long)(blockIdx.x - shard * a.blocks_per_shard) * span;
  const long long first = (long long)shard * a.n_loc;  // the shard's first global slot
  unsigned long long* region = keys + (long long)blockIdx.x * span;
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < per_thread; ++it) {
    const long long i = base + (long long)it * kPickThreads + threadIdx.x;
    bool cand = false;
    unsigned long long key = 0;
    if (i < a.n_loc && __ldg(type_ids + i) == a.solvent) {
      // Box.wrap's z
      const float z = __ldg(pos + 3 * i + 2);
      const float shift = (float)(int)floorf(__fadd_rn(__fmul_rn(z, a.inv_lz), 0.5f));
      const float zw = __fsub_rn(z, __fmul_rn(shift, a.lz));
      if (zw >= a.lo && zw < a.hi) {
        cand = true;
        const uint32_t priority =
            az::threefry2x32<kRounds>(a.k0, k1, (uint32_t)__ldg(tag + i), 0u).x;
        key = ((unsigned long long)priority << 31) | (unsigned long long)(first + i);
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
// `span` keys, over every shard. With at most k of them, every candidate
// flips (global slot s in shard s / n_loc, at s % n_loc). Else the k-th
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
                       const __grid_constant__ Flips out, int n_loc) {
  if (fire != nullptr && !*fire) return;
  // the flip of global slot s: its shard's typeid
  auto flip = [&](long long s) {
    out.type_ids[s / n_loc][s % n_loc] = evaporated;
  };
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
    for (int j = t; j < m; j += kSelectThreads) flip((long long)(key_at(j) & kSlot));
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
      if (key <= kth) flip((long long)(key & kSlot));
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
      flip(slot);
      continue;
    }
    long long below = 0;  // candidates below 0xFFFFFFFF at slots <= slot
    for (int i = 0; i < m; ++i) {
      const unsigned long long other = key_at(i);
      if ((other >> 31) != kTie && (long long)(other & kSlot) <= slot) ++below;
    }
    if (slot + 1 - below <= (long long)(k - m_lt)) flip(slot);
  }
}

}  // namespace

extern "C" {

// Each entry point launches its kernel on `stream` and returns the CUDA
// error (0 = launched).

// The pick's scratch for n_shards shards of n_loc slots each:
// `blocks_per_shard` regions of `span` keys (int64) a shard and as many
// counts (int32), at most kPickMaxBlocks regions in all; the wrapper
// allocates n_shards * blocks_per_shard of each.
void az_pick_layout(int n_loc, int n_shards, int* blocks_out, int* span_out) {
  const long long per_shard = kPickMaxBlocks / (n_shards > 0 ? n_shards : 1);
  const long long reach = (long long)kPickThreads * per_shard;
  const int per = (int)(((long long)n_loc + reach - 1) / reach);
  const int span = kPickThreads * (per > 0 ? per : 1);
  *span_out = span;
  *blocks_out = (int)(((long long)n_loc + span - 1) / span);
}

static bool pick_shape_ok(int n_loc, int n_shards) {
  return n_loc > 0 && n_shards > 0 && n_shards <= kMaxShards &&
         (long long)n_loc * n_shards < (1ll << 31);
}

// The pick's first launch: each candidate's key into its block's region of
// `keys`, each block's count into `counts` (az_pick_layout's scratch).
// type_ids, pos, tag: host arrays of n_shards device pointers, shard d's
// int32 [n_loc], float32 [n_loc, 3] and int32 [n_loc]; lo, hi the slab's
// float32 bounds; inv_lz = float32(1 / Lz) (the reciprocal formed in
// double), lz = float32(Lz); (k0, k1) K4's key, its timestep word k1 or,
// with a non-null `clock`, (uint32)(*clock + offset); fire a device bool
// or null (fired).
int az_pick_scan(const int* const* type_ids, const float* const* pos, const int* const* tag,
                 int n_loc, int n_shards, int solvent, float lo, float hi, float inv_lz,
                 float lz, uint32_t k0, uint32_t k1, const long long* clock, int offset,
                 const bool* fire, unsigned long long* keys, int* counts, void* stream) {
  if (!pick_shape_ok(n_loc, n_shards)) return (int)cudaErrorInvalidValue;
  int blocks = 0, span = 0;
  az_pick_layout(n_loc, n_shards, &blocks, &span);
  Shards sh{};
  for (int d = 0; d < n_shards; ++d) {
    sh.type_ids[d] = type_ids[d];
    sh.pos[d] = pos[d];
    sh.tag[d] = tag[d];
  }
  const PickArgs a{n_loc, blocks, solvent, lo, hi, inv_lz, lz, k0, k1,
                   clock, offset};
  pick_scan_kernel<<<blocks * n_shards, kPickThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sh, a, span / kPickThreads, fire, keys, counts);
  return (int)cudaGetLastError();
}

// The pick's second launch: flips, in each shard's typeid (type_ids: a
// host array of n_shards device pointers to int32 [n_loc], in place), the
// candidates among the k smallest keys of az_pick_scan's scratch; k >= 1.
int az_pick_select(int* const* type_ids, int n_loc, int n_shards, int k, int evaporated,
                   const bool* fire, const unsigned long long* keys, const int* counts,
                   void* stream) {
  if (!pick_shape_ok(n_loc, n_shards) || k < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0, span = 0;
  az_pick_layout(n_loc, n_shards, &blocks, &span);
  Flips out{};
  for (int d = 0; d < n_shards; ++d) out.type_ids[d] = type_ids[d];
  pick_select_kernel<<<1, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, counts, blocks * n_shards, span, k, evaporated, fire, out, n_loc);
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
