// The MPCD collision's cell sums, deterministic (K10).
//
// No pallas_call is replaced: the reference forms them as one scatter-add,
// `zeros((C + 1, 6)).at[cid].add(pay)` (azplugins_tpu/mpcd.py:267-273), which
// XLA lowers without atomics on its devices, so a collision is bitwise
// reproducible from run to run. PyTorch's `index_add_` on CUDA adds with
// float atomics, in an order that varies between runs; on the CPU it adds
// each index's rows in ascending row order from +0.0. This kernel gives
// that order on the card: every cell's sums are its rows' payloads added
// one at a time, in ascending row order, from +0.0 (mpcd.py::_cell_sums,
// whose plain version is mpcd.py::_cell_sums_plain).
//
// The payload of row i (mass m_i, 1 where `mass` is null; velocity v_i) is
// (1, m, m v, sum_k v_k (v_k m)), each product rounded on its own, the sum
// over 3 in the card's torch.sum order, (x0 + x2) + x1: what mpcd.py's
// _payload forms with PyTorch's operations on the card. Rows whose cell id
// lies outside [0, cells) (the collision's trash cell for empty MD slots)
// are left out: nothing reads the trash cell's sums.
//
// A memset of the counts and two kernels a call (three graph nodes):
//   1. place: a row a thread takes a slot in its cell's bucket with an
//      integer atomic on the cell's count and, below the bucket's capacity
//      `cap` (the wrapper's, at least twice the mean rows a cell), writes
//      its index there; a row past it appends (cell, row) to the overflow
//      list instead (one atomic a warp). The slots come in an order that
//      varies; the count is exact.
//   2. sum: G lanes a cell (G = 1, 8, 16 or 32, the wrapper's pick from
//      the rows a cell). A lone lane (G = 1, for a row a cell) loads four
//      slots in one vector load, sorts them in registers and adds their
//      payloads; a group of G lanes loads a slot each, sorts with a bitonic
//      network over shuffles, gathers its rows in parallel and lanes 0-5
//      add the six columns in row order from shared memory. A cell deeper
//      than that (4 rows for a lone lane, G for a group) is taken by its
//      warp as a group of 32 after the others, and one deeper than 32 by
//      its block: the bucket's indices and the cell's entries of the
//      overflow list (a pass over the list, which ends when the cell's
//      rows are all found) sorted in shared memory (bitonic, up to
//      kSortRows), or, deeper still, the rows found in order by the
//      block's pass over every row's cell id (ballots, so each keeps its
//      place); the block adds them kThreads rows at a time from shared
//      memory.
// A cell's rows are thus gathered in parallel and two dependent loads
// (count and slots, then rows) stand between the kernel's start and a
// sum. The buckets are small (8 slots, one 32-byte sector, at a row a
// cell) so that the scattered slots and the sums' reads of them stay few
// sectors and mostly in L2; the overflow list is short where the cap is
// at least twice the mean.
//
// What bounds it on an H100: the bytes. A row's id (8 B), velocity (12 B)
// and mass (4 B) are read once and a cell's six sums written once (24 B);
// the buckets add 4 B a row written and a sector a cell read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSortRows = 4096;  // the most rows of a cell a block sorts
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNone = 0x7FFFFFFF;  // an empty slot: sorts last

int blocks(long long n, int threads) { return (int)((n + threads - 1) / threads); }

__device__ __forceinline__ bool in_range(long long c, int cells) { return c >= 0 && c < cells; }

// row i's payload: (1, m, m v0, m v1, m v2, (v0 mv0 + v2 mv2) + v1 mv1)
__device__ __forceinline__ void payload(const float* __restrict__ vel,
                                        const float* __restrict__ mass, int i, float* p) {
  const float m = mass != nullptr ? __ldg(mass + i) : 1.0f;
  const float v0 = __ldg(vel + 3 * (long long)i), v1 = __ldg(vel + 3 * (long long)i + 1),
              v2 = __ldg(vel + 3 * (long long)i + 2);
  const float mv0 = __fmul_rn(v0, m), mv1 = __fmul_rn(v1, m), mv2 = __fmul_rn(v2, m);
  p[0] = 1.0f;
  p[1] = m;
  p[2] = mv0;
  p[3] = mv1;
  p[4] = mv2;
  p[5] = __fadd_rn(__fadd_rn(__fmul_rn(v0, mv0), __fmul_rn(v2, mv2)), __fmul_rn(v1, mv1));
}

__device__ __forceinline__ void order(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// a cell of at most 4 rows by one lane: its four slots in one load, sorted
// in registers, the payloads gathered and added in row order
__device__ __forceinline__ void lone_cell(const float* __restrict__ vel,
                                          const float* __restrict__ mass,
                                          const int* __restrict__ slots, int c, int k,
                                          float* __restrict__ sums) {
  const int4 s = k > 0 ? __ldg(reinterpret_cast<const int4*>(slots)) : make_int4(0, 0, 0, 0);
  int i[4] = {k > 0 ? s.x : kNone, k > 1 ? s.y : kNone, k > 2 ? s.z : kNone,
              k > 3 ? s.w : kNone};
  order(i[0], i[1]);
  order(i[2], i[3]);
  order(i[0], i[2]);
  order(i[1], i[3]);
  order(i[1], i[2]);
  float p[4][6];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < k) payload(vel, mass, i[j], p[j]);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < k) {
#pragma unroll
      for (int q = 0; q < 6; ++q) acc[q] = __fadd_rn(acc[q], p[j][q]);
    }
  float2* out = reinterpret_cast<float2*>(sums + 6 * (long long)c);
  out[0] = make_float2(acc[0], acc[1]);
  out[1] = make_float2(acc[2], acc[3]);
  out[2] = make_float2(acc[4], acc[5]);
}

// ascending bitonic sort of one int a lane over groups of G lanes; every
// lane of the warp takes part
template <int G>
__device__ __forceinline__ int group_sort(int v, int gl) {
#pragma unroll
  for (int size = 2; size <= G; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, stride);
      const bool up = (gl & size) == 0, low = (gl & stride) == 0;
      v = low == up ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// cell c's sums by the G lanes of a group (gl its lane, i its row or kNone;
// `pay` its warp's 32 rows of 6 in shared memory, the group's from row
// `first`); `mine`: the group holds a cell of k <= G rows. Every lane of
// the warp calls it.
template <int G>
__device__ __forceinline__ void group_cell(const float* __restrict__ vel,
                                           const float* __restrict__ mass, int i, bool mine,
                                           int c, int k, int gl, float* pay, int first,
                                           float* __restrict__ sums) {
  i = group_sort<G>(i, gl);
  float p[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (mine && gl < k) payload(vel, mass, i, p);
  float* row = pay + 6 * (first + gl);
#pragma unroll
  for (int q = 0; q < 6; ++q) row[q] = p[q];
  __syncwarp();
  if (mine) {
    const float* rows = pay + 6 * first;
    for (int q = gl; q < 6; q += G) {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, rows[6 * j + q]);
      sums[6 * (long long)c + q] = acc;
    }
  }
  __syncwarp();
}

// the rows of cell c past its bucket's `cap` slots, from the overflow list
// (`spill` entries of (cell << 32 | row)): each lane whose entry is c's
// writes its row at ids[have + its place among them], for the entries
// [base, base + 32) of the list; returns how many it found. Every lane of
// the warp calls it.
__device__ __forceinline__ int warp_spilled(const unsigned long long* __restrict__ ovf,
                                            int spill, int base, int c, int have, int* ids) {
  const int lane = threadIdx.x & 31, j = base + lane;
  const unsigned long long e = j < spill ? __ldg(ovf + j) : ~0ULL;
  const bool hit = (int)(e >> 32) == c;
  const unsigned votes = __ballot_sync(kFull, hit);
  if (hit) ids[have + __popc(votes & ((1u << lane) - 1u))] = (int)(unsigned)e;
  return __popc(votes);
}

// a cell of 32 < k rows by the whole block: the bucket's indices and its
// overflow entries sorted in shared memory (k <= kSortRows) or the rows
// found in order by a pass over every row's id; the payloads added
// kThreads rows at a time by threads 0-5
__device__ void block_cell(const long long* __restrict__ cid, const float* __restrict__ vel,
                           const float* __restrict__ mass, int n, const int* __restrict__ slots,
                           int cap, const unsigned long long* __restrict__ ovf, int spill, int c,
                           int k, int* ids, float* rows, int* counts, float* __restrict__ sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc = 0.0f;
  if (k <= kSortRows) {
    int width = 64;
    while (width < k) width <<= 1;
    const int kept = min(k, cap);
    for (int j = tid; j < width; j += kThreads) ids[j] = j < kept ? __ldg(slots + j) : kNone;
    __syncthreads();
    // the rest from the overflow list, kThreads entries at a time, until found
    for (int base = 0, have = kept; have < k && base < spill; base += kThreads) {
      const int j = base + tid;
      const unsigned long long e = j < spill ? __ldg(ovf + j) : ~0ULL;
      const bool hit = (int)(e >> 32) == c;
      const unsigned votes = __ballot_sync(kFull, hit);
      if (lane == 0) counts[warp] = __popc(votes);
      __syncthreads();
      int at = have + __popc(votes & ((1u << lane) - 1u)), m = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        at += w < warp ? counts[w] : 0;
        m += counts[w];
      }
      if (hit) ids[at] = (int)(unsigned)e;
      have += m;
      __syncthreads();
    }
    for (int size = 2; size <= width; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int j = tid; j < width; j += kThreads) {
          const int o = j ^ stride;
          if (o > j) {
            const int a = ids[j], b = ids[o];
            if ((a > b) == ((j & size) == 0)) {
              ids[j] = b;
              ids[o] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int base = 0; base < k; base += kThreads) {
      if (base + tid < k) payload(vel, mass, ids[base + tid], rows + 6 * tid);
      __syncthreads();
      if (tid < 6) {
        const int m = min(kThreads, k - base);
        for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, rows[6 * j + tid]);
      }
      __syncthreads();
    }
  } else {
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      const bool hit = i < n && __ldg(cid + i) == c;
      const unsigned votes = __ballot_sync(kFull, hit);
      if (lane == 0) counts[warp] = __popc(votes);
      __syncthreads();
      int at = __popc(votes & ((1u << lane) - 1u)), m = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        at += w < warp ? counts[w] : 0;
        m += counts[w];
      }
      if (hit) payload(vel, mass, i, rows + 6 * at);
      __syncthreads();
      if (tid < 6)
        for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, rows[6 * j + tid]);
      __syncthreads();
    }
  }
  if (tid < 6) sums[6 * (long long)c + tid] = acc;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    place_kernel(const long long* __restrict__ cid, int n, int cells, int cap,
                 int* __restrict__ count, int* __restrict__ bucket, int* __restrict__ spill,
                 unsigned long long* __restrict__ ovf) {
  const int i = blockIdx.x * kThreads + threadIdx.x, lane = threadIdx.x & 31;
  const long long c = i < n ? __ldg(cid + i) : -1;
  const bool in = in_range(c, cells);
  const int s = in ? atomicAdd(count + c, 1) : 0;
  const bool over = in && s >= cap;
  if (in && !over) bucket[c * cap + s] = i;
  const unsigned votes = __ballot_sync(kFull, over);
  if (votes) {
    const int leader = __ffs(votes) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(spill, __popc(votes));
    base = __shfl_sync(kFull, base, leader);
    if (over)
      ovf[base + __popc(votes & ((1u << lane) - 1u))] =
          ((unsigned long long)c << 32) | (unsigned)i;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    sum_kernel(const long long* __restrict__ cid, const float* __restrict__ vel,
               const float* __restrict__ mass, int n, int cells, int cap,
               const int* __restrict__ count, const int* __restrict__ bucket,
               const int* __restrict__ spilled, const unsigned long long* __restrict__ ovf,
               float* __restrict__ sums) {
  __shared__ int ids[kSortRows], deep[kThreads], counts[kWarps], n_deep;
  __shared__ float rows[6 * kThreads];  // a warp's 32 rows of 6, or the block's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gl = tid & (G - 1);
  if (tid == 0) n_deep = 0;
  const int c = blockIdx.x * (kThreads / G) + tid / G;
  const bool live = c < cells;
  const int k = live ? __ldg(count + c) : 0;
  const int* slots = bucket + (long long)(live ? c : 0) * cap;
  const int fast = min(G == 1 ? 4 : G, cap);  // the rows a lone lane or a group takes
  if constexpr (G == 1) {
    if (live && k <= fast) lone_cell(vel, mass, slots, c, k, sums);
  } else {
    const bool mine = live && k <= fast;
    group_cell<G>(vel, mass, mine && gl < k ? __ldg(slots + gl) : kNone, mine, c, k, gl,
                  rows + 6 * 32 * warp, lane - gl, sums);
  }
  // deeper cells of at most 32 rows: the warp, as one group, one at a time;
  // rows past the bucket's cap from the overflow list
  const int spill = __ldg(spilled);
  int* warp_ids = ids + 32 * warp;
  unsigned mid = __ballot_sync(kFull, gl == 0 && live && k > fast && k <= 32);
  while (mid) {
    const int src = __ffs(mid) - 1;
    mid &= mid - 1;
    const int cc = __shfl_sync(kFull, c, src), kk = __shfl_sync(kFull, k, src);
    const int kept = min(kk, cap);
    int i = lane < kept ? __ldg(bucket + (long long)cc * cap + lane) : kNone;
    if (kk > kept) {
      warp_ids[lane] = i;
      __syncwarp();
      for (int base = 0, have = kept; have < kk && base < spill; base += 32) {
        have += warp_spilled(ovf, spill, base, cc, have, warp_ids);
        __syncwarp();
      }
      i = warp_ids[lane];
      __syncwarp();
    }
    group_cell<32>(vel, mass, i, true, cc, kk, lane, rows + 6 * 32 * warp, 0, sums);
  }
  // deeper still: the block, one cell at a time
  __syncthreads();
  if (gl == 0 && live && k > 32) deep[atomicAdd(&n_deep, 1)] = c;
  __syncthreads();
  for (int e = 0; e < n_deep; ++e) {
    const int cc = deep[e];
    block_cell(cid, vel, mass, n, bucket + (long long)cc * cap, cap, ovf, spill, cc,
               __ldg(count + cc), ids, rows, counts, sums);
  }
}

template <int G>
void launch_sums(const long long* cid, const float* vel, const float* mass, int n, int cells,
                 int cap, const int* count, const int* bucket, const int* spill,
                 const unsigned long long* ovf, float* sums, cudaStream_t st) {
  sum_kernel<G><<<blocks(cells, kThreads / G), kThreads, 0, st>>>(
      cid, vel, mass, n, cells, cap, count, bucket, spill, ovf, sums);
}

}  // namespace

extern "C" {

// The int32 entries of az_cell_sums's workspace: the overflow list (two
// entries a row, n rounded up to even), the buckets (`cap` slots a cell),
// then the counts (one a cell) and the overflow list's length, which each
// call zeroes.
long long az_cell_sums_work(int n, int cells, int cap) {
  return 2 * ((long long)n + (n & 1)) + (long long)cells * (cap + 1) + 1;
}

// K10: `sums` float32 [cells, 6], cell c's (count, mass, momentum xyz, m v^2)
// over the rows i with cid[i] == c, added in ascending i from +0.0; `cid`
// int64 [n], `vel` float32 [n, 3], `mass` float32 [n] or null (1 a row),
// `group` the lanes a cell (1, 8, 16 or 32), `cap` the slots a bucket (a
// multiple of 4 from 8 to 4,096), `work` int32 of az_cell_sums_work(n,
// cells, cap) entries. Launches a memset and two kernels on `stream` and
// returns the CUDA error (0 = launched).
int az_cell_sums(const long long* cid, const float* vel, const float* mass, int n, int cells,
                 int group, int cap, int* work, float* sums, void* stream) {
  if (n < 0 || cells <= 0 || cap < 8 || cap > kSortRows || cap % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ovf = reinterpret_cast<unsigned long long*>(work);
  int* bucket = work + 2 * ((long long)n + (n & 1));
  int* count = bucket + (long long)cells * cap;
  int* spill = count + cells;
  decltype(&launch_sums<1>) sum;
  switch (group) {
    case 1: sum = launch_sums<1>; break;
    case 8: sum = launch_sums<8>; break;
    case 16: sum = launch_sums<16>; break;
    case 32: sum = launch_sums<32>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaMemsetAsync(count, 0, sizeof(int) * ((size_t)cells + 1), st);
  if (n > 0)
    place_kernel<<<blocks(n, kThreads), kThreads, 0, st>>>(cid, n, cells, cap, count, bucket,
                                                          spill, ovf);
  sum(cid, vel, mass, n, cells, cap, count, bucket, spill, ovf, sums, st);
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
