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
// Five kernels and a memset, one entry point (az_cell_sums):
//   1. count: a row a thread, an integer atomic add to its cell's count
//      (exact, whatever the order);
//   2. scan: the exclusive scan of the cells + 1 counts, in tiles of
//      kScanTile entries a block (warp shuffles, then the warps' totals),
//      and 3. the tiles' totals scanned by one block in rounds of 1,024, so
//      a cell's first row sits at off[c] + part[c / kScanTile];
//   4. place: a row a thread takes a slot in its cell's bucket with an
//      atomic decrement of the count (an order that varies);
//   5. rank: a row a thread counts the rows of its bucket with a smaller
//      index and writes itself at that rank (buckets hold a few rows, so the
//      pass is short; a bucket of n rows costs n^2 reads, spread over its n
//      threads): the buckets are now in ascending row order;
//   6. sum: a cell a thread adds its rows' payloads in that order.
//
// What bounds it on an H100: the bytes. A row's id (8 B), velocity (12 B)
// and mass (4 B) are read once and a cell's six sums written once (24 B);
// the passes between them move a few int32 a row and a cell more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr unsigned kFull = 0xFFFFFFFFu;

int blocks(long long n, int threads) { return (int)((n + threads - 1) / threads); }

__device__ __forceinline__ bool in_range(long long c, int cells) { return c >= 0 && c < cells; }

// The exclusive scan of x over the block (kScanThreads threads); *total
// receives the block's sum. Uses `warp_sums` (32 entries) and returns after
// a barrier, so the caller may call it again.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = incl - x + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[31];
  __syncthreads();
  return excl;
}

// where cell c's rows start in the buckets
__device__ __forceinline__ int start_of(const int* off, const int* part, int c) {
  return off[c] + part[c / kScanTile];
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const long long* __restrict__ cid, int n, int cells, int* __restrict__ cnt) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long c = __ldg(cid + i);
  if (in_range(c, cells)) atomicAdd(cnt + c, 1);
}

// tile b's entries of cnt[0..m): off[j] = the sum of the tile's entries
// before j; part[b] = the tile's sum
__global__ void __launch_bounds__(kScanThreads)
    scan_tiles_kernel(const int* __restrict__ cnt, int m, int* __restrict__ off,
                      int* __restrict__ part) {
  __shared__ int warp_sums[32];
  const long long base = (long long)blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems], run = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = base + k < m ? cnt[base + k] : 0;
    run += v[k];
  }
  int total;
  int excl = block_exclusive_scan(run, warp_sums, &total);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k < m) off[base + k] = excl;
    excl += v[k];
  }
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// one block: the exclusive scan of part[0..tiles) in place, in rounds
__global__ void __launch_bounds__(kScanThreads) scan_parts_kernel(int* __restrict__ part,
                                                                  int tiles) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int first = 0; first < tiles; first += kScanThreads) {
    const int j = first + threadIdx.x;
    const int x = j < tiles ? part[j] : 0;
    int total;
    const int excl = block_exclusive_scan(x, warp_sums, &total);
    if (j < tiles) part[j] = carry + excl;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
    place_kernel(const long long* __restrict__ cid, int n, int cells, const int* __restrict__ off,
                 const int* __restrict__ part, int* __restrict__ cnt, int* __restrict__ bucket) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long c = __ldg(cid + i);
  if (!in_range(c, cells)) return;
  const int k = atomicSub(cnt + c, 1) - 1;
  bucket[start_of(off, part, (int)c) + k] = i;
}

__global__ void __launch_bounds__(kThreads)
    rank_kernel(const long long* __restrict__ cid, int n, int cells, const int* __restrict__ off,
                const int* __restrict__ part, const int* __restrict__ bucket,
                int* __restrict__ order) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long c = __ldg(cid + i);
  if (!in_range(c, cells)) return;
  const int s = start_of(off, part, (int)c), e = start_of(off, part, (int)c + 1);
  int r = 0;
  for (int j = s; j < e; ++j) r += __ldg(bucket + j) < i;
  order[s + r] = i;
}

__global__ void __launch_bounds__(kThreads)
    sum_kernel(const float* __restrict__ vel, const float* __restrict__ mass, int cells,
               const int* __restrict__ off, const int* __restrict__ part,
               const int* __restrict__ order, float* __restrict__ sums) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cells) return;
  const int s = start_of(off, part, c), e = start_of(off, part, c + 1);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = s; j < e; ++j) {
    const int i = __ldg(order + j);
    const float m = mass != nullptr ? __ldg(mass + i) : 1.0f;
    float v[3], mv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = __ldg(vel + 3 * (long long)i + k);
      mv[k] = __fmul_rn(v[k], m);
    }
    const float mv2 = __fadd_rn(__fadd_rn(__fmul_rn(v[0], mv[0]), __fmul_rn(v[2], mv[2])),
                                __fmul_rn(v[1], mv[1]));
    acc[0] = __fadd_rn(acc[0], 1.0f);
    acc[1] = __fadd_rn(acc[1], m);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[2 + k] = __fadd_rn(acc[2 + k], mv[k]);
    acc[5] = __fadd_rn(acc[5], mv2);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) sums[6 * (long long)c + k] = acc[k];
}

}  // namespace

extern "C" {

// The int32 entries of az_cell_sums's workspace for n rows and `cells`
// cells: the counts and their scan (cells + 1 each), the tiles' totals, the
// buckets and their ordered copy (n each).
long long az_cell_sums_work(int n, int cells) {
  const long long m = (long long)cells + 1;
  return 2 * m + (m + kScanTile - 1) / kScanTile + 2 * (long long)n;
}

// K10: `sums` float32 [cells, 6], cell c's (count, mass, momentum xyz, m v^2)
// over the rows i with cid[i] == c, added in ascending i from +0.0; `cid`
// int64 [n], `vel` float32 [n, 3], `mass` float32 [n] or null (1 a row),
// `work` int32 of az_cell_sums_work(n, cells) entries. Launches on `stream`
// and returns the CUDA error (0 = launched).
int az_cell_sums(const long long* cid, const float* vel, const float* mass, int n, int cells,
                 int* work, float* sums, void* stream) {
  if (n < 0 || cells <= 0 || cells == 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaMemsetAsync(sums, 0, sizeof(float) * 6 * (size_t)cells, st);
    return (int)cudaGetLastError();
  }
  const int m = cells + 1, tiles = blocks(m, kScanTile);
  int* cnt = work;
  int* off = cnt + m;
  int* part = off + m;
  int* bucket = part + tiles;
  int* order = bucket + n;
  cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)m, st);
  count_kernel<<<blocks(n, kThreads), kThreads, 0, st>>>(cid, n, cells, cnt);
  scan_tiles_kernel<<<tiles, kScanThreads, 0, st>>>(cnt, m, off, part);
  scan_parts_kernel<<<1, kScanThreads, 0, st>>>(part, tiles);
  place_kernel<<<blocks(n, kThreads), kThreads, 0, st>>>(cid, n, cells, off, part, cnt, bucket);
  rank_kernel<<<blocks(n, kThreads), kThreads, 0, st>>>(cid, n, cells, off, part, bucket, order);
  sum_kernel<<<blocks(cells, kThreads), kThreads, 0, st>>>(vel, mass, cells, off, part, order,
                                                           sums);
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
