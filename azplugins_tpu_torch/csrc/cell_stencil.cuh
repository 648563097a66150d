// Shared geometry and schedule of the cell-stencil kernels
// (cell_pair_force.cu, cell_dpd_force.cu, cell_aniso_force.cu).
//
// Layout (ops/dense.py): S = C * cap slots, cell-major; slot s = c * cap + r.
// Cells are indexed (cx * Dy + cy) * Dz + cz. Empty slots carry tag < 0.
//
// Window (a spatial shard, parallel/spatial.py::halo_window): the input
// arrays hold n_cols whole z columns of the grid (a column is cx * Dy + cy)
// in ring order from column w0, each column Dz cells of cap slots; a launch
// computes the n_own columns from column c0 (inside the window) and writes
// its outputs for them alone, own cell (column - c0) * Dz + cz. Geometry
// (the stencil, its wraps and lattice shifts) is the grid's; a neighbour
// cell is then read at its window cell. The whole grid is w0 = c0 = 0,
// n_cols = n_own = Dx * Dy, and gives what a launch without windows gave.
//
// One schedule, the packed schedule (the second half of this file): one
// block per cell; the occupied slots of the whole stencil are staged once,
// each i slot gets several lanes, and each lane lists the candidates inside
// its filter radius before it evaluates any of them. Each pair is evaluated
// from both of its sides, so there are no atomics and the sums are
// deterministic.
//
// Grids with >= 3 cells on every axis use the 27-cell stencil and take the
// periodic lattice shift from the neighbour cell's index wrap, never from
// positions (positions drift unwrapped between rebuilds). Per pair, the
// separation is formed exactly as the reference's Newton half stencil forms
// it from the pair's home side (the cell whose offset to the other is
// lexicographically positive), then negated where this thread is the far
// side: separations, and with them the cutoff decisions, are bitwise those
// of the plain PyTorch version, and the far side's separation is the exact
// negation of the home side's. Grids with an axis under 3 cells use the
// deduplicated stencil with per-pair minimum image, as the reference's
// full-stencil branch does. The geometry uses explicitly rounded
// intrinsics so that it is never contracted into fused multiply-adds.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace az {

struct BoxArgs {
  float Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz;
};

struct Window {
  int w0, n_cols, c0, n_own;

  // The window cell of the grid's cell g, or -1 where the window does not
  // hold its column. cols = Dx * Dy.
  __host__ __device__ __forceinline__ int cell(int g, int Dz, int cols) const {
    int k = g / Dz - w0;
    if (k < 0) k += cols;
    return k < n_cols ? k * Dz + g % Dz : -1;
  }
};

__device__ __forceinline__ int wrap_cell(int c, int D, int* w) {
  if (c < 0) {
    *w = -1;
    return c + D;
  }
  if (c >= D) {
    *w = 1;
    return c - D;
  }
  *w = 0;
  return c;
}

// r + sum of the lattice vectors a_k times w_k, added axis by axis in the
// order the reference's halo pad adds them (x cell axis, then y, then z).
__device__ __forceinline__ void lattice_shift(float* x, float* y, float* z, int wx, int wy,
                                              int wz, const BoxArgs& b) {
  if (wx) *x = __fadd_rn(*x, wx > 0 ? b.Lx : -b.Lx);
  if (wy) {
    *x = __fadd_rn(*x, wy > 0 ? b.xyLy : -b.xyLy);
    *y = __fadd_rn(*y, wy > 0 ? b.Ly : -b.Ly);
  }
  if (wz) {
    *x = __fadd_rn(*x, wz > 0 ? b.xzLz : -b.xzLz);
    *y = __fadd_rn(*y, wz > 0 ? b.yzLz : -b.yzLz);
    *z = __fadd_rn(*z, wz > 0 ? b.Lz : -b.Lz);
  }
}

// Box::min_image_components of the port, operation for operation.
__device__ __forceinline__ void min_image(float* dx, float* dy, float* dz, const BoxArgs& b) {
  const float fz = __fdiv_rn(*dz, b.Lz);
  const float fy = __fdiv_rn(__fsub_rn(*dy, __fmul_rn(b.yzLz, fz)), b.Ly);
  const float fx = __fdiv_rn(
      __fsub_rn(__fsub_rn(*dx, __fmul_rn(b.xyLy, fy)), __fmul_rn(b.xzLz, fz)), b.Lx);
  const float sx = rintf(fx), sy = rintf(fy), sz = rintf(fz);
  *dx = __fsub_rn(*dx, __fadd_rn(__fadd_rn(__fmul_rn(sx, b.Lx),
                                           __fmul_rn(__fmul_rn(sy, b.xy), b.Ly)),
                                 __fmul_rn(__fmul_rn(sz, b.xz), b.Lz)));
  *dy = __fsub_rn(*dy, __fadd_rn(__fmul_rn(sy, b.Ly), __fmul_rn(__fmul_rn(sz, b.yz), b.Lz)));
  *dz = __fsub_rn(*dz, __fmul_rn(sz, b.Lz));
}

// Separation (this slot minus the staged slot) and its square.
template <bool MIN_IMAGE>
__device__ __forceinline__ float separation(float xs, float ys, float zs, float xj, float yj,
                                            float zj, const BoxArgs& b, float* dx, float* dy,
                                            float* dz) {
  *dx = __fsub_rn(xs, xj);
  *dy = __fsub_rn(ys, yj);
  *dz = __fsub_rn(zs, zj);
  if (MIN_IMAGE) min_image(dx, dy, dz, b);
  return __fadd_rn(__fadd_rn(__fmul_rn(*dx, *dx), __fmul_rn(*dy, *dy)), __fmul_rn(*dz, *dz));
}

// ---------------------------------------------------------------------------
// The packed schedule
// ---------------------------------------------------------------------------
//
// One block of B threads per cell (B a template parameter: each kernel
// picks its own; cell_aniso_force.cu gives a block several cells, with a
// plan of its own), in four steps:
// 1. plan_stencil lists the deduplicated stencil's neighbour cells (the
//    segments: offsets {-1,0,1} on an axis with >= 3 cells, {0,1} with 2,
//    {0} with 1, in lexicographic order, x slowest, as GridSpec.stencil
//    lists them), counts each one's occupied slots and numbers the occupied
//    slots of all segments 0..M-1 (the candidates), segment after segment,
//    each in slot order. A segment is forward where the reference's half
//    stencil evaluates its pairs from this block's cell (its offset is
//    lexicographically positive). For a backward segment this cell's own
//    position is shifted into the neighbour's frame (the separation is
//    then the exact negation of the home side's); consecutive segments in
//    which it takes the same shift form a run.
// 2. stage_round copies candidates into shared memory, a forward segment's
//    positions shifted into this cell's frame: all M at once when they fit
//    the staging buffer (kStageBytes, or the kernel's own size), else in
//    rounds of its size. Only occupied slots are staged, so every loop
//    below runs to the cells' occupancy, not to cap.
// 3. The cell's n_i occupied slots get K = B / n_i lanes each (LaneMap; one
//    lane each, in rounds, where n_i > B). Lane k of slot i takes the
//    candidates k, k + K, ... of each run (sweep_round). It first only
//    forms the separation and tests it against the largest cutoff of its
//    type, listing the hits (buffer indices) in shared memory; the kernel's
//    flush evaluates the list when any lane of the warp may fill it and at
//    the end of each run. So the evaluation runs only on lanes that hold
//    pairs, up to the longest list of the warp. From a Verlet pair list
//    (PairList; the pair kernel's) a lane tests only its listed candidates
//    (sweep_list), in the same order.
// 4. reduce_lanes adds each slot's K partial sums in lane order.
// Global loads go kBatch to a thread at a time, so their latencies overlap.
// The order of every sum depends on the input alone, so two launches on the
// same input give the same bits.
//
// Precondition: each cell's occupied slots are its first ones (slot r of a
// cell holding n particles is occupied for r < n), the layout
// ops/dense.py::_bin_to_slots builds and every state of the port keeps. The
// plan checks it; a block whose stencil breaks it writes NaN to its cell's
// outputs (poison_cell) rather than drop a candidate.

constexpr int kStageBytes = 24 * 1024;  // a block's staging buffer, at most; more go in rounds
constexpr int kListLen = 32;      // candidates a lane lists before a flush
constexpr int kUnroll = 4;        // candidates a lane tests per step of the filter
constexpr int kBatch = 4;         // independent global loads a thread issues at once
constexpr int kMaxSegments = 27;  // the 27-cell stencil
constexpr int kTableSmemBytes = 32 * 1024;  // larger tables are read from global memory
constexpr unsigned kFullMask = 0xffffffffu;

// a wrap (each of wx, wy, wz in -1..1) in one int; kNoWrap is (0, 0, 0)
constexpr int kNoWrap = 21;
__device__ __forceinline__ int pack_wrap(int wx, int wy, int wz) {
  return (wx + 1) | ((wy + 1) << 2) | ((wz + 1) << 4);
}
// the packed wrap of (-wx, -wy, -wz): each 2-bit field f becomes 2 - f
__device__ __forceinline__ int negated_wrap(int p) { return 42 - p; }

// Lattice shift by a packed wrap, as lattice_shift adds it.
__device__ __forceinline__ void shift_by(float* x, float* y, float* z, int p, const BoxArgs& b) {
  if (p != kNoWrap)
    lattice_shift(x, y, z, (p & 3) - 1, ((p >> 2) & 3) - 1, ((p >> 4) & 3) - 1, b);
}

__host__ __device__ __forceinline__ int stencil_extent(int D) { return D >= 3 ? 3 : (D >= 2 ? 2 : 1); }

struct StencilPlan {
  int n_seg, self_seg, n_runs;
  int prefix;                   // the precondition holds and the window holds every segment
  int cell[kMaxSegments];       // the neighbour's window cell
  int wrap[kMaxSegments];       // packed wrap of the neighbour cell; -1: outside the window
  int forward[kMaxSegments];    // this cell is the pair's home side
  int start[kMaxSegments + 1];  // segment s holds candidates [start[s], start[s + 1])
  int last[kMaxSegments];       // one past the segment's last occupied slot
  int run_lo[kMaxSegments + 1]; // run r holds candidates [run_lo[r], run_lo[r + 1])
  int self_shift[kMaxSegments]; // packed shift of this cell's own position in run r
};

// Occupied slots of each segment, added into P.start[s + 1], and one past
// its last, into P.last[s]: each thread reads W tags at a time (W = 4: an
// int4 load), kBatch loads in flight. P: a plan with cell, start and last.
template <int B, int W, class Plan>
__device__ __forceinline__ void count_segments(Plan& P, const int* __restrict__ tag, int n_seg,
                                               int cap) {
  const int per = cap / W, total = n_seg * per;
  for (int x0 = threadIdx.x; x0 < total; x0 += kBatch * B) {
    int v[kBatch][W], seg[kBatch], r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int x = min(x0 + u * B, total - 1);  // past the end: read again, not counted
      seg[u] = x / per;
      r[u] = W * (x - seg[u] * per);
      const int* p = tag + P.cell[seg[u]] * cap + r[u];
      if constexpr (W == 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(p));
        v[u][0] = q.x;
        v[u][1] = q.y;
        v[u][2] = q.z;
        v[u][3] = q.w;
      } else {
        v[u][0] = __ldg(p);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      int n = 0, top = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (v[u][w] >= 0) {
          ++n;
          top = r[u] + w + 1;
        }
      }
      if (n > 0 && x0 + u * B < total) {
        atomicAdd(&P.start[seg[u] + 1], n);
        atomicMax(&P.last[seg[u]], top);
      }
    }
  }
}

// Step 1 for the grid's cell `cell`, reading the window `win`; every
// thread of the block calls it, and it ends synchronised. A neighbour cell
// the window does not hold fails the plan (prefix 0), as a broken layout does.
template <int B, bool MIN_IMAGE>
__device__ void plan_stencil(StencilPlan& P, const int* __restrict__ tag, int cell,
                             const Window& win, int Dx, int Dy, int Dz, int cap) {
  const int t = threadIdx.x, lane = t & 31;
  const int ex = stencil_extent(Dx), ey = stencil_extent(Dy), ez = stencil_extent(Dz);
  const int n_seg = ex * ey * ez;
  const int self_seg = (Dx >= 3) * ey * ez + (Dy >= 3) * ez + (Dz >= 3);
  if (t < n_seg) {
    const int cz = cell % Dz, cy = (cell / Dz) % Dy, cx = cell / (Dz * Dy);
    const int ox = t / (ey * ez) - (Dx >= 3);
    const int oy = (t / ez) % ey - (Dy >= 3);
    const int oz = t % ez - (Dz >= 3);
    int wx, wy, wz;
    const int nx = wrap_cell(cx + ox, Dx, &wx);
    const int ny = wrap_cell(cy + oy, Dy, &wy);
    const int nz = wrap_cell(cz + oz, Dz, &wz);
    const int wc = win.cell((nx * Dy + ny) * Dz + nz, Dz, Dx * Dy);
    // outside the window: counted at this cell (always held), then refused
    P.cell[t] = wc >= 0 ? wc : win.cell(cell, Dz, Dx * Dy);
    P.wrap[t] = wc >= 0 ? pack_wrap(wx, wy, wz) : -1;
    P.forward[t] = ox > 0 || (ox == 0 && (oy > 0 || (oy == 0 && oz > 0)));
    P.start[t + 1] = 0;  // the count, summed below
    P.last[t] = 0;
  }
  __syncthreads();
  if ((cap & 3) == 0 && (reinterpret_cast<size_t>(tag) & 15) == 0)
    count_segments<B, 4>(P, tag, n_seg, cap);
  else
    count_segments<B, 1>(P, tag, n_seg, cap);
  __syncthreads();
  if (t < 32) {  // one warp: the prefix sum, the runs and the layout check
    const int n = lane < n_seg ? P.start[lane + 1] : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += v;
    }
    // a nonempty segment starts a run where its shift differs from the
    // shift of the nonempty segment before it
    const int shift = lane < n_seg && n > 0
                          ? ((MIN_IMAGE || P.forward[lane]) ? kNoWrap : negated_wrap(P.wrap[lane]))
                          : -1;
    const unsigned before = __ballot_sync(kFullMask, shift >= 0) & ((1u << lane) - 1u);
    const int prev = __shfl_sync(kFullMask, shift, before ? 31 - __clz(before) : lane);
    const bool starts = shift >= 0 && (before == 0 || prev != shift);
    const unsigned starts_mask = __ballot_sync(kFullMask, starts);
    const bool prefix =
        __all_sync(kFullMask, lane >= n_seg || (P.last[lane] == n && P.wrap[lane] >= 0));
    const int M = __shfl_sync(kFullMask, incl, n_seg - 1);
    if (starts) {
      const int run = __popc(starts_mask & ((1u << lane) - 1u));
      P.run_lo[run] = incl - n;
      P.self_shift[run] = shift;
    }
    if (lane < n_seg) P.start[lane + 1] = incl;
    if (lane == 0) {
      P.start[0] = 0;
      P.n_runs = __popc(starts_mask);
      P.run_lo[__popc(starts_mask)] = M;
      P.n_seg = n_seg;
      P.self_seg = self_seg;
      P.prefix = prefix;
    }
  }
  __syncthreads();
}

// The outputs of a cell whose stencil breaks the precondition or leaves the
// window: NaN in every slot of its own (output) cell, the torque too for a
// kernel that has one, so the caller sees the input was refused. Every
// thread calls it.
template <int B, bool WANT_ALL>
__device__ __forceinline__ void poison_cell(int cell, int cap, float* force, float* energy,
                                            float* virial, float* torque = nullptr) {
  const float nan = __int_as_float(0x7fc00000);
  for (int r = threadIdx.x; r < cap; r += B) {
    const int s = cell * cap + r;
    force[3 * s] = force[3 * s + 1] = force[3 * s + 2] = nan;
    if (torque) torque[3 * s] = torque[3 * s + 1] = torque[3 * s + 2] = nan;
    if (WANT_ALL) {
      energy[s] = nan;
      for (int a = 0; a < 6; ++a) virial[6 * s + a] = nan;
    }
  }
}

// Step 2: stage candidates [R0, R1) at buffer index g - R0. load(slot,
// wrap, forward) reads one slot's entry from global memory and store(index,
// entry) writes it to the buffer. Candidate g of segment s is the segment's
// slot g - start[s] (the precondition). Each thread takes kBatch candidates
// at a time, their loads issued together. Every thread calls it; the caller
// synchronises before and after.
template <int B, class Load, class Store>
__device__ __forceinline__ void stage_round(const StencilPlan& P, int cap, int R0, int R1,
                                            Load&& load, Store&& store) {
  using Entry = decltype(load(0, 0, 0));
  int s = 0;
  for (int g0 = R0 + (int)threadIdx.x; g0 < R1; g0 += kBatch * B) {
    Entry entry[kBatch];
    int slot[kBatch], seg[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = min(g0 + u * B, R1 - 1);  // past R1: read again, not stored
      while (P.start[s + 1] <= g) ++s;
      seg[u] = s;
      slot[u] = P.cell[s] * cap + g - P.start[s];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) entry[u] = load(slot[u], P.wrap[seg[u]], P.forward[seg[u]]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (g0 + u * B < R1) store(g0 + u * B - R0, entry[u]);
    }
  }
}

// Step 3's lane map: K lanes for each of the cell's n_i occupied slots,
// per_round slots at a time.
template <int B>
struct LaneMap {
  int K, per_round, rounds;
  __device__ explicit LaneMap(int n_i) {
    K = n_i < B ? B / max(n_i, 1) : 1;
    per_round = B / K;
    rounds = (n_i + per_round - 1) / per_round;
  }
};

// Step 3 for one lane and one staging round [R0, R1): lists the candidates
// whose squared distance from (xi, yi, zi) is below rfilt_sq in
// list[e * B + t] and calls flush(xs, ys, zs, n) to evaluate them, (xs, ys,
// zs) being this cell's own position as the run's pairs see it. self_g is
// the lane's own candidate number, never listed. Each step tests kUnroll
// candidates, K apart. Every thread of the block calls it with the same
// R0, R1 and K.
template <int B, bool MIN_IMAGE, class Flush>
__device__ __forceinline__ void sweep_round(const StencilPlan& P, const float4* __restrict__ pos4,
                                            int R0, int R1, int K, int k, bool active, int self_g,
                                            float xi, float yi, float zi, float rfilt_sq,
                                            const BoxArgs& box, unsigned short* list,
                                            Flush&& flush) {
  const int t = threadIdx.x;
  for (int run = 0; run < P.n_runs; ++run) {
    const int lo = max(P.run_lo[run], R0), hi = min(P.run_lo[run + 1], R1);
    if (lo >= hi) continue;
    float xs = xi, ys = yi, zs = zi;
    if (!MIN_IMAGE) shift_by(&xs, &ys, &zs, P.self_shift[run], box);
    int n = 0;
    for (int base = lo + k; base - k < hi; base += kUnroll * K) {
      float rsq[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // kUnroll independent tests
        const float4 pj = pos4[min(base + u * K, hi - 1) - R0];
        float dx, dy, dz;
        rsq[u] = separation<MIN_IMAGE>(xs, ys, zs, pj.x, pj.y, pj.z, box, &dx, &dy, &dz);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int g = base + u * K;
        if (active && g < hi && g != self_g && rsq[u] < rfilt_sq) {
          list[n * B + t] = (unsigned short)(g - R0);
          ++n;
        }
      }
      if (__any_sync(kFullMask, n > kListLen - kUnroll)) {
        flush(xs, ys, zs, n);
        n = 0;
      }
    }
    flush(xs, ys, zs, n);
  }
}

// A Verlet pair list of step 3 (cell_pair_force.cu's build and sweep): a
// lane's candidates within a list radius of its slot at the last rebuild's
// positions, in the order sweep_round visits them (ascending). A lane's
// entries go in groups of kListGroup, one 16-byte access a group: entry e
// of lane t of the block of own cell b is list_entry(pl, b, t, e), a
// candidate number; counts[b * B + t] entries; cap_e (a multiple of
// kListGroup) at most. The build keeps each block's plan (kPlanInts ints
// from plans + b * kPlanInts), which its sweeps load instead of planning
// anew. A block with fallback[b] != 0 (its lists overflowed cap_e, or its
// stencil takes several staging or i rounds, or breaks the precondition)
// plans and sweeps every candidate instead; each build adds its blocks that
// fall back into *n_fallback.
constexpr int kListGroup = 8;
constexpr int kPlanInts = (int)(sizeof(StencilPlan) / sizeof(int));
struct PairList {
  unsigned short* entries;
  unsigned short* counts;
  int* fallback;
  int* plans;
  unsigned long long* n_fallback;
  int cap_e;
};

// A plan to a block's kPlanInts ints of global memory, and back (the load
// ends synchronised). Every thread calls them.
template <int B>
__device__ __forceinline__ void store_plan(const StencilPlan& P, int* __restrict__ dst) {
  const int* src = reinterpret_cast<const int*>(&P);
  for (int x = threadIdx.x; x < kPlanInts; x += B) dst[x] = src[x];
}
template <int B>
__device__ __forceinline__ void load_plan(StencilPlan& P, const int* __restrict__ src) {
  int* dst = reinterpret_cast<int*>(&P);
  for (int x = threadIdx.x; x < kPlanInts; x += B) dst[x] = __ldg(src + x);
  __syncthreads();
}

// Appends a lane's entries to its list a whole group at a time (one 16-byte
// store), the group's entries held in registers until it is complete; past
// cap entries nothing more is stored (the list overflowed).
struct ListWriter {
  uint4* dst;  // the lane's first group; the next ones B groups apart
  int n, cap;
  unsigned w[4];
  __device__ __forceinline__ ListWriter(uint4* d, int c) : dst(d), n(0), cap(c), w{0, 0, 0, 0} {}
  __device__ __forceinline__ void shift_in(unsigned v) {
    w[0] = (w[0] >> 16) | (w[1] << 16);
    w[1] = (w[1] >> 16) | (w[2] << 16);
    w[2] = (w[2] >> 16) | (w[3] << 16);
    w[3] = (w[3] >> 16) | (v << 16);
  }
  template <int B>
  __device__ __forceinline__ void push(unsigned v) {
    shift_in(v);
    if (++n % kListGroup == 0 && n <= cap)
      dst[(size_t)(n / kListGroup - 1) * B] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // the last group, where it is partial (padded with zeros past the count)
  template <int B>
  __device__ __forceinline__ void finish() {
    if (n % kListGroup == 0 || n > cap) return;
    for (int m = n; m % kListGroup; ++m) shift_in(0);
    dst[(size_t)(n / kListGroup) * B] = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <int B>
__device__ __forceinline__ size_t list_entry(const PairList& pl, int b, int t, int e) {
  return (((size_t)b * (pl.cap_e / kListGroup) + e / kListGroup) * B + t) * kListGroup +
         e % kListGroup;
}

// A lane's own position as the pairs of candidate g's run see it (its
// run's shift, as sweep_round applies it), for g ascending.
struct RunCursor {
  int run, hi;
  float xs, ys, zs;
  __device__ __forceinline__ RunCursor() : run(-1), hi(0), xs(0.f), ys(0.f), zs(0.f) {}
  template <bool MIN_IMAGE>
  __device__ __forceinline__ void seek(const StencilPlan& P, int g, float xi, float yi, float zi,
                                       const BoxArgs& box) {
    if (g < hi) return;
    do {
      ++run;
      hi = P.run_lo[run + 1];
    } while (g >= hi);
    xs = xi;
    ys = yi;
    zs = zi;
    if (!MIN_IMAGE) shift_by(&xs, &ys, &zs, P.self_shift[run], box);
  }
};

// Step 3 from a lane's list (one staging round, R0 = 0): the lane's cnt
// entries from lst (its first group; the next ones B groups apart), a
// group a step, the next group's load in flight; those whose squared
// distance from (xi, yi, zi), shifted as their run has it, is below
// rfilt_sq are listed in list[n * B + t] and flush(n) evaluates them when
// any lane of the warp may fill it, and at the end. The list holds every
// candidate sweep_round would list, in its order, so the lane evaluates
// the same candidates in the same order. Every thread of the block calls it.
template <int B, bool MIN_IMAGE, class Flush>
__device__ __forceinline__ void sweep_list(const StencilPlan& P, const float4* __restrict__ pos4,
                                           const uint4* __restrict__ lst, int cnt, float xi,
                                           float yi, float zi, float rfilt_sq, const BoxArgs& box,
                                           unsigned short* list, Flush&& flush) {
  static_assert(kListLen >= 2 * kListGroup, "a step lists at most kListGroup");
  const int t = threadIdx.x;
  const int n_groups = (cnt + kListGroup - 1) / kListGroup;
  uint4 cur = n_groups > 0 ? __ldg(lst) : make_uint4(0, 0, 0, 0);
  RunCursor c;
  int n = 0;
  for (int gi = 0; __any_sync(kFullMask, gi < n_groups); ++gi) {
    const uint4 next = gi + 1 < n_groups ? __ldg(lst + (size_t)(gi + 1) * B)
                                         : make_uint4(0, 0, 0, 0);
    if (gi < n_groups) {
      const unsigned w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int u = 0; u < kListGroup; ++u) {
        if (gi * kListGroup + u < cnt) {
          const int g = (int)((w[u / 2] >> (16 * (u % 2))) & 0xffffu);
          c.seek<MIN_IMAGE>(P, g, xi, yi, zi, box);
          const float4 pj = pos4[g];
          float dx, dy, dz;
          const float rsq =
              separation<MIN_IMAGE>(c.xs, c.ys, c.zs, pj.x, pj.y, pj.z, box, &dx, &dy, &dz);
          if (rsq < rfilt_sq) {
            list[n * B + t] = (unsigned short)g;
            ++n;
          }
        }
      }
    }
    cur = next;
    if (__any_sync(kFullMask, n > kListLen - kListGroup)) {
      flush(n);
      n = 0;
    }
  }
  flush(n);
}

// Step 4: this i round's lane partials to slot sums; write(ir, sum) for
// each occupied slot rank ir of the round, sum[a] = its K partials added in
// lane order. Every thread of the block calls it.
template <int B, int N_ACC, class Write>
__device__ __forceinline__ void reduce_lanes(float* part, const float (&acc)[N_ACC],
                                             const LaneMap<B>& L, int q, int n_i, Write&& write) {
  const int t = threadIdx.x;
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) part[a * B + t] = acc[a];
  __syncthreads();
  const int ir = q * L.per_round + t;
  if (t < L.per_round && ir < n_i) {
    float sum[N_ACC];
#pragma unroll
    for (int a = 0; a < N_ACC; ++a) sum[a] = part[a * B + t * L.K];
    for (int k = 1; k < L.K; ++k) {
#pragma unroll
      for (int a = 0; a < N_ACC; ++a) sum[a] += part[a * B + t * L.K + k];
    }
    write(ir, sum);
  }
  __syncthreads();
}

// Shared memory of one block, carved from the dynamic allocation in this
// order, each piece 16-byte aligned: the staging buffer (stage_cap entries
// of entry_bytes, within stage_bytes), the tables where they fit in
// kTableSmemBytes (else tab_floats is 0 and the kernel reads them from
// global memory), the lane partials and the lists.
struct PackedLayout {
  int stage_cap, tab_floats, off_tab, off_part, off_list, bytes;
};

// Host side: grid, block and layout for blocks of `threads` over the own
// columns of `win`; false for a shape or a window the kernels do not take.
// A kernel may stage in a smaller buffer than kStageBytes, and may give a
// block `group` consecutive cells along z (its stencil is then the cells
// within one of any of them).
inline bool packed_launch(int Dx, int Dy, int Dz, int cap, const Window& win, int T,
                          int n_tab_rows, int entry_bytes, int n_acc, int threads, dim3* grid,
                          dim3* block, PackedLayout* L, int stage_bytes = kStageBytes,
                          int group = 1) {
  const long long n_cells = (long long)Dx * Dy * Dz;
  if (n_cells <= 0 || n_cells > 2147483647LL || cap <= 0 || T <= 0) return false;
  const int cols = Dx * Dy;
  if (win.w0 < 0 || win.w0 >= cols || win.n_cols < 1 || win.n_cols > cols || win.c0 < 0 ||
      win.n_own < 1 || win.c0 + win.n_own > cols ||
      (win.c0 - win.w0 + cols) % cols + win.n_own > win.n_cols)
    return false;
  if (stage_bytes < entry_bytes || stage_bytes > kStageBytes) return false;
  if (group < 1 || (group > 1 && group + 2 > Dz)) return false;
  auto align16 = [](long long b) { return (b + 15) & ~15LL; };
  const long long n_seg = stencil_extent(Dx) * stencil_extent(Dy) *
                          (group > 1 ? group + 2 : stencil_extent(Dz));
  const long long stage_cap = std::min(n_seg * cap, (long long)(stage_bytes / entry_bytes));
  const long long tab = (long long)n_tab_rows * T * T;
  L->stage_cap = (int)stage_cap;
  L->tab_floats = 4 * tab <= kTableSmemBytes ? (int)tab : 0;
  long long off = align16(stage_cap * entry_bytes);
  L->off_tab = (int)off;
  off = align16(off + 4LL * L->tab_floats);
  L->off_part = (int)off;
  off = align16(off + 4LL * n_acc * threads);
  L->off_list = (int)off;
  L->bytes = (int)align16(off + 2LL * kListLen * threads);
  *grid = dim3((unsigned)((long long)win.n_own * ((Dz + group - 1) / group)));
  *block = dim3(threads);
  return true;
}

// Launch on `stream` with the layout's dynamic shared memory, raising the
// kernel's limit where it passes 48 KB; returns the launch's error (0 = launched).
template <class... KArgs, class... Args>
inline cudaError_t launch_packed(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                                 const PackedLayout& L, cudaStream_t stream, Args... args) {
  if (L.bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the wrapper raises on the value returned
      return err;
    }
  }
  kernel<<<grid, block, L.bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace az
