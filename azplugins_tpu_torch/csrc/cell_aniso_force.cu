// Cell-stencil anisotropic force: TwoPatchMorse force and per-side torques.
//
// Replaces the TPU kernel azplugins_tpu/ops/pallas_pair.py
// (stencil_pair_force_kernel, body _kernel) as run by
// azplugins_tpu/ops/dense.py::_pallas_half_aniso_force. It computes the same
// per-slot sums as the plain version ops/dense.py::dense_aniso_force with the
// evaluator ops/evaluators/aniso.py::two_patch_morse, operation for
// operation; the schedule is Hopper's own: the packed schedule of
// cell_stencil.cuh. For each pair inside r_cut, with u = dx / r and n the
// body x axis rotated by each particle's quaternion:
//
//   U = M_d ((1 - exp(-(r - r_eq) / M_r))^2 - 1)   (flat -M_d below r_eq
//                                                     without repulsion),
//   Omega(g) = 1 / (1 + exp(-omega (g^2 - alpha))),  g = u . n,
//   e = U Omega_i Omega_j - U_cut Omega_i Omega_j (U_cut = 0 for mode none),
//
// the force from dU/dr and dU/dg on both sides, and the torques
// dU/dg_i (u x n_i) to i and dU/dg_j (u x n_j) to j.
//
// Newton's third law bit for bit: every pair is evaluated in its home
// side's frame (the side the reference's half stencil evaluates it from:
// the cell whose offset to the other is lexicographically positive, and the
// lower slot within one cell), as (dx_home, q_home, q_far), on both of its
// lanes, through one call site whose inputs are opaque to the compiler.
// Both lanes then hold the same pair values; the home lane keeps +f and
// t_i, the far lane -f and t_j. Evaluating with the roles swapped would
// reorder the sum dU/dg_i n_i + dU/dg_j n_j, which fused multiply-adds then
// round differently, and the total force would vanish only to round-off.
// Who is home is staged with each candidate (enum Column). Grids with an
// axis under 3 cells take the full stencil with minimum image, as the
// reference's full-stencil branch does: every slot evaluates its pairs in
// its own frame and keeps +f and t_i.
//
// Tables: [kNTab, T, T] float32, indexed in home order, copied into shared
// memory where they fit (az::kTableSmemBytes), else read from global
// memory; a lane keeps the last type pair's values in registers. The filter
// tests against the largest cutoff of the lane's type, the evaluation
// against the pair's own. want_all adds e/2 and the virial 0.5 dx f to each
// side.
//
// What bounds it on an H100: the instructions of each block's fixed work,
// not bytes or arithmetic. At the patchy-colloid state (27,000 particles in
// 23^3 cells of cap 16, mean occupancy 2.2) a call tests ~1.6 M candidates
// and evaluates ~162,000 pair sides (three expf, a sqrt and several divides
// each) on ~1 MB of slot data that stays in L2; the bytes bound it at
// 0.00189 ms. With one block per cell, 12,167 blocks each read the tags of
// 27 cells, number their occupied slots and stage ~60 candidates for two
// particles: that fixed work was two thirds of a call, and it grew with
// the threads of the block (64 threads: 1.6x the time, 128: 2.7x). TMA,
// cp.async pipelines and tensor cores have nothing to offer here; the
// levers are the instructions a cell costs, idle lanes and dependent loads.
// What the design does about them (the packed schedule of cell_stencil.cuh,
// with a plan of its own for sparse cells):
// - a block is one warp (kThreads = 32) and takes kGroup = 4 consecutive
//   cells along z, ~9 particles: their stencils overlap in 54 cells, not
//   108, which the block plans and stages once (plan_group), and the
//   group's particles share the warp's lanes, ~3 each;
// - only occupied slots are staged (two float4 per candidate: position
//   with type and column class, quaternion), so every loop runs to the
//   occupancy, not to cap, and the filter reads 16 bytes a candidate; a
//   lane evaluates only the candidates it listed inside its cutoff, so
//   the transcendental work runs on lanes that hold pairs;
// - a member's stencil is one range of consecutive candidates (the union
//   is numbered layer by layer), so the sweep is az::sweep_round's with
//   each lane on its own member's runs (sweep_group);
// - the staging buffer is kStageEntries candidates (8 KB; a larger stencil
//   goes in rounds), the block's own slots are loaded before the staging
//   and first used after it, and empty slots are zeroed as one contiguous
//   range from the plan's count;
// - the lane partials of a particle are added in lane order by one thread
//   per (particle, accumulator) (reduce_group).
// Grids whose stencil cells would not all be distinct in a group (an axis
// under 3 cells, or fewer than kGroup + 2 cells along z) take one cell a
// block: the same code with a group of one. Cells of ~8 particles are
// better served by one cell a block (0.123 against 0.163 ms at 24^3 cells
// of 8): the constants are sized for the sparse cells of patchy colloids.
// The one-thread-per-slot walk this replaces (27 staging rounds of all cap
// slots per block, 93% of the lanes idle) took 0.2582 ms a call at the
// patchy state on an NVIDIA H100 80GB HBM3 at 700.00 W. IEEE expf, sqrtf
// and division keep it within 2e-5 of the plain version.

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace {

using az::BoxArgs;

// stacked [T, T] float32 tables (ops/aniso_kernel.py::aniso_kernel_tables)
enum Tab { kMd = 0, kMrinv, kReq, kOmega, kAlpha, kRep, kRcutsq, kUcut, kNTab };

constexpr int kThreads = 32;        // threads per block: one warp
constexpr int kGroup = 4;           // consecutive cells along z a block takes
constexpr int kStageEntries = 256;  // candidates a staging round holds (32 bytes each)
constexpr int kStageBatch = 4;      // candidates a thread stages at a time
constexpr int kMaxUnion = 9 * (kGroup + 2);  // cells of a group's stencil
constexpr int kColumnShift = 24;    // a staged type: typeid | column class << kColumnShift

// one type pair's parameters, held in registers
struct Params {
  float M_d, M_rinv, r_eq, omega, alpha, rep, U_cut;
};

struct PairOut {
  float e, fx, fy, fz, tix, tiy, tiz, tjx, tjy, tjz;
};

// Hide a value's origin from the optimiser: whatever the caller selected
// it from, the evaluator after this point compiles to one instruction
// sequence for both sides of a pair.
__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

__device__ __forceinline__ void rotate_x(float w, float x, float y, float z, float* nx,
                                         float* ny, float* nz) {
  *nx = 1.0f - 2.0f * (y * y + z * z);
  *ny = 2.0f * (x * y + w * z);
  *nz = 2.0f * (x * z - w * y);
}

// ops/evaluators/aniso.py::two_patch_morse for one pair with rsq > 0.
__device__ __forceinline__ PairOut two_patch_morse(float dx, float dy, float dz,
                                                   const float* qi, const float* qj,
                                                   const Params& p) {
  const float M_d = p.M_d, M_rinv = p.M_rinv, r_eq = p.r_eq, omega = p.omega, alpha = p.alpha;

  const float rsq = dx * dx + dy * dy + dz * dz;
  const float rinv = 1.0f / sqrtf(rsq);
  const float r = rsq * rinv;
  const float ux = dx * rinv, uy = dy * rinv, uz = dz * rinv;

  float nix, niy, niz, njx, njy, njz;
  rotate_x(qi[0], qi[1], qi[2], qi[3], &nix, &niy, &niz);
  rotate_x(qj[0], qj[1], qj[2], qj[3], &njx, &njy, &njz);

  const float morse_exp = expf(-(r - r_eq) * M_rinv);
  const float one_minus = 1.0f - morse_exp;
  // rounded before the subtraction, as the plain version rounds it: far
  // from r_eq the difference cancels to ~2 exp(-(r - r_eq) / M_r), and a
  // fused multiply-add would keep digits the plain version loses
  float U = M_d * (__fmul_rn(one_minus, one_minus) - 1.0f);
  float dU_dr_radial = 2.0f * M_d * M_rinv * morse_exp * one_minus;
  if (r < r_eq && p.rep == 0.0f) {  // flat bottom
    U = -M_d;
    dU_dr_radial = 0.0f;
  }

  const float gamma_i = ux * nix + uy * niy + uz * niz;
  const float gamma_j = ux * njx + uy * njy + uz * njz;
  const float gi_exp = expf(-omega * (gamma_i * gamma_i - alpha));
  const float Om_i = 1.0f / (1.0f + gi_exp);
  const float dOmi = 2.0f * omega * gamma_i * gi_exp * Om_i * Om_i;
  const float gj_exp = expf(-omega * (gamma_j * gamma_j - alpha));
  const float Om_j = 1.0f / (1.0f + gj_exp);
  const float dOmj = 2.0f * omega * gamma_j * gj_exp * Om_j * Om_j;

  const float dU_dr = dU_dr_radial * Om_i * Om_j;
  const float dU_dgi = dOmi * U * Om_j;
  const float dU_dgj = dOmj * U * Om_i;

  const float nipx = nix - gamma_i * ux, nipy = niy - gamma_i * uy, nipz = niz - gamma_i * uz;
  const float njpx = njx - gamma_j * ux, njpy = njy - gamma_j * uy, njpz = njz - gamma_j * uz;

  PairOut o;
  o.fx = -dU_dr * ux - rinv * (dU_dgi * nipx + dU_dgj * njpx);
  o.fy = -dU_dr * uy - rinv * (dU_dgi * nipy + dU_dgj * njpy);
  o.fz = -dU_dr * uz - rinv * (dU_dgi * nipz + dU_dgj * njpz);
  o.tix = dU_dgi * (uy * niz - uz * niy);
  o.tiy = dU_dgi * (uz * nix - ux * niz);
  o.tiz = dU_dgi * (ux * niy - uy * nix);
  o.tjx = dU_dgj * (uy * njz - uz * njy);
  o.tjy = dU_dgj * (uz * njx - ux * njz);
  o.tjz = dU_dgj * (ux * njy - uy * njx);
  o.e = U * Om_i * Om_j - p.U_cut * Om_i * Om_j;
  return o;
}

// One slot's quaternion (w, x, y, z): one 16-byte load where `quat` is
// aligned for it.
__device__ __forceinline__ float4 load_quat(const float* __restrict__ quat, int s, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(quat) + s);
  return make_float4(quat[4 * s], quat[4 * s + 1], quat[4 * s + 2], quat[4 * s + 3]);
}

// one staged candidate: x, y, z, typeid bits; quaternion w, x, y, z
struct Staged {
  float4 pos, quat;
};

// The stencil of a group of cells (cx, cy, z0 .. z0 + n_members - 1): the
// union of the members' stencils, z layer after z layer, each layer's
// columns ((ox, oy)) in lexicographic order. Member j's stencil is the
// layers j .. j + 2 (grids with >= 3 cells along z; else the group is one
// cell and the layers its deduplicated z offsets): one run of consecutive
// union cells, so of consecutive candidates, its n_seg segments.
struct GroupPlan {
  int n_union, n_col, n_seg, self_u;  // self_u + j * n_col: member j's own cell
  int prefix;                      // the precondition holds and the window holds every cell
  int max_runs;                    // the most runs a member has
  int cell[kMaxUnion];             // the union cell's window cell
  int wrap[kMaxUnion];             // packed wrap of the union cell; -1: outside the window
  int forward[kMaxUnion];          // staged shifted into the group's frame (see plan_group)
  int column[kMaxUnion];           // the class of the cell's column (enum Column)
  int start[kMaxUnion + 1];        // union cell u holds candidates [start[u], start[u + 1])
  int last[kMaxUnion];             // one past the cell's last occupied slot
  int seg_forward[az::kMaxSegments];  // a member is the home side of its segment's pairs
  int first[kGroup + 1];           // particles of the members before member j
  // member j's run r: candidates [run_lo[j][r], run_lo[j][r + 1]), in which
  // its own position takes the packed shift run_shift[j][r]
  int n_runs[kGroup];
  int run_lo[kGroup][az::kMaxSegments + 1];
  int run_shift[kGroup][az::kMaxSegments];
};

// The class of a column (ox, oy), staged with each candidate's type: the
// column lies before the group's own (its cells are backward neighbours of
// every member), is the group's own, or lies after it (forward). In the
// group's own column, lower layers come first and a cell's slots are in
// order, so there a member is the home side of exactly the candidates
// numbered above its own slot.
enum Column { kBefore = 0, kOwn, kAfter };

// Every thread of the block calls it, and it ends synchronised. A union
// cell with a wrap is a forward neighbour of every member that sees it, or
// of none: columns after the group's own are forward and columns before it
// backward whatever the member, and in the group's own column only the
// cells below the first member and above the last can wrap. So a forward
// cell's positions are staged shifted into the group's frame, once for all
// members; for a backward cell a member's own position is shifted into the
// neighbour's frame (the separation is then the exact negation of the home
// side's), and consecutive segments in which it takes the same shift form
// a run of that member. Cells are read at their window cell of `win`; a
// union cell the window does not hold fails the plan (prefix 0).
template <int B, bool MIN_IMAGE>
__device__ void plan_group(GroupPlan& P, const int* __restrict__ tag, int cx, int cy, int z0,
                           int n_members, const az::Window& win, int Dx, int Dy, int Dz,
                           int cap) {
  const int t = threadIdx.x, lane = t & 31;
  const int ey = az::stencil_extent(Dy), ez = az::stencil_extent(Dz);
  const int n_col = az::stencil_extent(Dx) * ey;
  const int lox = -(Dx >= 3), loy = -(Dy >= 3), loz = -(Dz >= 3);
  const int nz = Dz >= 3 ? n_members + 2 : ez;  // layers of the union
  const int zspan = Dz >= 3 ? 3 : ez;           // of them, a member's
  const int n_union = n_col * nz, n_seg = n_col * zspan;
  for (int u = t; u < n_union; u += B) {
    const int pz = u / n_col, c = u - pz * n_col;
    const int ox = c / ey + lox, oy = c % ey + loy;
    int wx, wy, wz;
    const int nx = az::wrap_cell(cx + ox, Dx, &wx);
    const int ny = az::wrap_cell(cy + oy, Dy, &wy);
    const int nzc = az::wrap_cell(z0 + pz + loz, Dz, &wz);
    const int wc = win.cell((nx * Dy + ny) * Dz + nzc, Dz, Dx * Dy);
    // outside the window: counted at the group's first cell (always held), then refused
    P.cell[u] = wc >= 0 ? wc : win.cell((cx * Dy + cy) * Dz + z0, Dz, Dx * Dy);
    P.wrap[u] = wc >= 0 ? az::pack_wrap(wx, wy, wz) : -1;
    P.forward[u] = ox > 0 || (ox == 0 && (oy > 0 || (oy == 0 && pz == nz - 1)));
    P.column[u] = ox > 0 || (ox == 0 && oy > 0) ? kAfter : (ox == 0 && oy == 0 ? kOwn : kBefore);
    P.start[u + 1] = 0;  // the count, summed below
    P.last[u] = 0;
  }
  if (t < n_seg) {
    const int dz = t / n_col, c = t - dz * n_col;
    const int ox = c / ey + lox, oy = c % ey + loy, oz = dz + loz;
    P.seg_forward[t] = ox > 0 || (ox == 0 && (oy > 0 || (oy == 0 && oz > 0)));
  }
  __syncthreads();
  if ((cap & 3) == 0 && (reinterpret_cast<size_t>(tag) & 15) == 0)
    az::count_segments<B, 4>(P, tag, n_union, cap);
  else
    az::count_segments<B, 1>(P, tag, n_union, cap);
  __syncthreads();
  if (t < 32) {  // one warp: the prefix sum, the layout check, the members' counts and runs
    const int self_u = (Dz >= 3) * n_col + (Dx >= 3) * ey + (Dy >= 3);
    int carry = 0;
    bool prefix = true;
    for (int base = 0; base < n_union; base += 32) {
      const int u = base + lane;
      const int n = u < n_union ? P.start[u + 1] : 0;
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(az::kFullMask, incl, o);
        if (lane >= o) incl += v;
      }
      prefix = __all_sync(az::kFullMask, u >= n_union || (P.last[u] == n && P.wrap[u] >= 0)) &&
               prefix;
      if (u < n_union) P.start[u + 1] = carry + incl;
      carry += __shfl_sync(az::kFullMask, incl, 31);
    }
    if (lane == 0) P.start[0] = 0;
    __syncwarp();
    int max_runs = 0;
    for (int j = 0; j < n_members; ++j) {
      // lane = segment of member j; a nonempty segment starts a run where
      // its shift differs from the shift of the nonempty segment before it
      const int u = (Dz >= 3 ? j : 0) * n_col + lane;
      const bool nonempty = lane < n_seg && P.start[u + 1] > P.start[u];
      const int shift = !nonempty ? -1
                        : (MIN_IMAGE || P.seg_forward[lane]) ? az::kNoWrap
                                                             : az::negated_wrap(P.wrap[u]);
      const unsigned before = __ballot_sync(az::kFullMask, shift >= 0) & ((1u << lane) - 1u);
      const int prev = __shfl_sync(az::kFullMask, shift, before ? 31 - __clz(before) : lane);
      const bool starts = shift >= 0 && (before == 0 || prev != shift);
      const unsigned starts_mask = __ballot_sync(az::kFullMask, starts);
      const int n_runs = __popc(starts_mask);
      if (starts) {
        const int run = __popc(starts_mask & ((1u << lane) - 1u));
        P.run_lo[j][run] = P.start[u];
        P.run_shift[j][run] = shift;
      }
      if (lane == 0) {
        P.n_runs[j] = n_runs;
        P.run_lo[j][n_runs] = P.start[u + n_seg];  // the end of the member's candidates
        P.first[j + 1] = P.start[self_u + j * n_col + 1] - P.start[self_u + j * n_col];
      }
      max_runs = max(max_runs, n_runs);
    }
    __syncwarp();
    if (lane == 0) {
      P.n_union = n_union;
      P.n_col = n_col;
      P.n_seg = n_seg;
      P.self_u = self_u;
      P.prefix = prefix;
      P.max_runs = max_runs;
      P.first[0] = 0;
      for (int j = 0; j < n_members; ++j) P.first[j + 1] += P.first[j];
    }
  }
  __syncthreads();
}

// Stage candidates [R0, R1) at buffer index g - R0: candidate g of union
// cell u is the cell's slot g - start[u] (the precondition); u is the last
// cell that starts at or before g, found by bisection. Each thread takes
// kStageBatch candidates at a time, their loads in flight together. Every
// thread calls it; the caller synchronises before and after.
template <int B, class Load, class Store>
__device__ __forceinline__ void stage_group(const GroupPlan& P, int cap, int R0, int R1,
                                            Load&& load, Store&& store) {
  for (int g0 = R0 + (int)threadIdx.x; g0 < R1; g0 += kStageBatch * B) {
    Staged entry[kStageBatch];
    int slot[kStageBatch], cell[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int g = min(g0 + b * B, R1 - 1);  // past R1: read again, not stored
      int u = 0, hi = P.n_union;              // start[u] <= g < start[hi]
      while (hi - u > 1) {
        const int mid = (u + hi) >> 1;
        if (P.start[mid] <= g) u = mid; else hi = mid;
      }
      cell[b] = u;
      slot[b] = P.cell[u] * cap + g - P.start[u];
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) entry[b] = load(slot[b], cell[b]);
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      if (g0 + b * B < R1) store(g0 + b * B - R0, entry[b]);
    }
  }
}

// One lane's sweep of one staging round [R0, R1), as az::sweep_round's: it
// lists the candidates of its member j whose squared distance from (xi, yi,
// zi) is below rfilt_sq in list[e * B + t] and calls flush(xs, ys, zs, n)
// to evaluate them, (xs, ys, zs) being its own position as the run's pairs
// see it. self_g is the lane's own candidate number, never listed. The
// lanes of a warp belong to different members, so every loop runs to the
// longest of the warp's and a lane past its own end tests nothing. Each
// step tests az::kUnroll candidates, K apart. Every thread of the block
// calls it with the same R0, R1 and K.
template <int B, bool MIN_IMAGE, class Flush>
__device__ __forceinline__ void sweep_group(const GroupPlan& P, const float4* __restrict__ pos4,
                                            int R0, int R1, int K, int k, bool active, int j,
                                            int self_g, float xi, float yi, float zi,
                                            float rfilt_sq, const BoxArgs& box,
                                            unsigned short* list, Flush&& flush) {
  const int t = threadIdx.x;
  for (int run = 0; run < P.max_runs; ++run) {
    int lo = 0, hi = 0;
    float xs = xi, ys = yi, zs = zi;
    if (active && run < P.n_runs[j]) {
      lo = max(P.run_lo[j][run], R0);
      hi = min(P.run_lo[j][run + 1], R1);
      if (!MIN_IMAGE) az::shift_by(&xs, &ys, &zs, P.run_shift[j][run], box);
    }
    const int longest = __reduce_max_sync(az::kFullMask, max(hi - lo, 0));
    int n = 0;
    for (int off = k; off - k < longest; off += az::kUnroll * K) {
      float rsq[az::kUnroll];
#pragma unroll
      for (int u = 0; u < az::kUnroll; ++u) {  // kUnroll independent tests
        const int g = lo + off + u * K;
        const float4 pj = pos4[g < hi ? g - R0 : 0];
        float dx, dy, dz;
        rsq[u] = az::separation<MIN_IMAGE>(xs, ys, zs, pj.x, pj.y, pj.z, box, &dx, &dy, &dz);
      }
#pragma unroll
      for (int u = 0; u < az::kUnroll; ++u) {
        const int g = lo + off + u * K;
        if (g < hi && g != self_g && rsq[u] < rfilt_sq) {
          list[n * B + t] = (unsigned short)(g - R0);
          ++n;
        }
      }
      if (__any_sync(az::kFullMask, n > az::kListLen - az::kUnroll)) {
        flush(xs, ys, zs, n);
        n = 0;
      }
    }
    flush(xs, ys, zs, n);
  }
}

// This round's lane partials to slot sums: write(pi, a, sum) for
// accumulator a of each of the round's n particles from `first` on, sum =
// its K partials added in lane order, one thread to each (particle,
// accumulator). Every thread of the block calls it.
template <int B, int N_ACC, class Write>
__device__ __forceinline__ void reduce_group(float* part, const float (&acc)[N_ACC], int K,
                                             int first, int n, Write&& write) {
  const int t = threadIdx.x;
#pragma unroll
  for (int a = 0; a < N_ACC; ++a) part[t * N_ACC + a] = acc[a];
  __syncthreads();
  for (int item = t; item < n * N_ACC; item += B) {
    const int r = item / N_ACC, a = item - r * N_ACC;
    const float* p = part + r * K * N_ACC + a;
    float sum = p[0];
    for (int k = 1; k < K; ++k) sum += p[k * N_ACC];
    write(first + r, a, sum);
  }
  __syncthreads();
}

template <bool WANT_ALL, bool MIN_IMAGE>
__global__ void __launch_bounds__(kThreads)
    cell_aniso_force_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
                            const int* __restrict__ type_of, const int* __restrict__ tag,
                            const float* __restrict__ tab, int T, int Dx, int Dy, int Dz, int cap,
                            int group, az::Window win, BoxArgs box, az::PackedLayout lay,
                            float* __restrict__ force, float* __restrict__ torque,
                            float* __restrict__ energy, float* __restrict__ virial) {
  constexpr int B = kThreads;
  constexpr int N_ACC = WANT_ALL ? 13 : 6;  // force, torque; energy, virial
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ GroupPlan P;
  float4* stage = reinterpret_cast<float4*>(smem);  // x, y, z, typeid bits
  float4* stage_q = stage + lay.stage_cap;           // quaternion w, x, y, z
  float* part = reinterpret_cast<float*>(smem + lay.off_part);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + lay.off_list);
  const int t = threadIdx.x, TT = T * T;
  const bool quat_aligned = (reinterpret_cast<size_t>(quat) & 15) == 0;
  // this block's cells: (cx, cy, z0 + j), j < n_members, of the grid's
  // column cxy; own (output) cell cell0 + j, window (input) cell in0 + j
  const int n_gz = (Dz + group - 1) / group;
  const int z0 = ((int)blockIdx.x % n_gz) * group, own_col = (int)blockIdx.x / n_gz;
  const int cxy = win.c0 + own_col;
  const int n_members = min(group, Dz - z0), cell0 = own_col * Dz + z0;
  const int in0 = win.cell(cxy * Dz + z0, Dz, Dx * Dy);

  const float* tabs = tab;
  if (lay.tab_floats > 0) {
    float* s_tab = reinterpret_cast<float*>(smem + lay.off_tab);
    for (int x = t; x < lay.tab_floats; x += B) s_tab[x] = __ldg(tab + x);
    tabs = s_tab;
  }
  plan_group<B, MIN_IMAGE>(P, tag, cxy / Dy, cxy % Dy, z0, n_members, win, Dx, Dy, Dz, cap);
  if (!P.prefix) {
    for (int j = 0; j < n_members; ++j)
      az::poison_cell<B, WANT_ALL>(cell0 + j, cap, force, energy, virial, torque);
    return;
  }
  const int n_tot = P.first[n_members];
  for (int j = 0; j < n_members; ++j) {
    // empty slots sum to exactly zero: the cell's slots from its count on (the precondition)
    const int n_j = P.first[j + 1] - P.first[j];
    const int first = (cell0 + j) * cap + n_j, n_empty = cap - n_j;
    for (int x = t; x < 3 * n_empty; x += B) {
      force[3 * first + x] = 0.f;
      torque[3 * first + x] = 0.f;
    }
    if (WANT_ALL) {
      for (int x = t; x < n_empty; x += B) energy[first + x] = 0.f;
      for (int x = t; x < 6 * n_empty; x += B) virial[6 * first + x] = 0.f;
    }
  }
  if (n_tot == 0) return;
  const int M = P.start[P.n_union];
  const int n_stage = (M + lay.stage_cap - 1) / lay.stage_cap;

  // the group's particles, all at once with K = B / n_tot lanes each, or in
  // rounds of B with one lane each
  for (int p0 = 0; p0 < n_tot; p0 += B) {
    const int np = min(n_tot - p0, B);
    const int K = B / np, k = t % K;
    const int pi = p0 + t / K;  // this lane's particle of the group
    const bool active = t / K < np;
    // its member j and slot: loaded ahead of the staging, first used after it
    int j = 0, ti = 0, self_g = 0;
    float xi = 0.f, yi = 0.f, zi = 0.f, rfilt = 0.f;
    float4 qs = make_float4(1.f, 0.f, 0.f, 0.f);
    if (active) {
      while (P.first[j + 1] <= pi) ++j;
      const int r = pi - P.first[j];
      const int si = (in0 + j) * cap + r;  // the precondition: the r-th slot
      self_g = P.start[P.self_u + j * P.n_col] + r;  // its own candidate number
      ti = type_of[si];
      xi = pos[3 * si];
      yi = pos[3 * si + 1];
      zi = pos[3 * si + 2];
      qs = load_quat(quat, si, quat_aligned);
    }
    float acc[N_ACC];
#pragma unroll
    for (int a = 0; a < N_ACC; ++a) acc[a] = 0.f;
    // the table values of the last type pair (home type, far type),
    // reloaded when the pair changes
    int cached_pair = -1;
    float rcutsq = 0.f;
    Params prm = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int stage_lo = 0;  // the candidate number of the staging buffer's entry 0

    // evaluates this lane's n listed candidates against their own type
    // pair's cutoff, adding what each pair inside gives this slot; (xs, ys,
    // zs) is this slot's position as the run's pairs see it
    auto flush = [&](float xs, float ys, float zs, int n) {
      for (int e = 0; e < n; ++e) {
        const int m = list[e * B + t];
        const float4 pj = stage[m];
        float dx, dy, dz;
        const float rsq =
            az::separation<MIN_IMAGE>(xs, ys, zs, pj.x, pj.y, pj.z, box, &dx, &dy, &dz);
        const int bits = __float_as_int(pj.w);
        const int tj = bits & ((1 << kColumnShift) - 1), column = bits >> kColumnShift;
        // this lane is the pair's home side, or the far side of a pair
        // whose home is the candidate
        const bool home =
            MIN_IMAGE || column == kAfter || (column == kOwn && stage_lo + m > self_g);
        const int pair = home ? ti * T + tj : tj * T + ti;
        if (pair != cached_pair) {
          const float* p = tabs + pair;
          cached_pair = pair;
          rcutsq = p[kRcutsq * TT];
          prm.M_d = p[kMd * TT];
          prm.M_rinv = p[kMrinv * TT];
          prm.r_eq = p[kReq * TT];
          prm.omega = p[kOmega * TT];
          prm.alpha = p[kAlpha * TT];
          prm.rep = p[kRep * TT];
          prm.U_cut = p[kUcut * TT];
        }
        if (!(rsq > 0.f && rsq < rcutsq)) continue;
        const float4 qo = stage_q[m];

        // the home frame: the far side's separation is the exact negation
        const float dxh = opaque(home ? dx : -dx);
        const float dyh = opaque(home ? dy : -dy);
        const float dzh = opaque(home ? dz : -dz);
        const float qh[4] = {opaque(home ? qs.x : qo.x), opaque(home ? qs.y : qo.y),
                             opaque(home ? qs.z : qo.z), opaque(home ? qs.w : qo.w)};
        const float qf[4] = {opaque(home ? qo.x : qs.x), opaque(home ? qo.y : qs.y),
                             opaque(home ? qo.z : qs.z), opaque(home ? qo.w : qs.w)};
        const PairOut o = two_patch_morse(dxh, dyh, dzh, qh, qf, prm);
        // the home lane keeps +f and t_i, the far lane -f and t_j
        acc[0] += home ? o.fx : -o.fx;
        acc[1] += home ? o.fy : -o.fy;
        acc[2] += home ? o.fz : -o.fz;
        acc[3] += home ? o.tix : o.tjx;
        acc[4] += home ? o.tiy : o.tjy;
        acc[5] += home ? o.tiz : o.tjz;
        if constexpr (WANT_ALL) {
          acc[6] += 0.5f * o.e;
          acc[7] += 0.5f * (dxh * o.fx);
          acc[8] += 0.5f * (dxh * o.fy);
          acc[9] += 0.5f * (dxh * o.fz);
          acc[10] += 0.5f * (dyh * o.fy);
          acc[11] += 0.5f * (dyh * o.fz);
          acc[12] += 0.5f * (dzh * o.fz);
        }
      }
    };

    for (int sr = 0; sr < n_stage; ++sr) {
      const int R0 = sr * lay.stage_cap, R1 = min(M, R0 + lay.stage_cap);
      stage_lo = R0;
      if (n_stage > 1 || p0 == 0) {
        __syncthreads();  // the previous round's candidates are consumed
        stage_group<B>(
            P, cap, R0, R1,
            [&](int sj, int u) {
              float x = pos[3 * sj], y = pos[3 * sj + 1], z = pos[3 * sj + 2];
              if (!MIN_IMAGE && P.forward[u]) az::shift_by(&x, &y, &z, P.wrap[u], box);
              const int bits = type_of[sj] | (P.column[u] << kColumnShift);
              return Staged{make_float4(x, y, z, __int_as_float(bits)),
                            load_quat(quat, sj, quat_aligned)};
            },
            [&](int e, const Staged& entry) {
              stage[e] = entry.pos;
              stage_q[e] = entry.quat;
            });
        __syncthreads();
      }
      if (sr == 0 && active) {  // the filter radius: the largest cutoff of this slot's type
        for (int tj = 0; tj < T; ++tj)
          rfilt = fmaxf(rfilt, fmaxf(tabs[kRcutsq * TT + ti * T + tj],
                                     tabs[kRcutsq * TT + tj * T + ti]));
      }
      sweep_group<B, MIN_IMAGE>(P, stage, R0, R1, K, k, active, j, self_g, xi, yi, zi, rfilt,
                                box, list, flush);
    }

    reduce_group<B, N_ACC>(part, acc, K, p0, np, [&](int pr, int a, float sum) {
      int m = 0;
      while (P.first[m + 1] <= pr) ++m;
      const int si = (cell0 + m) * cap + pr - P.first[m];
      if (a < 3) force[3 * si + a] = sum;
      else if (a < 6) torque[3 * si + a - 3] = sum;
      else if (a == 6) energy[si] = sum;
      else virial[6 * si + a - 7] = sum;
    });
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns its CUDA error (0 = launched).
// `quat` is [S, 4] (w, x, y, z); `tables` holds kNTab stacked [T, T] float32
// tables (enum Tab). pos, quat, type_of and tag hold the window (w0,
// n_cols) of the grid; the outputs, the n_own columns from c0
// (cell_stencil.cuh, Window). `energy` and `virial` are written only when
// want_all != 0 (and may be null otherwise).
int az_cell_aniso_force(const float* pos, const float* quat, const int* type_of,
                        const int* tag, const float* tables, int T, int Dx, int Dy, int Dz,
                        int cap, int w0, int n_cols, int c0, int n_own, float Lx, float Ly,
                        float Lz, float xy, float xz, float yz, float xyLy, float xzLz,
                        float yzLz, int min_image, int want_all, float* force, float* torque,
                        float* energy, float* virial, void* stream) {
  dim3 grid, block;
  az::PackedLayout lay;
  const az::Window win{w0, n_cols, c0, n_own};
  // a block takes kGroup cells along z where their stencils' cells are all
  // distinct (the half stencil, and kGroup + 2 cells along z), else one
  const int group = (!min_image && Dz >= kGroup + 2) ? kGroup : 1;
  if (!az::packed_launch(Dx, Dy, Dz, cap, win, T, kNTab, sizeof(Staged), want_all ? 13 : 6,
                         kThreads, &grid, &block, &lay, kStageEntries * (int)sizeof(Staged),
                         group))
    return (int)cudaErrorInvalidValue;
  const BoxArgs box{Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz};
  auto kernel = want_all ? (min_image ? cell_aniso_force_kernel<true, true>
                                      : cell_aniso_force_kernel<true, false>)
                         : (min_image ? cell_aniso_force_kernel<false, true>
                                      : cell_aniso_force_kernel<false, false>);
  return (int)az::launch_packed(kernel, grid, block, lay, static_cast<cudaStream_t>(stream), pos,
                                quat, type_of, tag, tables, T, Dx, Dy, Dz, cap, group, win, box,
                                lay, force, torque, energy, virial);
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
