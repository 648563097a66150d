// Cell-stencil pair force for every isotropic pair potential of the port.
//
// Replaces the TPU kernel azplugins_tpu/ops/pallas_pair.py
// (stencil_pair_force_kernel, body _kernel) as run by
// azplugins_tpu/ops/dense.py::_pallas_half_pair_force, both with the PLJ/LJ
// force-only evaluator (want="force") and with the general evaluator
// (any isotropic potential, modes none/shift/xplor, want="all" adding the
// per-slot energy and virial). It computes the same per-slot sums; the
// schedule is Hopper's own: the packed schedule of cell_stencil.cuh.
//
// The sweep over every candidate (outside a rebuild segment, and where a
// block's lists do not hold): only occupied slots are staged and visited
// (the loop runs to the occupancy, not to cap), the cell's slots share the
// block's 256 lanes (K lanes each), and a lane evaluates only the candidates
// it listed inside its filter radius, so a warp does not pay the full
// evaluation on every candidate one of its lanes accepts. At the 262,144
// headline (19^3 cells of ~38 particles, r_cut 3.0 in cells 3.56 wide) a
// slot has ~1,000 occupied candidates and ~96 inside the cutoff; the call
// took 0.419 ms on an H100 80GB HBM3 at 700 W: the plan 0.030, staging and
// the reduction 0.048, the candidate filter 0.218 (~20 instructions a
// candidate), the evaluation 0.117.
//
// Verlet pair lists (az::PairList in cell_stencil.cuh) take the filter off
// the steps between rebuilds. A slot's layout holds from one rebuild to the
// next, and the drift check keeps the two largest drifts since the rebuild
// under the buffer, so a pair inside any cutoff at a step of the segment
// was within r_max + buffer at the rebuild's positions. The build (BUILD),
// once a segment, runs the same plan, staging and lanes on those positions
// and lists, a lane at a time, its candidates within that radius in the
// order the filter visits them, and keeps the block's plan. Each force-only
// call of the segment sweeps them: it loads the plan, stages the current
// positions, filters each lane's list (~26 entries at the headline, 8 to a
// 16-byte load) against its slot's largest cutoff and evaluates the hits
// with the same body, so each lane adds the same pairs in the same order
// and the forces are bitwise the full sweep's. A block whose lists
// overflow, or that needs several staging or i rounds, sweeps every
// candidate instead. What bounds K1 now: at the headline a sweep takes
// 0.257 ms, the evaluation 0.097 of it (instruction issue in ~40
// instructions a pair, the lanes of a warp waiting for the longest list),
// the list's filter 0.088, staging and the reduction 0.060 (global-load
// latency), the kept plan 0.005; the build 0.380 ms, once every ~7 steps.
// Evaluating each pair once (Newton's third law) would halve the largest
// part; it needs a j-side sum the design has not got.

// Potentials are compile-time evaluators selected by a potential id (enum
// Pot, the order of ops/pair_kernel.py::KERNEL_POTENTIALS). Each one is the
// plain evaluator of ops/evaluators/pair.py, operation for operation, in
// plain C++ that nvcc may contract into fused multiply-adds.
//
// Parameters come from [T, T] float32 tables, stacked as enum Tab: the
// squared cutoff, the energy offset, the squared xplor switch-on radius,
// then the potential's own parameters in its precompute order. The block
// copies them into shared memory where they fit (az::kTableSmemBytes) and
// reads them from global memory otherwise; a lane keeps the last type
// pair's values in registers. The filter tests each candidate against the
// largest cutoff of the slot's type; the evaluation applies the pair's own.
// The wrapper folds the shift mode into the tables: "none" has ecut 0 and
// ronsq +inf, "shift" the pair energy at the cutoff and ronsq +inf, "xplor"
// r_on^2 with ecut 0 where r_on < r_cut and HOOMD's plain shift where
// r_on >= r_cut. So one code path serves all three modes; only
// the xplor instantiations read the r_on row and test for smoothing, which
// cost 9% at the 64k headline on an H100 when every mode paid for it.

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace {

using az::BoxArgs;

enum Pot { kPLJ = 0, kLJ, kColloid, kExpandedYukawa, kHertz, kMorse, kGaussian, kYukawa, kNPot };
enum Tab { kRcutsq = 0, kEcut, kRonsq, kParam };
// each potential's parameter count (ops/pair_kernel.py::KERNEL_POTENTIALS)
__host__ __device__ constexpr int n_params(int pot) {
  return pot == kPLJ ? 5 : pot == kColloid ? 4 : pot == kExpandedYukawa || pot == kMorse ? 3
                                                : pot == kHertz ? 1 : 2;
}

constexpr int kThreads = 256;  // threads per block (one block per cell)

// one type pair's parameters, held in registers
template <int POT>
struct Params {
  float v[n_params(POT)];
  __device__ __forceinline__ float operator[](int k) const { return v[k]; }
};

__device__ __forceinline__ float pow7inv(float x) {
  const float xi = 1.0f / x;
  const float x2 = xi * xi;
  return x2 * x2 * x2 * xi;
}

// Colloid (reference plugin: src/PairEvaluatorColloid.h:101-269), the
// branch the radii select; the guards keep contact singularities finite
template <bool WANT_E, class Params>
__device__ __forceinline__ void colloid(float rsq, const Params& p, float* e, float* f) {
  const float A = p[0], ai = p[1], aj = p[2], sigma_3 = p[3];
  const float sigma_6 = sigma_3 * sigma_3;
  if (ai == 0.f && aj == 0.f) {  // solvent-solvent: LJ with prefactor A/36
    const float r2inv = 1.0f / rsq;
    const float r6inv = r2inv * r2inv * r2inv;
    const float c1 = A * sigma_6 / 36.0f;
    *f = 6.0f * c1 * r2inv * r6inv * (2.0f * sigma_6 * r6inv - 1.0f);
    if (WANT_E) *e = c1 * r6inv * (sigma_6 * r6inv - 1.0f);
  } else if (ai == 0.f || aj == 0.f) {  // colloid-solvent
    const float a = fmaxf(ai, aj);
    const float asq = a * a;
    float am = asq - rsq;
    if (am == 0.f) am = 1e-20f;
    const float am3 = am * am * am;
    const float am6 = am3 * am3;
    const float rsqsq = rsq * rsq;
    const float fR = sigma_3 * A * a * asq / am3;
    *f = (float)(4.0 / 15.0) * fR *
         (2.0f * (asq + rsq) * (asq * (5.0f * asq + 22.0f * rsq) + 5.0f * rsqsq) * sigma_6 / am6 -
          5.0f) /
         am;
    if (WANT_E)
      *e = (float)(2.0 / 9.0) * fR *
           (1.0f - (asq * (asq * (asq / 3.0f + 3.0f * rsq) + 4.2f * rsqsq) + rsq * rsqsq) *
                       sigma_6 / am6);
  } else {  // colloid-colloid (Everaers-Ejtehadi)
    const float r = sqrtf(rsq);
    const float k0 = ai * aj, k1 = ai + aj, k2 = ai - aj;
    float k3 = k1 + r, k4 = k1 - r, k5 = k2 + r, k6 = k2 - r;
    const float tiny = 1e-20f;
    if (k3 == 0.f) k3 = tiny;
    if (k4 == 0.f) k4 = tiny;
    if (k5 == 0.f) k5 = tiny;
    if (k6 == 0.f) k6 = tiny;
    const float k7 = 1.0f / (k3 * k4);
    const float k8 = 1.0f / (k5 * k6);
    float g0 = pow7inv(k3), g1 = pow7inv(k4), g2 = pow7inv(k5), g3 = pow7inv(k6);
    const float h0 = ((k3 + 5.0f * k1) * k3 + 30.0f * k0) * g0;
    const float h1 = ((k4 + 5.0f * k1) * k4 + 30.0f * k0) * g1;
    const float h2 = ((k5 + 5.0f * k2) * k5 - 30.0f * k0) * g2;
    const float h3 = ((k6 + 5.0f * k2) * k6 - 30.0f * k0) * g3;
    g0 = g0 * (42.0f * k0 / k3 + 6.0f * k1 + k3);
    g1 = g1 * (42.0f * k0 / k4 + 6.0f * k1 + k4);
    g2 = g2 * (-42.0f * k0 / k5 + 6.0f * k2 + k5);
    g3 = g3 * (-42.0f * k0 / k6 + 6.0f * k2 + k6);
    const float fR = A * sigma_6 / r / 37800.0f;
    const float e_rep = fR * (h0 - h1 - h2 + h3);
    const float dUR = e_rep / r + 5.0f * fR * (g0 + g1 - g2 - g3);
    const float dUA = -A / 3.0f * r * ((2.0f * k0 * k7 + 1.0f) * k7 + (2.0f * k0 * k8 - 1.0f) * k8);
    *f = (dUR + dUA) / r;
    if (WANT_E) {
      const float q = k8 / k7;
      const float ratio = q > 0.f ? q : 1.0f;
      *e = e_rep + A / 6.0f * (2.0f * k0 * (k7 + k8) - logf(ratio));
    }
  }
}

// Force / r (and the energy, when WANT_E) of one pair inside the cutoff;
// false for a pair whose scale parameter is 0 (zero energy and force).
template <int POT, bool WANT_E>
__device__ __forceinline__ bool evaluate(float rsq, float rcutsq, const Params<POT>& p, float* e,
                                         float* f) {
  if (p[0] == 0.f) return false;
  if constexpr (POT == kPLJ || POT == kLJ) {
    const float lj1 = p[0], lj2 = p[1];
    const float r2inv = 1.0f / rsq;
    const float r6inv = r2inv * r2inv * r2inv;
    *f = r2inv * r6inv * (12.0f * lj1 * r6inv - 6.0f * lj2);
    if (WANT_E) *e = r6inv * (lj1 * r6inv - lj2);
    if constexpr (POT == kPLJ) {
      // selects, not a branch: a warp's pairs fall on both sides of the
      // WCA core (a branch cost 5% at the 64k headline on an H100)
      const float lam = p[2];
      const bool in_core = rsq < p[3];
      if (!in_core) *f *= lam;
      if (WANT_E) *e = in_core ? *e + p[4] : *e * lam;
    }
  } else if constexpr (POT == kColloid) {
    colloid<WANT_E>(rsq, p, e, f);
  } else if constexpr (POT == kExpandedYukawa) {
    const float eps = p[0], kappa = p[1], delta = p[2];
    const float r = sqrtf(rsq);
    float rd = r - delta;
    if (rd == 0.f) rd = 1e-20f;
    const float rd_inv = 1.0f / rd;
    const float en = eps * expf(-kappa * rd) * rd_inv;
    *f = en * (kappa + rd_inv) / r;
    if (WANT_E) *e = en;
  } else if constexpr (POT == kHertz) {
    const float r = sqrtf(rsq);
    const float rcut = sqrtf(rcutsq);
    const float x = fmaxf(1.0f - r / rcut, 0.0f);
    const float ex32 = p[0] * x * sqrtf(x);
    *f = 2.5f * ex32 / (r * rcut);
    if (WANT_E) *e = ex32 * x;
  } else if constexpr (POT == kMorse) {
    const float D0 = p[0], alpha = p[1], r0 = p[2];
    const float r = sqrtf(rsq);
    const float ea = expf(-alpha * (r - r0));
    *f = 2.0f * D0 * alpha * ea * (ea - 1.0f) / r;
    if (WANT_E) *e = D0 * ea * (ea - 2.0f);
  } else if constexpr (POT == kGaussian) {
    const float sig2inv = p[1];
    const float en = p[0] * expf(-0.5f * rsq * sig2inv);
    *f = en * sig2inv;
    if (WANT_E) *e = en;
  } else if constexpr (POT == kYukawa) {
    const float eps = p[0], kappa = p[1];
    const float r = sqrtf(rsq);
    const float rinv = 1.0f / r;
    const float en = eps * expf(-kappa * r) * rinv;
    *f = en * (kappa + rinv) * rinv;
    if (WANT_E) *e = en;
  }
  return true;
}

// BUILD: the list build (pos holds the positions of the last rebuild, and
// each lane lists the candidates within sqrt(list_rsq) in pl); else the
// force, which sweeps pl's lists where pl.entries is set (force only) and
// the block's lists hold, and every candidate otherwise.
template <int POT, bool WANT_ALL, bool MIN_IMAGE, bool XPLOR, bool BUILD>
__global__ void __launch_bounds__(kThreads)
    cell_pair_force_kernel(const float* __restrict__ pos, const int* __restrict__ type_of,
                           const int* __restrict__ tag, const float* __restrict__ tab, int T,
                           int Dx, int Dy, int Dz, int cap, az::Window win, BoxArgs box,
                           az::PackedLayout lay, float* __restrict__ force,
                           float* __restrict__ energy, float* __restrict__ virial,
                           az::PairList pl, float list_rsq) {
  constexpr int B = kThreads;
  constexpr int N_ACC = WANT_ALL ? 10 : 3;
  static_assert(!(BUILD && WANT_ALL), "the build computes no force");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ az::StencilPlan P;
  float4* stage = reinterpret_cast<float4*>(smem);  // x, y, z, typeid bits
  float* part = reinterpret_cast<float*>(smem + lay.off_part);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + lay.off_list);
  const int t = threadIdx.x, TT = T * T;
  // the block's cell: the grid's (geometry), its own output cell, and (after
  // the plan) its window cell (inputs)
  const int out_cell = blockIdx.x, cell = win.c0 * Dz + out_cell;

  const float* tabs = tab;
  if (!BUILD && lay.tab_floats > 0) {
    float* s_tab = reinterpret_cast<float*>(smem + lay.off_tab);
    for (int x = t; x < lay.tab_floats; x += B) s_tab[x] = __ldg(tab + x);
    tabs = s_tab;
  }
  // the plan the last build kept where the block's lists hold, else a new one
  const bool cached = !BUILD && !WANT_ALL && pl.entries != nullptr &&
                      __ldg(pl.fallback + out_cell) == 0;
  if (cached)
    az::load_plan<B>(P, pl.plans + (size_t)out_cell * az::kPlanInts);  // synchronises
  else
    az::plan_stencil<B, MIN_IMAGE>(P, tag, cell, win, Dx, Dy, Dz, cap);  // synchronises
  const int n_i = P.prefix ? P.start[P.self_seg + 1] - P.start[P.self_seg] : 0;
  const int M = P.start[P.n_seg];
  const int n_stage = (M + lay.stage_cap - 1) / lay.stage_cap;
  const az::LaneMap<B> L(n_i);
  if constexpr (BUILD) {
    // one staging round and one i round, or every candidate at each sweep
    if (!P.prefix || n_stage > 1 || L.rounds > 1) {
      if (t == 0) {
        pl.fallback[out_cell] = 1;
        atomicAdd(pl.n_fallback, 1ULL);
      }
      return;
    }
    az::store_plan<B>(P, pl.plans + (size_t)out_cell * az::kPlanInts);
  }
  // the block sweeps its lists (uniform across the block)
  const bool listed = cached && n_i > 0 && n_stage == 1 && L.rounds == 1;
  const int in_cell = P.cell[P.self_seg];
  if (!BUILD) {
    if (!P.prefix) {
      az::poison_cell<B, WANT_ALL>(out_cell, cap, force, energy, virial);
      return;
    }
    for (int r = t; r < cap; r += B) {  // empty slots sum to exactly zero
      if (tag[in_cell * cap + r] >= 0) continue;
      const int s = out_cell * cap + r;
      force[3 * s] = force[3 * s + 1] = force[3 * s + 2] = 0.f;
      if (WANT_ALL) {
        energy[s] = 0.f;
        for (int a = 0; a < 6; ++a) virial[6 * s + a] = 0.f;
      }
    }
  }
  if (n_i == 0) {
    if (BUILD && t == 0) pl.fallback[out_cell] = 0;
    return;
  }
  const int k = t % L.K;
  // the build's: this lane's list
  az::ListWriter writer(
      BUILD ? reinterpret_cast<uint4*>(pl.entries + az::list_entry<B>(pl, out_cell, t, 0))
            : nullptr,
      pl.cap_e);

  for (int q = 0; q < L.rounds; ++q) {
    const int ir = q * L.per_round + t / L.K;
    const bool active = t / L.K < L.per_round && ir < n_i;
    int ti = 0;
    float xi = 0.f, yi = 0.f, zi = 0.f, rfilt = 0.f;
    if (active) {
      const int si = in_cell * cap + ir;  // the precondition: the ir-th slot
      ti = type_of[si];
      xi = pos[3 * si];
      yi = pos[3 * si + 1];
      zi = pos[3 * si + 2];
      if (BUILD)
        rfilt = list_rsq;
      else
        for (int tj = 0; tj < T; ++tj) rfilt = fmaxf(rfilt, tabs[kRcutsq * TT + ti * T + tj]);
    }
    const float* tp = tabs + ti * T;
    float acc[N_ACC];
#pragma unroll
    for (int a = 0; a < N_ACC; ++a) acc[a] = 0.f;
    // the table values of the last type pair, reloaded when the type changes
    int cached_tj = -1;
    float rcutsq = 0.f, ecut = 0.f, ronsq = 0.f;
    Params<POT> p;

    // adds what the listed candidate j gives this slot, (xs, ys, zs) its
    // own position as j's run sees it, where the pair is inside its type
    // pair's cutoff
    auto add_pair = [&](float xs, float ys, float zs, int j) {
      const float4 pj = stage[j];
      float dx, dy, dz;
      const float rsq =
          az::separation<MIN_IMAGE>(xs, ys, zs, pj.x, pj.y, pj.z, box, &dx, &dy, &dz);
      const int tj = __float_as_int(pj.w);
      if (tj != cached_tj) {
        const float* pp = tp + tj;
        cached_tj = tj;
        rcutsq = pp[kRcutsq * TT];
        if (WANT_ALL) ecut = pp[kEcut * TT];
        if (XPLOR) ronsq = pp[kRonsq * TT];
#pragma unroll
        for (int a = 0; a < n_params(POT); ++a) p.v[a] = pp[(kParam + a) * TT];
      }
      if (!(rsq < rcutsq)) return;
      float en = 0.f, f;
      if (!evaluate<POT, WANT_ALL>(rsq, rcutsq, p, &en, &f)) return;
      if (XPLOR && rsq > ronsq) {  // xplor smoothing (ops/pair_force.py::_xplor_smooth)
        // the force path forms the energy only here, where smoothing reads it
        if (!WANT_ALL) evaluate<POT, true>(rsq, rcutsq, p, &en, &f);
        const float dc = rcutsq - ronsq;
        float denom = dc * dc * dc;
        if (denom == 0.f) denom = 1.0f;
        const float dr = rcutsq - rsq;
        const float s = dr * dr * (rcutsq + 2.0f * rsq - 3.0f * ronsq) / denom;
        const float ds_dr_divr = 12.0f * (rsq - ronsq) * dr / denom;
        f = f * s + en * ds_dr_divr;
        en = en * s;
      }
      acc[0] += f * dx;
      acc[1] += f * dy;
      acc[2] += f * dz;
      if constexpr (WANT_ALL) {
        acc[3] += 0.5f * (en - ecut);
        const float w = 0.5f * f;
        acc[4] += w * dx * dx;
        acc[5] += w * dx * dy;
        acc[6] += w * dx * dz;
        acc[7] += w * dy * dy;
        acc[8] += w * dy * dz;
        acc[9] += w * dz * dz;
      }
    };
    // this lane's n listed candidates, all of one run; the build appends
    // them to the lane's list instead
    auto flush = [&](float xs, float ys, float zs, int n) {
      if constexpr (BUILD) {
        for (int e = 0; e < n; ++e) writer.push<B>(list[e * B + t]);
        return;
      }
      for (int e = 0; e < n; ++e) add_pair(xs, ys, zs, list[e * B + t]);
    };
    // a listed block's: the lane's n listed candidates, of any runs (ascending)
    az::RunCursor cursor;
    auto flush_listed = [&](int n) {
      for (int e = 0; e < n; ++e) {
        const int j = list[e * B + t];
        cursor.seek<MIN_IMAGE>(P, j, xi, yi, zi, box);
        add_pair(cursor.xs, cursor.ys, cursor.zs, j);
      }
    };

    for (int sr = 0; sr < n_stage; ++sr) {
      const int R0 = sr * lay.stage_cap, R1 = min(M, R0 + lay.stage_cap);
      if (n_stage > 1 || q == 0) {
        __syncthreads();  // the previous round's candidates are consumed
        az::stage_round<B>(
            P, cap, R0, R1,
            [&](int sj, int wrap, int forward) {
              float x = pos[3 * sj], y = pos[3 * sj + 1], z = pos[3 * sj + 2];
              // shifted into this cell's frame where this cell is the home side
              if (!MIN_IMAGE && forward) az::shift_by(&x, &y, &z, wrap, box);
              return make_float4(x, y, z, __int_as_float(type_of[sj]));
            },
            [&](int e, const float4& entry) { stage[e] = entry; });
        __syncthreads();
      }
      if (listed) {
        const uint4* lst =
            reinterpret_cast<const uint4*>(pl.entries + az::list_entry<B>(pl, out_cell, t, 0));
        az::sweep_list<B, MIN_IMAGE>(P, stage, lst, __ldg(pl.counts + out_cell * B + t), xi, yi,
                                     zi, rfilt, box, list, flush_listed);
      } else {
        az::sweep_round<B, MIN_IMAGE>(P, stage, R0, R1, L.K, k, active,
                                      P.start[P.self_seg] + ir, xi, yi, zi, rfilt, box, list,
                                      flush);
      }
    }

    if constexpr (BUILD) {
      writer.finish<B>();
      const bool over = __syncthreads_or(writer.n > pl.cap_e);
      pl.counts[out_cell * B + t] = (unsigned short)(over ? 0 : writer.n);
      if (t == 0) {
        pl.fallback[out_cell] = over;
        if (over) atomicAdd(pl.n_fallback, 1ULL);
      }
      return;
    }
    az::reduce_lanes<B, N_ACC>(part, acc, L, q, n_i, [&](int r, const float* sum) {
      const int s = out_cell * cap + r;
      force[3 * s] = sum[0];
      force[3 * s + 1] = sum[1];
      force[3 * s + 2] = sum[2];
      if constexpr (WANT_ALL) {
        energy[s] = sum[3];
        for (int a = 0; a < 6; ++a) virial[6 * s + a] = sum[4 + a];
      }
    });
  }
}

struct LaunchArgs {
  dim3 grid, block;
  az::PackedLayout lay;
  cudaStream_t stream;
  const float* pos;
  const int* type_of;
  const int* tag;
  const float* tab;
  int T, Dx, Dy, Dz, cap;
  az::Window win;
  BoxArgs box;
  float* force;
  float* energy;
  float* virial;
  az::PairList pl;
  float list_rsq;
};

template <int POT, bool WANT_ALL, bool MIN_IMAGE, bool XPLOR, bool BUILD>
cudaError_t launch_one(const LaunchArgs& a) {
  return az::launch_packed(cell_pair_force_kernel<POT, WANT_ALL, MIN_IMAGE, XPLOR, BUILD>, a.grid,
                           a.block, a.lay, a.stream, a.pos, a.type_of, a.tag, a.tab, a.T, a.Dx,
                           a.Dy, a.Dz, a.cap, a.win, a.box, a.lay, a.force, a.energy, a.virial,
                           a.pl, a.list_rsq);
}

template <int POT, bool WANT_ALL, bool MIN_IMAGE>
cudaError_t launch(const LaunchArgs& a, bool xplor) {
  return xplor ? launch_one<POT, WANT_ALL, MIN_IMAGE, true, false>(a)
               : launch_one<POT, WANT_ALL, MIN_IMAGE, false, false>(a);
}

template <int POT>
cudaError_t launch_pot(const LaunchArgs& a, bool want_all, bool min_image, bool xplor) {
  if (want_all) return min_image ? launch<POT, true, true>(a, xplor) : launch<POT, true, false>(a, xplor);
  return min_image ? launch<POT, false, true>(a, xplor) : launch<POT, false, false>(a, xplor);
}

// The arguments both entry points share; false for a shape the kernel does
// not take.
bool common_args(LaunchArgs* a, const float* pos, const int* type_of, const int* tag, int T,
                 int Dx, int Dy, int Dz, int cap, int w0, int n_cols, int c0, int n_own,
                 float Lx, float Ly, float Lz, float xy, float xz, float yz, float xyLy,
                 float xzLz, float yzLz, int n_tab_rows, int n_acc, void* stream) {
  a->win = az::Window{w0, n_cols, c0, n_own};
  if (!az::packed_launch(Dx, Dy, Dz, cap, a->win, T, n_tab_rows, 16, n_acc, kThreads, &a->grid,
                         &a->block, &a->lay))
    return false;
  a->stream = static_cast<cudaStream_t>(stream);
  a->pos = pos;
  a->type_of = type_of;
  a->tag = tag;
  a->T = T;
  a->Dx = Dx;
  a->Dy = Dy;
  a->Dz = Dz;
  a->cap = cap;
  a->box = BoxArgs{Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz};
  return true;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns its CUDA error (0 = launched).
// `tables` holds kParam + n_params stacked [T, T] float32 tables (enum Tab).
// xplor != 0 for tables built in mode xplor (the only mode whose kRonsq
// row is read). pos, type_of and tag hold the window (w0, n_cols) of the
// grid; the outputs, the n_own columns from c0 (cell_stencil.cuh, Window).
// `energy` and `virial` are written only when want_all != 0 (and may be
// null otherwise). With want_all == 0 and `entries` set, a block sweeps
// the pair lists az_cell_pair_list built on this layout (entries, counts,
// fallback, plans, cap_e: az::PairList; plan_ints must be az::kPlanInts)
// where its own hold.
int az_cell_pair_force(const float* pos, const int* type_of, const int* tag, const float* tables,
                       int T, int Dx, int Dy, int Dz, int cap, int w0, int n_cols, int c0,
                       int n_own, float Lx, float Ly, float Lz, float xy, float xz, float yz,
                       float xyLy, float xzLz, float yzLz, int min_image, int potential,
                       int xplor, int want_all, float* force, float* energy, float* virial,
                       unsigned short* entries, unsigned short* counts, int* fallback,
                       int* plans, int cap_e, int plan_ints, void* stream) {
  LaunchArgs a;
  const bool all = want_all != 0, mi = min_image != 0, xp = xplor != 0;
  if (potential < 0 || potential >= kNPot ||
      (entries != nullptr && (all || cap_e < 1 || cap_e % az::kListGroup ||
                              plan_ints != az::kPlanInts)) ||
      !common_args(&a, pos, type_of, tag, T, Dx, Dy, Dz, cap, w0, n_cols, c0, n_own, Lx, Ly, Lz,
                   xy, xz, yz, xyLy, xzLz, yzLz, kParam + n_params(potential), all ? 10 : 3,
                   stream))
    return (int)cudaErrorInvalidValue;
  a.tab = tables;
  a.force = force;
  a.energy = energy;
  a.virial = virial;
  a.pl = az::PairList{entries, counts, fallback, plans, nullptr, cap_e};
  a.list_rsq = 0.f;
  cudaError_t err = cudaErrorInvalidValue;
  switch (potential) {
    case kPLJ: err = launch_pot<kPLJ>(a, all, mi, xp); break;
    case kLJ: err = launch_pot<kLJ>(a, all, mi, xp); break;
    case kColloid: err = launch_pot<kColloid>(a, all, mi, xp); break;
    case kExpandedYukawa: err = launch_pot<kExpandedYukawa>(a, all, mi, xp); break;
    case kHertz: err = launch_pot<kHertz>(a, all, mi, xp); break;
    case kMorse: err = launch_pot<kMorse>(a, all, mi, xp); break;
    case kGaussian: err = launch_pot<kGaussian>(a, all, mi, xp); break;
    case kYukawa: err = launch_pot<kYukawa>(a, all, mi, xp); break;
  }
  return (int)err;
}

// The list build on `stream` (its CUDA error; 0 = launched): `ref` holds the
// positions of the layout's last rebuild, in the layout of
// az_cell_pair_force's pos; each lane lists its candidates whose squared
// separation at those positions is below list_rsq (az::PairList), each
// block whose lists hold keeps its plan, and each block that falls back
// adds 1 to *n_fallback.
int az_cell_pair_list(const float* ref, const int* type_of, const int* tag, int T, int Dx, int Dy,
                      int Dz, int cap, int w0, int n_cols, int c0, int n_own, float Lx, float Ly,
                      float Lz, float xy, float xz, float yz, float xyLy, float xzLz, float yzLz,
                      int min_image, float list_rsq, unsigned short* entries,
                      unsigned short* counts, int* fallback, int* plans,
                      unsigned long long* n_fallback, int cap_e, int plan_ints, void* stream) {
  LaunchArgs a;
  if (entries == nullptr || counts == nullptr || fallback == nullptr || plans == nullptr ||
      n_fallback == nullptr || cap_e < 1 || cap_e % az::kListGroup ||
      plan_ints != az::kPlanInts ||
      !common_args(&a, ref, type_of, tag, T, Dx, Dy, Dz, cap, w0, n_cols, c0, n_own, Lx, Ly, Lz,
                   xy, xz, yz, xyLy, xzLz, yzLz, 0, 3, stream))
    return (int)cudaErrorInvalidValue;
  a.tab = nullptr;
  a.force = a.energy = a.virial = nullptr;
  a.pl = az::PairList{entries, counts, fallback, plans, n_fallback, cap_e};
  a.list_rsq = list_rsq;
  const cudaError_t err = min_image ? launch_one<kPLJ, false, true, false, true>(a)
                                    : launch_one<kPLJ, false, false, false, true>(a);
  return (int)err;
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
