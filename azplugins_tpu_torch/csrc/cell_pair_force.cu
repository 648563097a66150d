// Cell-stencil pair force for every isotropic pair potential of the port.
//
// Replaces the TPU kernel azplugins_tpu/ops/pallas_pair.py
// (stencil_pair_force_kernel, body _kernel) as run by
// azplugins_tpu/ops/dense.py::_pallas_half_pair_force, both with the PLJ/LJ
// force-only evaluator (want="force") and with the general evaluator
// (any isotropic potential, modes none/shift/xplor, want="all" adding the
// per-slot energy and virial). It computes the same per-slot sums; the
// schedule is Hopper's own (cell_stencil.cuh).
//
// Potentials are compile-time evaluators selected by a potential id (enum
// Pot, the order of ops/pair_kernel.py::KERNEL_POTENTIALS). Each one is the
// plain evaluator of ops/evaluators/pair.py, operation for operation, in
// plain C++ that nvcc may contract into fused multiply-adds.
//
// Parameters are read straight from [T, T] float32 tables, stacked as enum
// Tab: the squared cutoff, the energy offset, the squared xplor switch-on
// radius, then the potential's own parameters in its precompute order. The
// wrapper folds the shift mode into the tables: "none" has ecut 0 and
// ronsq +inf, "shift" the pair energy at the cutoff and ronsq +inf,
// "xplor" r_on^2 with ecut 0 where r_on < r_cut and HOOMD's plain shift
// where r_on >= r_cut. So one code path serves all three modes; only the
// xplor instantiations read the r_on row and test for smoothing, which cost
// 9% at the 64k headline on an H100 when every mode paid for it.

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace {

using az::BoxArgs;

enum Pot { kPLJ = 0, kLJ, kColloid, kExpandedYukawa, kHertz, kMorse, kGaussian, kYukawa, kNPot };
enum Tab { kRcutsq = 0, kEcut, kRonsq, kParam };

// the potential's k-th parameter for one type pair
struct Params {
  const float* p;  // tables + ti * T + tj
  int TT;
  __device__ __forceinline__ float operator[](int k) const { return __ldg(p + (kParam + k) * TT); }
};

__device__ __forceinline__ float pow7inv(float x) {
  const float xi = 1.0f / x;
  const float x2 = xi * xi;
  return x2 * x2 * x2 * xi;
}

// Colloid (reference plugin: src/PairEvaluatorColloid.h:101-269), the
// branch the radii select; the guards keep contact singularities finite
template <bool WANT_E>
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
__device__ __forceinline__ bool evaluate(float rsq, float rcutsq, const Params& p, float* e,
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

template <int POT, bool WANT_ALL, bool MIN_IMAGE, bool XPLOR>
__global__ void cell_pair_force_kernel(const float* __restrict__ pos,
                                       const int* __restrict__ type_of,
                                       const int* __restrict__ tag,
                                       const float* __restrict__ tab, int T, int Dx, int Dy,
                                       int Dz, int cap, BoxArgs box, float* __restrict__ force,
                                       float* __restrict__ energy, float* __restrict__ virial) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  int* st = reinterpret_cast<int*>(sz + cap);  // typeid, -1 for an empty slot

  const int cell = blockIdx.x;
  const int li = threadIdx.x;
  const bool has_i = li < cap;
  const int si = cell * cap + li;
  const int TT = T * T;

  int ti = -1;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (has_i && tag[si] >= 0) {
    ti = type_of[si];
    xi = pos[3 * si];
    yi = pos[3 * si + 1];
    zi = pos[3 * si + 2];
  }
  float fx = 0.f, fy = 0.f, fz = 0.f;
  float en = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f, v4 = 0.f, v5 = 0.f;

  az::for_each_neighbour_cell(cell, Dx, Dy, Dz, [&](int ncell, int wx, int wy, int wz,
                                                    bool forward) {
    __syncthreads();  // the previous neighbour's staging is consumed
    if (has_i) {
      const int sj = ncell * cap + li;
      float x = pos[3 * sj], y = pos[3 * sj + 1], z = pos[3 * sj + 2];
      az::stage_position<MIN_IMAGE>(&x, &y, &z, wx, wy, wz, forward, box);
      sx[li] = x;
      sy[li] = y;
      sz[li] = z;
      st[li] = tag[sj] >= 0 ? type_of[sj] : -1;
    }
    __syncthreads();
    if (ti < 0) return;

    float xs = xi, ys = yi, zs = zi;
    az::self_position<MIN_IMAGE>(&xs, &ys, &zs, wx, wy, wz, forward, box);
    const bool self_cell = ncell == cell;
    const float* tp = tab + ti * T;

    for (int lj = 0; lj < cap; ++lj) {
      const int tj = st[lj];
      if (tj < 0 || (self_cell && lj == li)) continue;
      float dx, dy, dz;
      const float rsq = az::separation<MIN_IMAGE>(xs, ys, zs, sx[lj], sy[lj], sz[lj], box, &dx,
                                                  &dy, &dz);
      const float* pp = tp + tj;
      const float rcutsq = __ldg(pp + kRcutsq * TT);
      if (!(rsq < rcutsq)) continue;
      const Params p{pp, TT};
      float e = 0.f, f;
      if (!evaluate<POT, WANT_ALL>(rsq, rcutsq, p, &e, &f)) continue;
      const float ronsq = XPLOR ? __ldg(pp + kRonsq * TT) : 0.f;
      if (XPLOR && rsq > ronsq) {  // xplor smoothing (ops/pair_force.py::_xplor_smooth)
        // the force path forms the energy only here, where smoothing reads it
        if (!WANT_ALL) evaluate<POT, true>(rsq, rcutsq, p, &e, &f);
        const float dc = rcutsq - ronsq;
        float denom = dc * dc * dc;
        if (denom == 0.f) denom = 1.0f;
        const float dr = rcutsq - rsq;
        const float s = dr * dr * (rcutsq + 2.0f * rsq - 3.0f * ronsq) / denom;
        const float ds_dr_divr = 12.0f * (rsq - ronsq) * dr / denom;
        f = f * s + e * ds_dr_divr;
        e = e * s;
      }
      fx += f * dx;
      fy += f * dy;
      fz += f * dz;
      if (WANT_ALL) {
        en += 0.5f * (e - __ldg(pp + kEcut * TT));
        const float w = 0.5f * f;
        v0 += w * dx * dx;
        v1 += w * dx * dy;
        v2 += w * dx * dz;
        v3 += w * dy * dy;
        v4 += w * dy * dz;
        v5 += w * dz * dz;
      }
    }
  });

  if (!has_i) return;
  force[3 * si] = fx;
  force[3 * si + 1] = fy;
  force[3 * si + 2] = fz;
  if (WANT_ALL) {
    energy[si] = en;
    virial[6 * si] = v0;
    virial[6 * si + 1] = v1;
    virial[6 * si + 2] = v2;
    virial[6 * si + 3] = v3;
    virial[6 * si + 4] = v4;
    virial[6 * si + 5] = v5;
  }
}

struct LaunchArgs {
  dim3 grid, block;
  size_t smem;
  cudaStream_t stream;
  const float* pos;
  const int* type_of;
  const int* tag;
  const float* tab;
  int T, Dx, Dy, Dz, cap;
  BoxArgs box;
  float* force;
  float* energy;
  float* virial;
};

template <int POT, bool WANT_ALL, bool MIN_IMAGE>
void launch(const LaunchArgs& a, bool xplor) {
#define AZ_LAUNCH(X)                                                                             \
  cell_pair_force_kernel<POT, WANT_ALL, MIN_IMAGE, X><<<a.grid, a.block, a.smem, a.stream>>>( \
      a.pos, a.type_of, a.tag, a.tab, a.T, a.Dx, a.Dy, a.Dz, a.cap, a.box, a.force, a.energy, \
      a.virial)
  if (xplor) AZ_LAUNCH(true); else AZ_LAUNCH(false);
#undef AZ_LAUNCH
}

template <int POT>
void launch_pot(const LaunchArgs& a, bool want_all, bool min_image, bool xplor) {
  if (want_all) {
    if (min_image) launch<POT, true, true>(a, xplor); else launch<POT, true, false>(a, xplor);
  } else {
    if (min_image) launch<POT, false, true>(a, xplor); else launch<POT, false, false>(a, xplor);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// `tables` holds kParam + n_params stacked [T, T] float32 tables (enum Tab).
// xplor != 0 for tables built in mode xplor (the only mode whose kRonsq
// row is read). `energy` and `virial` are written only when want_all != 0
// (and may be null otherwise).
int az_cell_pair_force(const float* pos, const int* type_of, const int* tag, const float* tables,
                       int T, int Dx, int Dy, int Dz, int cap, float Lx, float Ly, float Lz,
                       float xy, float xz, float yz, float xyLy, float xzLz, float yzLz,
                       int min_image, int potential, int xplor, int want_all, float* force,
                       float* energy, float* virial, void* stream) {
  LaunchArgs a;
  if (!az::launch_shape(Dx, Dy, Dz, cap, T, &a.grid, &a.block) || potential < 0 ||
      potential >= kNPot)
    return (int)cudaErrorInvalidValue;
  a.smem = (size_t)cap * (3 * sizeof(float) + sizeof(int));
  a.stream = static_cast<cudaStream_t>(stream);
  a.pos = pos;
  a.type_of = type_of;
  a.tag = tag;
  a.tab = tables;
  a.T = T;
  a.Dx = Dx;
  a.Dy = Dy;
  a.Dz = Dz;
  a.cap = cap;
  a.box = BoxArgs{Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz};
  a.force = force;
  a.energy = energy;
  a.virial = virial;
  const bool all = want_all != 0, mi = min_image != 0, xp = xplor != 0;
  switch (potential) {
    case kPLJ: launch_pot<kPLJ>(a, all, mi, xp); break;
    case kLJ: launch_pot<kLJ>(a, all, mi, xp); break;
    case kColloid: launch_pot<kColloid>(a, all, mi, xp); break;
    case kExpandedYukawa: launch_pot<kExpandedYukawa>(a, all, mi, xp); break;
    case kHertz: launch_pot<kHertz>(a, all, mi, xp); break;
    case kMorse: launch_pot<kMorse>(a, all, mi, xp); break;
    case kGaussian: launch_pot<kGaussian>(a, all, mi, xp); break;
    case kYukawa: launch_pot<kYukawa>(a, all, mi, xp); break;
  }
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
