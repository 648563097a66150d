// Cell-stencil anisotropic force: TwoPatchMorse force and per-side torques.
//
// Replaces the TPU kernel azplugins_tpu/ops/pallas_pair.py
// (stencil_pair_force_kernel, body _kernel) as run by
// azplugins_tpu/ops/dense.py::_pallas_half_aniso_force. It computes the same
// per-slot sums as the plain version ops/dense.py::dense_aniso_force with the
// evaluator ops/evaluators/aniso.py::two_patch_morse, operation for
// operation; the schedule is Hopper's own (cell_stencil.cuh). For each pair
// inside r_cut, with u = dx / r and n the body x axis rotated by each
// particle's quaternion:
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
// threads, through one call site whose inputs are opaque to the compiler.
// Both threads then hold the same pair values; the home thread keeps +f and
// t_i, the far thread -f and t_j. Evaluating with the roles swapped would
// reorder the sum dU/dg_i n_i + dU/dg_j n_j, which fused multiply-adds then
// round differently, and the total force would vanish only to round-off.
// Grids with an axis under 3 cells take the full stencil with minimum
// image, as the reference's full-stencil branch does: every slot evaluates
// its pairs in its own frame and keeps +f and t_i.
//
// Tables: [kNTab, T, T] float32, read directly per pair (the TPU kernel's
// T <= 4 cap and its one-hot parameter rebuild are not needed here).
// want_all adds e/2 and the virial 0.5 dx f to each side.
//
// What bounds it on an H100: at the patchy-colloid state (27,000 particles,
// 23^3 cells, mean occupancy 2.2, cap 16) a slot sees ~60 occupied
// candidates in its 27 neighbour cells and ~6 inside r_cut 1.6 (81,000
// pairs at the lattice start); each pair costs three expf, a sqrt and two
// divides, ~170 float32 operations with its geometry and sums. The least
// the card could take is set by the slot data (36 bytes in, 24 out per
// slot: ~11.7 MB, ~3.5 us at 3.35 TB/s); the pair arithmetic is ~14 MFLOP. The kernel is far from either: at 2.2 particles per 16-slot
// cell, 93% of the lanes of a 32-thread block idle, and each block walks
// 27 staging rounds, each a dependent global load and two barriers, so
// latency binds it. Design: staging in shared memory so each neighbour slot
// is read once per block, accumulation in registers with no atomics, empty
// slots skipped before any arithmetic. Packing several cells per block (or
// a pair list) is the later redesign. IEEE expf, sqrtf and division keep
// it within 2e-5 of the plain version.

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace {

using az::BoxArgs;

// stacked [T, T] float32 tables (ops/aniso_kernel.py::aniso_kernel_tables)
enum Tab { kMd = 0, kMrinv, kReq, kOmega, kAlpha, kRep, kRcutsq, kUcut, kNTab };

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
                                                   const float* p, int TT) {
  const float M_d = __ldg(p + kMd * TT);
  const float M_rinv = __ldg(p + kMrinv * TT);
  const float r_eq = __ldg(p + kReq * TT);
  const float omega = __ldg(p + kOmega * TT);
  const float alpha = __ldg(p + kAlpha * TT);
  const float rep = __ldg(p + kRep * TT);
  const float U_cut = __ldg(p + kUcut * TT);

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
  if (r < r_eq && rep == 0.0f) {  // flat bottom
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
  o.e = U * Om_i * Om_j - U_cut * Om_i * Om_j;
  return o;
}

template <bool WANT_ALL, bool MIN_IMAGE>
__global__ void cell_aniso_force_kernel(const float* __restrict__ pos,
                                        const float* __restrict__ quat,
                                        const int* __restrict__ type_of,
                                        const int* __restrict__ tag,
                                        const float* __restrict__ tab, int T, int Dx, int Dy,
                                        int Dz, int cap, BoxArgs box, float* __restrict__ force,
                                        float* __restrict__ torque, float* __restrict__ energy,
                                        float* __restrict__ virial) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* sq = sz + cap;  // [4][cap]: w, x, y, z planes
  int* st = reinterpret_cast<int*>(sq + 4 * cap);  // typeid, -1 for an empty slot

  const int cell = blockIdx.x;
  const int li = threadIdx.x;
  const bool has_i = li < cap;
  const int si = cell * cap + li;
  const int TT = T * T;

  int ti = -1;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  float qs[4] = {1.f, 0.f, 0.f, 0.f};
  if (has_i && tag[si] >= 0) {
    ti = type_of[si];
    xi = pos[3 * si];
    yi = pos[3 * si + 1];
    zi = pos[3 * si + 2];
    for (int k = 0; k < 4; ++k) qs[k] = quat[4 * si + k];
  }
  float fx = 0.f, fy = 0.f, fz = 0.f, tx = 0.f, ty = 0.f, tz = 0.f;
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
      for (int k = 0; k < 4; ++k) sq[k * cap + li] = quat[4 * sj + k];
      st[li] = tag[sj] >= 0 ? type_of[sj] : -1;
    }
    __syncthreads();
    if (ti < 0) return;

    float xs = xi, ys = yi, zs = zi;
    az::self_position<MIN_IMAGE>(&xs, &ys, &zs, wx, wy, wz, forward, box);
    const bool self_cell = ncell == cell;

    for (int lj = 0; lj < cap; ++lj) {
      const int tj = st[lj];
      if (tj < 0 || (self_cell && lj == li)) continue;
      float dx, dy, dz;
      const float rsq = az::separation<MIN_IMAGE>(xs, ys, zs, sx[lj], sy[lj], sz[lj], box, &dx,
                                                  &dy, &dz);
      // this thread is the pair's home side, or the far side of a pair
      // whose home is the staged slot
      const bool home = MIN_IMAGE || (self_cell ? li < lj : forward);
      const int ta = home ? ti : tj, tb = home ? tj : ti;
      const float* p = tab + ta * T + tb;
      if (!(rsq > 0.f && rsq < __ldg(p + kRcutsq * TT))) continue;

      // the home frame: the far side's separation is the exact negation
      const float dxh = opaque(home ? dx : -dx);
      const float dyh = opaque(home ? dy : -dy);
      const float dzh = opaque(home ? dz : -dz);
      float qh[4], qf[4];
      for (int k = 0; k < 4; ++k) {
        const float qo = sq[k * cap + lj];
        qh[k] = opaque(home ? qs[k] : qo);
        qf[k] = opaque(home ? qo : qs[k]);
      }
      const PairOut o = two_patch_morse(dxh, dyh, dzh, qh, qf, p, TT);
      if (home) {
        fx += o.fx;
        fy += o.fy;
        fz += o.fz;
        tx += o.tix;
        ty += o.tiy;
        tz += o.tiz;
      } else {
        fx -= o.fx;
        fy -= o.fy;
        fz -= o.fz;
        tx += o.tjx;
        ty += o.tjy;
        tz += o.tjz;
      }
      if (WANT_ALL) {
        en += 0.5f * o.e;
        v0 += 0.5f * (dxh * o.fx);
        v1 += 0.5f * (dxh * o.fy);
        v2 += 0.5f * (dxh * o.fz);
        v3 += 0.5f * (dyh * o.fy);
        v4 += 0.5f * (dyh * o.fz);
        v5 += 0.5f * (dzh * o.fz);
      }
    }
  });

  if (!has_i) return;
  force[3 * si] = fx;
  force[3 * si + 1] = fy;
  force[3 * si + 2] = fz;
  torque[3 * si] = tx;
  torque[3 * si + 1] = ty;
  torque[3 * si + 2] = tz;
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

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// `quat` is [S, 4] (w, x, y, z); `tables` holds kNTab stacked [T, T] float32
// tables (enum Tab). `energy` and `virial` are written only when
// want_all != 0 (and may be null otherwise).
int az_cell_aniso_force(const float* pos, const float* quat, const int* type_of,
                        const int* tag, const float* tables, int T, int Dx, int Dy, int Dz,
                        int cap, float Lx, float Ly, float Lz, float xy, float xz, float yz,
                        float xyLy, float xzLz, float yzLz, int min_image, int want_all,
                        float* force, float* torque, float* energy, float* virial,
                        void* stream) {
  dim3 grid, block;
  if (!az::launch_shape(Dx, Dy, Dz, cap, T, &grid, &block)) return (int)cudaErrorInvalidValue;
  const BoxArgs box{Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz};
  const size_t smem = (size_t)cap * (7 * sizeof(float) + sizeof(int));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AZ_LAUNCH(A, M)                                                                       \
  cell_aniso_force_kernel<A, M><<<grid, block, smem, s>>>(pos, quat, type_of, tag, tables, T, \
                                                         Dx, Dy, Dz, cap, box, force, torque, \
                                                         energy, virial)
  if (want_all) {
    if (min_image) AZ_LAUNCH(true, true); else AZ_LAUNCH(true, false);
  } else {
    if (min_image) AZ_LAUNCH(false, true); else AZ_LAUNCH(false, false);
  }
#undef AZ_LAUNCH
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
