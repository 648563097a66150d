// Cell-stencil DPD force: conservative, drag and pair-symmetric random force.
//
// Replaces the TPU kernel azplugins_tpu/ops/pallas_pair.py
// (stencil_pair_force_kernel, body _kernel) as run by
// azplugins_tpu/ops/dense.py::_pallas_half_dpd_force. It computes the same
// per-slot sums as the plain version ops/dense.py::dense_dpd_force; the
// schedule is Hopper's own (cell_stencil.cuh). For each pair inside r_cut:
//
//   f/r = A (1/r - 1/rc) - gamma w_R^2 (dx . dv) + sigma w_R alpha,
//   w_R = max(1 - r/rc, 0)^(s/2) / r,
//
// with alpha = uniform_from_bits(x0), x0 the first word of Threefry-2x32 at
// 13 rounds keyed (k0, k1) = ((200 << 16) ^ seed, timestep) on the counters
// (min(tag_i, tag_j), max(tag_i, tag_j)): bitwise core/rng.py::pair_uniform
// with rounds=FAST_ROUNDS. Tags are int32 and the timestep a uint32; the
// reference's f32 tag planes and 16-bit timestep halves were TPU workarounds.
//
// Newton's third law holds term by term: the far side's separation and
// velocity difference are the exact negations of the home side's, so dx.dv,
// r, w_R and alpha, and with them the pair scalar, are bitwise identical on
// both sides. sigma = sqrt(6 gamma kT / dt) comes from the wrapper as a
// [T, T] table (ops/dense.py::dpd_sigma_table). want_all adds e/2 per side
// and the conservative-only virial (reference :239).
//
// What bounds it on an H100: at the DPD fluid (rho 3, r_cut 1, 13^3 cells
// of ~10 particles, cap 40) each slot tests ~270 candidates in its 27
// neighbour cells and ~40 fall inside r_cut; each of those costs a Threefry
// of 13 rounds (~60 integer operations), a powf and a few divides. The
// candidate loop over mostly empty staged slots and the per-pair integer
// work, not memory, bind it. The geometry and the uniform are explicitly
// rounded (no contraction), so the cutoff decisions and alpha are bitwise
// the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_stencil.cuh"

namespace {

using az::BoxArgs;

// stacked [T, T] float32 tables (ops/dpd_kernel.py::dpd_kernel_tables)
enum Tab { kA = 0, kGamma, kS, kRcut, kSigma, kNTab };

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// First output word of Threefry-2x32 at 13 rounds (random123 schedule, as
// core/rng.py::threefry2x32): key injections after rounds 3, 7 and 11.
__device__ __forceinline__ uint32_t threefry2x32_13(uint32_t k0, uint32_t k1, uint32_t c0,
                                                    uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    x0 += x1;
    x1 = rotl32(x1, rot[i % 8]) ^ x0;
    if (i % 4 == 3) {
      const int inject = i / 4 + 1;
      x0 += ks[inject % 3];
      x1 += ks[(inject + 1) % 3] + (uint32_t)inject;
    }
  }
  return x0;
}

// core/rng.py::uniform_from_bits on [-1, 1): 23 mantissa bits under
// exponent 0 give [1, 2), then -1, x2, -1, each rounded on its own.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u);
  return __fadd_rn(__fmul_rn(__fsub_rn(u, 1.0f), 2.0f), -1.0f);
}

template <bool WANT_ALL, bool MIN_IMAGE>
__global__ void cell_dpd_force_kernel(const float* __restrict__ pos,
                                      const float* __restrict__ vel,
                                      const int* __restrict__ type_of,
                                      const int* __restrict__ tag, const float* __restrict__ tab,
                                      int T, int Dx, int Dy, int Dz, int cap, BoxArgs box,
                                      uint32_t k0, uint32_t k1, float* __restrict__ force,
                                      float* __restrict__ energy, float* __restrict__ virial) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* svx = sz + cap;
  float* svy = svx + cap;
  float* svz = svy + cap;
  int* st = reinterpret_cast<int*>(svz + cap);  // typeid, -1 for an empty slot
  int* stag = st + cap;

  const int cell = blockIdx.x;
  const int li = threadIdx.x;
  const bool has_i = li < cap;
  const int si = cell * cap + li;
  const int TT = T * T;

  int ti = -1, tag_i = -1;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  if (has_i && tag[si] >= 0) {
    ti = type_of[si];
    tag_i = tag[si];
    xi = pos[3 * si];
    yi = pos[3 * si + 1];
    zi = pos[3 * si + 2];
    vxi = vel[3 * si];
    vyi = vel[3 * si + 1];
    vzi = vel[3 * si + 2];
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
      svx[li] = vel[3 * sj];
      svy[li] = vel[3 * sj + 1];
      svz[li] = vel[3 * sj + 2];
      const int tg = tag[sj];
      stag[li] = tg;
      st[li] = tg >= 0 ? type_of[sj] : -1;
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
      const float* p = tp + tj;
      const float rcut = __ldg(p + kRcut * TT);
      const float rcutsq = __fmul_rn(rcut, rcut);
      if (!(rsq > 0.f && rsq < rcutsq)) continue;
      const float A = __ldg(p + kA * TT);
      const float gamma = __ldg(p + kGamma * TT);
      const float s = __ldg(p + kS * TT);
      const float sigma = __ldg(p + kSigma * TT);

      const float rcut_safe = rcut > 0.f ? rcut : 2.0f;
      const float rinv = __fdiv_rn(1.0f, __fsqrt_rn(rsq));
      const float r = __fmul_rn(rsq, rinv);
      const float rcutinv = __fdiv_rn(1.0f, rcut_safe);
      const float f_cons = A * (rinv - rcutinv);

      const float dvx = vxi - svx[lj], dvy = vyi - svy[lj], dvz = vzi - svz[lj];
      const float rdotv = dx * dvx + dy * dvy + dz * dvz;
      const float base = fmaxf(__fsub_rn(1.0f, __fmul_rn(r, rcutinv)), 0.0f);
      const float w_R = powf(base, 0.5f * s) * rinv;
      const float f_drag = -gamma * w_R * w_R * rdotv;

      const uint32_t ta = (uint32_t)tag_i, tb = (uint32_t)stag[lj];
      const float alpha = uniform_from_bits(threefry2x32_13(k0, k1, min(ta, tb), max(ta, tb)));
      const float f = f_cons + f_drag + sigma * w_R * alpha;
      fx += f * dx;
      fy += f * dy;
      fz += f * dz;
      if (WANT_ALL) {
        const float e = A * (rcut_safe - r) - 0.5f * A * rcutinv * (rcutsq - rsq);
        en += 0.5f * e;
        const float w = 0.5f * f_cons;
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

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// `tables` holds kNTab stacked [T, T] float32 tables (enum Tab); (k0, k1)
// is the Threefry key. `energy` and `virial` are written only when
// want_all != 0 (and may be null otherwise).
int az_cell_dpd_force(const float* pos, const float* vel, const int* type_of, const int* tag,
                      const float* tables, int T, int Dx, int Dy, int Dz, int cap, float Lx,
                      float Ly, float Lz, float xy, float xz, float yz, float xyLy, float xzLz,
                      float yzLz, uint32_t k0, uint32_t k1, int min_image, int want_all,
                      float* force, float* energy, float* virial, void* stream) {
  dim3 grid, block;
  if (!az::launch_shape(Dx, Dy, Dz, cap, T, &grid, &block)) return (int)cudaErrorInvalidValue;
  const BoxArgs box{Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz};
  const size_t smem = (size_t)cap * (6 * sizeof(float) + 2 * sizeof(int));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AZ_LAUNCH(A, M)                                                                     \
  cell_dpd_force_kernel<A, M><<<grid, block, smem, s>>>(pos, vel, type_of, tag, tables, T, Dx, \
                                                       Dy, Dz, cap, box, k0, k1, force,       \
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
