// Cell-stencil pair force for the perturbed Lennard-Jones potential.
//
// Replaces the TPU kernel azplugins_tpu/ops/pallas_pair.py
// (stencil_pair_force_kernel, body _kernel) as run by
// azplugins_tpu/ops/dense.py::_pallas_half_pair_force with the PLJ force
// evaluator (want="force") and with the general evaluator (want="all",
// modes none and shift). It computes the same per-slot sums; the schedule
// is Hopper's own.
//
// Layout (ops/dense.py): S = C * cap slots, cell-major; slot s = c * cap + r.
// Empty slots carry tag < 0 and are skipped on both sides of every pair.
// Cells are indexed (cx * Dy + cy) * Dz + cz.
//
// Schedule: one block per cell, one thread per i slot of the cell. The
// block walks the stencil's neighbour cells; for each it stages the
// neighbour's positions and typeids in shared memory, and every thread sums
// its pairs with all staged j slots in registers. Each pair is evaluated
// from both sides, so there are no atomics and the sums are deterministic.
//
// Grids with >= 3 cells on every axis use the 27-cell stencil and take the
// periodic lattice shift from the neighbour cell's index wrap, never from
// positions (positions drift unwrapped between rebuilds). Per pair, the
// separation is formed exactly as the reference's Newton half stencil forms
// it from the pair's home side (the lower-offset cell), then negated where
// this thread is the far side: separations, and with them the cutoff
// decisions, are bitwise those of the plain PyTorch version. Grids with an
// axis under 3 cells use the deduplicated stencil with per-pair minimum
// image, as the reference's full-stencil branch does.
//
// The pair arithmetic is the plain C++ below, which nvcc may contract into
// fused multiply-adds; the geometry (separation, minimum image, squared
// distance) uses explicitly rounded intrinsics so that it is never
// contracted.

#include <cuda_runtime.h>

namespace {

// parameter tables, each [T, T] float32, stacked in this order
enum Tab { kLj1 = 0, kLj2, kLam, kRwcasq, kWcaShift, kRcutsq, kEcut, kNTab };

struct BoxArgs {
  float Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz;
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

template <bool WANT_ALL, bool MIN_IMAGE, bool SHIFT>
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
  const int cz = cell % Dz;
  const int cy = (cell / Dz) % Dy;
  const int cx = cell / (Dz * Dy);
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

  // deduplicated stencil (GridSpec.stencil): {-1,0,1} on axes with >= 3
  // cells, {0,1} with 2, {0} with 1
  const int lox = Dx >= 3 ? -1 : 0, hix = Dx >= 2 ? 1 : 0;
  const int loy = Dy >= 3 ? -1 : 0, hiy = Dy >= 2 ? 1 : 0;
  const int loz = Dz >= 3 ? -1 : 0, hiz = Dz >= 2 ? 1 : 0;

  for (int ox = lox; ox <= hix; ++ox) {
    for (int oy = loy; oy <= hiy; ++oy) {
      for (int oz = loz; oz <= hiz; ++oz) {
        int wx, wy, wz;
        const int nx = wrap_cell(cx + ox, Dx, &wx);
        const int ny = wrap_cell(cy + oy, Dy, &wy);
        const int nz = wrap_cell(cz + oz, Dz, &wz);
        const int ncell = (nx * Dy + ny) * Dz + nz;
        // the reference's half stencil evaluates a pair from the cell whose
        // offset to the other is lexicographically positive
        const bool forward = ox > 0 || (ox == 0 && (oy > 0 || (oy == 0 && oz > 0)));

        __syncthreads();  // the previous neighbour's staging is consumed
        if (has_i) {
          const int sj = ncell * cap + li;
          float x = pos[3 * sj], y = pos[3 * sj + 1], z = pos[3 * sj + 2];
          if (!MIN_IMAGE && forward) lattice_shift(&x, &y, &z, wx, wy, wz, box);
          sx[li] = x;
          sy[li] = y;
          sz[li] = z;
          st[li] = tag[sj] >= 0 ? type_of[sj] : -1;
        }
        __syncthreads();
        if (ti < 0) continue;

        // far side of a backward pair: shift this slot as the home cell sees
        // it, so the separation is the exact negation of the home side's
        float xs = xi, ys = yi, zs = zi;
        if (!MIN_IMAGE && !forward) lattice_shift(&xs, &ys, &zs, -wx, -wy, -wz, box);
        const bool self_cell = ncell == cell;
        const float* tp = tab + ti * T;

        for (int lj = 0; lj < cap; ++lj) {
          const int tj = st[lj];
          if (tj < 0 || (self_cell && lj == li)) continue;
          float dx = __fsub_rn(xs, sx[lj]);
          float dy = __fsub_rn(ys, sy[lj]);
          float dz = __fsub_rn(zs, sz[lj]);
          if (MIN_IMAGE) min_image(&dx, &dy, &dz, box);
          const float rsq =
              __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          const float* p = tp + tj;
          if (!(rsq < __ldg(p + kRcutsq * TT))) continue;
          const float lj1 = __ldg(p + kLj1 * TT);
          if (lj1 == 0.f) continue;  // inactive pair: zero force and energy
          const float lj2 = __ldg(p + kLj2 * TT);
          const float lam = __ldg(p + kLam * TT);
          const bool in_core = rsq < __ldg(p + kRwcasq * TT);

          const float r2inv = 1.0f / rsq;
          const float r6inv = r2inv * r2inv * r2inv;
          float f = r2inv * r6inv * (12.0f * lj1 * r6inv - 6.0f * lj2);
          if (!in_core) f *= lam;
          fx += f * dx;
          fy += f * dy;
          fz += f * dz;
          if (WANT_ALL) {
            float e = r6inv * (lj1 * r6inv - lj2);
            e = in_core ? e + __ldg(p + kWcaShift * TT) : e * lam;
            if (SHIFT) e -= __ldg(p + kEcut * TT);
            en += 0.5f * e;
            const float w = 0.5f * f;
            v0 += w * dx * dx;
            v1 += w * dx * dy;
            v2 += w * dx * dz;
            v3 += w * dy * dy;
            v4 += w * dy * dz;
            v5 += w * dz * dz;
          }
        }
      }
    }
  }

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

template <bool WANT_ALL, bool MIN_IMAGE, bool SHIFT>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream, const float* pos,
            const int* type_of, const int* tag, const float* tab, int T, int Dx, int Dy, int Dz,
            int cap, const BoxArgs& box, float* force, float* energy, float* virial) {
  cell_pair_force_kernel<WANT_ALL, MIN_IMAGE, SHIFT><<<grid, block, smem, stream>>>(
      pos, type_of, tag, tab, T, Dx, Dy, Dz, cap, box, force, energy, virial);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// `tables` holds kNTab stacked [T, T] float32 tables. `energy` and `virial`
// are written only when want_all != 0 (and may be null otherwise).
int az_cell_pair_force(const float* pos, const int* type_of, const int* tag, const float* tables,
                       int T, int Dx, int Dy, int Dz, int cap, float Lx, float Ly, float Lz,
                       float xy, float xz, float yz, float xyLy, float xzLz, float yzLz,
                       int min_image, int shift_mode, int want_all, float* force, float* energy,
                       float* virial, void* stream) {
  const int n_cells = Dx * Dy * Dz;
  const int threads = ((cap + 31) / 32) * 32;
  if (n_cells <= 0 || cap <= 0 || T <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  const BoxArgs box{Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz};
  const dim3 grid(n_cells), block(threads);
  const size_t smem = (size_t)cap * (3 * sizeof(float) + sizeof(int));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AZ_LAUNCH(A, M, H)                                                                   \
  launch<A, M, H>(grid, block, smem, s, pos, type_of, tag, tables, T, Dx, Dy, Dz, cap, box, \
                  force, energy, virial)
  if (want_all) {
    if (min_image) {
      if (shift_mode) AZ_LAUNCH(true, true, true); else AZ_LAUNCH(true, true, false);
    } else {
      if (shift_mode) AZ_LAUNCH(true, false, true); else AZ_LAUNCH(true, false, false);
    }
  } else {
    if (min_image) AZ_LAUNCH(false, true, false); else AZ_LAUNCH(false, false, false);
  }
#undef AZ_LAUNCH
  return (int)cudaGetLastError();
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
