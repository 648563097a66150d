// Shared geometry of the cell-stencil kernels (cell_pair_force.cu,
// cell_dpd_force.cu).
//
// Layout (ops/dense.py): S = C * cap slots, cell-major; slot s = c * cap + r.
// Cells are indexed (cx * Dy + cy) * Dz + cz. Empty slots carry tag < 0.
//
// Schedule shared by both kernels: one block per cell, one thread per i
// slot. The block walks the stencil's neighbour cells
// (for_each_neighbour_cell); for each it stages the neighbour's slots in
// shared memory, and every thread sums its pairs with the staged slots in
// registers. Each pair is evaluated from both sides, so there are no atomics
// and the sums are deterministic.
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

namespace az {

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

// One neighbour cell of the stencil, as visit(ncell, wx, wy, wz, forward)
// sees it: its index, the wrap of each axis (-1, 0, 1) and whether the
// reference's half stencil evaluates the pair from this block's cell.
// The stencil is deduplicated (GridSpec.stencil): {-1,0,1} on axes with
// >= 3 cells, {0,1} with 2, {0} with 1. Called by every thread of the
// block in the same order, so visit may synchronise the block.
template <class Visit>
__device__ __forceinline__ void for_each_neighbour_cell(int cell, int Dx, int Dy, int Dz,
                                                        Visit&& visit) {
  const int cz = cell % Dz;
  const int cy = (cell / Dz) % Dy;
  const int cx = cell / (Dz * Dy);
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
        const bool forward = ox > 0 || (ox == 0 && (oy > 0 || (oy == 0 && oz > 0)));
        visit((nx * Dy + ny) * Dz + nz, wx, wy, wz, forward);
      }
    }
  }
}

// Position of a staged neighbour slot: shifted into this cell's frame when
// this cell is the pair's home side.
template <bool MIN_IMAGE>
__device__ __forceinline__ void stage_position(float* x, float* y, float* z, int wx, int wy,
                                               int wz, bool forward, const BoxArgs& b) {
  if (!MIN_IMAGE && forward) lattice_shift(x, y, z, wx, wy, wz, b);
}

// This slot's position as the home cell sees it, for a backward neighbour:
// the separation is then the exact negation of the home side's.
template <bool MIN_IMAGE>
__device__ __forceinline__ void self_position(float* x, float* y, float* z, int wx, int wy,
                                              int wz, bool forward, const BoxArgs& b) {
  if (!MIN_IMAGE && !forward) lattice_shift(x, y, z, -wx, -wy, -wz, b);
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

// Launch shape shared by both kernels: one block per cell, a whole number
// of warps covering the cell's slots.
inline bool launch_shape(int Dx, int Dy, int Dz, int cap, int T, dim3* grid, dim3* block) {
  const int n_cells = Dx * Dy * Dz;
  const int threads = ((cap + 31) / 32) * 32;
  if (n_cells <= 0 || cap <= 0 || T <= 0 || threads > 1024) return false;
  *grid = dim3(n_cells);
  *block = dim3(threads);
  return true;
}

}  // namespace az
