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
// 13 rounds (threefry.cuh) keyed (k0, k1) = ((200 << 16) ^ seed, timestep) on the counters
// (min(tag_i, tag_j), max(tag_i, tag_j)): bitwise core/rng.py::pair_uniform
// with rounds=FAST_ROUNDS. Tags are int32 and the timestep a uint32; the
// reference's f32 tag planes and 16-bit timestep halves were TPU workarounds.
// The timestep word comes from the host, or from a clock on the card
// (az::step_word, read once a block), so a CUDA graph keys each replay on
// the clock's timestep.
//
// Newton's third law holds term by term: the far side's separation and
// velocity difference are the exact negations of the home side's, so dx.dv,
// r, w_R and alpha, and with them the pair scalar, are bitwise identical on
// both sides. sigma = sqrt(6 gamma kT / dt) comes from the wrapper as a
// [T, T] table (ops/dense.py::dpd_sigma_table). want_all adds e/2 per side
// and the conservative-only virial (reference :239).
//
// What bounds it on an H100: the per-pair work. At the DPD fluid (rho 3,
// r_cut 1, 13^3 cells of ~10 particles) each slot has ~270 occupied
// candidates in its 27 neighbour cells and ~40 inside r_cut; each of those
// costs a Threefry of 13 rounds (~60 integer operations), a powf, an IEEE
// sqrt and two IEEE divides, ~130 operations. What the design does about it
// (the packed schedule of cell_stencil.cuh): only occupied slots are staged
// and visited, the cell's ~10 slots share the block's 128 lanes (~12 lanes
// each), and a lane evaluates only the candidates it listed inside r_cut,
// so a warp pays the evaluation for its pairs, not for every candidate one
// of its lanes accepts. The one-thread-per-slot schedule it replaces,
// walking every slot of cap 40 with a 64-thread block, took 0.274 ms a call
// at the DPD fluid on an H100 80GB HBM3 at 700 W. The geometry and the
// uniform are explicitly rounded (no contraction), so the cutoff decisions
// and alpha are bitwise the plain version's. The [T, T] tables are copied
// into shared memory where they fit (az::kTableSmemBytes), else read from
// global memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_stencil.cuh"
#include "threefry.cuh"

namespace {

using az::BoxArgs;

// stacked [T, T] float32 tables (ops/dpd_kernel.py::dpd_kernel_tables)
enum Tab { kA = 0, kGamma, kS, kRcut, kSigma, kNTab };

constexpr int kThreads = 128;  // threads per block (one block per cell)

// one staged candidate: x, y, z, typeid bits; vx, vy, vz, tag bits
struct Staged {
  float4 pos, vel;
};

template <bool WANT_ALL, bool MIN_IMAGE>
__global__ void __launch_bounds__(kThreads)
    cell_dpd_force_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                          const int* __restrict__ type_of, const int* __restrict__ tag,
                          const float* __restrict__ tab, int T, int Dx, int Dy, int Dz, int cap,
                          az::Window win, BoxArgs box, uint32_t k0, uint32_t host_k1,
                          const long long* __restrict__ clock, int offset,
                          az::PackedLayout lay,
                          float* __restrict__ force, float* __restrict__ energy,
                          float* __restrict__ virial) {
  constexpr int B = kThreads;
  constexpr int N_ACC = WANT_ALL ? 10 : 3;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ az::StencilPlan P;
  float4* stage = reinterpret_cast<float4*>(smem);  // x, y, z, typeid bits
  float4* stage_v = stage + lay.stage_cap;           // vx, vy, vz, tag bits
  float* part = reinterpret_cast<float*>(smem + lay.off_part);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + lay.off_list);
  const int t = threadIdx.x, TT = T * T;
  const uint32_t k1 = az::step_word(host_k1, clock, offset);
  // the block's cell: the grid's (geometry), its own output cell, and (after
  // the plan) its window cell (inputs)
  const int out_cell = blockIdx.x, cell = win.c0 * Dz + out_cell;

  const float* tabs = tab;
  if (lay.tab_floats > 0) {
    float* s_tab = reinterpret_cast<float*>(smem + lay.off_tab);
    for (int x = t; x < lay.tab_floats; x += B) s_tab[x] = __ldg(tab + x);
    tabs = s_tab;
  }
  az::plan_stencil<B, MIN_IMAGE>(P, tag, cell, win, Dx, Dy, Dz, cap);  // synchronises
  if (!P.prefix) {
    az::poison_cell<B, WANT_ALL>(out_cell, cap, force, energy, virial);
    return;
  }
  const int in_cell = P.cell[P.self_seg];
  for (int r = t; r < cap; r += B) {  // empty slots sum to exactly zero
    if (tag[in_cell * cap + r] >= 0) continue;
    const int s = out_cell * cap + r;
    force[3 * s] = force[3 * s + 1] = force[3 * s + 2] = 0.f;
    if (WANT_ALL) {
      energy[s] = 0.f;
      for (int a = 0; a < 6; ++a) virial[6 * s + a] = 0.f;
    }
  }
  const int n_i = P.start[P.self_seg + 1] - P.start[P.self_seg];
  if (n_i == 0) return;
  const int M = P.start[P.n_seg];
  const int n_stage = (M + lay.stage_cap - 1) / lay.stage_cap;
  const az::LaneMap<B> L(n_i);
  const int k = t % L.K;

  for (int q = 0; q < L.rounds; ++q) {
    const int ir = q * L.per_round + t / L.K;
    const bool active = t / L.K < L.per_round && ir < n_i;
    int ti = 0, tag_i = 0;
    float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f, rfilt = 0.f;
    if (active) {
      const int si = in_cell * cap + ir;  // the precondition: the ir-th slot
      ti = type_of[si];
      tag_i = tag[si];
      xi = pos[3 * si];
      yi = pos[3 * si + 1];
      zi = pos[3 * si + 2];
      vxi = vel[3 * si];
      vyi = vel[3 * si + 1];
      vzi = vel[3 * si + 2];
      for (int tj = 0; tj < T; ++tj) {
        const float rc = tabs[kRcut * TT + ti * T + tj];
        rfilt = fmaxf(rfilt, __fmul_rn(rc, rc));
      }
    }
    const float* tp = tabs + ti * T;
    float acc[N_ACC];
#pragma unroll
    for (int a = 0; a < N_ACC; ++a) acc[a] = 0.f;
    // the table values of the last type pair, reloaded when the type changes
    int cached_tj = -1;
    float rcut = 0.f, rcutsq = 0.f, A = 0.f, gamma = 0.f, s = 0.f, sigma = 0.f, rcut_safe = 0.f,
          rcutinv = 0.f;

    // evaluates this lane's n listed candidates against their own type
    // pair's cutoff, adding what each pair inside gives this slot
    auto flush = [&](float xs, float ys, float zs, int n) {
      for (int e = 0; e < n; ++e) {
        const int m = list[e * B + t];
        const float4 pj = stage[m];
        float dx, dy, dz;
        const float rsq =
            az::separation<MIN_IMAGE>(xs, ys, zs, pj.x, pj.y, pj.z, box, &dx, &dy, &dz);
        const int tj = __float_as_int(pj.w);
        if (tj != cached_tj) {
          const float* p = tp + tj;
          cached_tj = tj;
          rcut = p[kRcut * TT];
          rcutsq = __fmul_rn(rcut, rcut);
          A = p[kA * TT];
          gamma = p[kGamma * TT];
          s = p[kS * TT];
          sigma = p[kSigma * TT];
          rcut_safe = rcut > 0.f ? rcut : 2.0f;
          rcutinv = __fdiv_rn(1.0f, rcut_safe);
        }
        if (!(rsq > 0.f && rsq < rcutsq)) continue;
        const float4 vj = stage_v[m];

        const float rinv = __fdiv_rn(1.0f, __fsqrt_rn(rsq));
        const float r = __fmul_rn(rsq, rinv);
        const float f_cons = A * (rinv - rcutinv);

        const float dvx = vxi - vj.x, dvy = vyi - vj.y, dvz = vzi - vj.z;
        const float rdotv = dx * dvx + dy * dvy + dz * dvz;
        const float base = fmaxf(__fsub_rn(1.0f, __fmul_rn(r, rcutinv)), 0.0f);
        const float w_R = powf(base, 0.5f * s) * rinv;
        const float f_drag = -gamma * w_R * w_R * rdotv;

        const uint32_t ta = (uint32_t)tag_i, tb = (uint32_t)__float_as_int(vj.w);
        // Threefry-2x32-13's first word on [-1, 1): core/rng.py::pair_uniform
        const float alpha =
            az::uniform_from_bits(az::threefry2x32<13>(k0, k1, min(ta, tb), max(ta, tb)).x, 2.0f,
                                  -1.0f);
        const float f = f_cons + f_drag + sigma * w_R * alpha;
        acc[0] += f * dx;
        acc[1] += f * dy;
        acc[2] += f * dz;
        if constexpr (WANT_ALL) {
          const float en = A * (rcut_safe - r) - 0.5f * A * rcutinv * (rcutsq - rsq);
          acc[3] += 0.5f * en;
          const float w = 0.5f * f_cons;
          acc[4] += w * dx * dx;
          acc[5] += w * dx * dy;
          acc[6] += w * dx * dz;
          acc[7] += w * dy * dy;
          acc[8] += w * dy * dz;
          acc[9] += w * dz * dz;
        }
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
              return Staged{make_float4(x, y, z, __int_as_float(type_of[sj])),
                            make_float4(vel[3 * sj], vel[3 * sj + 1], vel[3 * sj + 2],
                                        __int_as_float(tag[sj]))};
            },
            [&](int e, const Staged& entry) {
              stage[e] = entry.pos;
              stage_v[e] = entry.vel;
            });
        __syncthreads();
      }
      az::sweep_round<B, MIN_IMAGE>(P, stage, R0, R1, L.K, k, active, P.start[P.self_seg] + ir,
                                    xi, yi, zi, rfilt, box, list, flush);
    }

    az::reduce_lanes<B, N_ACC>(part, acc, L, q, n_i, [&](int r, const float* sum) {
      const int si = out_cell * cap + r;
      force[3 * si] = sum[0];
      force[3 * si + 1] = sum[1];
      force[3 * si + 2] = sum[2];
      if constexpr (WANT_ALL) {
        energy[si] = sum[3];
        for (int a = 0; a < 6; ++a) virial[6 * si + a] = sum[4 + a];
      }
    });
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns its CUDA error (0 = launched).
// `tables` holds kNTab stacked [T, T] float32 tables (enum Tab); (k0, k1)
// is the Threefry key, its timestep word (uint32)(*clock + offset) instead
// where `clock` (a device int64) is not null. pos, vel, type_of and tag hold the window (w0,
// n_cols) of the grid; the outputs, the n_own columns from c0
// (cell_stencil.cuh, Window). `energy` and `virial` are written only when
// want_all != 0 (and may be null otherwise).
int az_cell_dpd_force(const float* pos, const float* vel, const int* type_of, const int* tag,
                      const float* tables, int T, int Dx, int Dy, int Dz, int cap, int w0,
                      int n_cols, int c0, int n_own, float Lx, float Ly, float Lz, float xy,
                      float xz, float yz, float xyLy, float xzLz, float yzLz, uint32_t k0,
                      uint32_t k1, const long long* clock, int offset, int min_image,
                      int want_all, float* force, float* energy, float* virial, void* stream) {
  dim3 grid, block;
  az::PackedLayout lay;
  const az::Window win{w0, n_cols, c0, n_own};
  if (!az::packed_launch(Dx, Dy, Dz, cap, win, T, kNTab, 32, want_all ? 10 : 3, kThreads, &grid,
                         &block, &lay))
    return (int)cudaErrorInvalidValue;
  const BoxArgs box{Lx, Ly, Lz, xy, xz, yz, xyLy, xzLz, yzLz};
  auto kernel = want_all ? (min_image ? cell_dpd_force_kernel<true, true>
                                      : cell_dpd_force_kernel<true, false>)
                         : (min_image ? cell_dpd_force_kernel<false, true>
                                      : cell_dpd_force_kernel<false, false>);
  return (int)az::launch_packed(kernel, grid, block, lay, static_cast<cudaStream_t>(stream), pos,
                                vel, type_of, tag, tables, T, Dx, Dy, Dz, cap, win, box, k0, k1,
                                clock, offset, lay, force, energy, virial);
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
