// K5: one rendered frame — sim_count implicit-CG substeps, each the blocked
// prep, the rhs assembly, the reference CG solve and the implicit advection —
// in one cooperative launch.
//
// Replaces the TPU kernel fem_tpu/ops/pallas_blocked_frame.py:_frame_kernel
// (reached through fused_blocked_frame), every material and robust
// Neo-Hookean (the shared chain fem::material_chain), with the plastic and
// Maxwell branches.  The
// TPU kernel runs on one core over VMEM-resident one-hot tables (s_dense,
// g_dense, the pj/psum selection tensors) with 3-plane bf16 dots and
// (8, 128)-padded planes; none of that is semantics and none is carried
// over: this kernel indexes directly and computes in plain f32.
//
// Semantics, unchanged (fused_blocked_frame's contract):
//   per substep: K_e and force columns at pos (the shared chain,
//   element_chain.cuh); b = v + dt f / m; the reference CG — x_0 = b,
//   normal equations A^T A x = A^T b when `normal`, else A x = b, while
//   it < max_iter && |r|^2 > tol — with A v = v - dt^2 G(K) v / m and
//   A^T v = v - dt^2 G(K^T)(v / m); then advection: vel_g gains 9.8 g dt,
//   both channels decay by exp(-dt damping), the lower wall zeroes both
//   channels and the upper wall zeroes vel but not vel_g, circles project
//   in obstacle order (radius 0 never hits), pos += (vel + vel_g) dt.
//
// The kernel is templated on the dimension D in {2, 3}, as the Pallas
// kernel takes `dim`: the same phases over (N, D) rows, (D+1)-vertex
// elements and D x D blocks; and on the material M (fem::Material), as it
// takes `material` and `robust`: a compile-time instance, so the
// Neo-Hookean instance carries no other material's code or registers.
// fem_blocked_frame launches the instance of (args->T.dim, args->material);
// a library built with -DFEM_MATERIAL holds one material's four instances
// (utils/cuda_build.py builds the materials' libraries in parallel).
//
// Inelastic materials (the INELASTIC instance, chosen at launch;
// inelastic.cuh): the prep runs the base material's chain on each element's
// R^-1 F_p^-1 and adds the Maxwell branch's stable Neo-Hookean k and h
// (lam = 0, mu_v, on R^-1 F_v^-1) before the -V scaling
// (pallas_blocked_frame.py:139-197); after each substep's advection and the
// grid barrier that ends it, each CTA updates its own blocks' elements from
// the end-of-substep positions (:296-373).  The barrier the elastic kernel
// already has there orders the update after every CTA's advection, and the
// next prep reads only the CTA's own blocks' state, so the barrier count is
// unchanged.  The state stays in the output arrays, mesh element order,
// through element_perm.
//
// Design.  One thread block per locality block (17 on the 3D flagship, 1
// on the 2D default scene; grid-stride when a mesh has more blocks than the
// grid): each CTA keeps the K blocks of the locality blocks it owns in
// shared memory for the whole solve, and phases that cross blocks are separated by grid barriers
// (cooperative_groups::this_grid().sync(); the launch is cooperative, so
// the grid is co-resident or the launch fails — it never hangs).  An
// operator apply is a per-block local product (blocked_common.cuh), a grid
// barrier, and a per-particle sum over its block slots.  A dot product is a
// per-CTA partial in a fixed order, a barrier, and a sum of all CTAs'
// partials in index order done by every CTA, so every CTA holds the same
// alpha and beta and two runs are bit-identical.  The partials and the
// per-slot buffers alternate between two copies, so a fast CTA's next write
// never lands on what a slow CTA is still reading.  Data written by another
// CTA in the same launch is read past L1 (__ldcg).
//
// Bound on the H100: operations — a flagship frame at 29 CG iterations is
// ~47 MFLOP, 0.7 us at 67 TFLOP/s f32, and its bytes take less; what sets
// the time is the chain of ~6 grid barriers per CG iteration and the
// per-block work done by one SM each.  A first kernel that is right; fewer
// barriers and more SMs per block are later work.  With one locality block
// (the shipped 2D scenes) the grid is one CTA: the grid barriers still run,
// and cost what a CTA-wide barrier plus the cooperative sync's device-memory
// flag round trip costs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "blocked_common.cuh"
#include "cooperative.cuh"
#include "inelastic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

}  // namespace

// The Python side mirrors this layout (ops/frame_kernels.py: FrameArgsC).
struct FemFrameArgs {
  fem::BlockTables T;    // T.dim is D
  const int* slot_ptr;   // (N+1,) slot plan
  const int* slot_rows;  // flat block slots b*Pb+p
  const float* pos_in;   // (N, D)
  const float* vel_in;
  const float* velg_in;
  const float* mass;     // (N,)
  const float* centers;  // (O, D)
  const float* radii;    // (O,)
  int n;
  int n_obst;
  int sim_count;
  int max_iter;
  int normal;
  int material;    // fem::Material: the instance the launch runs
  float dt;
  float dt2;
  float decay;
  float g0, g1, g2;  // 9.8 g_dir (g2 unused in 2D)
  fem::MaterialParams mat;  // the material's numbers
  float tol;
  float* pos;      // (N, D) outputs, the state through the frame
  float* vel;
  float* velg;
  float* scratch;  // see fem_blocked_frame_scratch_floats
  int* iters;      // (S,)
  float* res;      // (S,)
  fem::InelasticArgs in;
};

namespace {

struct Vecs {
  float* minv;      // (N,)
  float* x;         // (N, D) each below
  float* r;
  float* d;
  float* q;
  float* u;
  float* z;
  float* part[2];   // (B*Pb, D) per-slot partials, two copies
  float* dots;      // (2, grid) per-CTA dot-product partials
};

template <int D>
__device__ Vecs carve(const FemFrameArgs& a) {
  Vecs v;
  const size_t nd = D * static_cast<size_t>(a.n);
  const size_t slots = D * static_cast<size_t>(a.T.num_blocks) * a.T.pb;
  v.minv = a.scratch;
  v.x = v.minv + a.n;
  v.r = v.x + nd;
  v.d = v.r + nd;
  v.q = v.d + nd;
  v.u = v.q + nd;
  v.z = v.u + nd;
  v.part[0] = v.z + nd;
  v.part[1] = v.part[0] + slots;
  v.dots = v.part[1] + slots;
  return v;
}

// Sum of `v` over the CTA in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();
  return total;
}

template <int D, int M, bool INELASTIC>
struct Frame {
  static constexpr int DD = D * D;
  static constexpr int R = fem::rows_floats(D);

  const FemFrameArgs& a;
  Vecs v;
  cg::grid_group grid;
  float* ksh;  // K blocks of the owned locality blocks
  float* xs;   // one block's particle rows
  float* t;    // one block's contribution rows
  float* red;
  float* bcast;
  int buf;     // which half of `dots` the next dot product uses
  int first;   // this thread's first particle, and the stride
  int stride;

  // Sum over the grid of each thread's `part`, identical in every CTA.
  __device__ float grid_sum(float part) {
    const float s = block_sum(part, red);
    float* dots = v.dots + buf * gridDim.x;
    if (threadIdx.x == 0) __stcg(dots + blockIdx.x, s);
    grid.sync();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int i = 0; i < static_cast<int>(gridDim.x); ++i) total += __ldcg(dots + i);
      *bcast = total;
    }
    __syncthreads();
    const float total = *bcast;
    buf ^= 1;
    return total;
  }

  // Per-slot partials `out` of the element-Laplacian product of every
  // owned block's K (K^T when `transpose`) with `src`.  `src` must be
  // complete (a grid barrier since its last write).
  __device__ void local_products(const float* src, bool transpose, float* out) {
    const fem::BlockTables& T = a.T;
    for (int b = blockIdx.x, ib = 0; b < T.num_blocks; b += gridDim.x, ++ib) {
      fem::load_block_rows<D>(T, b, src, xs);
      __syncthreads();
      const int nel = T.block_elements[b];
      for (int e = threadIdx.x; e < nel; e += blockDim.x) {
        fem::element_apply<D>(T, b, e, xs, ksh + DD * (ib * T.eb + e),
                              transpose, t + R * e);
      }
      __syncthreads();
      fem::block_slot_sums<D>(T, b, t, out + D * b * T.pb);
      __syncthreads();
    }
  }

  // The prep of real element e of block b with the material layers: the
  // base chain on R^-1 F_p^-1 plus the Maxwell branch's, then -V.
  __device__ void element_prep_layers(int b, int e, float* k_out, float* tr) {
    const fem::BlockTables& T = a.T;
    const int slot = b * T.eb + e;
    float x[DD], r[DD], r_base[DD], r_branch[DD], k[DD], h[DD];
    fem::block_edges<D>(T, b, e, xs, x);
#pragma unroll
    for (int i = 0; i < DD; ++i) r[i] = T.ref_inv[DD * slot + i];
    fem::layer_refs<D>(a.in, slot, r, r_base, r_branch);
    fem::material_chain<D, M>(x, r_base, a.mat, k, h);
    if (a.in.viscous != nullptr) {
      float k2[DD], h2[DD];
      fem::material_chain<D, fem::kStableNeoHookean>(
          x, r_branch, fem::branch_params(a.in.viscous_mu), k2, h2);
#pragma unroll
      for (int i = 0; i < DD; ++i) {
        k[i] = k[i] + k2[i];
        h[i] = h[i] + h2[i];
      }
    }
    const float nv = -T.volume[slot];
#pragma unroll
    for (int i = 0; i < DD; ++i) k_out[i] = nv * k[i];
    fem::column_rows<D>(nv, h, tr);
  }

  // K blocks into shared memory and force partials into `out`, at a.pos.
  __device__ void prep(float* out) {
    const fem::BlockTables& T = a.T;
    for (int b = blockIdx.x, ib = 0; b < T.num_blocks; b += gridDim.x, ++ib) {
      fem::load_block_rows<D>(T, b, a.pos, xs);
      __syncthreads();
      const int nel = T.block_elements[b];
      for (int e = threadIdx.x; e < nel; e += blockDim.x) {
        if constexpr (INELASTIC) {
          element_prep_layers(b, e, ksh + DD * (ib * T.eb + e), t + R * e);
        } else {
          fem::element_prep<D, M>(T, b, e, xs, a.mat,
                                  ksh + DD * (ib * T.eb + e), t + R * e);
        }
      }
      __syncthreads();
      fem::block_slot_sums<D>(T, b, t, out + D * b * T.pb);
      __syncthreads();
    }
  }

  __device__ void slot_sum(const float* part, int p, float* w) {
    fem::particle_slot_sum<D>(a.slot_ptr, a.slot_rows, part, p, w);
  }

  // q = op(src) with op = A^T A (normal) or A; for the normal equations
  // `u` holds A src.  Returns sum_p src . q over this thread's particles.
  // Ends with the slot sums read; the caller's grid_sum is the barrier.
  __device__ float apply_op(const float* src, float* qv) {
    local_products(src, false, v.part[0]);
    grid.sync();
    float part = 0.0f;
    if (a.normal) {
      for (int p = first; p < a.n; p += stride) {
        float w[D];
        slot_sum(v.part[0], p, w);
        const float mi = v.minv[p];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float uc = __ldcg(src + D * p + c) - a.dt2 * w[c] * mi;
          v.u[D * p + c] = uc;
          v.z[D * p + c] = uc * mi;
        }
      }
      grid.sync();
      local_products(v.z, true, v.part[1]);
      grid.sync();
      for (int p = first; p < a.n; p += stride) {
        float w[D];
        slot_sum(v.part[1], p, w);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float qc = v.u[D * p + c] - a.dt2 * w[c];
          qv[D * p + c] = qc;
          part += __ldcg(src + D * p + c) * qc;
        }
      }
    } else {
      for (int p = first; p < a.n; p += stride) {
        float w[D];
        slot_sum(v.part[0], p, w);
        const float mi = v.minv[p];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float sc = __ldcg(src + D * p + c);
          const float qc = sc - a.dt2 * w[c] * mi;
          qv[D * p + c] = qc;
          part += sc * qc;
        }
      }
    }
    return part;
  }

  // The velocity solve of one substep; leaves x and returns (it, |r|^2).
  __device__ void solve(int* it_out, float* delta_out) {
    prep(v.part[0]);
    grid.sync();
    // b = v + dt f / m into x (x_0 = b); z = b / m for A^T b.
    for (int p = first; p < a.n; p += stride) {
      float f[D];
      slot_sum(v.part[0], p, f);
      const float mi = v.minv[p];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float bc = a.vel[D * p + c] + a.dt * f[c] * mi;
        v.x[D * p + c] = bc;
        v.z[D * p + c] = bc * mi;
      }
    }
    grid.sync();
    if (a.normal) {
      // r = A^T b (the rhs), kept in r until op(x_0) is subtracted.
      local_products(v.z, true, v.part[1]);
      grid.sync();
      for (int p = first; p < a.n; p += stride) {
        float w[D];
        slot_sum(v.part[1], p, w);
#pragma unroll
        for (int c = 0; c < D; ++c) v.r[D * p + c] = v.x[D * p + c] - a.dt2 * w[c];
      }
      // The grid barriers inside apply_op order these writes of r before
      // any later read, and z's rewrite after every CTA's read of it.
    }
    apply_op(v.x, v.q);
    float part = 0.0f;
    for (int p = first; p < a.n; p += stride) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const int i = D * p + c;
        const float rhs = a.normal ? v.r[i] : v.x[i];
        const float ri = rhs - v.q[i];
        v.r[i] = ri;
        v.d[i] = ri;
        part += ri * ri;
      }
    }
    float delta = grid_sum(part);
    int it = 0;
    while (it < a.max_iter && delta > a.tol) {
      const float alpha = delta / grid_sum(apply_op(v.d, v.q));
      part = 0.0f;
      for (int p = first; p < a.n; p += stride) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * p + c;
          v.x[i] += alpha * v.d[i];
          const float ri = v.r[i] - alpha * v.q[i];
          v.r[i] = ri;
          part += ri * ri;
        }
      }
      const float delta_next = grid_sum(part);
      const float beta = delta_next / delta;
      for (int p = first; p < a.n; p += stride) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * p + c;
          v.d[i] = v.r[i] + beta * v.d[i];
        }
      }
      grid.sync();
      delta = delta_next;
      ++it;
    }
    *it_out = it;
    *delta_out = delta;
  }

  // Sum_c u[c] w[c] in the plain version's order, round-to-nearest.
  static __device__ float dot_rn(const float* u, const float* w) {
    float s = __fmul_rn(u[0], w[0]);
#pragma unroll
    for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(u[c], w[c]));
    return s;
  }

  // The internal update of every owned block's real elements from the
  // end-of-substep positions (a grid barrier since the advection).
  __device__ void internal_update() {
    const fem::BlockTables& T = a.T;
    for (int b = blockIdx.x; b < T.num_blocks; b += gridDim.x) {
      fem::load_block_rows<D>(T, b, a.pos, xs);
      __syncthreads();
      const int nel = T.block_elements[b];
      for (int e = threadIdx.x; e < nel; e += blockDim.x) {
        const int slot = b * T.eb + e;
        float x[DD];
        fem::block_edges<D>(T, b, e, xs, x);
        fem::update_slot<D>(a.in, slot, x, T.ref_inv + DD * slot);
      }
      __syncthreads();
    }
  }

  // The state of every owned block's real elements from the inputs into
  // the outputs; the same thread later reads and updates it.
  __device__ void copy_state() {
    const fem::BlockTables& T = a.T;
    for (int b = blockIdx.x; b < T.num_blocks; b += gridDim.x) {
      const int nel = T.block_elements[b];
      for (int e = threadIdx.x; e < nel; e += blockDim.x) {
        fem::copy_state<D>(a.in, b * T.eb + e);
      }
    }
  }

  // Implicit advection of this thread's particles; vel_in is the solve's x.
  __device__ void advect() {
    const float g[3] = {a.g0, a.g1, a.g2};
    for (int p = first; p < a.n; p += stride) {
      float pos[D], vel[D], velg[D], vv[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        pos[c] = a.pos[D * p + c];
        velg[c] = __fmul_rn(__fadd_rn(a.velg[D * p + c], __fmul_rn(g[c], a.dt)),
                            a.decay);
        vel[c] = __fmul_rn(v.x[D * p + c], a.decay);
        vv[c] = __fadd_rn(vel[c], velg[c]);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        if (pos[c] < 0.0f && vv[c] < 0.0f) vel[c] = velg[c] = vv[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        // The reference does not zero vel_g at the upper wall.
        if (pos[c] > 1.0f && vv[c] > 0.0f) vel[c] = vv[c] = 0.0f;
      }
      for (int o = 0; o < a.n_obst; ++o) {
        const float radius = a.radii[o];
        float disp[D], away[D];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          disp[c] = __fsub_rn(pos[c], a.centers[D * o + c]);
          away[c] = -disp[c];
        }
        const float dist_sq = dot_rn(disp, disp);
        const float toward = dot_rn(vv, away);
        if (dist_sq < radius * radius && toward > 0.0f && radius > 0.0f) {
          const float denom = fmaxf(dist_sq, 1e-30f);
          float* chans[3] = {vv, vel, velg};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float* u = chans[k];
            const float s = __fdiv_rn(dot_rn(u, disp), denom);
#pragma unroll
            for (int c = 0; c < D; ++c) u[c] = __fsub_rn(u[c], __fmul_rn(s, disp[c]));
          }
        }
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        a.pos[D * p + c] = __fadd_rn(pos[c], __fmul_rn(vv[c], a.dt));
        a.vel[D * p + c] = vel[c];
        a.velg[D * p + c] = velg[c];
      }
    }
  }
};

// __grid_constant__: Frame keeps a reference to the parameter, which then
// stays in the parameter space instead of a per-thread copy.
template <int D, int M, bool INELASTIC>
__global__ void __launch_bounds__(kThreads, 1)
    blocked_frame_kernel(const __grid_constant__ FemFrameArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ float bcast;
  const int bpc = (a.T.num_blocks + gridDim.x - 1) / gridDim.x;
  float* xs = smem + D * D * bpc * a.T.eb;
  Frame<D, M, INELASTIC> fr{a, carve<D>(a), cg::this_grid(), smem, xs,
              xs + D * a.T.pb,
              red, &bcast, 0,
              static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x),
              static_cast<int>(gridDim.x * blockDim.x)};
  for (int p = fr.first; p < a.n; p += fr.stride) {
    fr.v.minv[p] = 1.0f / a.mass[p];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      a.pos[D * p + c] = a.pos_in[D * p + c];
      a.vel[D * p + c] = a.vel_in[D * p + c];
      a.velg[D * p + c] = a.velg_in[D * p + c];
    }
  }
  if constexpr (INELASTIC) fr.copy_state();
  fr.grid.sync();
  for (int s = 0; s < a.sim_count; ++s) {
    int it;
    float delta;
    fr.solve(&it, &delta);
    fr.advect();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.iters[s] = it;
      a.res[s] = delta;
    }
    fr.grid.sync();
    if constexpr (INELASTIC) fr.internal_update();
  }
}

template <int D>
int plan_instance(int material, bool inelastic, int grid, size_t smem,
                  int* max_grid_out) {
  return fem::dispatch_material<true>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return inelastic
        ? fem::cooperative_fit(blocked_frame_kernel<D, M, true>, kThreads,
                               grid, smem, max_grid_out)
        : fem::cooperative_fit(blocked_frame_kernel<D, M, false>, kThreads,
                               grid, smem, max_grid_out);
  });
}

template <int D>
int launch_instance(FemFrameArgs* a, int grid, int smem, void* stream) {
  const bool inelastic = a->in.plastic != nullptr || a->in.viscous != nullptr;
  return fem::dispatch_material<true>(a->material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return inelastic
        ? fem::cooperative_launch(blocked_frame_kernel<D, M, true>, a, grid,
                                  kThreads, smem, stream)
        : fem::cooperative_launch(blocked_frame_kernel<D, M, false>, a, grid,
                                  kThreads, smem, stream);
  });
}

size_t frame_smem(int grid, int num_blocks, int eb, int pb, int dim) {
  const int bpc = (num_blocks + grid - 1) / grid;
  return sizeof(float) *
         (static_cast<size_t>(dim) * dim * bpc * eb +
          fem::block_work_floats(eb, pb, dim));
}

}  // namespace

// Floats of scratch the launch needs for `grid` CTAs in dimension `dim`.
extern "C" long long fem_blocked_frame_scratch_floats(int n, int num_blocks,
                                                      int pb, int grid,
                                                      int dim) {
  return static_cast<long long>(n) + 6LL * dim * n +
         2LL * dim * num_blocks * pb + 2LL * grid;
}

// Checks that a cooperative grid of `grid` CTAs (0: one per locality block,
// at most one per SM) of the (`dim`, `material`, `inelastic`) instance fits
// the device; writes the grid, its dynamic shared memory and the most
// co-resident CTAs.  Returns 0, a CUDA error, or -1 (no cooperative
// launch), -2 (shared memory too large), -3 (the grid cannot be
// co-resident).
extern "C" int fem_blocked_frame_plan(int num_blocks, int eb, int pb, int grid,
                                      int dim, int material, int inelastic,
                                      int* grid_out, int* smem_out,
                                      int* max_grid_out) {
  *max_grid_out = 0;
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = fem::cooperative_grid(num_blocks, grid, grid_out);
  if (rc != 0) return rc;
  const size_t smem = frame_smem(*grid_out, num_blocks, eb, pb, dim);
  *smem_out = static_cast<int>(smem);
  return dim == 3 ? plan_instance<3>(material, inelastic != 0, *grid_out,
                                    smem, max_grid_out)
                  : plan_instance<2>(material, inelastic != 0, *grid_out,
                                    smem, max_grid_out);
}

// Launches the instance of args->material; the inelastic one when args->in
// has a state (plastic or viscous not null).
extern "C" int fem_blocked_frame(const FemFrameArgs* args, int grid, int smem,
                                 void* stream) {
  FemFrameArgs a = *args;
  if (a.T.dim == 3) return launch_instance<3>(&a, grid, smem, stream);
  if (a.T.dim == 2) return launch_instance<2>(&a, grid, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fem_blocked_frame_error(int code) {
  return fem::cooperative_error(code);
}
