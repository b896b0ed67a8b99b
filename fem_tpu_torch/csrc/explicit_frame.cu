// K8: one rendered frame of the explicit (and autodiff) path — sim_count
// substeps, each the energy gradient over the locality blocks and the
// kinematic step — in one cooperative launch.
//
// Replaces the TPU kernel fem_tpu/ops/pallas_blocked_frame.py:
// _explicit_frame_kernel (reached through fused_explicit_frame), every
// material (the shared chain fem::material_grad_cols), with the plastic and
// Maxwell branches.  The TPU kernel runs on one core over VMEM-resident
// one-hot tables (s_dense, g_dense, the pj selections) with 3-plane bf16
// dots and (8, 128)-padded planes; none of that is semantics and none is
// carried over: this kernel indexes the block tables directly and computes
// in plain f32.  Like the TPU kernel it runs the analytic gradient chain for
// autodiff configs too: autograd of the energy computes the same formula up
// to the order of its sums.
//
// Semantics, unchanged (fused_explicit_frame's contract):
//   per substep: grad = sum over tets of the +V g columns (the shared chain
//   fem::material_grad_cols, element_chain.cuh: for Neo-Hookean the
//   unclamped log), column j to local
//   vertex j+1 and minus their sum to vertex 0; then per particle
//   vel += (9.8 g_dir - grad m^-1) dt, vel *= exp(-dt damping), a component
//   pushing through a unit-box wall (tested on the old position, lower wall
//   then upper) is zeroed, circles project in obstacle order on the old
//   position (radius 0 never hits), pos += vel dt.
//
// The kernel is templated on the dimension D in {2, 3}, as the Pallas
// kernel takes `dim`, and on the material M (fem::Material), as it takes
// `material`: a compile-time instance, so the Neo-Hookean instance carries
// no other material's code.  fem_explicit_frame launches the instance of
// (args->T.dim, args->material); a library built with -DFEM_MATERIAL holds
// one material's four instances.  The 2D default scene (configs/default.json) is the first
// shipped scene whose circles are hit on the card: two circles of radius
// 0.21 that the body squeezes between, projected in obstacle order.
//
// Design.  K5's skeleton (blocked_frame.cu): one thread block per locality
// block (17 on the 3D flagship, 1 on the 2D default scene; grid-stride when
// a mesh has more blocks than the grid), a cooperative launch so that the
// grid is co-resident or the launch fails, and data written by another CTA
// read past L1 (__ldcg).
// Each substep has two phases separated by grid barriers:
//   1. gradient partials: each CTA loads its blocks' positions into shared
//      memory, runs one thread per real tet (padded slots are skipped, so
//      the unclamped log of their X = 0 never runs), and writes the
//      per-slot partials through the block's local plan;
//   2. assembly and kinematics: each thread owns particles, sums their slot
//      partials through the slot plan in a fixed order and advances them.
// Phase 1 of substep s+1 reads positions that phase 2 of substep s wrote in
// other CTAs, and phase 2 reads partials of phase 1 in other CTAs: a
// barrier sits between each pair, 2 sim_count - 1 a frame.  No float
// atomics, so two runs are bit-identical.
//
// Inelastic materials (the INELASTIC instance; inelastic.cuh): phase 1
// runs the base chain on each element's R^-1 F_p^-1 and adds the Maxwell
// branch's stable Neo-Hookean g (lam = 0, mu_v, on R^-1 F_v^-1) before the
// +V scaling, as the TPU kernel does (pallas_blocked_frame.py:646-688); a
// third phase per substep updates the state from the end-of-substep
// positions (:702-765).  Those positions come from other CTAs' phase 2, so
// a grid barrier precedes it — also after the last substep: 2 sim_count
// barriers a frame.  Each CTA reads and writes only its own blocks' state,
// so the next substep's phase 1 needs no barrier for it.  The state stays
// in the output arrays, in mesh element order, reached through
// element_perm; the frame's first step copies the inputs there.  The
// elastic instance is the code it was: the branches are chosen at launch.  The kinematic step uses
// round-to-nearest intrinsics in the plain version's order (no fused
// multiply-adds), so it rounds as the plain version does.
//
// Bound on the H100: operations — a flagship frame is 10 x (~200 f32
// operations a tet x 4,068 tets + the slot sums + the kinematics), about
// 11 MFLOP, 0.16 us at 67 TFLOP/s f32; its bytes take less.  What sets the
// time is the chain of grid barriers and the per-block work done by one SM
// each.  A first kernel that is right; more SMs per block is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "blocked_common.cuh"
#include "cooperative.cuh"
#include "inelastic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

}  // namespace

// The Python side mirrors this layout (ops/frame_kernels.py:
// ExplicitFrameArgsC).
struct FemExplicitFrameArgs {
  fem::BlockTables T;    // T.dim is D
  const int* slot_ptr;   // (N+1,) slot plan
  const int* slot_rows;  // flat block slots b*Pb+p
  const float* pos_in;   // (N, D)
  const float* vel_in;
  const float* mass;     // (N,)
  const float* centers;  // (O, D)
  const float* radii;    // (O,)
  int n;
  int n_obst;
  int sim_count;
  int material;     // fem::Material: the instance the launch runs
  float dt;
  float decay;
  float g0, g1, g2;  // 9.8 g_dir (g2 unused in 2D)
  fem::MaterialParams mat;  // the material's numbers
  float* pos;       // (N, D) outputs, the state through the frame
  float* vel;
  float* partials;  // (B*Pb, D) scratch
  fem::InelasticArgs in;
};

namespace {

// The contribution rows t of real element e of block b with the material
// layers: the base material's chain on R^-1 F_p^-1, plus the Maxwell
// branch's.
template <int D, int M>
__device__ __forceinline__ void element_grad_layers(
    const FemExplicitFrameArgs& a, int b, int e, const float* xs, float* t) {
  constexpr int DD = D * D;
  const fem::BlockTables& T = a.T;
  const int slot = b * T.eb + e;
  float x[DD], r[DD], r_base[DD], r_branch[DD], g[DD];
  fem::block_edges<D>(T, b, e, xs, x);
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = T.ref_inv[DD * slot + i];
  fem::layer_refs<D>(a.in, slot, r, r_base, r_branch);
  fem::material_grad_cols<D, M>(x, r_base, a.mat, g);
  if (a.in.viscous != nullptr) {
    float g2[DD];
    fem::material_grad_cols<D, fem::kStableNeoHookean>(
        x, r_branch, fem::branch_params(a.in.viscous_mu), g2);
#pragma unroll
    for (int i = 0; i < DD; ++i) g[i] = g[i] + g2[i];
  }
  fem::column_rows<D>(T.volume[slot], g, t);
}

// Phase 1: the per-slot gradient partials of every owned block at `src`.
template <int D, int M, bool INELASTIC>
__device__ void gradient_partials(const FemExplicitFrameArgs& a,
                                  const float* src, float* xs, float* t) {
  const fem::BlockTables& T = a.T;
  for (int b = blockIdx.x; b < T.num_blocks; b += gridDim.x) {
    fem::load_block_rows<D>(T, b, src, xs);
    __syncthreads();
    const int nel = T.block_elements[b];
    for (int e = threadIdx.x; e < nel; e += blockDim.x) {
      if constexpr (INELASTIC) {
        element_grad_layers<D, M>(a, b, e, xs, t + fem::rows_floats(D) * e);
      } else {
        fem::element_grad<D, M>(T, b, e, xs, a.mat,
                                t + fem::rows_floats(D) * e);
      }
    }
    __syncthreads();
    fem::block_slot_sums<D>(T, b, t, a.partials + D * b * T.pb);
    __syncthreads();
  }
}

// Sum_c u[c] w[c] in the plain version's order, round-to-nearest.
template <int D>
__device__ __forceinline__ float dot_rn(const float* u, const float* w) {
  float s = __fmul_rn(u[0], w[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(u[c], w[c]));
  return s;
}

// Phase 3 (INELASTIC): the internal update of every owned block's real
// elements from the end-of-substep positions a.pos.
template <int D>
__device__ void internal_update(const FemExplicitFrameArgs& a, float* xs) {
  constexpr int DD = D * D;
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

// The frame's first step (INELASTIC): the state of every owned block's
// real elements from the inputs into the outputs.
template <int D>
__device__ void copy_state(const FemExplicitFrameArgs& a) {
  const fem::BlockTables& T = a.T;
  for (int b = blockIdx.x; b < T.num_blocks; b += gridDim.x) {
    const int nel = T.block_elements[b];
    for (int e = threadIdx.x; e < nel; e += blockDim.x) {
      fem::copy_state<D>(a.in, b * T.eb + e);
    }
  }
}

// Phase 2: the kinematic step of particle p from state (pos_src, vel_src).
template <int D>
__device__ void kinematic(const FemExplicitFrameArgs& a, int p,
                          const float* pos_src, const float* vel_src) {
  const float g[3] = {a.g0, a.g1, a.g2};
  float grad[D];
  fem::particle_slot_sum<D>(a.slot_ptr, a.slot_rows, a.partials, p, grad);
  const float minv = __fdiv_rn(1.0f, a.mass[p]);
  float pos[D], vel[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    pos[c] = pos_src[D * p + c];
    const float acc = __fsub_rn(g[c], __fmul_rn(grad[c], minv));
    vel[c] = __fmul_rn(__fadd_rn(vel_src[D * p + c], __fmul_rn(acc, a.dt)),
                       a.decay);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    if ((pos[c] < 0.0f && vel[c] < 0.0f) || (pos[c] > 1.0f && vel[c] > 0.0f)) {
      vel[c] = 0.0f;
    }
  }
  for (int o = 0; o < a.n_obst; ++o) {
    const float radius = a.radii[o];
    float disp[D], away[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      disp[c] = __fsub_rn(pos[c], a.centers[D * o + c]);
      away[c] = -disp[c];
    }
    const float dist_sq = dot_rn<D>(disp, disp);
    const float toward = dot_rn<D>(vel, away);
    if (dist_sq < __fmul_rn(radius, radius) && toward > 0.0f && radius > 0.0f) {
      const float coeff = __fdiv_rn(dot_rn<D>(vel, disp), fmaxf(dist_sq, 1e-30f));
#pragma unroll
      for (int c = 0; c < D; ++c) vel[c] = __fsub_rn(vel[c], __fmul_rn(coeff, disp[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    a.pos[D * p + c] = __fadd_rn(pos[c], __fmul_rn(vel[c], a.dt));
    a.vel[D * p + c] = vel[c];
  }
}

// __grid_constant__: the parameter stays in the parameter space instead of
// a per-thread copy.
template <int D, int M, bool INELASTIC>
__global__ void __launch_bounds__(kThreads, 1)
    explicit_frame_kernel(const __grid_constant__ FemExplicitFrameArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + D * a.T.pb;
  cg::grid_group grid = cg::this_grid();
  const int first = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const int stride = static_cast<int>(gridDim.x * blockDim.x);
  // The same thread copies, reads and updates an element's state.
  if constexpr (INELASTIC) copy_state<D>(a);
  for (int s = 0; s < a.sim_count; ++s) {
    // Substep 0 reads the inputs; later ones the state in the outputs, which
    // only the owning thread rewrites in phase 2 (other CTAs' rows are read
    // past L1 in phase 1).
    const float* pos_src = s == 0 ? a.pos_in : a.pos;
    const float* vel_src = s == 0 ? a.vel_in : a.vel;
    gradient_partials<D, M, INELASTIC>(a, pos_src, xs, t);
    grid.sync();
    for (int p = first; p < a.n; p += stride) kinematic<D>(a, p, pos_src, vel_src);
    if constexpr (INELASTIC) {
      grid.sync();
      internal_update<D>(a, xs);
    } else {
      if (s + 1 < a.sim_count) grid.sync();
    }
  }
}

template <int D>
int plan_instance(int material, bool inelastic, int grid, size_t smem,
                  int* max_grid_out) {
  return fem::dispatch_material<false>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return inelastic
        ? fem::cooperative_fit(explicit_frame_kernel<D, M, true>, kThreads,
                               grid, smem, max_grid_out)
        : fem::cooperative_fit(explicit_frame_kernel<D, M, false>, kThreads,
                               grid, smem, max_grid_out);
  });
}

template <int D>
int launch_instance(FemExplicitFrameArgs* a, int grid, int smem,
                    void* stream) {
  const bool inelastic = a->in.plastic != nullptr || a->in.viscous != nullptr;
  return fem::dispatch_material<false>(a->material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return inelastic
        ? fem::cooperative_launch(explicit_frame_kernel<D, M, true>, a, grid,
                                  kThreads, smem, stream)
        : fem::cooperative_launch(explicit_frame_kernel<D, M, false>, a, grid,
                                  kThreads, smem, stream);
  });
}

}  // namespace

// Checks that a cooperative grid of `grid` CTAs (0: one per locality block,
// at most one per SM) of the (`dim`, `material`) instance, elastic or
// inelastic, fits the device; writes the grid, its dynamic shared memory
// and the most co-resident CTAs.  Returns 0, a CUDA error, or -1 (no
// cooperative launch), -2 (shared memory too large), -3 (the grid cannot be
// co-resident).
extern "C" int fem_explicit_frame_plan(int num_blocks, int eb, int pb, int grid,
                                       int dim, int material, int inelastic,
                                       int* grid_out, int* smem_out,
                                       int* max_grid_out) {
  *max_grid_out = 0;
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = fem::cooperative_grid(num_blocks, grid, grid_out);
  if (rc != 0) return rc;
  const size_t smem = sizeof(float) * fem::block_work_floats(eb, pb, dim);
  *smem_out = static_cast<int>(smem);
  return dim == 3 ? plan_instance<3>(material, inelastic != 0, *grid_out,
                                    smem, max_grid_out)
                  : plan_instance<2>(material, inelastic != 0, *grid_out,
                                    smem, max_grid_out);
}

// Launches the instance of args->material; the inelastic one when args->in
// has a state (plastic or viscous not null).
extern "C" int fem_explicit_frame(const FemExplicitFrameArgs* args, int grid,
                                  int smem, void* stream) {
  FemExplicitFrameArgs a = *args;
  if (a.sim_count <= 0 || a.n <= 0) return 0;
  if (a.T.dim == 3) return launch_instance<3>(&a, grid, smem, stream);
  if (a.T.dim == 2) return launch_instance<2>(&a, grid, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fem_explicit_frame_error(int code) {
  return fem::cooperative_error(code);
}
