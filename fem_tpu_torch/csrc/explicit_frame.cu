// K8: one rendered frame of the explicit (and autodiff) path — sim_count
// substeps, each the energy gradient over the locality blocks and the
// kinematic step — in one launch: one thread-block cluster, or a
// cooperative grid for meshes too large for one cluster (see Design).
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
// The gradient of a particle is summed in two fixed orders: each block's
// rows landing on a block slot through the block's local plan, then the
// particle's block slots in the slot plan's order.  Both variants sum so,
// and the kinematic step uses round-to-nearest intrinsics in the plain
// version's order (no fused multiply-adds), so it rounds as the plain
// version does.
//
// The kernel is templated on the dimension D in {2, 3}, as the Pallas
// kernel takes `dim`, and on the material M (fem::Material), as it takes
// `material`: a compile-time instance, so the Neo-Hookean instance carries
// no other material's code.  The entries launch the instance of
// (args->T.dim, args->material); a library built with -DFEM_MATERIAL holds
// one material's instances.  The 2D default scene (configs/default.json)
// is the first shipped scene whose circles are hit on the card: two
// circles of radius 0.21 that the body squeezes between, projected in
// obstacle order.
//
// Inelastic materials (the INELASTIC instance; inelastic.cuh): the
// gradient runs the base chain on each element's R^-1 F_p^-1 and adds the
// Maxwell branch's stable Neo-Hookean g (lam = 0, mu_v, on R^-1 F_v^-1)
// before the +V scaling, as the TPU kernel does
// (pallas_blocked_frame.py:646-688); after each substep's kinematic step
// the state of every element is updated from the end-of-substep positions
// (:702-765).  The state enters and leaves in mesh element order, reached
// through element_perm.  The elastic instance carries none of it: the
// branches are chosen at launch.
//
// Design: two variants of one frame, chosen by size before the launch
// (ops/frame_kernels.py: explicit_frame_plan), never one in place of the
// other after a failure.
//
// The cluster variant (cluster_explicit_frame_kernel), for every frame
// whose state fits the shared memory of one thread-block cluster (<= 16
// CTAs on the H100; the 3D flagship's 17 blocks, the 2D scenes' 1 and
// 16): the whole grid is one cluster.  CTA `rank` owns the locality
// blocks b = rank (mod C), one or two thread groups of 256 threads each
// working on one block at a time (K5's ownership, frame_kernels.
// cluster_assignment), and keeps in its shared memory their tables,
// rest-edge inverses and volumes (and, inelastic, their elements' F_p^-1
// and F_v^-1, loaded once a frame and written back once), and a copy of the
// position of every particle its blocks touch; each particle is owned by
// one CTA, which also keeps its velocity and 1/m.  A substep, following
// K11b's lesson (store into the reader, never read remote):
//   1. every CTA computes its real elements' gradient rows and each block
//      slot's sum through the block's local plan, and stores that sum into
//      a receive slot of the CTA that owns the slot's particle (a store to
//      distributed shared memory; a particle's receive slots lie in the
//      slot plan's order); cluster barrier;
//   2. every owner sums its particles' receive slots in that order, runs
//      the kinematic step, and stores the new position into every CTA that
//      holds the particle (velocities are read by the owner only); cluster
//      barrier — left out after the last substep of an elastic frame, where
//      no CTA reads the positions again;
//   3. inelastic only: every CTA updates its own elements' state from its
//      now-local end-of-substep positions; no barrier.
// So 2 barriers a substep, one fewer in an elastic frame, and one after
// the copy-in (so that no CTA stores into one that has not started): 2 S
// elastic, 2 S + 1 inelastic.  After the last barrier no CTA touches
// another's shared memory, so none needs another before it leaves.  A
// cluster of one CTA (one locality block) syncs with __syncthreads().
// The arithmetic is the grid variant's, in the same order.
//
// The grid variant (explicit_frame_kernel), for meshes whose state does not
// fit one cluster (e.g. 270 blocks): one 256-thread CTA per locality block
// (grid-stride when a mesh has more blocks than the grid), a cooperative
// launch so that the grid is co-resident or the launch fails, and data
// written by another CTA read past L1 (__ldcg).  Each substep: the per-slot
// partials to device memory; a grid barrier; each thread owns particles,
// sums their slot partials through the slot plan and advances them; the
// inelastic update after one more grid barrier.  2 S - 1 grid barriers a
// frame elastic, 2 S inelastic.
//
// Both variants count the barriers they meet and report them
// (args.barriers; frame_kernels.explicit_frame_barriers gives the count).
// No float atomics, so two runs are bit-identical.
//
// Bound on the H100: operations — a flagship frame is 10 x (~200 f32
// operations a tet x 4,068 tets + the slot sums + the kinematics), about
// 11 MFLOP, 0.16 us at 67 TFLOP/s f32; its bytes take less.  What sets the
// time is the chain of barrier-separated phases and the per-block work
// done by one SM each: the grid variant's phase is a software grid barrier
// plus dependent L2 round trips, the cluster variant's a hardware cluster
// barrier with every operand in shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "blocked_common.cuh"
#include "cluster.cuh"
#include "cluster_slots.cuh"
#include "cooperative.cuh"
#include "inelastic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// The cluster variant: a CTA is 1 or 2 groups of kThreads, each group
// working on one of the CTA's locality blocks at a time.
constexpr int kMaxGroups = 2;
constexpr int kClusterThreads = kMaxGroups * kThreads;

// Floats of a receive slot and of a position row of the cluster variant:
// D padded to a whole vector (16 bytes in 3D, 8 in 2D), so that a row
// stored into another CTA's shared memory is one transaction.
__host__ __device__ constexpr int row_stride(int dim) {
  return dim == 3 ? 4 : 2;
}

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
  float* partials;  // (B*Pb, D) scratch of the grid variant
  fem::InelasticArgs in;
  // The cluster variant's plan (ops/frame_kernels.py: explicit_assignment);
  // the grid variant reads none of it.
  const int* cl_local_ptr;    // (C+1,) each rank's span of cl_local_ids
  const int* cl_local_ids;    // particle id of each local particle, a
                              // rank's owned ones first
  const int* cl_owned_ptr;    // (C+1,) each rank's span of owned particles
                              // (its first local ones), flat over the ranks
  const int* cl_block_local;  // (B*Pb,) local index, in its block's rank,
                              // of each block slot's particle (0: padding)
  const int* cl_slot_dest;    // (B*Pb,) where each block slot's sum goes:
                              // owner rank * 65536 + receive slot (-1:
                              // padding)
  const int* cl_recv_ptr;     // (owned + 1,) each owned particle's span of
                              // its rank's receive slots, slot plan order
  const int* cl_push_ptr;     // (owned + 1,) each owned particle's span of
                              // cl_push_codes
  const int* cl_push_codes;   // the other ranks holding it, as rank * 65536
                              // + its local index there
  int cl_cap;       // most local particles of a rank
  int cl_entries;   // most receive slots of a rank
  int cl_pushes;    // most push codes of a rank's owned particles
  int* barriers;    // (1,) or null: the barriers the launch met, written by
                    // thread 0 of CTA 0
};

namespace {

// The contribution rows t of a real element with edge matrix x, static
// rest-edge inverse r and volume vol: material M's +V g columns, with the
// material layers (fp / fv: the element's F_p^-1 / F_v^-1, or null) the
// base chain on R^-1 F_p^-1 plus the Maxwell branch's on R^-1 F_v^-1.
template <int D, int M>
__device__ __forceinline__ void grad_rows(const FemExplicitFrameArgs& a,
                                          const float* x, const float* r,
                                          float vol, const float* fp,
                                          const float* fv, float* t) {
  constexpr int DD = D * D;
  float r_base[DD], r_branch[DD], g[DD];
  if (fp != nullptr) {
    fem::mul<D>(r, fp, r_base);
  } else {
#pragma unroll
    for (int c = 0; c < DD; ++c) r_base[c] = r[c];
  }
  fem::material_grad_cols<D, M>(x, r_base, a.mat, g);
  if (fv != nullptr) {
    float g2[DD];
    fem::mul<D>(r, fv, r_branch);
    fem::material_grad_cols<D, fem::kStableNeoHookean>(
        x, r_branch, fem::branch_params(a.in.viscous_mu), g2);
#pragma unroll
    for (int i = 0; i < DD; ++i) g[i] = g[i] + g2[i];
  }
  fem::column_rows<D>(vol, g, t);
}

// The contribution rows t of real element e of block b (rows in xs), with
// the material layers read from the outputs' state through element_perm.
template <int D, int M>
__device__ __forceinline__ void element_grad_layers(
    const FemExplicitFrameArgs& a, int b, int e, const float* xs, float* t) {
  constexpr int DD = D * D;
  const fem::BlockTables& T = a.T;
  const int slot = b * T.eb + e;
  const size_t m = static_cast<size_t>(a.in.element_perm[slot]) * DD;
  float x[DD], r[DD];
  fem::block_edges<D>(T, b, e, xs, x);
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = T.ref_inv[DD * slot + i];
  grad_rows<D, M>(a, x, r, T.volume[slot],
                  a.in.plastic != nullptr ? a.in.plastic + m : nullptr,
                  a.in.viscous != nullptr ? a.in.viscous + m : nullptr, t);
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

// The kinematic step of one particle: its gradient `grad`, 1/m `minv`, and
// its state (pos, vel), advanced in place (pos to the end of the substep).
template <int D>
__device__ __forceinline__ void kinematic_step(const FemExplicitFrameArgs& a,
                                               const float* grad, float minv,
                                               float* pos, float* vel) {
  const float g[3] = {a.g0, a.g1, a.g2};
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float acc = __fsub_rn(g[c], __fmul_rn(grad[c], minv));
    vel[c] = __fmul_rn(__fadd_rn(vel[c], __fmul_rn(acc, a.dt)), a.decay);
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
  for (int c = 0; c < D; ++c) pos[c] = __fadd_rn(pos[c], __fmul_rn(vel[c], a.dt));
}

// Phase 2: the kinematic step of particle p from state (pos_src, vel_src).
template <int D>
__device__ void kinematic(const FemExplicitFrameArgs& a, int p,
                          const float* pos_src, const float* vel_src) {
  float grad[D];
  fem::particle_slot_sum<D>(a.slot_ptr, a.slot_rows, a.partials, p, grad);
  float pos[D], vel[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    pos[c] = pos_src[D * p + c];
    vel[c] = vel_src[D * p + c];
  }
  kinematic_step<D>(a, grad, __fdiv_rn(1.0f, a.mass[p]), pos, vel);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    a.pos[D * p + c] = pos[c];
    a.vel[D * p + c] = vel[c];
  }
}

// The grid variant.  __grid_constant__: the parameter stays in the
// parameter space instead of a per-thread copy.
template <int D, int M, bool INELASTIC>
__global__ void __launch_bounds__(kThreads, 1)
    explicit_frame_kernel(const __grid_constant__ FemExplicitFrameArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + D * a.T.pb;
  cg::grid_group grid = cg::this_grid();
  int barriers = 0;
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
    ++barriers;
    grid.sync();
    for (int p = first; p < a.n; p += stride) kinematic<D>(a, p, pos_src, vel_src);
    if constexpr (INELASTIC) {
      ++barriers;
      grid.sync();
      internal_update<D>(a, xs);
    } else {
      if (s + 1 < a.sim_count) {
        ++barriers;
        grid.sync();
      }
    }
  }
  if (a.barriers != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *a.barriers = barriers;
  }
}

// Ints of one owned block's tables staged in the cluster variant's shared
// memory: plus and minus (Eb*D each), the local plan's rows (Eb*(D+1)) and
// offsets (Pb+1), the local index of each slot's particle (Pb) and each
// slot's destination (Pb).
__host__ __device__ inline size_t block_table_ints(int eb, int pb, int dim) {
  return static_cast<size_t>(3 * dim + 1) * eb + 3 * static_cast<size_t>(pb) +
         1;
}

// 4-byte words of the cluster variant's dynamic shared memory: the CTA's
// receive slots (`entries` rows of row_stride floats), the local positions
// (cap rows of row_stride floats), one block's working set (xs, t) for each
// of `groups` thread groups, the owned blocks' rest-edge inverses and
// volumes (bpc blocks of Eb elements), their elements' state (`states`
// D x D matrices an element: 0, 1 or 2), the owned particles' velocities
// (cap rows of D) and 1/m (cap), then the owned blocks' tables, the local
// particles' ids, the owned particles' spans of receive slots and of push
// codes (cap + 1 each) and the push codes.
inline size_t cluster_smem_words(int num_blocks, int eb, int pb, int cap,
                                 int entries, int pushes, int cluster,
                                 int dim, int groups, int states) {
  const size_t bpc = (num_blocks + cluster - 1) / cluster;
  const size_t dd = static_cast<size_t>(dim) * dim;
  const size_t rs = row_stride(dim);
  return rs * entries + rs * cap + groups * fem::block_work_floats(eb, pb, dim) +
         bpc * eb * (dd + 1) + states * bpc * eb * dd +
         static_cast<size_t>(cap) * (dim + 1) +
         bpc * block_table_ints(eb, pb, dim) + static_cast<size_t>(cap) +
         2 * (static_cast<size_t>(cap) + 1) + pushes;
}

template <int D, int M, bool INELASTIC>
struct ClusterExplicit {
  static constexpr int DD = D * D;
  static constexpr int R = fem::rows_floats(D);
  static constexpr int RS = row_stride(D);
  using Row = typename std::conditional<D == 3, float4, float2>::type;

  const FemExplicitFrameArgs& a;
  cg::cluster_group cl;
  int me;        // this CTA's rank
  int nr;        // CTAs in the cluster
  int bpc;       // most blocks of a rank
  int nl;        // local particles
  int no;        // of which the first `no` are owned
  int rounds;    // block rounds of a pass over the owned blocks
  int groups;    // thread groups, each on one block in a round
  int grp;       // this thread's group
  int gtid;      // this thread's index in its group
  float* recv;   // the receive slots of the owned particles, (entries, RS)
  float* pos;    // local positions, (cap, RS)
  float* xs;     // this group's block's particle rows
  float* t;      // this group's block's contribution rows
  float* rinv;   // the owned blocks' rest-edge inverses, (bpc * Eb, D, D)
  float* vol;    // their volumes, (bpc * Eb,)
  float* fp;     // their elements' F_p^-1 and F_v^-1 (INELASTIC, when on)
  float* fv;
  float* vel;    // owned velocities, (cap, D)
  float* minv;   // owned 1/m, (cap,)
  int* tabs;     // the owned blocks' tables, block_table_ints each
  int* ids;      // the local particles' ids
  int* sptr;     // (no+1,) each owned particle's span of receive slots
  int* pptr;     // (no+1,) each owned particle's span of pcodes
  int* pcodes;   // the other holders of it: rank * 65536 + local index there
  int barriers;  // barriers met so far

  // The barrier between phases, counted: the hardware cluster barrier, or
  // the CTA barrier when the cluster is one CTA.  It orders every store to
  // another CTA before the reads behind it (release / acquire).
  __device__ void sync() {
    ++barriers;
    if (nr == 1) {
      __syncthreads();
    } else {
      cl.sync();
    }
  }

  // CTA `rank`'s copy of this CTA's shared address `p`.
  template <typename T>
  __device__ T* at(T* p, int rank) {
    return rank == me ? p : cl.map_shared_rank(p, rank);
  }

  __device__ const int* table(int ib) const {
    return tabs + ib * block_table_ints(a.T.eb, a.T.pb, D);
  }

  // The block tables of owned block b (the ib-th), read from their copy in
  // shared memory: pointers shifted so that the global block index b
  // addresses the copy.
  __device__ fem::BlockTables view(int b, int ib) const {
    const fem::BlockTables& T = a.T;
    fem::BlockTables v = T;
    const int* base = table(ib);
    const ptrdiff_t shift = static_cast<ptrdiff_t>(b) * T.eb * D;
    v.plus = base - shift;
    v.minus = base + T.eb * D - shift;
    v.local_rows = base + 2 * T.eb * D -
                   static_cast<ptrdiff_t>(b) * T.eb * (D + 1);
    v.local_ptr = base + (3 * D + 1) * T.eb -
                  static_cast<ptrdiff_t>(b) * (T.pb + 1);
    const ptrdiff_t eshift = static_cast<ptrdiff_t>(ib - b) * T.eb;
    v.ref_inv = rinv + DD * eshift;
    v.volume = vol + eshift;
    return v;
  }

  // The local index of each slot's particle of the ib-th owned block.
  __device__ const int* block_local(int ib) const {
    return table(ib) + (3 * D + 1) * a.T.eb + a.T.pb + 1;
  }

  // Where each slot's sum of the ib-th owned block goes.
  __device__ const int* slot_dest(int ib) const {
    return block_local(ib) + a.T.pb;
  }

  // Copies the owned blocks' tables, rest-edge inverses, volumes and state
  // and the local particles' ids, spans and push codes into shared memory
  // (the caller's barrier publishes them).
  __device__ void stage(int first, int first_owned) {
    const fem::BlockTables& T = a.T;
    const int words = static_cast<int>(block_table_ints(T.eb, T.pb, D));
    const int rd = T.eb * D;
    const int rr = T.eb * (D + 1);
    for (int b = me, ib = 0; b < T.num_blocks; b += nr, ++ib) {
      int* dst = tabs + ib * words;
      for (int i = threadIdx.x; i < words; i += blockDim.x) {
        int v;
        if (i < rd) {
          v = T.plus[b * rd + i];
        } else if (i < 2 * rd) {
          v = T.minus[b * rd + i - rd];
        } else if (i < 2 * rd + rr) {
          v = T.local_rows[b * rr + i - 2 * rd];
        } else if (i < 2 * rd + rr + T.pb + 1) {
          v = T.local_ptr[b * (T.pb + 1) + i - 2 * rd - rr];
        } else if (i < 2 * rd + rr + 2 * T.pb + 1) {
          v = a.cl_block_local[b * T.pb + i - 2 * rd - rr - T.pb - 1];
        } else {
          v = a.cl_slot_dest[b * T.pb + i - 2 * rd - rr - 2 * T.pb - 1];
        }
        dst[i] = v;
      }
      for (int i = threadIdx.x; i < DD * T.eb; i += blockDim.x) {
        rinv[DD * ib * T.eb + i] = T.ref_inv[DD * b * T.eb + i];
      }
      for (int e = threadIdx.x; e < T.eb; e += blockDim.x) {
        vol[ib * T.eb + e] = T.volume[b * T.eb + e];
      }
      if constexpr (INELASTIC) {
        const int nel = T.block_elements[b];
        for (int i = threadIdx.x; i < DD * nel; i += blockDim.x) {
          const int e = i / DD;
          const size_t m =
              static_cast<size_t>(a.in.element_perm[b * T.eb + e]) * DD +
              (i - DD * e);
          if (fp != nullptr) fp[DD * ib * T.eb + i] = a.in.plastic_in[m];
          if (fv != nullptr) fv[DD * ib * T.eb + i] = a.in.viscous_in[m];
        }
      }
    }
    const int rbase = a.cl_recv_ptr[first_owned];
    const int pbase = a.cl_push_ptr[first_owned];
    for (int l = threadIdx.x; l <= no; l += blockDim.x) {
      sptr[l] = a.cl_recv_ptr[first_owned + l] - rbase;
      pptr[l] = a.cl_push_ptr[first_owned + l] - pbase;
    }
    const int pushes = a.cl_push_ptr[first_owned + no] - pbase;
    for (int i = threadIdx.x; i < pushes; i += blockDim.x) {
      pcodes[i] = a.cl_push_codes[pbase + i];
    }
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
      const int g = a.cl_local_ids[first + l];
      ids[l] = g;
#pragma unroll
      for (int c = 0; c < D; ++c) pos[RS * l + c] = a.pos_in[D * g + c];
      if (l < no) {
        minv[l] = __fdiv_rn(1.0f, a.mass[g]);
#pragma unroll
        for (int c = 0; c < D; ++c) vel[D * l + c] = a.vel_in[D * g + c];
      }
    }
  }

  // One pass over the owned blocks, `groups` at a time: for each, the
  // group's local positions into xs, then elem(Tb, b, ib, e) for its real
  // elements (Tb: its staged tables), then after(Tb, b, ib).  Every thread
  // meets every CTA barrier.
  template <typename Elem, typename After>
  __device__ void blocks_pass(Elem elem, After after) {
    const fem::BlockTables& T = a.T;
    for (int round = 0; round < rounds; ++round) {
      const int ib = round * groups + grp;
      const int b = me + ib * nr;
      const bool on = b < T.num_blocks;
      const fem::BlockTables Tb = view(on ? b : me, ib);
      __syncthreads();  // positions complete; xs and t free
      if (on) {
        const int* loc = block_local(ib);
        for (int i = gtid; i < D * T.pb; i += kThreads) {
          const int p = i / D;
          xs[i] = pos[RS * loc[p] + (i - D * p)];
        }
      }
      __syncthreads();
      if (on) {
        const int nel = T.block_elements[b];
        for (int e = gtid; e < nel; e += kThreads) elem(Tb, b, ib, e);
      }
      __syncthreads();
      if (on) after(Tb, b, ib);
    }
  }

  // Phase 1: every owned block's gradient rows, each slot's sum through
  // the block's local plan stored into its receive slot in the CTA that
  // owns its particle (cluster_slots.cuh: store_slot_sum, shared with K3).
  __device__ void gradient() {
    blocks_pass(
        [&](const fem::BlockTables& Tb, int b, int ib, int e) {
          if constexpr (INELASTIC) {
            float x[DD], r[DD];
            fem::block_edges<D>(Tb, b, e, xs, x);
            const int slot = b * Tb.eb + e;
#pragma unroll
            for (int i = 0; i < DD; ++i) r[i] = Tb.ref_inv[DD * slot + i];
            const size_t k = static_cast<size_t>(DD) * (ib * Tb.eb + e);
            grad_rows<D, M>(a, x, r, Tb.volume[slot],
                            fp != nullptr ? fp + k : nullptr,
                            fv != nullptr ? fv + k : nullptr, t + R * e);
          } else {
            fem::element_grad<D, M>(Tb, b, e, xs, a.mat, t + R * e);
          }
        },
        [&](const fem::BlockTables& Tb, int b, int ib) {
          const int* ptr = Tb.local_ptr + b * (Tb.pb + 1);
          const int* rows = Tb.local_rows + b * Tb.eb * (D + 1);
          const int* dest = slot_dest(ib);
          for (int p = gtid; p < Tb.pb; p += kThreads) {
            const int to = dest[p];
            if (to < 0) continue;
            fem::store_slot_sum<D>(ptr, rows, t, p,
                                   at(recv + RS * (to & 0xffff), to >> 16));
          }
        });
  }

  // Phase 2: every owned particle's gradient, the sum of its receive slots
  // in the slot plan's order (cluster_slots.cuh: receive_sum), and its
  // kinematic step; with `push` its new position is stored into every other
  // CTA that holds it.
  __device__ void advance(bool push) {
    for (int l = threadIdx.x; l < no; l += blockDim.x) {
      float grad[D];
      fem::receive_sum<D>(recv, sptr[l], sptr[l + 1], grad);
      float p[D], u[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        p[c] = pos[RS * l + c];
        u[c] = vel[D * l + c];
      }
      kinematic_step<D>(a, grad, minv[l], p, u);
      Row row;
      row.x = p[0];
      row.y = p[1];
      if constexpr (D == 3) {
        row.z = p[2];
        row.w = 0.0f;
      }
      *reinterpret_cast<Row*>(pos + RS * l) = row;
#pragma unroll
      for (int c = 0; c < D; ++c) vel[D * l + c] = u[c];
      if (push) {
        for (int i = pptr[l]; i < pptr[l + 1]; ++i) {
          const int code = pcodes[i];
          *reinterpret_cast<Row*>(at(pos + RS * (code & 0xffff), code >> 16)) =
              row;
        }
      }
    }
  }

  // Phase 3 (INELASTIC): every owned block's elements' state from the
  // local end-of-substep positions.
  __device__ void update() {
    blocks_pass(
        [&](const fem::BlockTables& Tb, int b, int ib, int e) {
          float x[DD], p[DD], v[DD];
          fem::block_edges<D>(Tb, b, e, xs, x);
          const size_t k = static_cast<size_t>(DD) * (ib * Tb.eb + e);
#pragma unroll
          for (int c = 0; c < DD; ++c) {
            if (fp != nullptr) p[c] = fp[k + c];
            if (fv != nullptr) v[c] = fv[k + c];
          }
          fem::internal_update<D>(x, Tb.ref_inv + DD * (b * Tb.eb + e),
                                  fp != nullptr ? p : nullptr,
                                  fv != nullptr ? v : nullptr,
                                  a.in.plastic_yield, a.in.relax);
#pragma unroll
          for (int c = 0; c < DD; ++c) {
            if (fp != nullptr) fp[k + c] = p[c];
            if (fv != nullptr) fv[k + c] = v[c];
          }
        },
        [](const fem::BlockTables&, int, int) {});
  }

  // The owned blocks' elements' state into the outputs (INELASTIC).
  __device__ void write_state() {
    const fem::BlockTables& T = a.T;
    __syncthreads();  // the last update's state is complete
    for (int b = me, ib = 0; b < T.num_blocks; b += nr, ++ib) {
      const int nel = T.block_elements[b];
      for (int i = threadIdx.x; i < DD * nel; i += blockDim.x) {
        const int e = i / DD;
        const size_t m =
            static_cast<size_t>(a.in.element_perm[b * T.eb + e]) * DD +
            (i - DD * e);
        if (fp != nullptr) a.in.plastic[m] = fp[DD * ib * T.eb + i];
        if (fv != nullptr) a.in.viscous[m] = fv[DD * ib * T.eb + i];
      }
    }
  }
};

// The cluster variant: the grid is one cluster (the launch sets the cluster
// dimension to the grid), of kThreads or kClusterThreads threads a CTA.
template <int D, int M, bool INELASTIC>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_explicit_frame_kernel(
        const __grid_constant__ FemExplicitFrameArgs a) {
  constexpr int RS = row_stride(D);
  extern __shared__ __align__(16) float cluster_smem[];
  ClusterExplicit<D, M, INELASTIC> fr{a, cg::this_cluster()};
  const fem::BlockTables& T = a.T;
  fr.nr = static_cast<int>(fr.cl.num_blocks());
  fr.me = static_cast<int>(fr.cl.block_rank());
  fr.bpc = (T.num_blocks + fr.nr - 1) / fr.nr;
  const int first = a.cl_local_ptr[fr.me];
  fr.nl = a.cl_local_ptr[fr.me + 1] - first;
  const int first_owned = a.cl_owned_ptr[fr.me];
  fr.no = a.cl_owned_ptr[fr.me + 1] - first_owned;
  fr.groups = static_cast<int>(blockDim.x) / kThreads;
  fr.rounds = (fr.bpc + fr.groups - 1) / fr.groups;
  fr.grp = static_cast<int>(threadIdx.x) / kThreads;
  fr.gtid = static_cast<int>(threadIdx.x) % kThreads;
  const size_t cap = a.cl_cap;
  const size_t elems = static_cast<size_t>(fr.bpc) * T.eb;
  const size_t work = fem::block_work_floats(T.eb, T.pb, D);
  fr.recv = cluster_smem;  // first: 16-byte aligned rows
  fr.pos = fr.recv + RS * a.cl_entries;  // 16-byte aligned too
  float* works = fr.pos + RS * cap;
  fr.xs = works + fr.grp * work;
  fr.t = fr.xs + D * T.pb;
  fr.rinv = works + fr.groups * work;
  fr.vol = fr.rinv + D * D * elems;
  float* next = fr.vol + elems;
  fr.fp = nullptr;
  fr.fv = nullptr;
  if constexpr (INELASTIC) {
    if (a.in.plastic != nullptr) {
      fr.fp = next;
      next += D * D * elems;
    }
    if (a.in.viscous != nullptr) {
      fr.fv = next;
      next += D * D * elems;
    }
  }
  fr.vel = next;
  fr.minv = fr.vel + D * cap;
  fr.tabs = reinterpret_cast<int*>(fr.minv + cap);
  fr.ids = fr.tabs + fr.bpc * block_table_ints(T.eb, T.pb, D);
  fr.sptr = fr.ids + cap;
  fr.pptr = fr.sptr + cap + 1;
  fr.pcodes = fr.pptr + cap + 1;
  fr.barriers = 0;
  fr.stage(first, first_owned);
  // Every CTA of the cluster is running, and the staged tables and
  // positions are complete, before any stores into another's shared memory.
  fr.sync();
  for (int s = 0; s < a.sim_count; ++s) {
    const bool last = s + 1 == a.sim_count;
    fr.gradient();
    fr.sync();
    // After the last substep of an elastic frame no CTA reads positions
    // again: no push and no barrier.
    const bool push = INELASTIC || !last;
    fr.advance(push);
    if (push) fr.sync();
    if constexpr (INELASTIC) fr.update();
  }
  // An owned row is the same thread's since the copy-in above.
  for (int l = threadIdx.x; l < fr.no; l += blockDim.x) {
    const int g = fr.ids[l];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      a.pos[D * g + c] = fr.pos[RS * l + c];
      a.vel[D * g + c] = fr.vel[D * l + c];
    }
  }
  if constexpr (INELASTIC) fr.write_state();
  if (a.barriers != nullptr && fr.me == 0 && threadIdx.x == 0) {
    *a.barriers = fr.barriers;
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

// f(kernel) for the cluster variant's instance of (D, material, inelastic).
template <int D, typename F>
int with_cluster_kernel(int material, bool inelastic, F&& f) {
  return fem::dispatch_material<false>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return inelastic ? f(cluster_explicit_frame_kernel<D, M, true>)
                     : f(cluster_explicit_frame_kernel<D, M, false>);
  });
}

template <typename F>
int with_cluster_instance(int dim, int material, bool inelastic, F&& f) {
  if (dim == 3) return with_cluster_kernel<3>(material, inelastic, f);
  if (dim == 2) return with_cluster_kernel<2>(material, inelastic, f);
  return static_cast<int>(cudaErrorInvalidValue);
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

// The grid variant: launches the instance of args->material; the inelastic
// one when args->in has a state (plastic or viscous not null).
extern "C" int fem_explicit_frame(const FemExplicitFrameArgs* args, int grid,
                                  int smem, void* stream) {
  FemExplicitFrameArgs a = *args;
  if (a.sim_count <= 0 || a.n <= 0) return 0;
  if (a.T.dim == 3) return launch_instance<3>(&a, grid, smem, stream);
  if (a.T.dim == 2) return launch_instance<2>(&a, grid, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The device's limits for the cluster variant's instance of (`dim`,
// `material`, `inelastic`): the most CTAs a cluster of it can have, the
// most dynamic shared memory a CTA can take and the SMs.  Returns 0 or a
// CUDA error.
extern "C" int fem_explicit_frame_limits(int dim, int material, int inelastic,
                                         int* max_cluster, int* smem_optin,
                                         int* sms) {
  return with_cluster_instance(dim, material, inelastic != 0, [&](auto kernel) {
    return fem::cluster_limits(kernel, kClusterThreads, max_cluster,
                               smem_optin, sms);
  });
}

// Bytes of dynamic shared memory of the cluster variant's CTA: `cluster`
// CTAs of `groups` thread groups over `num_blocks` blocks, `cap` local
// particles, `entries` receive slots, `pushes` push codes and `states`
// internal states an element.
extern "C" long long fem_explicit_frame_cluster_smem(
    int num_blocks, int eb, int pb, int cap, int entries, int pushes,
    int cluster, int dim, int groups, int states) {
  return static_cast<long long>(
      sizeof(float) * cluster_smem_words(num_blocks, eb, pb, cap, entries,
                                         pushes, cluster, dim, groups,
                                         states));
}

// Checks that one cluster of `cluster` CTAs of the cluster variant's
// instance, `threads` threads (kThreads or kClusterThreads) and `smem`
// bytes of dynamic shared memory each, can be placed on the device; writes
// how many could be active at once.  Returns 0, a CUDA error, -2 (shared
// memory too large) or -4 (the cluster cannot be scheduled).
extern "C" int fem_explicit_frame_cluster_fit(int cluster, int threads,
                                              int smem, int dim, int material,
                                              int inelastic, int* max_active) {
  *max_active = 0;
  return with_cluster_instance(dim, material, inelastic != 0, [&](auto kernel) {
    return fem::cluster_fit(kernel, threads, cluster,
                            static_cast<size_t>(smem), max_active);
  });
}

// The cluster variant: launches the instance of args->material (the
// inelastic one when args->in has a state) as one cluster of `cluster`
// CTAs of `threads` threads with `smem` bytes of dynamic shared memory.
extern "C" int fem_explicit_frame_cluster(const FemExplicitFrameArgs* args,
                                          int cluster, int threads, int smem,
                                          void* stream) {
  FemExplicitFrameArgs a = *args;
  if (a.sim_count <= 0 || a.n <= 0) return 0;
  const bool inelastic = a.in.plastic != nullptr || a.in.viscous != nullptr;
  return with_cluster_instance(a.T.dim, a.material, inelastic, [&](auto kernel) {
    return fem::cluster_launch(kernel, &a, cluster, threads, smem, stream);
  });
}

extern "C" const char* fem_explicit_frame_error(int code) {
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return fem::cooperative_error(code);
}
