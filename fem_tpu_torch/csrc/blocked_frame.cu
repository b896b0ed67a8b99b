// K5: one rendered frame — sim_count implicit-CG substeps, each the blocked
// prep, the rhs assembly, the reference CG solve and the implicit advection —
// in one launch: one thread-block cluster, or a cooperative grid for
// meshes too large for one cluster (see Design).
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
// fem_blocked_frame_cluster and fem_blocked_frame launch the instance of
// (args->T.dim, args->material) of their variant; a library built with
// -DFEM_MATERIAL holds one material's eight instances (utils/cuda_build.py
// builds the materials' libraries in parallel).
//
// Inelastic materials (the INELASTIC instance, chosen at launch;
// inelastic.cuh): the prep runs the base material's chain on each element's
// R^-1 F_p^-1 and adds the Maxwell branch's stable Neo-Hookean k and h
// (lam = 0, mu_v, on R^-1 F_v^-1) before the -V scaling
// (pallas_blocked_frame.py:139-197); after each substep's advection each
// CTA updates its own blocks' elements from the end-of-substep positions
// (:296-373).  In the grid variant the grid barrier that ends the substep
// orders the update after every CTA's advection; in the cluster variant a
// CTA reads its own copy of the positions, so no barrier is needed; either
// way the next prep reads only the CTA's own blocks' state, so the barrier
// count is the elastic kernel's.  The state stays in the output arrays,
// mesh element order, through element_perm.
//
// Design: two variants of one frame, chosen by size before the launch
// (ops/frame_kernels.py: frame_plan), never one in place of the other
// after a failure.
//
// The cluster variant (cluster_frame_kernel), for every frame whose state
// fits the shared memory of one thread-block cluster (<= 16 CTAs on the
// H100; the 3D flagship's 17 blocks, the 2D scenes' 1 and 16): the whole
// grid is one cluster.  CTA `rank` owns the locality blocks b = rank (mod
// C) and keeps in its shared memory their K, their per-slot partials (a
// ring of three copies) and its own copy of every particle vector (pos, vel, vel_g, x,
// r, d, q, 1/m) for its local particles: the particles its blocks touch,
// assigned on the host (frame_kernels.cluster_assignment), each owned by
// exactly one CTA.  A CTA reads other CTAs' slot partials directly from
// their shared memory (distributed shared memory, cluster.map_shared_rank)
// and computes every per-particle step for all its local particles,
// redundantly with the other CTAs that hold a particle, in the same
// operation order, so all copies stay bit-identical and no vector crosses
// CTAs: an operator apply is the local products, one cluster barrier and
// the per-particle slot sums; the normal equations' A^T A takes a second
// product and barrier, with z = u / m gathered straight from the CTA's own
// u; the CG's vector updates (x, r, then d after beta) need no barrier.
// Dot products sum over owned particles only: a per-CTA partial in a fixed
// order, one barrier, and every CTA sums the CTAs' partials in rank order,
// so alpha and beta are the same everywhere and two runs bit-identical.
// The rhs's A^T b and the first product of op(x_0) share a phase (both
// read only b), so per substep in normal-equations mode there are 4
// barriers (prep, A^T b with G(K) x_0, the A^T half of op(x_0), |r_0|^2)
// and 4 an iteration (two applies, two dots), against the grid variant's 8
// and 6; plain mode 3 and 3 against 5 and 4; one more before exit, so that
// no CTA leaves while another may read its shared memory.  Both variants
// count the phase barriers they meet and report them (args.barriers).  A
// cluster of one CTA (one locality block) syncs with __syncthreads() and
// reads its own partials.
//
// The grid variant (blocked_frame_kernel), for meshes whose state does not
// fit one cluster (e.g. 270 blocks): one CTA per locality block, grid-stride
// when a mesh has more blocks than the grid; each CTA keeps its blocks' K
// in shared memory, the vectors live in device memory (scratch), and
// phases that cross blocks are separated by grid barriers
// (cooperative_groups::this_grid().sync(); the launch is cooperative, so the
// grid is co-resident or the launch fails — it never hangs).  Its dot
// products are as above; its partials and per-slot buffers alternate
// between two copies; data written by another CTA in the same launch is
// read past L1 (__ldcg).
//
// Bound on the H100: operations — a flagship frame at 29 CG iterations is
// ~47 MFLOP, 0.7 us at 67 TFLOP/s f32, and its bytes take less.  What sets
// the time is the chain of barrier-separated phases, each a few hundred
// f32 operations a thread: the grid variant's phase is a software grid
// barrier through device memory plus a dependent L2 round trip (~3.8 us a
// phase on the flagship), the cluster variant's a hardware cluster barrier
// plus DSMEM reads, with fewer phases.  Both do a block's work on one SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "blocked_common.cuh"
#include "cluster.cuh"
#include "cooperative.cuh"
#include "inelastic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The cluster variant: a CTA is 1 or 2 groups of kThreads, each group
// working on one of the CTA's locality blocks at a time.
constexpr int kMaxGroups = 2;
constexpr int kClusterThreads = kMaxGroups * kThreads;
// Copies of the cluster variant's slot partials: a ring, as one phase may
// write two of them (the rhs's A^T b and the first product of A x_0).
constexpr int kParts = 3;

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
  // The cluster variant's plan (ops/frame_kernels.py: cluster_assignment);
  // the grid variant reads none of it.
  const int* cl_local_ptr;    // (C+1,) each rank's span of cl_local_ids
  const int* cl_local_ids;    // particle id of each local particle, a
                              // rank's owned ones first
  const int* cl_owned;        // (C,) owned local particles of each rank
  const int* cl_block_local;  // (B*Pb,) local index, in its block's rank,
                              // of each block slot's particle (0: padding)
  const int* cl_slot_ptr;     // (sum of local counts + 1,) each local
                              // particle's span of cl_slot_code
  const int* cl_slot_code;    // its block slots in ascending order, as
                              // rank * 65536 + slot index in that rank
  int cl_cap;                 // rows of each local vector in shared memory
  int* barriers;  // (1,) or null: the phase barriers the launch met, written
                  // by thread 0 of CTA 0 (frame_kernels.frame_barriers)
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

// Sum of `v` over the CTA (`warps` warps) in a fixed order; every thread
// gets the total.
__device__ float block_sum(float v, float* red, int warps = kWarps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < warps ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();
  return total;
}

// The prep of real element e of block b (rows in xs): K_e = -V k into
// k_out and its force rows into tr; with the material layers (INELASTIC)
// the base chain on R^-1 F_p^-1 plus the Maxwell branch's, then -V.
template <int D, int M, bool INELASTIC>
__device__ __forceinline__ void prep_element(const FemFrameArgs& a,
                                             const fem::BlockTables& T, int b,
                                             int e, const float* xs,
                                             float* k_out, float* tr) {
  constexpr int DD = D * D;
  if constexpr (!INELASTIC) {
    fem::element_prep<D, M>(T, b, e, xs, a.mat, k_out, tr);
  } else {
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
}

// Sum_c u[c] w[c] in the plain version's order, round-to-nearest.
template <int D>
__device__ __forceinline__ float dot_rn(const float* u, const float* w) {
  float s = __fmul_rn(u[0], w[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(u[c], w[c]));
  return s;
}

// The implicit advection of one particle (pos_in, the solve's x, vel_g_in)
// into pos_out, vel_out, velg_out, which may alias the inputs: every input
// is read before the first write.
template <int D>
__device__ __forceinline__ void advect_particle(
    const FemFrameArgs& a, const float* pos_in, const float* x_in,
    const float* velg_in, float* pos_out, float* vel_out, float* velg_out) {
  const float g[3] = {a.g0, a.g1, a.g2};
  float pos[D], vel[D], velg[D], vv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    pos[c] = pos_in[c];
    velg[c] = __fmul_rn(__fadd_rn(velg_in[c], __fmul_rn(g[c], a.dt)), a.decay);
    vel[c] = __fmul_rn(x_in[c], a.decay);
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
    const float dist_sq = dot_rn<D>(disp, disp);
    const float toward = dot_rn<D>(vv, away);
    if (dist_sq < radius * radius && toward > 0.0f && radius > 0.0f) {
      const float denom = fmaxf(dist_sq, 1e-30f);
      float* chans[3] = {vv, vel, velg};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float* u = chans[k];
        const float s = __fdiv_rn(dot_rn<D>(u, disp), denom);
#pragma unroll
        for (int c = 0; c < D; ++c) u[c] = __fsub_rn(u[c], __fmul_rn(s, disp[c]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    pos_out[c] = __fadd_rn(pos[c], __fmul_rn(vv[c], a.dt));
    vel_out[c] = vel[c];
    velg_out[c] = velg[c];
  }
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
  int barriers;  // grid barriers met so far

  // The barrier between phases, counted.
  __device__ void sync() {
    ++barriers;
    grid.sync();
  }

  // Sum over the grid of each thread's `part`, identical in every CTA.
  __device__ float grid_sum(float part) {
    const float s = block_sum(part, red);
    float* dots = v.dots + buf * gridDim.x;
    if (threadIdx.x == 0) __stcg(dots + blockIdx.x, s);
    sync();
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

  // K blocks into shared memory and force partials into `out`, at a.pos.
  __device__ void prep(float* out) {
    const fem::BlockTables& T = a.T;
    for (int b = blockIdx.x, ib = 0; b < T.num_blocks; b += gridDim.x, ++ib) {
      fem::load_block_rows<D>(T, b, a.pos, xs);
      __syncthreads();
      const int nel = T.block_elements[b];
      for (int e = threadIdx.x; e < nel; e += blockDim.x) {
        prep_element<D, M, INELASTIC>(a, T, b, e, xs,
                                      ksh + DD * (ib * T.eb + e), t + R * e);
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
    sync();
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
      sync();
      local_products(v.z, true, v.part[1]);
      sync();
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
    sync();
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
    sync();
    if (a.normal) {
      // r = A^T b (the rhs), kept in r until op(x_0) is subtracted.
      local_products(v.z, true, v.part[1]);
      sync();
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
      sync();
      delta = delta_next;
      ++it;
    }
    *it_out = it;
    *delta_out = delta;
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
    for (int p = first; p < a.n; p += stride) {
      advect_particle<D>(a, a.pos + D * p, v.x + D * p, a.velg + D * p,
                         a.pos + D * p, a.vel + D * p, a.velg + D * p);
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
              static_cast<int>(gridDim.x * blockDim.x), 0};
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
  fr.sync();
  for (int s = 0; s < a.sim_count; ++s) {
    int it;
    float delta;
    fr.solve(&it, &delta);
    fr.advect();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.iters[s] = it;
      a.res[s] = delta;
    }
    fr.sync();
    if constexpr (INELASTIC) fr.internal_update();
  }
  if (a.barriers != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *a.barriers = fr.barriers;
  }
}

// Ints of one owned block's tables staged in shared memory: plus and
// minus (Eb*D each), the local plan's rows (Eb*(D+1)) and offsets (Pb+1),
// and the local index of each slot's particle (Pb).
__host__ __device__ inline size_t block_table_ints(int eb, int pb, int dim) {
  return static_cast<size_t>(2 * dim + dim + 1) * eb + 2 * pb + 1;
}

// 4-byte words of the cluster variant's dynamic shared memory: the owned
// blocks' K (bpc of them), one block's working set (xs, t) for each of
// `groups` thread groups, the owned blocks' slot partials (kParts copies), the
// local vectors (pos, vel, vel_g, x, r, d, q: cap rows of D; 1/m: cap),
// then the owned blocks' tables, the local particles' ids, and their slot
// lists (offsets cap+1, at most B*Pb entries).
inline size_t cluster_smem_words(int num_blocks, int eb, int pb, int cap,
                                 int cluster, int dim, int groups) {
  const size_t bpc = (num_blocks + cluster - 1) / cluster;
  return static_cast<size_t>(dim) * dim * bpc * eb +
         groups * fem::block_work_floats(eb, pb, dim) +
         kParts * bpc * pb * dim +
         static_cast<size_t>(cap) * (7 * dim + 1) +
         bpc * block_table_ints(eb, pb, dim) + 2 * static_cast<size_t>(cap) +
         1 + static_cast<size_t>(num_blocks) * pb;
}

template <int D, int M, bool INELASTIC>
struct ClusterFrame {
  static constexpr int DD = D * D;
  static constexpr int R = fem::rows_floats(D);

  const FemFrameArgs& a;
  cg::cluster_group cl;
  int me;            // this CTA's rank
  int nr;            // CTAs in the cluster
  int nl;            // local particles
  int no;            // of which the first `no` are owned
  int* ids;          // their particle ids (shared memory, as below)
  int* sptr;         // (nl+1,) each one's span of scode
  int* scode;        // its block slots: rank * 65536 + slot index there
  int* tabs;         // the owned blocks' tables, block_table_ints each
  int rounds;        // block rounds of a pass over the owned blocks
  int groups;        // thread groups, each on one block in a round
  int grp;           // this thread's group
  int gtid;          // this thread's index in its group
  float* ksh;        // K of the owned blocks
  float* xs;         // this group's block's particle rows
  float* t;          // this group's block's contribution rows
  float* part[kParts];  // the owned blocks' slot partials, a ring
  float* pos;        // local vectors, (cap, D) each
  float* vel;
  float* velg;
  float* x;
  float* r;
  float* d;
  float* q;
  float* minv;       // (cap,)
  float* red;
  float* bcast;
  float* dots;       // this CTA's dot partials, two copies
  int pbuf;          // the partial copy the next product writes
  int dbuf;          // the dot copy the next sum writes
  int barriers;      // phase barriers met so far

  // The barrier between phases, counted: the hardware cluster barrier, or
  // the CTA barrier when the cluster is one CTA.
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

  // Sum over the cluster of each thread's `part`, identical in every CTA:
  // lane i of warp 0 reads CTA i's partial (all at once), lane 0 sums them
  // in rank order.
  __device__ float cluster_sum(float part) {
    const float s = block_sum(part, red, blockDim.x / 32);
    if (threadIdx.x == 0) dots[dbuf] = s;
    sync();
    if (threadIdx.x < 32) {
      const float mine = threadIdx.x < nr ? *at(dots + dbuf, threadIdx.x) : 0.0f;
      float total = 0.0f;
      for (int i = 0; i < nr; ++i) total += __shfl_sync(0xffffffffu, mine, i);
      if (threadIdx.x == 0) *bcast = total;
    }
    __syncthreads();
    const float total = *bcast;
    dbuf ^= 1;
    return total;
  }

  // The block tables of owned block b (the ib-th), read from their copy in
  // shared memory: pointers shifted so that the global block index b
  // addresses the copy; ref_inv and volume stay in device memory.
  __device__ fem::BlockTables view(int b, int ib) const {
    const fem::BlockTables& T = a.T;
    fem::BlockTables v = T;
    const int* base = tabs + ib * block_table_ints(T.eb, T.pb, D);
    const ptrdiff_t shift = static_cast<ptrdiff_t>(b) * T.eb * D;
    v.plus = base - shift;
    v.minus = base + T.eb * D - shift;
    v.local_rows = base + 2 * T.eb * D -
                   static_cast<ptrdiff_t>(b) * T.eb * (D + 1);
    v.local_ptr = base + (3 * D + 1) * T.eb - static_cast<ptrdiff_t>(b) * (T.pb + 1);
    return v;
  }

  // The local index of each slot's particle of the ib-th owned block.
  __device__ const int* block_local(int ib) const {
    const fem::BlockTables& T = a.T;
    return tabs + ib * block_table_ints(T.eb, T.pb, D) + (3 * D + 1) * T.eb +
           T.pb + 1;
  }

  // Copies the owned blocks' tables and the local particles' ids and slot
  // lists into shared memory (the caller's CTA barrier publishes them).
  __device__ void stage_tables(int first) {
    const fem::BlockTables& T = a.T;
    const int words = static_cast<int>(block_table_ints(T.eb, T.pb, D));
    for (int b = me, ib = 0; b < T.num_blocks; b += nr, ++ib) {
      int* dst = tabs + ib * words;
      const int rd = T.eb * D;
      const int rr = T.eb * (D + 1);
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
        } else {
          v = a.cl_block_local[b * T.pb + i - 2 * rd - rr - T.pb - 1];
        }
        dst[i] = v;
      }
    }
    const int base = a.cl_slot_ptr[first];
    for (int l = threadIdx.x; l <= nl; l += blockDim.x) {
      if (l < nl) ids[l] = a.cl_local_ids[first + l];
      sptr[l] = a.cl_slot_ptr[first + l] - base;
    }
    const int entries = a.cl_slot_ptr[first + nl] - base;
    for (int k = threadIdx.x; k < entries; k += blockDim.x) {
      scode[k] = a.cl_slot_code[base + k];
    }
  }

  // xs = the rows of local vector `src` (times 1/m when `scale`) of the
  // ib-th owned block's slots.
  __device__ void load_rows(int ib, const float* src, bool scale) {
    const int* loc = block_local(ib);
    for (int i = gtid; i < D * a.T.pb; i += kThreads) {
      const int p = i / D;
      const int l = loc[p];
      const float s = src[D * l + (i - D * p)];
      xs[i] = scale ? s * minv[l] : s;
    }
  }

  // The copy of the slot partials that the next product writes.  Products
  // take the copies in turn, at most two between barriers, and every copy
  // is read only between the barrier after its product and the next one,
  // so a CTA never writes a copy that another CTA may still be reading.
  __device__ float* next_part() {
    float* out = part[pbuf];
    pbuf = pbuf + 1 == kParts ? 0 : pbuf + 1;
    return out;
  }

  // out[D*p + c] = the sum of the group's block's rows t landing on its
  // slot p, in the local plan's order (fem::block_slot_sums' arithmetic),
  // the rows of up to kChunk entries loaded before any is added.
  static constexpr int kChunk = 4;
  __device__ void slot_sums(const fem::BlockTables& Tb, int b, float* out) {
    const int* ptr = Tb.local_ptr + b * (Tb.pb + 1);
    const int* rows = Tb.local_rows + b * Tb.eb * (D + 1);
    for (int p = gtid; p < Tb.pb; p += kThreads) {
      float acc[D];
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = 0.0f;
      const int end = ptr[p + 1];
      for (int q0 = ptr[p]; q0 < end; q0 += kChunk) {
        float v[kChunk][D];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (q0 + j < end) {
            const float* row = t + D * rows[q0 + j];
#pragma unroll
            for (int c = 0; c < D; ++c) v[j][c] = row[c];
          }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (q0 + j < end) {
#pragma unroll
            for (int c = 0; c < D; ++c) acc[c] += v[j][c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < D; ++c) out[D * p + c] = acc[c];
    }
  }

  // One pass over the owned blocks, `groups` at a time: for each, the
  // group's rows of `src` (times 1/m when `scale`) into xs, then
  // elem(Tb, b, ib, e) for its real elements (Tb: its staged tables), then
  // (when `out`) the slot sums of its rows t into out.  Every thread meets
  // every CTA barrier.
  template <typename Elem>
  __device__ void blocks_pass(const float* src, bool scale, float* out,
                              Elem elem) {
    const fem::BlockTables& T = a.T;
    for (int round = 0; round < rounds; ++round) {
      const int ib = round * groups + grp;
      const int b = me + ib * nr;
      const bool on = b < T.num_blocks;
      const fem::BlockTables Tb = view(on ? b : 0, ib);
      __syncthreads();  // src complete; xs and t free
      if (on) load_rows(ib, src, scale);
      __syncthreads();
      if (on) {
        const int nel = T.block_elements[b];
        for (int e = gtid; e < nel; e += kThreads) elem(Tb, b, ib, e);
      }
      __syncthreads();
      if (on && out != nullptr) slot_sums(Tb, b, out + D * ib * T.pb);
    }
  }

  // Slot partials `out` of every owned block's G(K) src (K^T when
  // `transpose`; src / m when `scale`).  The caller's barrier publishes them.
  __device__ void local_products(const float* src, bool scale, bool transpose,
                                 float* out) {
    blocks_pass(src, scale, out,
                [&](const fem::BlockTables& Tb, int b, int ib, int e) {
      fem::element_apply<D>(Tb, b, e, xs, ksh + DD * (ib * Tb.eb + e),
                            transpose, t + R * e);
    });
  }

  // K of the owned blocks into shared memory and their force partials into
  // `out`, at the local positions.
  __device__ void prep(float* out) {
    blocks_pass(pos, false, out,
                [&](const fem::BlockTables& Tb, int b, int ib, int e) {
      prep_element<D, M, INELASTIC>(a, Tb, b, e, xs,
                                    ksh + DD * (ib * Tb.eb + e), t + R * e);
    });
  }

  // Sum over local particle l's block slots of the partials `buf` (each in
  // the CTA that owns the slot's block), in ascending slot order; the rows
  // of up to kChunk slots are loaded before any is added, so that their
  // distributed-shared-memory reads overlap.
  __device__ void slot_sum(float* buf, int l, float* w) {
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.0f;
    const int end = sptr[l + 1];
    for (int k0 = sptr[l]; k0 < end; k0 += kChunk) {
      float v[kChunk][D];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j < end) {
          const int code = scode[k0 + j];
          const float* row = at(buf + D * (code & 0xffff), code >> 16);
#pragma unroll
          for (int c = 0; c < D; ++c) v[j][c] = row[c];
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j < end) {
#pragma unroll
          for (int c = 0; c < D; ++c) acc[c] += v[j][c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < D; ++c) w[c] = acc[c];
  }

  // u = A src into q for every local particle, from the published partials
  // p0 of G(K) src (normal equations).
  __device__ void apply_a(const float* src, float* p0) {
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
      float w[D];
      slot_sum(p0, l, w);
      const float mi = minv[l];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        q[D * l + c] = src[D * l + c] - a.dt2 * w[c] * mi;
      }
    }
  }

  // q = op(src) for every local particle, op = A^T A (normal) or A; for the
  // normal equations q holds u = A src until A^T u replaces it.  With `p0`
  // the partials of G(K) src are published already (and u not yet taken).
  // Returns sum src . q over this thread's owned particles.
  __device__ float apply_op(const float* src, float* p0 = nullptr) {
    if (p0 == nullptr) {
      p0 = next_part();
      local_products(src, false, false, p0);
      sync();
    }
    float dot = 0.0f;
    if (a.normal) {
      apply_a(src, p0);
      float* p1 = next_part();
      local_products(q, true, true, p1);  // z = u / m, no barrier before
      sync();
      for (int l = threadIdx.x; l < nl; l += blockDim.x) {
        float w[D];
        slot_sum(p1, l, w);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float qc = q[D * l + c] - a.dt2 * w[c];
          q[D * l + c] = qc;
          if (l < no) dot += src[D * l + c] * qc;
        }
      }
    } else {
      for (int l = threadIdx.x; l < nl; l += blockDim.x) {
        float w[D];
        slot_sum(p0, l, w);
        const float mi = minv[l];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float sc = src[D * l + c];
          const float qc = sc - a.dt2 * w[c] * mi;
          q[D * l + c] = qc;
          if (l < no) dot += sc * qc;
        }
      }
    }
    return dot;
  }

  // The velocity solve of one substep; leaves x and returns (it, |r|^2).
  __device__ void solve(int* it_out, float* delta_out) {
    float* pf = next_part();
    prep(pf);
    sync();
    // b = v + dt f / m into x (x_0 = b).
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
      float f[D];
      slot_sum(pf, l, f);
      const float mi = minv[l];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        x[D * l + c] = vel[D * l + c] + a.dt * f[c] * mi;
      }
    }
    float* p0 = nullptr;
    if (a.normal) {
      // r = A^T b (the rhs), kept in r until op(x_0) is subtracted; the
      // product of A x_0 (x_0 = b) is taken before the same barrier.
      float* p1 = next_part();
      p0 = next_part();
      local_products(x, true, true, p1);  // z = b / m
      local_products(x, false, false, p0);
      sync();
      for (int l = threadIdx.x; l < nl; l += blockDim.x) {
        float w[D];
        slot_sum(p1, l, w);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          r[D * l + c] = x[D * l + c] - a.dt2 * w[c];
        }
      }
    }
    apply_op(x, p0);
    float part = 0.0f;
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const int i = D * l + c;
        const float rhs = a.normal ? r[i] : x[i];
        const float ri = rhs - q[i];
        r[i] = ri;
        d[i] = ri;
        if (l < no) part += ri * ri;
      }
    }
    float delta = cluster_sum(part);
    int it = 0;
    while (it < a.max_iter && delta > a.tol) {
      const float alpha = delta / cluster_sum(apply_op(d));
      part = 0.0f;
      for (int l = threadIdx.x; l < nl; l += blockDim.x) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * l + c;
          x[i] += alpha * d[i];
          const float ri = r[i] - alpha * q[i];
          r[i] = ri;
          if (l < no) part += ri * ri;
        }
      }
      const float delta_next = cluster_sum(part);
      const float beta = delta_next / delta;
      // Every CTA updates its own copy: no barrier before the next apply.
      for (int l = threadIdx.x; l < nl; l += blockDim.x) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * l + c;
          d[i] = r[i] + beta * d[i];
        }
      }
      delta = delta_next;
      ++it;
    }
    *it_out = it;
    *delta_out = delta;
  }

  // Implicit advection of every local particle; vel_in is the solve's x.
  __device__ void advect() {
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
      const int i = D * l;
      advect_particle<D>(a, pos + i, x + i, velg + i, pos + i, vel + i,
                         velg + i);
    }
  }

  // The internal update of every owned block's real elements from the
  // end-of-substep local positions.
  __device__ void internal_update() {
    blocks_pass(pos, false, nullptr,
                [&](const fem::BlockTables& Tb, int b, int, int e) {
      const int slot = b * Tb.eb + e;
      float xe[DD];
      fem::block_edges<D>(Tb, b, e, xs, xe);
      fem::update_slot<D>(a.in, slot, xe, Tb.ref_inv + DD * slot);
    });
  }

  // The state of every owned block's real elements from the inputs into
  // the outputs (the first pass over the blocks then starts with a CTA
  // barrier).
  __device__ void copy_state() {
    const fem::BlockTables& T = a.T;
    for (int b = me; b < T.num_blocks; b += nr) {
      const int nel = T.block_elements[b];
      for (int e = threadIdx.x; e < nel; e += blockDim.x) {
        fem::copy_state<D>(a.in, b * T.eb + e);
      }
    }
  }
};

// The cluster variant: the grid is one cluster (the launch sets the
// cluster dimension to the grid), of kThreads or kClusterThreads threads a
// CTA.
template <int D, int M, bool INELASTIC>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_frame_kernel(const __grid_constant__ FemFrameArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ float bcast;
  __shared__ float dots[2];
  ClusterFrame<D, M, INELASTIC> fr{a, cg::this_cluster()};
  fr.nr = static_cast<int>(fr.cl.num_blocks());
  fr.me = static_cast<int>(fr.cl.block_rank());
  const fem::BlockTables& T = a.T;
  const int bpc = (T.num_blocks + fr.nr - 1) / fr.nr;
  const int first = a.cl_local_ptr[fr.me];
  fr.nl = a.cl_local_ptr[fr.me + 1] - first;
  fr.no = a.cl_owned[fr.me];
  fr.groups = static_cast<int>(blockDim.x) / kThreads;
  fr.rounds = (bpc + fr.groups - 1) / fr.groups;
  fr.grp = static_cast<int>(threadIdx.x) / kThreads;
  fr.gtid = static_cast<int>(threadIdx.x) % kThreads;
  const size_t rows = static_cast<size_t>(D) * a.cl_cap;
  const size_t slots = static_cast<size_t>(bpc) * T.pb * D;
  const size_t work = fem::block_work_floats(T.eb, T.pb, D);
  fr.ksh = smem;
  float* works = fr.ksh + static_cast<size_t>(D * D) * bpc * T.eb;
  fr.xs = works + fr.grp * work;
  fr.t = fr.xs + D * T.pb;
  fr.part[0] = works + fr.groups * work;
  for (int k = 1; k < kParts; ++k) fr.part[k] = fr.part[k - 1] + slots;
  fr.pos = fr.part[kParts - 1] + slots;
  fr.vel = fr.pos + rows;
  fr.velg = fr.vel + rows;
  fr.x = fr.velg + rows;
  fr.r = fr.x + rows;
  fr.d = fr.r + rows;
  fr.q = fr.d + rows;
  fr.minv = fr.q + rows;
  fr.tabs = reinterpret_cast<int*>(fr.minv + a.cl_cap);
  fr.ids = fr.tabs + bpc * block_table_ints(T.eb, T.pb, D);
  fr.sptr = fr.ids + a.cl_cap;
  fr.scode = fr.sptr + a.cl_cap + 1;
  fr.red = red;
  fr.bcast = &bcast;
  fr.dots = dots;
  fr.pbuf = 0;
  fr.dbuf = 0;
  fr.barriers = 0;
  fr.stage_tables(first);
  for (int l = threadIdx.x; l < fr.nl; l += blockDim.x) {
    const int g = a.cl_local_ids[first + l];
    fr.minv[l] = 1.0f / a.mass[g];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      fr.pos[D * l + c] = a.pos_in[D * g + c];
      fr.vel[D * l + c] = a.vel_in[D * g + c];
      fr.velg[D * l + c] = a.velg_in[D * g + c];
    }
  }
  if constexpr (INELASTIC) fr.copy_state();
  for (int s = 0; s < a.sim_count; ++s) {
    int it;
    float delta;
    fr.solve(&it, &delta);
    fr.advect();
    if (fr.me == 0 && threadIdx.x == 0) {
      a.iters[s] = it;
      a.res[s] = delta;
    }
    if constexpr (INELASTIC) fr.internal_update();
  }
  // An owned row is the same thread's since the copy-in above.
  for (int l = threadIdx.x; l < fr.no; l += blockDim.x) {
    const int g = fr.ids[l];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      a.pos[D * g + c] = fr.pos[D * l + c];
      a.vel[D * g + c] = fr.vel[D * l + c];
      a.velg[D * g + c] = fr.velg[D * l + c];
    }
  }
  fr.sync();  // no CTA leaves while another may still read its partials
  if (a.barriers != nullptr && fr.me == 0 && threadIdx.x == 0) {
    *a.barriers = fr.barriers;
  }
}

// f(kernel) for the cluster variant's instance of (D, material, inelastic).
template <int D, typename F>
int with_cluster_kernel(int material, bool inelastic, F&& f) {
  return fem::dispatch_material<true>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return inelastic ? f(cluster_frame_kernel<D, M, true>)
                     : f(cluster_frame_kernel<D, M, false>);
  });
}

template <typename F>
int with_cluster_instance(int dim, int material, bool inelastic, F&& f) {
  if (dim == 3) return with_cluster_kernel<3>(material, inelastic, f);
  if (dim == 2) return with_cluster_kernel<2>(material, inelastic, f);
  return static_cast<int>(cudaErrorInvalidValue);
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

// The device's limits for the cluster variant's instance of (`dim`,
// `material`, `inelastic`): the most CTAs a cluster of it can have, the
// most dynamic shared memory a CTA can take and the SMs.  Returns 0 or a
// CUDA error.
extern "C" int fem_blocked_frame_limits(int dim, int material, int inelastic,
                                        int* max_cluster, int* smem_optin,
                                        int* sms) {
  return with_cluster_instance(dim, material, inelastic != 0, [&](auto kernel) {
    return fem::cluster_limits(kernel, kClusterThreads, max_cluster,
                               smem_optin, sms);
  });
}

// Bytes of dynamic shared memory of the cluster variant: `cluster` CTAs of
// `threads` threads over `num_blocks` blocks, local vectors of `cap` rows.
extern "C" long long fem_blocked_frame_cluster_smem(int num_blocks, int eb,
                                                    int pb, int cap,
                                                    int cluster, int dim,
                                                    int threads) {
  return static_cast<long long>(
      sizeof(float) * cluster_smem_words(num_blocks, eb, pb, cap, cluster,
                                         dim, threads / kThreads));
}

// Checks that one cluster of `cluster` CTAs of the cluster variant's
// instance, `threads` threads (kThreads or kClusterThreads) and `smem`
// bytes of dynamic shared memory each, can be placed on the device; writes
// how many could be active at once.  Returns 0, a CUDA error, -2 (shared
// memory too large) or -4 (the cluster cannot be scheduled).
extern "C" int fem_blocked_frame_cluster_fit(int cluster, int threads,
                                             int smem, int dim, int material,
                                             int inelastic, int* max_active) {
  *max_active = 0;
  if (threads != kThreads && threads != kClusterThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_cluster_instance(dim, material, inelastic != 0, [&](auto kernel) {
    return fem::cluster_fit(kernel, threads, cluster,
                            static_cast<size_t>(smem), max_active);
  });
}

// Launches the cluster variant's instance of args->material (the inelastic
// one when args->in has a state) as one cluster of `cluster` CTAs of
// `threads` threads.
extern "C" int fem_blocked_frame_cluster(const FemFrameArgs* args, int cluster,
                                         int threads, int smem, void* stream) {
  if (threads != kThreads && threads != kClusterThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FemFrameArgs a = *args;
  const bool inelastic = a.in.plastic != nullptr || a.in.viscous != nullptr;
  return with_cluster_instance(a.T.dim, a.material, inelastic, [&](auto kernel) {
    return fem::cluster_launch(kernel, &a, cluster, threads, smem, stream);
  });
}

extern "C" const char* fem_blocked_frame_error(int code) {
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return fem::cooperative_error(code);
}
