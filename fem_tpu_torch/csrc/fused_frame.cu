// K11b: one rendered frame over the UNblocked mesh — sim_count implicit-CG
// substeps, each the Neo-Hookean element pass, the rhs, the reference CG
// solve and the implicit advection — in one launch.
//
// Replaces the TPU kernel fem_tpu/experiments/pallas_frame.py:_frame_kernel
// (reached through fused_frame and make_fused_frame_fn, i.e.
// frame_backend="fused").  The TPU kernel gathers and scatters through
// one-hot masks regenerated per element tile and multiplied on the MXU,
// because Mosaic lowers no gather, and masks padded element lanes with a
// validity plane; none of that is semantics and none is carried over: this
// kernel gathers vertices directly by index and assembles through the
// per-particle plan, with no float atomics, so two runs are bit-identical.
//
// Semantics, unchanged from _frame_kernel, per substep:
//   K_e = -V k and the force columns -V h of the Neo-Hookean chain (non-
//   robust, element_chain.cuh: nh_chain, the chain of K1) at pos;
//   b = vel + dt f / m — no gravity: gravity lives in vel_g;
//   the reference CG (whole_cg.cuh, the core of K4 and K11a): x_0 = b,
//   normal equations when `normal`, while it < max_iter && |r|^2 > tol;
//   vel <- x, then the implicit advection (advect_common.cuh, K10b's step):
//   decay exp(-dt damping) in f32, vel_g <- (vel_g + 9.8 g dt) decay, the
//   lower wall zeroes vel, vel_g and v_tot, the upper wall vel and v_tot
//   but not vel_g, circles in order (radius 0 skipped) each projecting
//   v_tot, vel and vel_g with its own coefficient and 1/max(dist^2, 1e-30)
//   multiplied, pos += v_tot dt from the position before the update.
// Each substep's iterations and final |r|^2 go to iters[s] and res[s].
// Circles arrive as device arrays, not as compile-time constants.
// Templated on the dimension D in {2, 3}.
//
// Design: two variants of one frame, chosen by size before the launch
// (experiments/fused_frame.py: fused_frame_plan), never one in place of the
// other after a failure.
//
// The cluster variant (cluster_fused_frame_kernel), for every frame whose
// state fits the shared memory of one thread-block cluster (<= 16 CTAs on
// the H100).  CTA `rank` owns a contiguous range of elements, in the mesh's
// own order, and keeps in its shared memory their K and their vertices as
// local indices, and its own copy of every particle vector (pos, vel,
// vel_g, x, r, d, q, 1/m) for its local particles: those its elements
// touch.  Each particle is owned by one CTA (the CTA of the element of its
// middle plan row, which spreads ownership), assigned on the host
// (fused_frame.cluster_assignment).  An operator apply:
//   1. every CTA computes its elements' rows and stores each into a receive
//      slot of the CTA that owns the row's particle (st to distributed
//      shared memory; the slots of a particle lie in the plan's order);
//      hardware cluster barrier;
//   2. each owner sums its particles' slots in the plan's order — local
//      reads — and stores the sum into its own receive buffer and into
//      that of every other CTA holding the particle; cluster barrier;
//   3. every CTA finishes the step for all its local particles from the
//      sums, redundantly with the other holders and in the same operation
//      order, so every copy stays bit-identical.
// Storing rows and sums into their readers, rather than each CTA reading
// the rows it needs, keeps every distributed-shared-memory access a
// fire-and-forget store, which roughly halved a flagship phase on the H100
// against remote reads (PERF.md, section 6).  Where a dot product follows an apply, the owners
// finish their particles' step at once and store the CTA's partial into
// every CTA with the sums, so one barrier serves both; every CTA adds the
// partials in rank order, so alpha and beta agree everywhere and two runs
// are bit-identical.  Per substep in normal-equations mode 6 barriers (the
// element pass and its sums; A^T b with the first product of A x_0 and
// their sums; the A^T half of op(x_0) and its sums with |r_0|^2) and 5 an
// iteration (two applies, the second's sums with d.q, and r.r); in plain
// mode 4 and 3; two a frame: after the copy-in, so that no CTA stores into
// one that has not started, and before exit, so that none leaves while
// another may still store into it.  A cluster of one CTA syncs with
// __syncthreads().

// The single variant (fused_frame_kernel), for meshes whose state does not
// fit one cluster: K4's design — ONE thread block of 1,024 threads runs the
// whole frame, phases separated by __syncthreads(); per substep the element
// pass writes K (E, D, D) and the force rows ((D+1) E, D) to device-memory
// scratch, one thread an element, and every per-particle sum walks the CSR
// plan in a fixed order.  The scratch is O(E + N) floats of device memory,
// so this variant takes any mesh size; its limit is time, one SM's.
//
// Both variants count the barriers they meet and report them
// (args.barriers; fused_frame.frame_barriers gives the count).
//
// Bound on the H100: latency, as K4's and K5's: each CG iteration is a
// chain of dependent phases over a few thousand unknowns.  The frame's
// bytes (pos, vel, vel_g, R^-1, V, the ids, the plan and the mass in, the
// state out) and operations (the chain, the applies, the advection) take a
// few microseconds at the card's rates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "advect_common.cuh"
#include "blocked_common.cuh"
#include "cluster.cuh"
#include "whole_cg.cuh"

namespace cg = cooperative_groups;

// The Python side mirrors this layout (experiments/fused_frame.py:
// FusedFrameArgsC).
struct FemFusedFrameArgs {
  const float* pos_in;   // (N, D)
  const float* vel_in;
  const float* velg_in;
  const float* ref_inv;  // (E, D, D)
  const float* volume;   // (E,)
  const int* elem;       // (E, D+1)
  const int* ptr;        // (N + 1,) the per-particle plan
  const int* rows;       // ((D+1) E,)
  const float* mass;     // (N,)
  const float* centers;  // (O, D)
  const float* radii;    // (O,)
  const float* gravity;  // (D,) 9.8 g_dir
  int n;
  int e;
  int n_obst;
  int sim_count;
  int max_iter;
  int normal;
  int dim;
  float dt;
  float dt2;
  float decay;
  float mu;
  float lam;
  float half_lam;
  float tol;
  float* pos;      // (N, D) outputs, the state through the frame
  float* vel;
  float* velg;
  float* scratch;  // see fem_fused_frame_scratch_floats
  int* iters;      // (S,)
  float* res;      // (S,)
  // The cluster variant's plan (experiments/fused_frame.py:
  // cluster_assignment); the single variant reads none of it.
  const int* cl_elem_ptr;   // (C+1,) each rank's range of elements
  const int* cl_local_ptr;  // (C+1,) each rank's span of cl_local_ids
  const int* cl_local_ids;  // particle id of each local particle, a rank's
                            // owned ones first
  const int* cl_owned_ptr;  // (C+1,) each rank's span of owned particles
                            // (its first local ones), flat over the ranks
  const int* cl_elem_local;  // ((D+1) E,) each element's vertices as local
                             // indices in its rank
  const int* cl_row_dest;   // ((D+1) E,) where each element row goes: its
                            // particle's owner rank * 65536 + slot there
  const int* cl_recv_ptr;   // (N+1,) each owned particle's span of its
                            // rank's receive slots, in the plan's order
  const int* cl_push_ptr;   // (N+1,) each owned particle's span of
                            // cl_push_codes
  const int* cl_push_codes;  // the other ranks holding it, as rank * 65536
                             // + its local index there
  int cl_cap;       // rows of each local vector in shared memory
  int cl_elements;  // most elements of a rank
  int cl_entries;   // most receive slots of a rank (its owned particles'
                    // plan rows)
  int cl_pushes;    // most push codes of a rank's owned particles
  int* barriers;  // (1,) or null: the barriers the launch met, written by
                  // thread 0 of CTA 0
};

namespace {

using fem::whole_cg::CountSync;
using fem::whole_cg::kThreads;
using fem::whole_cg::Solve;

// The cluster variant's threads a CTA.
constexpr int kClusterThreads = 256;
// Copies of the cluster variant's receive slots: two, as one phase may
// write two (the rhs's A^T b and the first product of A x_0).
constexpr int kParts = 2;
// The most CTAs of a cluster (Hopper's non-portable limit).
constexpr int kMaxRanks = 16;
// Floats a contribution row of the cluster variant takes: D padded to a
// whole vector (16 bytes in 3D, 8 in 2D), so that a row stored into another
// CTA's shared memory is one transaction.
__host__ __device__ constexpr int row_stride(int dim) {
  return dim == 3 ? 4 : 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fused_frame_kernel(const __grid_constant__ FemFusedFrameArgs a) {
  constexpr int DD = D * D;
  constexpr int R = fem::rows_floats(D);
  __shared__ float red[33];
  int barriers = 0;
  const CountSync sync{&barriers};
  const int n = a.n;
  const size_t nd = static_cast<size_t>(D) * n;
  float* minv = a.scratch;
  float* x = minv + n;
  float* r = x + nd;
  float* d = r + nd;
  float* q = d + nd;
  float* u = q + nd;
  float* w = u + nd;
  float* z = w + nd;
  float* kb = z + nd;
  Solve s;
  s.k = kb;
  s.elem = a.elem;
  s.ptr = a.ptr;
  s.rows = a.rows;
  s.minv = minv;
  s.t = kb + static_cast<size_t>(DD) * a.e;
  s.w = w;
  s.z = z;
  s.num_elements = a.e;
  s.num_particles = n;
  s.dt2 = a.dt2;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    minv[p] = 1.0f / a.mass[p];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      a.pos[D * p + c] = a.pos_in[D * p + c];
      a.vel[D * p + c] = a.vel_in[D * p + c];
      a.velg[D * p + c] = a.velg_in[D * p + c];
    }
  }
  sync();
  for (int step = 0; step < a.sim_count; ++step) {
    // The element pass: K_e = -V k into kb, the force rows of -V h into t.
    for (int e = threadIdx.x; e < a.e; e += kThreads) {
      int v[D + 1];
      fem::load_element<D>(a.elem, e, v);
      float xe[DD], re[DD], k[DD], h[DD];
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          xe[D * i + j] = a.pos[D * v[j + 1] + i] - a.pos[D * v[0] + i];
        }
      }
#pragma unroll
      for (int i = 0; i < DD; ++i) re[i] = a.ref_inv[DD * e + i];
      fem::nh_chain<D, false>(xe, re, a.mu, a.lam, a.half_lam, k, h);
      const float nv = -a.volume[e];
#pragma unroll
      for (int i = 0; i < DD; ++i) kb[DD * e + i] = nv * k[i];
      fem::column_rows<D>(nv, h, s.t + R * e);
    }
    sync();
    fem::whole_cg::gather_rows<D>(s, w, sync);
    for (int i = threadIdx.x; i < D * n; i += kThreads) {
      x[i] = a.vel[i] + a.dt * w[i] * minv[i / D];  // x_0 = b
    }
    fem::whole_cg::reference_cg<D>(s, a.normal != 0, a.max_iter, a.tol, x, r,
                                   d, q, u, red, a.iters + step,
                                   a.res + step, sync);
    sync();  // x is read across threads
    for (int p = threadIdx.x; p < n; p += kThreads) {
      fem::advect_implicit_particle<D>(
          a.pos + D * p, x + D * p, a.velg + D * p, a.centers, a.radii,
          a.n_obst, a.gravity, a.dt, a.decay, a.pos + D * p, a.vel + D * p,
          a.velg + D * p);
    }
    sync();  // the next element pass reads every position
  }
  if (a.barriers != nullptr && threadIdx.x == 0) *a.barriers = barriers;
}

// 4-byte words of the cluster variant's dynamic shared memory: kParts
// copies of the CTA's receive slots (`entries` rows), two receive buffers of
// per-particle sums (cap rows), the K of its elements (ne of them), the
// local vectors (pos, vel, vel_g, x, r, d, q: cap rows of D; 1/m: cap), the
// dot partials (two copies of 16), then the elements' local vertex ids and
// row destinations, the local particles' ids, the owned particles' spans
// of receive slots and of push codes (cap + 1 each) and the push codes.
__host__ __device__ inline size_t cluster_smem_words(int ne, int cap,
                                                     int entries, int pushes,
                                                     int dim) {
  const size_t rs = row_stride(dim);
  return static_cast<size_t>(kParts) * rs * entries + 2 * rs * cap +
         static_cast<size_t>(dim) * dim * ne +
         static_cast<size_t>(cap) * (7 * dim + 1) + 2 * kMaxRanks +
         2 * static_cast<size_t>(dim + 1) * ne + static_cast<size_t>(cap) +
         2 * (static_cast<size_t>(cap) + 1) + pushes;
}

// Sum of `v` over the CTA in a fixed order; every thread gets the total.
__device__ float cta_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = static_cast<int>(blockDim.x) >> 5;
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

template <int D>
struct ClusterFrame {
  static constexpr int DD = D * D;
  static constexpr int RS = row_stride(D);
  static constexpr int kChunk = 8;  // plan rows loaded before any is added
  using Row = typename std::conditional<D == 3, float4, float2>::type;

  const FemFusedFrameArgs& a;
  cg::cluster_group cl;
  int me;     // this CTA's rank
  int nr;     // CTAs in the cluster
  int e0;     // first element of this rank
  int ne;     // its elements
  int nl;     // local particles
  int no;     // of which the first `no` are owned
  float* parts;  // the receive slots of its owned particles' plan rows,
                 // kParts copies
  int part_floats;  // floats of one copy
  float* k;   // the elements' K
  float* pos;  // local vectors, (cap, D) each
  float* vel;
  float* velg;
  float* x;
  float* r;
  float* d;
  float* q;
  float* minv;  // (cap,)
  float* wb0;   // per-particle sums pushed by their owners, (cap, RS) each
  float* wb1;
  float* dots;  // every rank's dot partial, two copies of kMaxRanks
  int* lv;      // the elements' vertices as local indices, (ne, D+1)
  int* rdest;   // where each of their rows goes: rank * 65536 + slot
  int* ids;     // the local particles' ids
  int* sptr;    // (no+1,) each owned particle's span of receive slots
  int* pptr;    // (no+1,) each owned particle's span of pcodes
  int* pcodes;  // the other holders of it: rank * 65536 + local index there
  float* red;
  int pbuf;     // the copy of the rows the next product writes
  int dbuf;     // the dot copy the next partials go to
  int barriers;  // phase barriers met so far

  // The barrier between phases, counted: the hardware cluster barrier, or
  // the CTA barrier when the cluster is one CTA.  It orders every push to
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

  // The CTA's partial of a dot product (each thread's `part`, in a fixed
  // order) into slot `me` of every rank's dot copy; the next barrier
  // publishes it.
  __device__ void publish(float part) {
    const float s = cta_sum(part, red);
    if (threadIdx.x < nr) at(dots + dbuf * kMaxRanks + me, threadIdx.x)[0] = s;
  }

  // The ranks' partials published before the last barrier, in rank order:
  // the same in every CTA.
  __device__ float total() {
    const float* p = dots + dbuf * kMaxRanks;
    float t = 0.0f;
    for (int i = 0; i < nr; ++i) t += p[i];
    dbuf ^= 1;
    return t;
  }

  // The copy of the receive slots that the next product writes.  Products
  // take the copies in turn, at most two between barriers; a copy is read
  // (by its owner) only between the barrier after its product and the next
  // one, and the product after next comes after that barrier, so no CTA
  // writes a copy that its owner may still be reading.
  __device__ float* next_part() {
    float* out = parts + pbuf * part_floats;
    pbuf = pbuf + 1 == kParts ? 0 : pbuf + 1;
    return out;
  }

  // Row j of element e to its receive slot (in this CTA or another; the
  // caller's barrier publishes it).
  __device__ void send(float* out, int e, int j, const float* v) {
    Row row;
    row.x = v[0];
    row.y = v[1];
    if constexpr (D == 3) {
      row.z = v[2];
      row.w = 0.0f;
    }
    const int dest = rdest[(D + 1) * e + j];
    *reinterpret_cast<Row*>(at(out + RS * (dest & 0xffff), dest >> 16)) = row;
  }

  // The rows of every element of the rank into their receive slots of
  // `out`: t_j = K_e (x_{v_{j+1}} - x_{v_0}) as row j+1 and -sum_j t_j as
  // row 0 (whole_cg::g_apply's arithmetic), K^T when `transpose`, src / m
  // when `scale`.
  __device__ void products(const float* src, bool scale, bool transpose,
                           float* out) {
    __syncthreads();  // src was written by other threads
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      int v[D + 1];
#pragma unroll
      for (int j = 0; j <= D; ++j) v[j] = lv[(D + 1) * e + j];
      float xs[D + 1][D];
#pragma unroll
      for (int j = 0; j <= D; ++j) {
        const float s = scale ? minv[v[j]] : 1.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          xs[j][c] = scale ? src[D * v[j] + c] * s : src[D * v[j] + c];
        }
      }
      const float* kk0 = k + DD * e;
      float kk[DD];
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          kk[D * i + c] = transpose ? kk0[D * c + i] : kk0[D * i + c];
        }
      }
      float rows[D + 1][D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float dd[D];
#pragma unroll
        for (int c = 0; c < D; ++c) dd[c] = xs[j + 1][c] - xs[0][c];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float ti = kk[D * i] * dd[0];
#pragma unroll
          for (int c = 1; c < D; ++c) ti = ti + kk[D * i + c] * dd[c];
          rows[j + 1][i] = ti;
          rows[0][i] = j == 0 ? ti : rows[0][i] + ti;
        }
      }
#pragma unroll
      for (int i = 0; i < D; ++i) rows[0][i] = -rows[0][i];
#pragma unroll
      for (int j = 0; j <= D; ++j) send(out, e, j, rows[j]);
    }
  }

  // K of the rank's elements and their force rows into their receive slots
  // of `out`, at the local positions (the single variant's element pass).
  __device__ void prep(float* out) {
    __syncthreads();  // the positions were written by other threads
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      int v[D + 1];
#pragma unroll
      for (int j = 0; j <= D; ++j) v[j] = lv[(D + 1) * e + j];
      const int g = e0 + e;
      float xe[DD], re[DD], kk[DD], h[DD];
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          xe[D * i + j] = pos[D * v[j + 1] + i] - pos[D * v[0] + i];
        }
      }
#pragma unroll
      for (int i = 0; i < DD; ++i) re[i] = a.ref_inv[DD * g + i];
      fem::nh_chain<D, false>(xe, re, a.mu, a.lam, a.half_lam, kk, h);
      const float nv = -a.volume[g];
#pragma unroll
      for (int i = 0; i < DD; ++i) k[DD * e + i] = nv * kk[i];
      float t[fem::rows_floats(D)];
      fem::column_rows<D>(nv, h, t);
#pragma unroll
      for (int j = 0; j <= D; ++j) send(out, e, j, t + D * j);
    }
  }

  // Owned particle l's sum of its plan rows, in the plan's order, from its
  // receive slots of `buf` here (up to kChunk loaded before any is added).
  // The sum goes to row l of `wb` here and in every other CTA that holds
  // the particle (pushed; the caller's barrier publishes it), and to w.
  __device__ void owned_sum(const float* buf, int l, float* wb, float* w) {
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.0f;
    const int end = sptr[l + 1];
    for (int k0 = sptr[l]; k0 < end; k0 += kChunk) {
      Row v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j < end) {
          v[j] = *reinterpret_cast<const Row*>(buf + RS * (k0 + j));
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j < end) {
          acc[0] += v[j].x;
          acc[1] += v[j].y;
          if constexpr (D == 3) acc[2] += v[j].z;
        }
      }
    }
    Row out;
    out.x = acc[0];
    out.y = acc[1];
    if constexpr (D == 3) {
      out.z = acc[2];
      out.w = 0.0f;
    }
    *reinterpret_cast<Row*>(wb + RS * l) = out;
    for (int i = pptr[l]; i < pptr[l + 1]; ++i) {
      const int code = pcodes[i];
      *reinterpret_cast<Row*>(at(wb + RS * (code & 0xffff), code >> 16)) =
          out;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) w[c] = acc[c];
  }

  // Every owned particle's sum of `buf` into `wb` of its holders.
  __device__ void owned_sums(const float* buf, float* wb) {
    for (int l = threadIdx.x; l < no; l += blockDim.x) {
      float w[D];
      owned_sum(buf, l, wb, w);
    }
  }

  // The velocity solve of one substep; leaves x and returns (it, |r|^2).
  // An operator apply: the products, a barrier, the owners' sums pushed to
  // the holders, a barrier, then every CTA reads the sums of its local
  // particles.  Where a dot product follows an apply, the owners finish
  // their particles' step at once and push the CTA's partial with the sums,
  // so that one barrier serves both.
  __device__ void solve(int* it_out, float* delta_out) {
    const float dt2 = a.dt2;
    float* p = next_part();
    prep(p);
    sync();
    owned_sums(p, wb0);
    sync();
    // b = v + dt f / m into x (x_0 = b).
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
      const float mi = minv[l];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        x[D * l + c] = vel[D * l + c] + a.dt * wb0[RS * l + c] * mi;
      }
    }
    float part = 0.0f;
    if (a.normal) {
      // r = A^T b (the rhs), then q = op(x_0) = A^T A b: the products of
      // A^T b and of A x_0 (x_0 = b) share a phase.
      float* p1 = next_part();
      float* p0 = next_part();
      products(x, true, true, p1);  // z = b / m
      products(x, false, false, p0);
      sync();
      owned_sums(p1, wb1);
      owned_sums(p0, wb0);
      sync();
      for (int l = threadIdx.x; l < nl; l += blockDim.x) {
        const float mi = minv[l];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * l + c;
          r[i] = x[i] - dt2 * wb1[RS * l + c];
          q[i] = x[i] - dt2 * wb0[RS * l + c] * mi;  // u = A x_0
        }
      }
      p = next_part();
      products(q, true, true, p);  // z = u / m
      sync();
      for (int l = threadIdx.x; l < no; l += blockDim.x) {
        float w[D];
        owned_sum(p, l, wb0, w);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * l + c;
          const float qc = q[i] - dt2 * w[c];
          const float ri = r[i] - qc;
          q[i] = qc;
          r[i] = ri;
          d[i] = ri;
          part += ri * ri;
        }
      }
      publish(part);
      sync();
      for (int l = no + threadIdx.x; l < nl; l += blockDim.x) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * l + c;
          const float qc = q[i] - dt2 * wb0[RS * l + c];
          const float ri = r[i] - qc;
          q[i] = qc;
          r[i] = ri;
          d[i] = ri;
        }
      }
    } else {
      p = next_part();
      products(x, false, false, p);
      sync();
      for (int l = threadIdx.x; l < no; l += blockDim.x) {
        float w[D];
        owned_sum(p, l, wb0, w);
        const float mi = minv[l];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * l + c;
          const float qc = x[i] - dt2 * w[c] * mi;
          const float ri = x[i] - qc;
          q[i] = qc;
          r[i] = ri;
          d[i] = ri;
          part += ri * ri;
        }
      }
      publish(part);
      sync();
      for (int l = no + threadIdx.x; l < nl; l += blockDim.x) {
        const float mi = minv[l];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const int i = D * l + c;
          const float qc = x[i] - dt2 * wb0[RS * l + c] * mi;
          const float ri = x[i] - qc;
          q[i] = qc;
          r[i] = ri;
          d[i] = ri;
        }
      }
    }
    float delta = total();
    int it = 0;
    while (it < a.max_iter && delta > a.tol) {
      // q = op(d) and the partials of d . q.
      p = next_part();
      products(d, false, false, p);
      sync();
      part = 0.0f;
      if (a.normal) {
        owned_sums(p, wb0);
        sync();
        for (int l = threadIdx.x; l < nl; l += blockDim.x) {
          const float mi = minv[l];
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const int i = D * l + c;
            q[i] = d[i] - dt2 * wb0[RS * l + c] * mi;  // u = A d
          }
        }
        p = next_part();
        products(q, true, true, p);  // z = u / m
        sync();
        for (int l = threadIdx.x; l < no; l += blockDim.x) {
          float w[D];
          owned_sum(p, l, wb0, w);
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const int i = D * l + c;
            const float qc = q[i] - dt2 * w[c];
            q[i] = qc;
            part += d[i] * qc;
          }
        }
        publish(part);
        sync();
        for (int l = no + threadIdx.x; l < nl; l += blockDim.x) {
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const int i = D * l + c;
            q[i] = q[i] - dt2 * wb0[RS * l + c];
          }
        }
      } else {
        for (int l = threadIdx.x; l < no; l += blockDim.x) {
          float w[D];
          owned_sum(p, l, wb0, w);
          const float mi = minv[l];
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const int i = D * l + c;
            const float qc = d[i] - dt2 * w[c] * mi;
            q[i] = qc;
            part += d[i] * qc;
          }
        }
        publish(part);
        sync();
        for (int l = no + threadIdx.x; l < nl; l += blockDim.x) {
          const float mi = minv[l];
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const int i = D * l + c;
            q[i] = d[i] - dt2 * wb0[RS * l + c] * mi;
          }
        }
      }
      const float alpha = delta / total();
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
      publish(part);
      sync();
      const float delta_next = total();
      const float beta = delta_next / delta;
      // Every CTA updates its own copy: the next products' barrier orders
      // it before any read.
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
};

// The cluster variant: the grid is one cluster (the launch sets the
// cluster dimension to the grid) of kClusterThreads threads a CTA.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_fused_frame_kernel(const __grid_constant__ FemFusedFrameArgs a) {
  constexpr int RS = row_stride(D);
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[33];
  ClusterFrame<D> fr{a, cg::this_cluster()};
  fr.nr = static_cast<int>(fr.cl.num_blocks());
  fr.me = static_cast<int>(fr.cl.block_rank());
  fr.e0 = a.cl_elem_ptr[fr.me];
  fr.ne = a.cl_elem_ptr[fr.me + 1] - fr.e0;
  const int first = a.cl_local_ptr[fr.me];
  fr.nl = a.cl_local_ptr[fr.me + 1] - first;
  const int first_owned = a.cl_owned_ptr[fr.me];
  fr.no = a.cl_owned_ptr[fr.me + 1] - first_owned;
  const size_t ne = a.cl_elements;
  const size_t cap = a.cl_cap;
  const size_t rows = D * cap;
  fr.parts = smem;  // first: 16-byte aligned rows
  fr.part_floats = static_cast<int>(RS * a.cl_entries);
  fr.wb0 = fr.parts + kParts * RS * a.cl_entries;  // 16-byte aligned too
  fr.wb1 = fr.wb0 + RS * cap;
  fr.k = fr.wb1 + RS * cap;
  fr.pos = fr.k + D * D * ne;
  fr.vel = fr.pos + rows;
  fr.velg = fr.vel + rows;
  fr.x = fr.velg + rows;
  fr.r = fr.x + rows;
  fr.d = fr.r + rows;
  fr.q = fr.d + rows;
  fr.minv = fr.q + rows;
  fr.dots = fr.minv + cap;
  fr.lv = reinterpret_cast<int*>(fr.dots + 2 * kMaxRanks);
  fr.rdest = fr.lv + (D + 1) * ne;
  fr.ids = fr.rdest + (D + 1) * ne;
  fr.sptr = fr.ids + cap;
  fr.pptr = fr.sptr + cap + 1;
  fr.pcodes = fr.pptr + cap + 1;
  fr.red = red;
  fr.pbuf = 0;
  fr.dbuf = 0;
  fr.barriers = 0;
  // The rank's tables and its local particles' state into shared memory.
  for (int i = threadIdx.x; i < (D + 1) * fr.ne; i += blockDim.x) {
    fr.lv[i] = a.cl_elem_local[(D + 1) * fr.e0 + i];
    fr.rdest[i] = a.cl_row_dest[(D + 1) * fr.e0 + i];
  }
  const int rbase = a.cl_recv_ptr[first_owned];
  const int pbase = a.cl_push_ptr[first_owned];
  for (int l = threadIdx.x; l <= fr.no; l += blockDim.x) {
    fr.sptr[l] = a.cl_recv_ptr[first_owned + l] - rbase;
    fr.pptr[l] = a.cl_push_ptr[first_owned + l] - pbase;
  }
  const int pushes = a.cl_push_ptr[first_owned + fr.no] - pbase;
  for (int i = threadIdx.x; i < pushes; i += blockDim.x) {
    fr.pcodes[i] = a.cl_push_codes[pbase + i];
  }
  for (int l = threadIdx.x; l < fr.nl; l += blockDim.x) {
    const int g = a.cl_local_ids[first + l];
    fr.ids[l] = g;
    fr.minv[l] = 1.0f / a.mass[g];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      fr.pos[D * l + c] = a.pos_in[D * g + c];
      fr.vel[D * l + c] = a.vel_in[D * g + c];
      fr.velg[D * l + c] = a.velg_in[D * g + c];
    }
  }
  // Every CTA of the cluster is running before any stores into another's
  // shared memory: the first rows are sent after this barrier.
  fr.sync();
  for (int s = 0; s < a.sim_count; ++s) {
    int it;
    float delta;
    fr.solve(&it, &delta);
    // The implicit advection of every local particle (vel_in is x).
    for (int l = threadIdx.x; l < fr.nl; l += blockDim.x) {
      const int i = D * l;
      fem::advect_implicit_particle<D>(
          fr.pos + i, fr.x + i, fr.velg + i, a.centers, a.radii, a.n_obst,
          a.gravity, a.dt, a.decay, fr.pos + i, fr.vel + i, fr.velg + i);
    }
    if (fr.me == 0 && threadIdx.x == 0) {
      a.iters[s] = it;
      a.res[s] = delta;
    }
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
  fr.sync();  // no CTA leaves while another may still read its rows
  if (a.barriers != nullptr && fr.me == 0 && threadIdx.x == 0) {
    *a.barriers = fr.barriers;
  }
}

template <typename F>
int with_cluster_kernel(int dim, F&& f) {
  if (dim == 3) return f(cluster_fused_frame_kernel<3>);
  if (dim == 2) return f(cluster_fused_frame_kernel<2>);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Floats of scratch a frame needs: minv (N), x, r, d, q, u, w, z (D N
// each), K (D^2 E) and the contribution rows ((D+1) D E).
extern "C" long long fem_fused_frame_scratch_floats(int dim, int num_elements,
                                                    int num_particles) {
  return static_cast<long long>(num_particles) +
         7LL * dim * num_particles +
         static_cast<long long>(dim) * dim * num_elements +
         static_cast<long long>(dim + 1) * dim * num_elements;
}

// The single variant: launches the instance of args->dim (2 or 3; anything
// else: cudaErrorInvalidValue, nothing launched).
extern "C" int fem_fused_frame(const FemFusedFrameArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (args->dim == 3) {
    fused_frame_kernel<3><<<1, kThreads, 0, st>>>(*args);
  } else if (args->dim == 2) {
    fused_frame_kernel<2><<<1, kThreads, 0, st>>>(*args);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device's limits for the cluster variant's instance of `dim`: the most
// CTAs a cluster of it can have, the most dynamic shared memory a CTA can
// take and the SMs.  Returns 0 or a CUDA error.
extern "C" int fem_fused_frame_limits(int dim, int* max_cluster,
                                      int* smem_optin, int* sms) {
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_limits(kernel, kClusterThreads, max_cluster,
                               smem_optin, sms);
  });
}

// Bytes of dynamic shared memory of the cluster variant's CTA: `ne`
// elements, local vectors of `cap` rows, `entries` plan rows and `pushes`
// push codes of its owned particles.
extern "C" long long fem_fused_frame_cluster_smem(int ne, int cap,
                                                  int entries, int pushes,
                                                  int dim) {
  return static_cast<long long>(
      sizeof(float) * cluster_smem_words(ne, cap, entries, pushes, dim));
}

// Checks that one cluster of `cluster` CTAs of the cluster variant's
// instance of `dim`, `smem` bytes of dynamic shared memory each, can be
// placed on the device; writes how many could be active at once.  Returns
// 0, a CUDA error, -2 (shared memory too large) or -4 (the cluster cannot
// be scheduled).
extern "C" int fem_fused_frame_cluster_fit(int cluster, int smem, int dim,
                                           int* max_active) {
  *max_active = 0;
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_fit(kernel, kClusterThreads, cluster,
                            static_cast<size_t>(smem), max_active);
  });
}

// The cluster variant: launches the instance of args->dim as one cluster of
// `cluster` CTAs with `smem` bytes of dynamic shared memory each.
extern "C" int fem_fused_frame_cluster(const FemFusedFrameArgs* args,
                                       int cluster, int smem, void* stream) {
  FemFusedFrameArgs a = *args;
  return with_cluster_kernel(a.dim, [&](auto kernel) {
    return fem::cluster_launch(kernel, &a, cluster, kClusterThreads, smem,
                               stream);
  });
}

extern "C" const char* fem_fused_frame_error(int code) {
  if (code == -2) return "the CTA's shared memory exceeds the device's limit";
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
