// The unblocked operator and the reference CG over one thread-block
// cluster, shared by the cluster variants of the unblocked whole frame K11b
// (fused_frame.cu), of the whole solve K4 (fused_cg.cu) and of the
// edge-matrix CG K11a (edge_cg.cu), so that their operator and their loop
// cannot drift apart.
//
// Semantics (the reference CG, as whole_cg.cuh):
//   apply_a(v)  = v - dt^2 G(K) v / m
//   apply_at(v) = v - dt^2 G(K^T) (v / m)
//   normal equations (A^T A x = A^T b) when `normal`, else A x = b;
//   x_0 = b (not the A^T A rhs); iterate while it < max_iter && |r|^2 > tol.
// G(K) x sums, per element, t_j = K_e (x_{v_{j+1}} - x_{v_0}) into vertex
// j+1 and -sum_j t_j into vertex 0.  Templated on the dimension D in
// {2, 3}.
//
// Design (K11b's cluster variant).  CTA `rank` owns a
// contiguous range of elements, in the mesh's own order, and keeps in its
// shared memory their K and their vertices as local indices, and its own
// copy of every particle vector (x, r, d, q, 1/m and the caller's) for its
// local particles: those its elements touch.  Each particle is owned by one
// CTA, assigned on the host (experiments/fused_frame.cluster_assignment).
// An operator apply:
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
// fire-and-forget store.  Where a dot product follows an apply, the owners
// finish their particles' step at once and store the CTA's partial into
// every CTA with the sums, so one barrier serves both; every CTA adds the
// partials in rank order, so alpha and beta agree everywhere and two runs
// are bit-identical.  A solve (ClusterSolve::solve) meets, in
// normal-equations mode, 6 barriers (the element pass and its sums; A^T b
// with the first product of A x_0 and their sums; the A^T half of op(x_0)
// and its sums with |r_0|^2) and 5 an iteration (two applies, the second's
// sums with d.q, and r.r); in plain mode 4 and 3.  A solve from a given b
// (ClusterSolve::solve_from_b: the edge-matrix CG K11a, edge_cg.cu) has no
// element pass, so 2 barriers fewer.  A cluster of one CTA
// syncs with __syncthreads().  The per-particle sums are those of
// whole_cg.cuh (the plan's order); the dot products sum per CTA, then over
// the CTAs in rank order, so a solve differs from whole_cg.cuh's only in
// the rounding of its dot products.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace fem::cluster_cg {

namespace cg = cooperative_groups;

// Threads a CTA.
constexpr int kThreads = 256;
// Copies of the receive slots: two, as one phase may write two (the rhs's
// A^T b and the first product of A x_0).
constexpr int kParts = 2;
// The most CTAs of a cluster (Hopper's non-portable limit).
constexpr int kMaxRanks = 16;

// Floats a contribution row takes: D padded to a whole vector (16 bytes in
// 3D, 8 in 2D), so that a row stored into another CTA's shared memory is
// one transaction.
__host__ __device__ constexpr int row_stride(int dim) {
  return dim == 3 ? 4 : 2;
}

// The cluster's assignment of elements and particles (device pointers;
// experiments/fused_frame.py: cluster_assignment).
struct Plan {
  const int* elem_ptr;    // (C+1,) each rank's range of elements
  const int* local_ptr;   // (C+1,) each rank's span of local_ids
  const int* local_ids;   // particle id of each local particle, a rank's
                          // owned ones first
  const int* owned_ptr;   // (C+1,) each rank's span of owned particles
                          // (its first local ones), flat over the ranks
  const int* elem_local;  // ((D+1) E,) each element's vertices as local
                          // indices in its rank
  const int* row_dest;    // ((D+1) E,) where each element row goes: its
                          // particle's owner rank * 65536 + slot there
  const int* recv_ptr;    // (N+1,) each owned particle's span of its rank's
                          // receive slots, in the plan's order
  const int* push_ptr;    // (N+1,) each owned particle's span of push_codes
  const int* push_codes;  // the other ranks holding it, as rank * 65536 +
                          // its local index there
  int cap;       // rows of each local vector in shared memory
  int elements;  // most elements of a rank
  int entries;   // most receive slots of a rank (its owned particles' plan
                 // rows)
  int pushes;    // most push codes of a rank's owned particles
};

// 4-byte words of a cluster CTA's dynamic shared memory: kParts copies of
// its receive slots (`entries` rows), two receive buffers of per-particle
// sums (cap rows), the K of its elements (ne of them), `vectors` local
// vectors of cap rows of D and 1/m (cap), the dot partials (two copies of
// kMaxRanks), then the elements' local vertex ids and row destinations, the
// local particles' ids, the owned particles' spans of receive slots and of
// push codes (cap + 1 each) and the push codes.
__host__ __device__ inline size_t smem_words(int ne, int cap, int entries,
                                             int pushes, int dim,
                                             int vectors) {
  const size_t rs = row_stride(dim);
  return static_cast<size_t>(kParts) * rs * entries + 2 * rs * cap +
         static_cast<size_t>(dim) * dim * ne +
         static_cast<size_t>(cap) * (vectors * dim + 1) + 2 * kMaxRanks +
         2 * static_cast<size_t>(dim + 1) * ne + static_cast<size_t>(cap) +
         2 * (static_cast<size_t>(cap) + 1) + pushes;
}

// Sum of `v` over the CTA in a fixed order; every thread gets the total.
__device__ inline float cta_sum(float v, float* red) {
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

// `Args` is the kernel's argument struct (a __grid_constant__ parameter),
// whose fields dt, dt2, tol, normal and max_iter the solve reads where they
// lie: in the parameter space, as values the same for every thread.
template <int D, typename Args>
struct ClusterSolve {
  static constexpr int DD = D * D;
  static constexpr int RS = row_stride(D);
  static constexpr int kChunk = 8;  // plan rows loaded before any is added
  using Row = typename std::conditional<D == 3, float4, float2>::type;

  const Args& a;
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
  float* vel;  // local vectors, (cap, D) each
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

  // This CTA's rank, its ranges of the plan `p` and the carve of `smem`
  // that every caller shares: the receive slots first (16-byte aligned
  // rows), the two sum buffers, then `ne` elements' K; returns the first
  // free word after them.
  __device__ float* begin(const Plan& p, float* smem) {
    nr = static_cast<int>(cl.num_blocks());
    me = static_cast<int>(cl.block_rank());
    e0 = p.elem_ptr[me];
    ne = p.elem_ptr[me + 1] - e0;
    nl = p.local_ptr[me + 1] - p.local_ptr[me];
    no = p.owned_ptr[me + 1] - p.owned_ptr[me];
    parts = smem;
    part_floats = static_cast<int>(RS * p.entries);
    wb0 = parts + kParts * RS * p.entries;  // 16-byte aligned too
    wb1 = wb0 + RS * p.cap;
    k = wb1 + RS * p.cap;
    pbuf = 0;
    dbuf = 0;
    barriers = 0;
    return k + DD * static_cast<size_t>(p.elements);
  }

  // After the caller's vectors and 1/m: the dot partials and the int
  // tables, carved from `next`.
  __device__ void carve_tables(const Plan& p, float* next) {
    dots = next;
    lv = reinterpret_cast<int*>(dots + 2 * kMaxRanks);
    rdest = lv + (D + 1) * static_cast<size_t>(p.elements);
    ids = rdest + (D + 1) * static_cast<size_t>(p.elements);
    sptr = ids + p.cap;
    pptr = sptr + p.cap + 1;
    pcodes = pptr + p.cap + 1;
  }

  // The rank's element tables and its owned particles' spans and push codes
  // into shared memory (the caller's barrier publishes them).
  __device__ void stage(const Plan& p) {
    for (int i = threadIdx.x; i < (D + 1) * ne; i += blockDim.x) {
      lv[i] = p.elem_local[(D + 1) * e0 + i];
      rdest[i] = p.row_dest[(D + 1) * e0 + i];
    }
    const int first_owned = p.owned_ptr[me];
    const int rbase = p.recv_ptr[first_owned];
    const int pbase = p.push_ptr[first_owned];
    for (int l = threadIdx.x; l <= no; l += blockDim.x) {
      sptr[l] = p.recv_ptr[first_owned + l] - rbase;
      pptr[l] = p.push_ptr[first_owned + l] - pbase;
    }
    const int pushes = p.push_ptr[first_owned + no] - pbase;
    for (int i = threadIdx.x; i < pushes; i += blockDim.x) {
      pcodes[i] = p.push_codes[pbase + i];
    }
  }

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

  // The velocity solve: prep(out) writes the rank's elements' K into k and
  // sends their force rows into the receive slots `out` (the element pass,
  // two barriers with its sums); then b = vel + dt f / m, x_0 = b and the
  // CG (solve_from_b).  Leaves x and returns (it, |r|^2).
  template <typename Prep>
  __device__ void solve(Prep&& prep, int* it_out, float* delta_out) {
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
    solve_from_b(it_out, delta_out);
  }

  // The CG from x_0 = b, which every CTA holds in x for its local
  // particles (the CTA barrier that opens products() publishes it to the
  // CTA's threads): r = rhs - op(x_0) with rhs = A^T b or b, then the loop.
  // Leaves x and returns (it, |r|^2).  In normal-equations mode it meets 4
  // barriers and 5 an iteration, in plain mode 2 and 3.  An operator
  // apply: the products, a barrier, the owners' sums pushed to the
  // holders, a barrier, then every CTA reads the sums of its local
  // particles.  Where a dot product follows an apply, the owners finish
  // their particles' step at once and push the CTA's partial with the
  // sums, so that one barrier serves both.
  __device__ void solve_from_b(int* it_out, float* delta_out) {
    const float dt2 = a.dt2;
    float* p;
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

}  // namespace fem::cluster_cg
