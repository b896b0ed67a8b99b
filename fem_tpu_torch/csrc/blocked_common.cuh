// Per-block pieces of the blocked kernels: one thread block works on one
// locality block (fem_tpu_torch/ops/blocking.py) at a time.  The blocked
// prep K2, its explicit mode K7b, the blocked matvec K3 and the blocked
// assembly K7a (blocked.cu) and the whole-frame kernels K5
// (blocked_frame.cu) and K8 (explicit_frame.cu) are built from these
// functions, so K5's prep is K2's per-block body, its operator applies are
// K3's, and K8's gradient is K7b's.  Every function is templated on the
// dimension D in {2, 3}: an element has D + 1 vertices and D edges, a
// particle row D components.
//
// A block gathers its <= Pb particles' rows into shared memory (`xs`,
// (Pb, D)), works on its <= Eb elements there, and writes one contribution
// row per (element, local vertex) into shared memory (`t`, (Eb, D+1, D));
// each local particle slot then sums its rows through the block's local
// plan in a fixed order.  No float atomics anywhere, so results do not
// depend on scheduling.
//
// The JAX kernels do the same with one-hot incidence matrices S_b on the
// MXU (edges = S_b x_b, assembly = S_b^T t), because Mosaic has no gather;
// here both are direct indexed loads.

#pragma once

#include <cuda_runtime.h>

#include "element_chain.cuh"

namespace fem {

// Device pointers of a Blocking's static tables; the Python side mirrors
// this layout (ops/blocked_kernels.py: BlockTablesC).
struct BlockTables {
  const int* block_particles;  // (B, Pb) global particle id of each slot
  const int* plus;             // (B, Eb*D) local slot of vertex j+1, row e*D+j
  const int* minus;            // (B, Eb*D) local slot of vertex 0
  const float* ref_inv;        // (B*Eb, D, D)
  const float* volume;         // (B*Eb,)
  const int* block_elements;   // (B,) real elements of each block (the rest pad)
  const int* local_ptr;        // (B, Pb+1) offsets into local_rows[b]
  const int* local_rows;       // (B, Eb*(D+1)) contribution rows e*(D+1)+l by slot
  int num_blocks;
  int eb;
  int pb;
  int dim;                     // D: the host entries launch the D instance
};

// xs[D*p + c] = src[block_particles[b, p], c] for every slot p of block b.
// src may have been written by other thread blocks of the same launch (the
// whole-frame kernel), so it is read past L1 (__ldcg).
template <int D>
__device__ __forceinline__ void load_block_rows(const BlockTables& T, int b,
                                                const float* src, float* xs) {
  const int* ids = T.block_particles + b * T.pb;
  for (int i = threadIdx.x; i < D * T.pb; i += blockDim.x) {
    const int p = i / D;
    xs[i] = __ldcg(src + D * ids[p] + (i - D * p));
  }
}

// Edge matrix x[D*i + j] = xs[v_{j+1}][i] - xs[v_0][i] of element e of
// block b.
template <int D>
__device__ __forceinline__ void block_edges(const BlockTables& T, int b, int e,
                                            const float* xs, float* x) {
  const int row = (b * T.eb + e) * D;
  const float* x0 = xs + D * T.minus[row];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float* xj = xs + D * T.plus[row + j];
#pragma unroll
    for (int i = 0; i < D; ++i) x[D * i + j] = xj[i] - x0[i];
  }
}

// Contribution rows t ((D+1) x D) of one element's columns s*h (row-major
// D x D): column j to local vertex j+1, minus their sum (summed j = 0, 1,
// ... left to right) to vertex 0.
template <int D>
__device__ __forceinline__ void column_rows(float s, const float* h, float* t) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float c = s * h[D * i + j];
      t[D * (j + 1) + i] = c;
      sum = j == 0 ? c : sum + c;
    }
    t[i] = -sum;
  }
}

// Prep of one real element from its edge matrix x, its rest-edge inverse
// r_src (D*D) and its volume: K_e = -V k into k_out (D*D), and its force
// contribution rows into t ((D+1)*D) from H_e = -V h — the same arithmetic
// as K1 followed by K4's force assembly; material M.
template <int D, int M>
__device__ __forceinline__ void element_prep_from(const float* x,
                                                  const float* r_src,
                                                  float volume,
                                                  const MaterialParams& m,
                                                  float* k_out, float* t) {
  constexpr int DD = D * D;
  float r[DD], k[DD], h[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = r_src[i];
  material_chain<D, M>(x, r, m, k, h);
  const float nv = -volume;
#pragma unroll
  for (int i = 0; i < DD; ++i) k_out[i] = nv * k[i];
  column_rows<D>(nv, h, t);
}

// Prep of real element e of block b (element_prep_from on the block's
// tables).
template <int D, int M>
__device__ __forceinline__ void element_prep(const BlockTables& T, int b,
                                             int e, const float* xs,
                                             const MaterialParams& m,
                                             float* k_out, float* t) {
  float x[D * D];
  block_edges<D>(T, b, e, xs, x);
  const int slot = b * T.eb + e;
  element_prep_from<D, M>(x, T.ref_inv + D * D * slot, T.volume[slot], m,
                          k_out, t);
}

// Explicit gradient of one real element from its edge matrix x, its
// rest-edge inverse r_src (D*D) and its volume: the contribution rows t
// ((D+1)*D) of G_e = +V g (material M's gradient columns) — the same
// arithmetic as K6 followed by the blocked assembly K7a.
template <int D, int M>
__device__ __forceinline__ void element_grad_from(const float* x,
                                                  const float* r_src,
                                                  float volume,
                                                  const MaterialParams& m,
                                                  float* t) {
  constexpr int DD = D * D;
  float r[DD], g[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = r_src[i];
  material_grad_cols<D, M>(x, r, m, g);
  column_rows<D>(volume, g, t);
}

// Explicit gradient of real element e of block b (element_grad_from on the
// block's tables).
template <int D, int M>
__device__ __forceinline__ void element_grad(const BlockTables& T, int b,
                                             int e, const float* xs,
                                             const MaterialParams& m,
                                             float* t) {
  float x[D * D];
  block_edges<D>(T, b, e, xs, x);
  const int slot = b * T.eb + e;
  element_grad_from<D, M>(x, T.ref_inv + D * D * slot, T.volume[slot], m, t);
}

// Operator rows of real element e of block b: t_j = K_e (x_{v_{j+1}} -
// x_{v_0}) (K_e^T when `transpose`) to local vertex j+1, -sum_j t_j to
// vertex 0.
template <int D>
__device__ __forceinline__ void element_apply(const BlockTables& T, int b,
                                              int e, const float* xs,
                                              const float* k, bool transpose,
                                              float* t) {
  float kk[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      kk[D * i + c] = transpose ? k[D * c + i] : k[D * i + c];
    }
  }
  const int row = (b * T.eb + e) * D;
  const float* x0 = xs + D * T.minus[row];
  float sum[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float* xj = xs + D * T.plus[row + j];
    float d[D];
#pragma unroll
    for (int c = 0; c < D; ++c) d[c] = xj[c] - x0[c];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float ti = kk[D * i] * d[0];
#pragma unroll
      for (int c = 1; c < D; ++c) ti = ti + kk[D * i + c] * d[c];
      t[D * (j + 1) + i] = ti;
      sum[i] = j == 0 ? ti : sum[i] + ti;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) t[i] = -sum[i];
}

// out[D*p + c] = sum of block b's contribution rows t landing on local slot
// p, in the local plan's order (padded slots get 0).
template <int D>
__device__ __forceinline__ void block_slot_sums(const BlockTables& T, int b,
                                                const float* t, float* out) {
  const int* ptr = T.local_ptr + b * (T.pb + 1);
  const int* rows = T.local_rows + b * T.eb * (D + 1);
  for (int p = threadIdx.x; p < T.pb; p += blockDim.x) {
    float a[D];
#pragma unroll
    for (int c = 0; c < D; ++c) a[c] = 0.0f;
    const int end = ptr[p + 1];
    for (int q = ptr[p]; q < end; ++q) {
      const float* row = t + D * rows[q];
#pragma unroll
      for (int c = 0; c < D; ++c) a[c] += row[c];
    }
#pragma unroll
    for (int c = 0; c < D; ++c) out[D * p + c] = a[c];
  }
}

// Sum over particle p's block slots (slot plan, CSR) of the per-slot
// partials (B*Pb, D), in ascending slot order.  Read past L1: the partials
// may come from other thread blocks of the same launch.
template <int D>
__device__ __forceinline__ void particle_slot_sum(const int* ptr,
                                                  const int* rows,
                                                  const float* partials, int p,
                                                  float* out) {
  float a[D];
#pragma unroll
  for (int c = 0; c < D; ++c) a[c] = 0.0f;
  const int end = ptr[p + 1];
  for (int q = ptr[p]; q < end; ++q) {
    const float* row = partials + D * rows[q];
#pragma unroll
    for (int c = 0; c < D; ++c) a[c] += __ldcg(row + c);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) out[c] = a[c];
}

// Floats of one element's contribution rows: (D+1) x D.
__host__ __device__ constexpr int rows_floats(int dim) {
  return (dim + 1) * dim;
}

// Dynamic shared memory of one block's working set: xs (Pb, D) + t (Eb,
// D+1, D).
__host__ __device__ inline size_t block_work_floats(int eb, int pb, int dim) {
  return static_cast<size_t>(dim) * pb +
         static_cast<size_t>(rows_floats(dim)) * eb;
}

}  // namespace fem
