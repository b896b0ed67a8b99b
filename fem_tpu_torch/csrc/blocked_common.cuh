// Per-block pieces of the blocked kernels: one thread block works on one
// locality block (fem_tpu_torch/ops/blocking.py) at a time.  The blocked
// prep K2, its explicit mode K7b, the blocked matvec K3 and the blocked
// assembly K7a (blocked.cu) and the whole-frame kernels K5
// (blocked_frame.cu) and K8 (explicit_frame.cu) are built from these
// functions, so K5's prep is K2's per-block body, its operator applies are
// K3's, and K8's gradient is K7b's.
//
// A block gathers its <= Pb particles' rows into shared memory (`xs`), works
// on its <= Eb tets there, and writes one contribution row per (tet, local
// vertex) into shared memory (`t`, (Eb, 4, 3)); each local particle slot
// then sums its rows through the block's local plan in a fixed order.  No
// float atomics anywhere, so results do not depend on scheduling.
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
  const int* plus;             // (B, Eb*3) local slot of vertex j+1, row e*3+j
  const int* minus;            // (B, Eb*3) local slot of vertex 0
  const float* ref_inv;        // (B*Eb, 3, 3)
  const float* volume;         // (B*Eb,)
  const int* block_elements;   // (B,) real tets of each block (the rest pad)
  const int* local_ptr;        // (B, Pb+1) offsets into local_rows[b]
  const int* local_rows;       // (B, Eb*4) contribution rows e*4+l by slot
  int num_blocks;
  int eb;
  int pb;
};

// xs[3*p + c] = src[block_particles[b, p], c] for every slot p of block b.
// src may have been written by other thread blocks of the same launch (the
// whole-frame kernel), so it is read past L1 (__ldcg).
__device__ __forceinline__ void load_block_rows(const BlockTables& T, int b,
                                                const float* src, float* xs) {
  const int* ids = T.block_particles + b * T.pb;
  for (int i = threadIdx.x; i < 3 * T.pb; i += blockDim.x) {
    const int p = i / 3;
    xs[i] = __ldcg(src + 3 * ids[p] + (i - 3 * p));
  }
}

// Edge matrix x[3*i + j] = xs[v_{j+1}][i] - xs[v_0][i] of tet e of block b.
__device__ __forceinline__ void block_edges(const BlockTables& T, int b, int e,
                                            const float* xs, float* x) {
  const int row = (b * T.eb + e) * 3;
  const float* x0 = xs + 3 * T.minus[row];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* xj = xs + 3 * T.plus[row + j];
#pragma unroll
    for (int i = 0; i < 3; ++i) x[3 * i + j] = xj[i] - x0[i];
  }
}

// Contribution rows t (12) of one tet's columns s*h (row-major 3x3): column
// j to local vertex j+1, minus their sum to vertex 0.
__device__ __forceinline__ void column_rows(float s, const float* h, float* t) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float c0 = s * h[3 * i], c1 = s * h[3 * i + 1], c2 = s * h[3 * i + 2];
    t[3 + i] = c0;
    t[6 + i] = c1;
    t[9 + i] = c2;
    t[i] = -((c0 + c1) + c2);
  }
}

// Prep of real tet e of block b: K_e = -V k into k_out (9), and its force
// contribution rows into t (12) from H_e = -V h — the same arithmetic as K1
// followed by K4's force assembly.
__device__ __forceinline__ void element_prep(const BlockTables& T, int b,
                                             int e, const float* xs, float mu,
                                             float lam, float half_lam,
                                             float* k_out, float* t) {
  float x[9], r[9], k[9], h[9];
  block_edges(T, b, e, xs, x);
  const int slot = b * T.eb + e;
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = T.ref_inv[9 * slot + i];
  nh_chain(x, r, mu, lam, half_lam, k, h);
  const float nv = -T.volume[slot];
#pragma unroll
  for (int i = 0; i < 9; ++i) k_out[i] = nv * k[i];
  column_rows(nv, h, t);
}

// Explicit gradient of real tet e of block b: the contribution rows t (12)
// of G_e = +V g (nh_grad_cols) — the same arithmetic as K6 followed by the
// blocked assembly K7a.
__device__ __forceinline__ void element_grad(const BlockTables& T, int b,
                                             int e, const float* xs, float mu,
                                             float lam, float* t) {
  float x[9], r[9], g[9];
  block_edges(T, b, e, xs, x);
  const int slot = b * T.eb + e;
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = T.ref_inv[9 * slot + i];
  nh_grad_cols(x, r, mu, lam, g);
  column_rows(T.volume[slot], g, t);
}

// Operator rows of real tet e of block b: t_j = K_e (x_{v_{j+1}} - x_{v_0})
// (K_e^T when `transpose`) to local vertex j+1, -sum_j t_j to vertex 0.
__device__ __forceinline__ void element_apply(const BlockTables& T, int b,
                                              int e, const float* xs,
                                              const float* k, bool transpose,
                                              float* t) {
  float kk[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      kk[3 * i + c] = transpose ? k[3 * c + i] : k[3 * i + c];
    }
  }
  const int row = (b * T.eb + e) * 3;
  const float* x0 = xs + 3 * T.minus[row];
  float sum[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* xj = xs + 3 * T.plus[row + j];
    const float d0 = xj[0] - x0[0];
    const float d1 = xj[1] - x0[1];
    const float d2 = xj[2] - x0[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ti = kk[3 * i] * d0 + kk[3 * i + 1] * d1 + kk[3 * i + 2] * d2;
      t[3 * (j + 1) + i] = ti;
      sum[i] = j == 0 ? ti : sum[i] + ti;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = -sum[i];
}

// out[3*p + c] = sum of block b's contribution rows t landing on local slot
// p, in the local plan's order (padded slots get 0).
__device__ __forceinline__ void block_slot_sums(const BlockTables& T, int b,
                                                const float* t, float* out) {
  const int* ptr = T.local_ptr + b * (T.pb + 1);
  const int* rows = T.local_rows + b * T.eb * 4;
  for (int p = threadIdx.x; p < T.pb; p += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    const int end = ptr[p + 1];
    for (int q = ptr[p]; q < end; ++q) {
      const float* row = t + 3 * rows[q];
      a0 += row[0];
      a1 += row[1];
      a2 += row[2];
    }
    out[3 * p] = a0;
    out[3 * p + 1] = a1;
    out[3 * p + 2] = a2;
  }
}

// Sum over particle p's block slots (slot plan, CSR) of the per-slot
// partials (B*Pb, 3), in ascending slot order.  Read past L1: the partials
// may come from other thread blocks of the same launch.
__device__ __forceinline__ void particle_slot_sum(const int* ptr,
                                                  const int* rows,
                                                  const float* partials, int p,
                                                  float* out) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  const int end = ptr[p + 1];
  for (int q = ptr[p]; q < end; ++q) {
    const float* row = partials + 3 * rows[q];
    a0 += __ldcg(row);
    a1 += __ldcg(row + 1);
    a2 += __ldcg(row + 2);
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

// Dynamic shared memory of one block's working set: xs (Pb, 3) + t (Eb, 4, 3).
__host__ __device__ inline size_t block_work_floats(int eb, int pb) {
  return static_cast<size_t>(3 * pb + 12 * eb);
}

}  // namespace fem
