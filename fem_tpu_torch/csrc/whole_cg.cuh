// The single-block reference CG over the unblocked element graph, shared by
// the whole-solve kernels K4 (fused_cg.cu), K11a (edge_cg.cu) and the
// unblocked whole frame K11b (fused_frame.cu), so that their operator and
// their loop cannot drift apart.
//
// Semantics (the reference CG, solver/implicit.py:289-341):
//   apply_a(v)  = v - dt^2 G(K) v / m
//   apply_at(v) = v - dt^2 G(K^T) (v / m)
//   normal equations (A^T A x = A^T b) when `normal`, else A x = b;
//   x_0 = b (not the A^T A rhs); iterate while it < max_iter && |r|^2 > tol.
// G(K) x sums, per element, t_j = K_e (x_{v_{j+1}} - x_{v_0}) into vertex
// j+1 and -sum_j t_j into vertex 0.  Everything is templated on the
// dimension D in {2, 3}.
//
// ONE thread block of kThreads threads runs the whole solve: phases are
// separated by __syncthreads() and nothing returns to the host between
// iterations.  An apply runs in two phases: per element, t_j into a scratch
// (E, D+1, D) buffer; then per particle, a sum over its CSR plan rows in a
// fixed order.  Dot products reduce in a fixed order (warp shuffles, then
// one warp), and there are no float atomics, so two runs give bit-identical
// results.  Vectors and scratch live in device memory (L2-resident at the
// flagship's size).

#pragma once

#include <cuda_runtime.h>

#include "element_chain.cuh"

namespace fem::whole_cg {

constexpr int kThreads = 1024;

// The block barrier.
struct CtaSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The block barrier, counted in *n (a per-thread count).
struct CountSync {
  int* n;
  __device__ __forceinline__ void operator()() const {
    ++*n;
    __syncthreads();
  }
};

struct Solve {
  const float* k;      // (E, D, D)
  const int* elem;     // (E, D+1)
  const int* ptr;      // (N + 1,)
  const int* rows;     // ((D+1) E,)
  const float* minv;   // (N,)
  float* t;            // ((D+1) E, D) per-element vertex contributions
  float* w;            // (N, D) G(K) product
  float* z;            // (N, D) v / m for apply_at
  int num_elements;
  int num_particles;
  float dt2;
};

// Sum of `v` over the block, the same order every call.  All threads return
// the total.
template <typename Sync = CtaSync>
__device__ inline float block_sum(float v, float* red, Sync sync = {}) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  sync();
  if (warp == 0) {
    v = red[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  sync();
  const float total = red[32];
  sync();  // red may be reused by the next call
  return total;
}

// Per particle, the sum of its contribution rows of s.t into dst.
template <int D, typename Sync = CtaSync>
__device__ void gather_rows(const Solve& s, float* __restrict__ dst,
                            Sync sync = {}) {
  for (int p = threadIdx.x; p < s.num_particles; p += kThreads) {
    float a[D];
#pragma unroll
    for (int c = 0; c < D; ++c) a[c] = 0.0f;
    const int end = s.ptr[p + 1];
    for (int q = s.ptr[p]; q < end; ++q) {
      const float* row = s.t + D * s.rows[q];
#pragma unroll
      for (int c = 0; c < D; ++c) a[c] += row[c];
    }
#pragma unroll
    for (int c = 0; c < D; ++c) dst[D * p + c] = a[c];
  }
  sync();
}

// s.w = G(K) src, or G(K^T) src when `transpose`.
template <int D, typename Sync = CtaSync>
__device__ void g_apply(const Solve& s, const float* __restrict__ src,
                        bool transpose, Sync sync = {}) {
  sync();  // src was written by other threads
  for (int e = threadIdx.x; e < s.num_elements; e += kThreads) {
    int v[D + 1];
    fem::load_element<D>(s.elem, e, v);
    float x0[D];
#pragma unroll
    for (int c = 0; c < D; ++c) x0[c] = src[D * v[0] + c];
    const float* k = s.k + D * D * e;
    float kk[D * D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        kk[D * i + c] = transpose ? k[D * c + i] : k[D * i + c];
      }
    }
    float sum[D];
    float* out = s.t + (D + 1) * D * e;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float d[D];
#pragma unroll
      for (int c = 0; c < D; ++c) d[c] = src[D * v[j + 1] + c] - x0[c];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float ti = kk[D * i] * d[0];
#pragma unroll
        for (int c = 1; c < D; ++c) ti = ti + kk[D * i + c] * d[c];
        out[D * (j + 1) + i] = ti;
        sum[i] = j == 0 ? ti : sum[i] + ti;
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) out[i] = -sum[i];
  }
  sync();
  gather_rows<D>(s, s.w, sync);
}

// dst = A src  (apply_a)
template <int D, typename Sync = CtaSync>
__device__ void apply_a(const Solve& s, const float* src, float* dst,
                        Sync sync = {}) {
  g_apply<D>(s, src, false, sync);
  for (int i = threadIdx.x; i < D * s.num_particles; i += kThreads) {
    dst[i] = src[i] - s.dt2 * s.w[i] * s.minv[i / D];
  }
}

// dst = A^T src  (apply_at)
template <int D, typename Sync = CtaSync>
__device__ void apply_at(const Solve& s, const float* src, float* dst,
                         Sync sync = {}) {
  for (int i = threadIdx.x; i < D * s.num_particles; i += kThreads) {
    s.z[i] = src[i] * s.minv[i / D];
  }
  g_apply<D>(s, s.z, true, sync);
  for (int i = threadIdx.x; i < D * s.num_particles; i += kThreads) {
    dst[i] = src[i] - s.dt2 * s.w[i];
  }
}

// dst = op src, op = A^T A (normal equations) or A; `u` is scratch.
template <int D, typename Sync = CtaSync>
__device__ void apply_op(const Solve& s, bool normal, const float* src,
                         float* u, float* dst, Sync sync = {}) {
  if (normal) {
    apply_a<D>(s, src, u, sync);
    apply_at<D>(s, u, dst, sync);
  } else {
    apply_a<D>(s, src, dst, sync);
  }
}

// The reference CG from x_0 = b, which the caller has left in x (each
// thread its own entries i = threadIdx.x + k kThreads): r = rhs - op(x_0)
// with rhs = A^T b or b, then the loop.  r, d, q and u are (N, D) scratch;
// `red` 33 floats of shared memory.  Thread 0 writes the iterations to
// *it_out and the final |r|^2 to *res_out.
template <int D, typename Sync = CtaSync>
__device__ void reference_cg(const Solve& s, bool normal, int max_iter,
                             float tol, float* x, float* r, float* d,
                             float* q, float* u, float* red, int* it_out,
                             float* res_out, Sync sync = {}) {
  const int nd = D * s.num_particles;
  if (normal) {
    apply_at<D>(s, x, r, sync);
  } else {
    for (int i = threadIdx.x; i < nd; i += kThreads) r[i] = x[i];
  }
  apply_op<D>(s, normal, x, u, q, sync);
  float part = 0.0f;
  for (int i = threadIdx.x; i < nd; i += kThreads) {
    const float ri = r[i] - q[i];
    r[i] = ri;
    d[i] = ri;
    part += ri * ri;
  }
  float delta = block_sum(part, red, sync);
  int it = 0;
  while (it < max_iter && delta > tol) {
    apply_op<D>(s, normal, d, u, q, sync);
    part = 0.0f;
    for (int i = threadIdx.x; i < nd; i += kThreads) part += d[i] * q[i];
    const float alpha = delta / block_sum(part, red, sync);
    part = 0.0f;
    for (int i = threadIdx.x; i < nd; i += kThreads) {
      x[i] += alpha * d[i];
      const float ri = r[i] - alpha * q[i];
      r[i] = ri;
      part += ri * ri;
    }
    const float delta_next = block_sum(part, red, sync);
    const float beta = delta_next / delta;
    for (int i = threadIdx.x; i < nd; i += kThreads) d[i] = r[i] + beta * d[i];
    delta = delta_next;
    ++it;
  }
  if (threadIdx.x == 0) {
    *it_out = it;
    *res_out = delta;
  }
}

}  // namespace fem::whole_cg
