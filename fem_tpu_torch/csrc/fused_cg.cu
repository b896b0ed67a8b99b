// The whole implicit velocity solve of one substep in one launch: rhs
// assembly, then the reference conjugate gradient to convergence.
//
// Replaces the TPU kernel fem_tpu/ops/pallas_blocked_cg.py:_fused_cg_kernel
// (reached through fused_blocked_cg_solve, with block_g_apply and
// reference_cg_core), which ran the same loop over VMEM-resident one-hot
// block tables because Mosaic has no in-kernel gather.
//
// Semantics, unchanged from _fused_cg_kernel:
//   b          = v + dt f / m,   f assembled from the rhs force columns
//   apply_a(v) = v - dt^2 G(K) v / m
//   apply_at(v)= v - dt^2 G(K^T) (v / m)
//   normal equations (A^T A x = A^T b) when `preconditioned`, else A x = b;
//   x_0 = b (not the A^T A rhs); iterate while it < max_iter && |r|^2 > tol.
// G(K) x sums, per element, t_j = K_e (x_{v_{j+1}} - x_{v_0}) into vertex
// j+1 and -sum_j t_j into vertex 0.  The kernel is templated on the
// dimension D in {2, 3} (the Pallas kernel takes `dim`); fem_fused_cg
// launches the instance of its `dim`.
//
// Bound on the H100: latency, not bytes or operations.  Every CG iteration
// is a chain of dependent phases (apply, reduce, update), each a few
// microseconds of work over ~3k unknowns, so the card's bandwidth and
// arithmetic rates are far from binding; what sets the pace is one SM's
// scattered 4-byte accesses to device memory (on an H100 80GB HBM3 at 700 W,
// tools/torch_k4_sweep.py reads about 51 us per operator apply on the
// flagship, thousands of times the bytes bound).  Design for this first
// version: ONE thread block of 1,024 threads runs the whole solve, so phases
// are separated by __syncthreads() and nothing returns to the host between
// iterations.  An apply runs in two phases: per element, t_j into a scratch
// (E, D+1, D) buffer; then per particle, a sum over its CSR plan rows in a
// fixed order.  Dot products reduce in a fixed order (warp shuffles, then
// one warp), and there are no float atomics, so two runs give bit-identical
// results.  Vectors and scratch live in device memory (L2-resident at the
// flagship's size); keeping them in shared memory and spreading the solve
// over more SMs is later work.  The operator and the CG loop are
// whole_cg.cuh's, shared with K11a (edge_cg.cu) and K11b (fused_frame.cu);
// this file adds the rhs assembly.

#include <cuda_runtime.h>

#include "whole_cg.cuh"

namespace {

using fem::whole_cg::kThreads;
using fem::whole_cg::Solve;

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fused_cg_kernel(
    Solve s, const float* __restrict__ cols, const float* __restrict__ vel,
    const float* __restrict__ mass, float* minv, float dt, int normal,
    int max_iter, float tol, float* x, float* r, float* d, float* q,
    float* u, int* it_out, float* res_out) {
  __shared__ float red[33];
  const int nd = D * s.num_particles;
  for (int p = threadIdx.x; p < s.num_particles; p += kThreads) {
    minv[p] = 1.0f / mass[p];
  }
  // Force contributions: column j of the element's rhs block to vertex j+1,
  // minus their sum to vertex 0 (element_contrib_full).
  for (int e = threadIdx.x; e < s.num_elements; e += kThreads) {
    const float* c = cols + D * D * e;
    float* out = s.t + (D + 1) * D * e;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float cj = c[D * i + j];
        out[D * (j + 1) + i] = cj;
        sum = j == 0 ? cj : sum + cj;
      }
      out[i] = -sum;
    }
  }
  __syncthreads();
  fem::whole_cg::gather_rows<D>(s, s.w);
  for (int i = threadIdx.x; i < nd; i += kThreads) {
    x[i] = vel[i] + dt * s.w[i] * minv[i / D];  // x_0 = b
  }
  fem::whole_cg::reference_cg<D>(s, normal != 0, max_iter, tol, x, r, d, q,
                                 u, red, it_out, res_out);
}

}  // namespace

// Floats of scratch a solve needs: minv (N), r, d, q, u, w, z (D N each),
// t ((D+1) D E).
extern "C" long long fem_fused_cg_scratch_floats(int dim, int num_elements,
                                                 int num_particles) {
  return static_cast<long long>(num_particles) +
         6LL * dim * num_particles +
         static_cast<long long>(dim + 1) * dim * num_elements;
}

// `dim` is 2 or 3 (anything else: cudaErrorInvalidValue, nothing launched).
extern "C" int fem_fused_cg(int dim, const void* k, const void* cols,
                            const void* elem, const void* ptr,
                            const void* rows, const void* vel,
                            const void* mass, int num_elements,
                            int num_particles, float dt, float dt2, int normal,
                            int max_iter, float tol, void* x_out,
                            void* scratch, void* it_out, void* res_out,
                            void* stream) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  float* base = static_cast<float*>(scratch);
  const int n = num_particles;
  const size_t nd = static_cast<size_t>(dim) * n;
  Solve s;
  s.k = static_cast<const float*>(k);
  s.elem = static_cast<const int*>(elem);
  s.ptr = static_cast<const int*>(ptr);
  s.rows = static_cast<const int*>(rows);
  float* minv = base;
  float* r = minv + n;
  float* d = r + nd;
  float* q = d + nd;
  float* u = q + nd;
  s.w = u + nd;
  s.z = s.w + nd;
  s.t = s.z + nd;
  s.minv = minv;
  s.num_elements = num_elements;
  s.num_particles = n;
  s.dt2 = dt2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cols);
  const float* v = static_cast<const float*>(vel);
  const float* m = static_cast<const float*>(mass);
  float* x = static_cast<float*>(x_out);
  int* it = static_cast<int*>(it_out);
  float* res = static_cast<float*>(res_out);
  if (dim == 3) {
    fused_cg_kernel<3><<<1, kThreads, 0, st>>>(s, c, v, m, minv, dt, normal,
                                               max_iter, tol, x, r, d, q, u,
                                               it, res);
  } else {
    fused_cg_kernel<2><<<1, kThreads, 0, st>>>(s, c, v, m, minv, dt, normal,
                                               max_iter, tol, x, r, d, q, u,
                                               it, res);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_fused_cg_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
