// K11a: the whole reference CG of one implicit velocity solve over the
// edge-matrix operator, in one launch.
//
// Replaces the TPU kernel fem_tpu/experiments/pallas_cg.py:_cg_kernel
// (reached through cg_solve_pallas), which keeps the dense +-1 edge matrix S
// (E*D, N) resident in VMEM and applies
//   A x   = x - dt^2 M^-1 S^T (K o (S x))
//   A^T y = y - dt^2 S^T (K^T o (S (M^-1 y)))
// as two MXU matmuls an apply.  Row e*D+j of S is +1 at v_{j+1} and -1 at
// v_0 of element e, so S x is the element's edge differences and S^T t the
// element-Laplacian scatter: S^T (K o S x) = G(K) x.  The dense S is TPU
// mechanism (Mosaic has no gather): multiplying by it costs O(E D N).  Here
// the wrapper (experiments/edge_cg.py) recovers each row's +1 and -1 columns
// once, checks that S has that structure, and hands this kernel the element
// vertex ids and the per-particle CSR plan; the kernel then runs the
// computation, not the mechanism: G(K) x by direct gathers, O(E).
//
// Semantics, unchanged from _cg_kernel: x_0 = b; normal equations
// (A^T A x = A^T b) when `normal`, else A x = b; iterate while
// it < max_iter && |r|^2 > tol; 1/m computed in f32; dt^2 one f32 constant.
// The operator and the loop are whole_cg.cuh's, the core of K4
// (fused_cg.cu), so the two whole-solve kernels cannot drift apart; K11a has
// no rhs assembly (b is an input).  Templated on the dimension D in {2, 3}.
//
// Bound on the H100: latency, as K4's (one SM runs the solve; every
// iteration is a chain of dependent phases over a few thousand unknowns).
// The bytes a call must move — K, b, the mass, the element ids and the
// plan read once, x written, about 0.3 MB on the flagship — take a tenth of
// a microsecond, and its operations little more; the dense S (49 MB on the
// flagship) is read once per S, when the wrapper recovers the plan, never
// by the kernel.

#include <cuda_runtime.h>

#include "whole_cg.cuh"

namespace {

using fem::whole_cg::kThreads;
using fem::whole_cg::Solve;

template <int D>
__global__ void __launch_bounds__(kThreads, 1) edge_cg_kernel(
    Solve s, const float* __restrict__ b, const float* __restrict__ mass,
    float* minv, int normal, int max_iter, float tol, float* x, float* r,
    float* d, float* q, float* u, int* it_out, float* res_out) {
  __shared__ float red[33];
  for (int p = threadIdx.x; p < s.num_particles; p += kThreads) {
    minv[p] = 1.0f / mass[p];
  }
  for (int i = threadIdx.x; i < D * s.num_particles; i += kThreads) {
    x[i] = b[i];  // x_0 = b
  }
  __syncthreads();  // minv is read across threads
  fem::whole_cg::reference_cg<D>(s, normal != 0, max_iter, tol, x, r, d, q,
                                 u, red, it_out, res_out);
}

}  // namespace

// Floats of scratch a solve needs: minv (N), r, d, q, u, w, z (D N each),
// t ((D+1) D E).
extern "C" long long fem_edge_cg_scratch_floats(int dim, int num_elements,
                                                int num_particles) {
  return static_cast<long long>(num_particles) +
         6LL * dim * num_particles +
         static_cast<long long>(dim + 1) * dim * num_elements;
}

// `dim` is 2 or 3 (anything else: cudaErrorInvalidValue, nothing launched).
extern "C" int fem_edge_cg(int dim, const void* k, const void* elem,
                           const void* ptr, const void* rows, const void* b,
                           const void* mass, int num_elements,
                           int num_particles, float dt2, int normal,
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
  const float* bb = static_cast<const float*>(b);
  const float* m = static_cast<const float*>(mass);
  float* x = static_cast<float*>(x_out);
  int* it = static_cast<int*>(it_out);
  float* res = static_cast<float*>(res_out);
  if (dim == 3) {
    edge_cg_kernel<3><<<1, kThreads, 0, st>>>(s, bb, m, minv, normal,
                                              max_iter, tol, x, r, d, q, u,
                                              it, res);
  } else {
    edge_cg_kernel<2><<<1, kThreads, 0, st>>>(s, bb, m, minv, normal,
                                              max_iter, tol, x, r, d, q, u,
                                              it, res);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_edge_cg_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
