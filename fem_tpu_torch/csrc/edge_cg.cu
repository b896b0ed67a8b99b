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
// K11a has no rhs assembly (b is an input).  Templated on the dimension D
// in {2, 3}.
//
// Bound on the H100: latency, as K4's (every iteration is a chain of
// dependent phases over a few thousand unknowns).  The bytes a call must
// move — K, b, the mass, the element ids and the plan read once, x
// written, about 0.3 MB on the flagship — take a tenth of a microsecond,
// and its operations little more; the dense S (49 MB on the flagship) is
// read once per S, when the wrapper recovers the plan, never by the kernel.
//
// Design: two variants of one solve, chosen by size before the launch
// (experiments/edge_cg.py: cg_solve_edge, with K11b's plan
// experiments/fused_frame.fused_frame_plan, as K4 plans), never one in
// place of the other after a failure.
//
// The cluster variant (cluster_edge_cg_kernel), for every mesh whose state
// fits the shared memory of one thread-block cluster (<= 16 CTAs on the
// H100; the flagship: 16, default.json: 1): the operator and CG of
// cluster_cg.cuh, K4's and K11b's cluster solve — contiguous element
// ranges, each CTA's K and its local particles' vectors (x, r, d, q, 1/m)
// in shared memory, element rows and per-particle sums stored into the
// CTAs that read them, counted cluster barriers.  The copy-in loads the
// CTA's elements' K and its local particles' b (into x: x_0 = b) and 1/m;
// then one cluster barrier, so that no CTA stores into one that has not
// started, and cluster_cg.cuh's solve from x_0 = b (solve_from_b): no
// element pass.  A solve meets 5 + 5 it barriers in normal-equations mode,
// 3 + 3 it in plain mode; after the last no CTA touches another's shared
// memory, so none needs another before it leaves.
//
// The single variant (edge_cg_kernel), for meshes whose state does not fit
// one cluster: ONE thread block of 1,024 threads runs the whole solve over
// vectors in device memory, on whole_cg.cuh, the core of K4's single
// variant (fused_cg.cu).  It meets 13 + 12 it barriers (__syncthreads) in
// normal-equations mode, 7 + 9 it in plain mode.
//
// Both variants count the barriers they meet and report them (a (1,) int
// buffer; experiments/edge_cg.edge_cg_barriers gives the count).  Dot
// products reduce in a fixed order and there are no float atomics, so two
// runs give bit-identical results; the variants' per-particle sums are the
// same (the plan's order), and their solves differ only in the rounding of
// the dot products.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "cluster_cg.cuh"
#include "whole_cg.cuh"

// The cluster variant's arguments; the Python side mirrors this layout
// (experiments/edge_cg.py: EdgeCgArgsC).
struct FemEdgeCgArgs {
  const float* k;     // (E, D, D)
  const float* b;     // (N, D) the rhs, and x_0
  const float* mass;  // (N,)
  int normal;
  int max_iter;
  float dt2;
  float tol;
  float* x;    // (N, D) the solution
  int* it;     // () iterations
  float* res;  // () final |r|^2
  fem::cluster_cg::Plan cl;  // experiments/fused_frame.py: cluster_assignment
  int* barriers;  // (1,) or null: the barriers the launch met, written by
                  // thread 0 of CTA 0
};

namespace {

using fem::cluster_cg::ClusterSolve;
using fem::whole_cg::CountSync;
using fem::whole_cg::kThreads;
using fem::whole_cg::Solve;

template <int D>
__global__ void __launch_bounds__(kThreads, 1) edge_cg_kernel(
    Solve s, const float* __restrict__ b, const float* __restrict__ mass,
    float* minv, int normal, int max_iter, float tol, float* x, float* r,
    float* d, float* q, float* u, int* it_out, float* res_out,
    int* barriers_out) {
  __shared__ float red[33];
  int barriers = 0;
  const CountSync sync{&barriers};
  for (int p = threadIdx.x; p < s.num_particles; p += kThreads) {
    minv[p] = 1.0f / mass[p];
  }
  for (int i = threadIdx.x; i < D * s.num_particles; i += kThreads) {
    x[i] = b[i];  // x_0 = b
  }
  sync();  // minv is read across threads
  fem::whole_cg::reference_cg<D>(s, normal != 0, max_iter, tol, x, r, d, q,
                                 u, red, it_out, res_out, sync);
  if (barriers_out != nullptr && threadIdx.x == 0) *barriers_out = barriers;
}

// The cluster variant's threads a CTA.
constexpr int kClusterThreads = fem::cluster_cg::kThreads;
// Its local vectors: x (which starts as b), r, d, q.
constexpr int kVectors = 4;

// The cluster variant: the grid is one cluster (the launch sets the cluster
// dimension to the grid) of kClusterThreads threads a CTA.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_edge_cg_kernel(const __grid_constant__ FemEdgeCgArgs a) {
  constexpr int DD = D * D;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[33];
  ClusterSolve<D, FemEdgeCgArgs> s{a, cooperative_groups::this_cluster()};
  const size_t cap = a.cl.cap;
  const size_t rows = D * cap;
  s.vel = nullptr;
  s.x = s.begin(a.cl, smem);
  s.r = s.x + rows;
  s.d = s.r + rows;
  s.q = s.d + rows;
  s.minv = s.q + rows;
  s.carve_tables(a.cl, s.minv + cap);
  s.red = red;
  s.stage(a.cl);
  const int first = a.cl.local_ptr[s.me];
  for (int l = threadIdx.x; l < s.nl; l += blockDim.x) {
    const int g = a.cl.local_ids[first + l];
    s.ids[l] = g;
    s.minv[l] = 1.0f / a.mass[g];
#pragma unroll
    for (int c = 0; c < D; ++c) s.x[D * l + c] = a.b[D * g + c];  // x_0 = b
  }
  for (int i = threadIdx.x; i < DD * s.ne; i += blockDim.x) {
    s.k[i] = a.k[DD * static_cast<size_t>(s.e0) + i];
  }
  // Every CTA of the cluster is running before any stores into another's
  // shared memory: the first rows are sent after this barrier.
  s.sync();
  int it;
  float delta;
  s.solve_from_b(&it, &delta);
  // An owned row of x: every CTA holds the same values.
  for (int l = threadIdx.x; l < s.no; l += blockDim.x) {
    const int g = s.ids[l];
#pragma unroll
    for (int c = 0; c < D; ++c) a.x[D * g + c] = s.x[D * l + c];
  }
  if (s.me == 0 && threadIdx.x == 0) {
    *a.it = it;
    *a.res = delta;
    if (a.barriers != nullptr) *a.barriers = s.barriers;
  }
}

template <typename F>
int with_cluster_kernel(int dim, F&& f) {
  if (dim == 3) return f(cluster_edge_cg_kernel<3>);
  if (dim == 2) return f(cluster_edge_cg_kernel<2>);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Floats of scratch a single-variant solve needs: minv (N), r, d, q, u, w,
// z (D N each), t ((D+1) D E).
extern "C" long long fem_edge_cg_scratch_floats(int dim, int num_elements,
                                                int num_particles) {
  return static_cast<long long>(num_particles) +
         6LL * dim * num_particles +
         static_cast<long long>(dim + 1) * dim * num_elements;
}

// The single variant.  `dim` is 2 or 3 (anything else:
// cudaErrorInvalidValue, nothing launched); `barriers` is null or a (1,)
// int the launch writes the barriers it met to.
extern "C" int fem_edge_cg(int dim, const void* k, const void* elem,
                           const void* ptr, const void* rows, const void* b,
                           const void* mass, int num_elements,
                           int num_particles, float dt2, int normal,
                           int max_iter, float tol, void* x_out,
                           void* scratch, void* it_out, void* res_out,
                           void* barriers, void* stream) {
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
  int* bar = static_cast<int*>(barriers);
  if (dim == 3) {
    edge_cg_kernel<3><<<1, kThreads, 0, st>>>(s, bb, m, minv, normal,
                                              max_iter, tol, x, r, d, q, u,
                                              it, res, bar);
  } else {
    edge_cg_kernel<2><<<1, kThreads, 0, st>>>(s, bb, m, minv, normal,
                                              max_iter, tol, x, r, d, q, u,
                                              it, res, bar);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device's limits for the cluster variant's instance of `dim`: the most
// CTAs a cluster of it can have, the most dynamic shared memory a CTA can
// take and the SMs.  Returns 0 or a CUDA error.
extern "C" int fem_edge_cg_limits(int dim, int* max_cluster, int* smem_optin,
                                  int* sms) {
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_limits(kernel, kClusterThreads, max_cluster,
                               smem_optin, sms);
  });
}

// Bytes of dynamic shared memory of the cluster variant's CTA: `ne`
// elements, local vectors of `cap` rows, `entries` plan rows and `pushes`
// push codes of its owned particles.
extern "C" long long fem_edge_cg_cluster_smem(int ne, int cap, int entries,
                                              int pushes, int dim) {
  return static_cast<long long>(
      sizeof(float) *
      fem::cluster_cg::smem_words(ne, cap, entries, pushes, dim, kVectors));
}

// Checks that one cluster of `cluster` CTAs of the cluster variant's
// instance of `dim`, `smem` bytes of dynamic shared memory each, can be
// placed on the device; writes how many could be active at once.  Returns
// 0, a CUDA error, -2 (shared memory too large) or -4 (the cluster cannot
// be scheduled).
extern "C" int fem_edge_cg_cluster_fit(int cluster, int smem, int dim,
                                       int* max_active) {
  *max_active = 0;
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_fit(kernel, kClusterThreads, cluster,
                            static_cast<size_t>(smem), max_active);
  });
}

// The cluster variant: launches the instance of `dim` as one cluster of
// `cluster` CTAs with `smem` bytes of dynamic shared memory each.
extern "C" int fem_edge_cg_cluster(const FemEdgeCgArgs* args, int dim,
                                   int cluster, int smem, void* stream) {
  FemEdgeCgArgs a = *args;
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_launch(kernel, &a, cluster, kClusterThreads, smem,
                               stream);
  });
}

extern "C" const char* fem_edge_cg_error(int code) {
  if (code == -2) return "the CTA's shared memory exceeds the device's limit";
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
