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
// j+1 and -sum_j t_j into vertex 0; the force columns assemble the same
// way (column j to vertex j+1, minus their sum to vertex 0).  The kernel is
// templated on the dimension D in {2, 3} (the Pallas kernel takes `dim`).
//
// Bound on the H100: latency, not bytes or operations.  Every CG iteration
// is a chain of dependent phases (apply, reduce, update), each a few
// microseconds of work over ~3k unknowns, so the card's bandwidth and
// arithmetic rates are far from binding; what sets the pace is the chain's
// length and what each phase waits on.
//
// Design: two variants of one solve, chosen by size before the launch
// (ops/cg_kernels.py: fused_cg_solve, with K11b's plan
// experiments/fused_frame.fused_frame_plan), never one in place of the
// other after a failure.
//
// The cluster variant (cluster_fused_cg_kernel), for every mesh whose state
// fits the shared memory of one thread-block cluster (<= 16 CTAs on the
// H100; the flagship: 16, default.json: 1): the operator and CG of
// cluster_cg.cuh, K11b's cluster solve — contiguous element ranges, each
// CTA's K and its local particles' vectors (vel, x, r, d, q, 1/m) in shared
// memory, element rows and per-particle sums stored into the CTAs that
// read them, counted cluster barriers.  Its element pass loads the CTA's
// elements' K and force columns, which K1 wrote to device memory, once, and
// sends the force rows to their owners like any product's rows.  A solve
// meets one barrier after the copy-in (so that no CTA stores into one that
// has not started) and cluster_cg.cuh's: 7 + 5 it in normal-equations
// mode, 5 + 3 it in plain mode; after the last no CTA touches another's
// shared memory, so none needs another before it leaves.
//
// The single variant (fused_cg_kernel), for meshes whose state does not fit
// one cluster: ONE thread block of 1,024 threads runs the whole solve, so
// phases are separated by __syncthreads() and nothing returns to the host
// between iterations (tools/torch_k4_sweep.py read about 51 us per operator
// apply on the flagship on an H100 80GB HBM3 at 700 W).  An apply runs in
// two phases: per element, t_j into a scratch (E, D+1, D) buffer; then per
// particle, a sum over its CSR plan rows in a fixed order.  Vectors and
// scratch live in device memory (L2-resident at the flagship's size).  The
// operator and the CG loop are whole_cg.cuh's, shared with K11a
// (edge_cg.cu) and K11b's single variant (fused_frame.cu); this file adds
// the rhs assembly.  It meets 14 + 12 it barriers in normal-equations mode,
// 8 + 9 it in plain mode.
//
// Both variants count the barriers they meet and report them (a (1,) int
// buffer; cg_kernels.fused_cg_barriers gives the count).  Dot products
// reduce in a fixed order and there are no float atomics, so two runs give
// bit-identical results; the variants' per-particle sums are the same, and
// their solves differ only in the rounding of the dot products.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "cluster_cg.cuh"
#include "whole_cg.cuh"

// The cluster variant's arguments; the Python side mirrors this layout
// (ops/cg_kernels.py: FusedCgArgsC).
struct FemFusedCgArgs {
  const float* k;     // (E, D, D) K1's K
  const float* cols;  // (E, D, D) K1's rhs force columns
  const float* vel;   // (N, D)
  const float* mass;  // (N,)
  int normal;
  int max_iter;
  float dt;
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
__global__ void __launch_bounds__(kThreads, 1) fused_cg_kernel(
    Solve s, const float* __restrict__ cols, const float* __restrict__ vel,
    const float* __restrict__ mass, float* minv, float dt, int normal,
    int max_iter, float tol, float* x, float* r, float* d, float* q,
    float* u, int* it_out, float* res_out, int* barriers_out) {
  __shared__ float red[33];
  int barriers = 0;
  const CountSync sync{&barriers};
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
  sync();
  fem::whole_cg::gather_rows<D>(s, s.w, sync);
  for (int i = threadIdx.x; i < nd; i += kThreads) {
    x[i] = vel[i] + dt * s.w[i] * minv[i / D];  // x_0 = b
  }
  fem::whole_cg::reference_cg<D>(s, normal != 0, max_iter, tol, x, r, d, q,
                                 u, red, it_out, res_out, sync);
  if (barriers_out != nullptr && threadIdx.x == 0) *barriers_out = barriers;
}

// The cluster variant's threads a CTA.
constexpr int kClusterThreads = fem::cluster_cg::kThreads;
// Its local vectors: vel, x, r, d, q.
constexpr int kVectors = 5;

// The cluster variant: the grid is one cluster (the launch sets the cluster
// dimension to the grid) of kClusterThreads threads a CTA.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_fused_cg_kernel(const __grid_constant__ FemFusedCgArgs a) {
  constexpr int DD = D * D;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[33];
  ClusterSolve<D, FemFusedCgArgs> s{a, cooperative_groups::this_cluster()};
  const size_t cap = a.cl.cap;
  const size_t rows = D * cap;
  s.vel = s.begin(a.cl, smem);
  s.x = s.vel + rows;
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
    for (int c = 0; c < D; ++c) s.vel[D * l + c] = a.vel[D * g + c];
  }
  // The rank's elements' K into shared memory, and their force rows (column
  // j to vertex j+1, minus their sum to vertex 0: the single variant's
  // arithmetic) into their receive slots of `out`.
  const auto prep = [&](float* out) {
    for (int e = threadIdx.x; e < s.ne; e += blockDim.x) {
      const int g = s.e0 + e;
      const float* c = a.cols + DD * static_cast<size_t>(g);
#pragma unroll
      for (int i = 0; i < DD; ++i) s.k[DD * e + i] = a.k[DD * g + i];
      float t[D + 1][D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float cj = c[D * i + j];
          t[j + 1][i] = cj;
          sum = j == 0 ? cj : sum + cj;
        }
        t[0][i] = -sum;
      }
#pragma unroll
      for (int j = 0; j <= D; ++j) s.send(out, e, j, t[j]);
    }
  };
  // Every CTA of the cluster is running before any stores into another's
  // shared memory: the first rows are sent after this barrier.
  s.sync();
  int it;
  float delta;
  s.solve(prep, &it, &delta);
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
  if (dim == 3) return f(cluster_fused_cg_kernel<3>);
  if (dim == 2) return f(cluster_fused_cg_kernel<2>);
  return static_cast<int>(cudaErrorInvalidValue);
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

// The single variant.  `dim` is 2 or 3 (anything else:
// cudaErrorInvalidValue, nothing launched); `barriers` is null or a (1,)
// int the launch writes the barriers it met to.
extern "C" int fem_fused_cg(int dim, const void* k, const void* cols,
                            const void* elem, const void* ptr,
                            const void* rows, const void* vel,
                            const void* mass, int num_elements,
                            int num_particles, float dt, float dt2, int normal,
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
  const float* c = static_cast<const float*>(cols);
  const float* v = static_cast<const float*>(vel);
  const float* m = static_cast<const float*>(mass);
  float* x = static_cast<float*>(x_out);
  int* it = static_cast<int*>(it_out);
  float* res = static_cast<float*>(res_out);
  int* bar = static_cast<int*>(barriers);
  if (dim == 3) {
    fused_cg_kernel<3><<<1, kThreads, 0, st>>>(s, c, v, m, minv, dt, normal,
                                               max_iter, tol, x, r, d, q, u,
                                               it, res, bar);
  } else {
    fused_cg_kernel<2><<<1, kThreads, 0, st>>>(s, c, v, m, minv, dt, normal,
                                               max_iter, tol, x, r, d, q, u,
                                               it, res, bar);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device's limits for the cluster variant's instance of `dim`: the most
// CTAs a cluster of it can have, the most dynamic shared memory a CTA can
// take and the SMs.  Returns 0 or a CUDA error.
extern "C" int fem_fused_cg_limits(int dim, int* max_cluster, int* smem_optin,
                                   int* sms) {
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_limits(kernel, kClusterThreads, max_cluster,
                               smem_optin, sms);
  });
}

// Bytes of dynamic shared memory of the cluster variant's CTA: `ne`
// elements, local vectors of `cap` rows, `entries` plan rows and `pushes`
// push codes of its owned particles.
extern "C" long long fem_fused_cg_cluster_smem(int ne, int cap, int entries,
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
extern "C" int fem_fused_cg_cluster_fit(int cluster, int smem, int dim,
                                        int* max_active) {
  *max_active = 0;
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_fit(kernel, kClusterThreads, cluster,
                            static_cast<size_t>(smem), max_active);
  });
}

// The cluster variant: launches the instance of `dim` as one cluster of
// `cluster` CTAs with `smem` bytes of dynamic shared memory each.
extern "C" int fem_fused_cg_cluster(const FemFusedCgArgs* args, int dim,
                                    int cluster, int smem, void* stream) {
  FemFusedCgArgs a = *args;
  return with_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_launch(kernel, &a, cluster, kClusterThreads, smem,
                               stream);
  });
}

extern "C" const char* fem_fused_cg_error(int code) {
  if (code == -2) return "the CTA's shared memory exceeds the device's limit";
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
