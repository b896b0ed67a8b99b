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
// the H100): the operator and CG of cluster_cg.cuh (shared with K4's
// cluster variant), whose CTA `rank` owns a contiguous range of elements
// and keeps their K and its local particles' vectors — here pos, vel, vel_g,
// x, r, d, q and 1/m — in its shared memory, element rows and per-particle
// sums stored into the CTAs that read them.  This file adds the element
// pass (the Neo-Hookean chain at the local positions, its force rows sent
// like any product's) and the advection, which every CTA runs for all its
// local particles, redundantly and in the same operation order.  Storing
// rows and sums into their readers, rather than each CTA reading the rows
// it needs, roughly halved a flagship phase on the H100 against remote
// reads (PERF.md, section 6).  Per substep in normal-equations mode 6
// barriers and 5 an iteration, in plain mode 4 and 3 (cluster_cg.cuh);
// two a frame: after the copy-in, so that no CTA stores into one that has
// not started, and before exit, so that none leaves while another may
// still store into it.  A cluster of one CTA syncs with __syncthreads().

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
#include "cluster_cg.cuh"
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
  fem::cluster_cg::Plan cl;
  int* barriers;  // (1,) or null: the barriers the launch met, written by
                  // thread 0 of CTA 0
};

namespace {

using fem::whole_cg::CountSync;
using fem::whole_cg::kThreads;
using fem::whole_cg::Solve;

using fem::cluster_cg::ClusterSolve;

// The cluster variant's threads a CTA.
constexpr int kClusterThreads = fem::cluster_cg::kThreads;

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

// 4-byte words of the cluster variant's dynamic shared memory
// (cluster_cg.cuh: smem_words), with its seven local vectors: pos, vel,
// vel_g, x, r, d, q.
__host__ __device__ inline size_t cluster_smem_words(int ne, int cap,
                                                     int entries, int pushes,
                                                     int dim) {
  return fem::cluster_cg::smem_words(ne, cap, entries, pushes, dim, 7);
}

// The cluster variant: the grid is one cluster (the launch sets the
// cluster dimension to the grid) of kClusterThreads threads a CTA.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_fused_frame_kernel(const __grid_constant__ FemFusedFrameArgs a) {
  constexpr int DD = D * D;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[33];
  ClusterSolve<D, FemFusedFrameArgs> fr{a, cg::this_cluster()};
  const size_t cap = a.cl.cap;
  const size_t rows = D * cap;
  float* pos = fr.begin(a.cl, smem);
  fr.vel = pos + rows;
  float* velg = fr.vel + rows;
  fr.x = velg + rows;
  fr.r = fr.x + rows;
  fr.d = fr.r + rows;
  fr.q = fr.d + rows;
  fr.minv = fr.q + rows;
  fr.carve_tables(a.cl, fr.minv + cap);
  fr.red = red;
  // The rank's tables and its local particles' state into shared memory.
  fr.stage(a.cl);
  const int first = a.cl.local_ptr[fr.me];
  for (int l = threadIdx.x; l < fr.nl; l += blockDim.x) {
    const int g = a.cl.local_ids[first + l];
    fr.ids[l] = g;
    fr.minv[l] = 1.0f / a.mass[g];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      pos[D * l + c] = a.pos_in[D * g + c];
      fr.vel[D * l + c] = a.vel_in[D * g + c];
      velg[D * l + c] = a.velg_in[D * g + c];
    }
  }
  // K of the rank's elements and their force rows into their receive slots
  // of `out`, at the local positions (the single variant's element pass).
  const auto prep = [&](float* out) {
    __syncthreads();  // the positions were written by other threads
    for (int e = threadIdx.x; e < fr.ne; e += blockDim.x) {
      int v[D + 1];
#pragma unroll
      for (int j = 0; j <= D; ++j) v[j] = fr.lv[(D + 1) * e + j];
      const int g = fr.e0 + e;
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
      for (int i = 0; i < DD; ++i) fr.k[DD * e + i] = nv * kk[i];
      float t[fem::rows_floats(D)];
      fem::column_rows<D>(nv, h, t);
#pragma unroll
      for (int j = 0; j <= D; ++j) fr.send(out, e, j, t + D * j);
    }
  };
  // Every CTA of the cluster is running before any stores into another's
  // shared memory: the first rows are sent after this barrier.
  fr.sync();
  for (int s = 0; s < a.sim_count; ++s) {
    int it;
    float delta;
    fr.solve(prep, &it, &delta);
    // The implicit advection of every local particle (vel_in is x).
    for (int l = threadIdx.x; l < fr.nl; l += blockDim.x) {
      const int i = D * l;
      fem::advect_implicit_particle<D>(
          pos + i, fr.x + i, velg + i, a.centers, a.radii, a.n_obst,
          a.gravity, a.dt, a.decay, pos + i, fr.vel + i, velg + i);
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
      a.pos[D * g + c] = pos[D * l + c];
      a.vel[D * g + c] = fr.vel[D * l + c];
      a.velg[D * g + c] = velg[D * l + c];
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
