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
// Design: K4's — ONE thread block of 1,024 threads runs the whole frame,
// phases separated by __syncthreads(); per substep the element pass writes
// K (E, D, D) and the force rows ((D+1) E, D) to device-memory scratch, one
// thread an element, and every per-particle sum walks the CSR plan in a
// fixed order.  Mosaic's VMEM gates (the mask set and the planes) have no
// counterpart: the scratch is O(E + N) floats of device memory and the
// block walks elements and particles in grid-stride loops, so the kernel
// takes any mesh size; its limit is time, one SM's.
//
// Bound on the H100: latency, as K4's: each CG iteration is a chain of
// dependent phases over a few thousand unknowns on one SM.  The frame's
// bytes (pos, vel, vel_g, R^-1, V, the ids, the plan and the mass in, the
// state out) and operations (the chain, the applies, the advection) take a
// few microseconds at the card's rates.

#include <cuda_runtime.h>

#include "advect_common.cuh"
#include "blocked_common.cuh"
#include "whole_cg.cuh"

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
};

namespace {

using fem::whole_cg::kThreads;
using fem::whole_cg::Solve;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fused_frame_kernel(const __grid_constant__ FemFusedFrameArgs a) {
  constexpr int DD = D * D;
  constexpr int R = fem::rows_floats(D);
  __shared__ float red[33];
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
  __syncthreads();
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
    __syncthreads();
    fem::whole_cg::gather_rows<D>(s, w);
    for (int i = threadIdx.x; i < D * n; i += kThreads) {
      x[i] = a.vel[i] + a.dt * w[i] * minv[i / D];  // x_0 = b
    }
    fem::whole_cg::reference_cg<D>(s, a.normal != 0, a.max_iter, a.tol, x, r,
                                   d, q, u, red, a.iters + step,
                                   a.res + step);
    __syncthreads();  // x is read across threads
    for (int p = threadIdx.x; p < n; p += kThreads) {
      fem::advect_implicit_particle<D>(
          a.pos + D * p, x + D * p, a.velg + D * p, a.centers, a.radii,
          a.n_obst, a.gravity, a.dt, a.decay, a.pos + D * p, a.vel + D * p,
          a.velg + D * p);
    }
    __syncthreads();  // the next element pass reads every position
  }
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

// Launches the instance of args->dim (2 or 3; anything else:
// cudaErrorInvalidValue, nothing launched).
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

extern "C" const char* fem_fused_frame_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
