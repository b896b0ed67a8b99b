// The fused advection steps, one thread per particle, 2D or 3D.
//
// K10a, fem_kinematic: the explicit kinematic step (reference
// solver/kinematic.py:14-45).  Replaces the TPU kernel
// fem_tpu/ops/pallas_advect.py:_kinematic_kernel (reached through
// kinematic_pallas):
//   v = (vel + (g - grad m^-1) dt) decay
//   v_k = 0 where (pos_k < 0 and v_k < 0), then where (pos_k > 1 and v_k > 0)
//   per circle b in order: inside (|x - c_b|^2 < r_b^2), moving toward the
//     center and r_b > 0 -> v -= (v . disp / max(|disp|^2, 1e-30)) disp
//   pos' = pos + v dt
//
// K10b, fem_advect_implicit: the implicit advection with the separate
// gravity channel vel_g (reference solver/implicit.py:407-438).  Replaces
// fem_tpu/ops/pallas_advect.py:_advect_implicit_kernel (reached through
// advect_implicit_pallas):
//   vel *= decay; vel_g = (vel_g + g dt) decay; v = vel + vel_g
//   the lower wall zeroes vel, vel_g and v; the upper wall zeroes vel and v
//     but NOT vel_g (the reference's quirk, implicit.py:422)
//   per circle: the hit test on v, then v, vel and vel_g each lose their
//     component along disp, with 1/max(|disp|^2, 1e-30) multiplied (the
//     Pallas kernel's form; the XLA step divides)
//   pos' = pos + v dt
//
// g is 9.8 g_dir and decay exp(-dt damping), both f32 from the host.  The
// arithmetic is written with round-to-nearest intrinsics in the plain
// version's order (ops/advect_kernels.py), so that no multiply-add is
// contracted and the kernel tracks it to rounding of the sums.  K10b's
// particle step is advect_common.cuh's, shared with K11b (fused_frame.cu).
//
// Bound on the H100: bytes.  K10a reads pos, vel, grad (3 x 12 B in 3D)
// and m^-1 (4 B) and writes pos', vel' (24 B) a particle, for ~40 f32
// operations plus ~15 a circle; K10b reads 36 B and writes 36 B.  At the
// flagship's 1,007 particles either moves ~70 KB, some 0.00002 ms at
// 3.35 TB/s, far below a launch: the kernel is launch-bound.  Design: one
// thread a particle, the circles (a handful) read by every thread from L1,
// everything else in registers.

#include <cuda_runtime.h>

#include "advect_common.cuh"

namespace {

constexpr int kThreads = 256;

using fem::dot_rn;

// The walls: lower wall zeroes a component moving down below 0, then the
// upper wall one moving up above 1 (tested on the already-zeroed v).
template <int D>
__device__ __forceinline__ void walls(const float* x, float* v) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (x[i] < 0.0f && v[i] < 0.0f) v[i] = 0.0f;
    if (x[i] > 1.0f && v[i] > 0.0f) v[i] = 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) kinematic_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ grad, const float* __restrict__ minv,
    const float* __restrict__ centers, const float* __restrict__ radii,
    int num_circles, const float* __restrict__ gravity, float dt,
    float decay, int n, float* __restrict__ pos_out,
    float* __restrict__ vel_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float x[D], v[D];
  const float m = minv[p];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = pos[D * p + i];
    const float a = __fsub_rn(gravity[i], __fmul_rn(grad[D * p + i], m));
    v[i] = __fmul_rn(__fadd_rn(vel[D * p + i], __fmul_rn(a, dt)), decay);
  }
  walls<D>(x, v);
  for (int b = 0; b < num_circles; ++b) {
    const float r = radii[b];
    float disp[D], neg[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      disp[i] = __fsub_rn(x[i], centers[D * b + i]);
      neg[i] = -disp[i];
    }
    const float dist_sq = dot_rn<D>(disp, disp);
    const bool hit = dist_sq < __fmul_rn(r, r) &&
                     dot_rn<D>(v, neg) > 0.0f && r > 0.0f;
    if (hit) {
      const float coeff =
          __fdiv_rn(dot_rn<D>(v, disp), fmaxf(dist_sq, 1e-30f));
#pragma unroll
      for (int i = 0; i < D; ++i) v[i] = __fsub_rn(v[i], __fmul_rn(coeff, disp[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    vel_out[D * p + i] = v[i];
    pos_out[D * p + i] = __fadd_rn(x[i], __fmul_rn(v[i], dt));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) advect_implicit_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ vel_g, const float* __restrict__ centers,
    const float* __restrict__ radii, int num_circles,
    const float* __restrict__ gravity, float dt, float decay, int n,
    float* __restrict__ pos_out, float* __restrict__ vel_out,
    float* __restrict__ vel_g_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  fem::advect_implicit_particle<D>(pos + D * p, vel + D * p, vel_g + D * p,
                                   centers, radii, num_circles, gravity, dt,
                                   decay, pos_out + D * p, vel_out + D * p,
                                   vel_g_out + D * p);
}

}  // namespace

// `dim` is 2 or 3 (anything else: cudaErrorInvalidValue, nothing launched).
extern "C" int fem_kinematic(int dim, const void* pos, const void* vel,
                             const void* grad, const void* minv,
                             const void* centers, const void* radii,
                             int num_circles, const void* gravity, float dt,
                             float decay, int n, void* pos_out, void* vel_out,
                             void* stream) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto kernel) {
      kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(pos), static_cast<const float*>(vel),
          static_cast<const float*>(grad), static_cast<const float*>(minv),
          static_cast<const float*>(centers), static_cast<const float*>(radii),
          num_circles, static_cast<const float*>(gravity), dt, decay, n,
          static_cast<float*>(pos_out), static_cast<float*>(vel_out));
    };
    if (dim == 3) {
      args(kinematic_kernel<3>);
    } else {
      args(kinematic_kernel<2>);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fem_advect_implicit(int dim, const void* pos, const void* vel,
                                   const void* vel_g, const void* centers,
                                   const void* radii, int num_circles,
                                   const void* gravity, float dt, float decay,
                                   int n, void* pos_out, void* vel_out,
                                   void* vel_g_out, void* stream) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto kernel) {
      kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(pos), static_cast<const float*>(vel),
          static_cast<const float*>(vel_g), static_cast<const float*>(centers),
          static_cast<const float*>(radii), num_circles,
          static_cast<const float*>(gravity), dt, decay, n,
          static_cast<float*>(pos_out), static_cast<float*>(vel_out),
          static_cast<float*>(vel_g_out));
    };
    if (dim == 3) {
      args(advect_implicit_kernel<3>);
    } else {
      args(advect_implicit_kernel<2>);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_advect_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
