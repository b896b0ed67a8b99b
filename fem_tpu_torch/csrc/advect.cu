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
// operations plus ~25 a circle; K10b reads 36 B and writes 36 B.  At the
// flagship's 1,007 particles either moves ~70 KB, some 0.00002 ms at
// 3.35 TB/s, far below a launch: there the kernel is launch- and
// latency-bound; at a million particles it is bytes-bound.
//
// Design: one thread a particle in CTAs of kTile = 64 particles
// (ops/advect_kernels.advect_plan), so that a small mesh spreads over many
// SMs (the flagship's 1,007 particles: 16 CTAs of 64, where CTAs of 256
// took 4).  Each thread first loads its particle's rows and gravity into
// registers, then the CTA copies the circle table (centers then radii,
// B (D + 1) floats) into dynamic shared memory, one barrier, and the
// circle loop reads it from there: the loop's loads are no longer round
// trips to L2 on a latency-bound thread, and the rows' loads are in flight
// while the table is staged.  B = 0 takes no shared memory and no
// barrier; a table over 48 KB opts in to more, up to a CTA's 227 KB.  The
// rows stay AoS, read by 4-byte loads from L1-cached lines: at a million
// particles in 3D, CTAs of 256 reading them so already reached 80 % (K10a)
// and 64 % (K10b) of the byte bound on the H100, and staging each CTA's
// slab of rows through shared memory by 16-byte loads was slower at every
// size swept.  Tiles of 32, 128 and 256 were swept too; 64 was within 6 %
// of the fastest at every size but K10b in 3D from 262,144 particles on
// (32: 9-13 % faster), and every tile gave the same bits (PERF.md,
// section 6).

#include <cuda_runtime.h>

#include "advect_common.cuh"

namespace {

using fem::dot_rn;

// Particles a CTA, one thread each.
constexpr int kTile = 64;

// Dynamic shared memory a launch may take without opting in, and the most
// it may take on the H100 (a CTA's 227 KB).
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;

// The operands of one launch of either kernel.  K10a: aux = grad, minv =
// m^-1, aux_out unused; K10b: aux = vel_g, aux_out = vel_g', minv unused.
struct AdvectArgs {
  const float* pos;
  const float* vel;
  const float* aux;
  const float* minv;
  const float* centers;
  const float* radii;
  const float* gravity;
  float* pos_out;
  float* vel_out;
  float* aux_out;
  float dt;
  float decay;
  int num_circles;
  int n;
};

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

// The kinematic step of one particle from its rows pos, vel, grad and its
// m^-1 into the rows pos_out, vel_out (which may alias pos and vel: every
// input is read before the first write); the circles from `centers` (B x D)
// and `radii` (B).
template <int D>
__device__ __forceinline__ void kinematic_particle(
    const float* pos, const float* vel, const float* grad, float m,
    const float* centers, const float* radii, int num_circles,
    const float* gravity, float dt, float decay, float* pos_out,
    float* vel_out) {
  float x[D], v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = pos[i];
    const float a = __fsub_rn(gravity[i], __fmul_rn(grad[i], m));
    v[i] = __fmul_rn(__fadd_rn(vel[i], __fmul_rn(a, dt)), decay);
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
    vel_out[i] = v[i];
    pos_out[i] = __fadd_rn(x[i], __fmul_rn(v[i], dt));
  }
}

// The CTA's circle table (centers B x D, then radii B) into shared memory,
// and one barrier when there is a circle.  Returns the shared table.
template <int D>
__device__ __forceinline__ const float* stage_circles(float* smem,
                                                      const AdvectArgs& a) {
  const int nc = D * a.num_circles;
  for (int k = threadIdx.x; k < nc + a.num_circles; k += kTile)
    smem[k] = k < nc ? a.centers[k] : a.radii[k - nc];
  if (a.num_circles > 0) __syncthreads();
  return smem;
}

// Thread t of CTA c steps particle c kTile + t: its rows and gravity are
// loaded before the circle table is staged, the step runs after.
template <int D>
__global__ void __launch_bounds__(kTile) tiled_kinematic_kernel(AdvectArgs a) {
  extern __shared__ float smem[];
  const int p = blockIdx.x * kTile + threadIdx.x;
  const bool live = p < a.n;
  float x[D], u[D], grad[D], g[D], m = 0.0f;
  if (live) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x[i] = a.pos[D * p + i];
      u[i] = a.vel[D * p + i];
      grad[i] = a.aux[D * p + i];
      g[i] = a.gravity[i];
    }
    m = a.minv[p];
  }
  const float* centers = stage_circles<D>(smem, a);
  if (live)
    kinematic_particle<D>(x, u, grad, m, centers, centers + D * a.num_circles,
                          a.num_circles, g, a.dt, a.decay, a.pos_out + D * p,
                          a.vel_out + D * p);
}

template <int D>
__global__ void __launch_bounds__(kTile) tiled_advect_implicit_kernel(
    AdvectArgs a) {
  extern __shared__ float smem[];
  const int p = blockIdx.x * kTile + threadIdx.x;
  const bool live = p < a.n;
  float x[D], u[D], w[D], g[D];
  if (live) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x[i] = a.pos[D * p + i];
      u[i] = a.vel[D * p + i];
      w[i] = a.aux[D * p + i];
      g[i] = a.gravity[i];
    }
  }
  const float* centers = stage_circles<D>(smem, a);
  if (live)
    fem::advect_implicit_particle<D>(
        x, u, w, centers, centers + D * a.num_circles, a.num_circles, g,
        a.dt, a.decay, a.pos_out + D * p, a.vel_out + D * p,
        a.aux_out + D * p);
}

using Kernel = void (*)(AdvectArgs);

// One launch of `kernel` (0: K10a, 1: K10b) over a.n particles;
// cudaErrorInvalidValue for a dim the kernels do not take, or a circle
// table larger than a CTA's shared memory.
int launch(int kernel, int dim, const AdvectArgs& a, void* stream) {
  const Kernel k =
      dim == 3   ? (kernel == 0 ? tiled_kinematic_kernel<3>
                                : tiled_advect_implicit_kernel<3>)
      : dim == 2 ? (kernel == 0 ? tiled_kinematic_kernel<2>
                                : tiled_advect_implicit_kernel<2>)
                 : nullptr;
  if (k == nullptr || a.num_circles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (dim + 1) * static_cast<size_t>(a.num_circles);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = (a.n + kTile - 1) / kTile;
  if (ctas > 0) {
    if (smem > kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    k<<<ctas, kTile, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `dim` is 2 or 3.
extern "C" int fem_kinematic(int dim, const void* pos,
                             const void* vel, const void* grad,
                             const void* minv, const void* centers,
                             const void* radii, int num_circles,
                             const void* gravity, float dt, float decay,
                             int n, void* pos_out, void* vel_out,
                             void* stream) {
  const AdvectArgs a{static_cast<const float*>(pos),
                     static_cast<const float*>(vel),
                     static_cast<const float*>(grad),
                     static_cast<const float*>(minv),
                     static_cast<const float*>(centers),
                     static_cast<const float*>(radii),
                     static_cast<const float*>(gravity),
                     static_cast<float*>(pos_out),
                     static_cast<float*>(vel_out),
                     nullptr, dt, decay, num_circles, n};
  return launch(0, dim, a, stream);
}

extern "C" int fem_advect_implicit(int dim, const void* pos,
                                   const void* vel, const void* vel_g,
                                   const void* centers,
                                   const void* radii, int num_circles,
                                   const void* gravity, float dt, float decay,
                                   int n, void* pos_out, void* vel_out,
                                   void* vel_g_out, void* stream) {
  const AdvectArgs a{static_cast<const float*>(pos),
                     static_cast<const float*>(vel),
                     static_cast<const float*>(vel_g),
                     nullptr,
                     static_cast<const float*>(centers),
                     static_cast<const float*>(radii),
                     static_cast<const float*>(gravity),
                     static_cast<float*>(pos_out),
                     static_cast<float*>(vel_out),
                     static_cast<float*>(vel_g_out), dt, decay, num_circles, n};
  return launch(1, dim, a, stream);
}

extern "C" const char* fem_advect_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
