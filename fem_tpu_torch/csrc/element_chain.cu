// The element chains over the mesh's elements, one thread per element (a
// tet in 3D, a triangle in 2D), for every material.
//
// K1: per element, the implicit system block K_e and the rhs force columns
// in one pass.  Replaces the TPU kernel fem_tpu/ops/pallas_kernels.py:
// _hessian_and_force_kernel (reached through hessian_and_force_pallas),
// which runs k_and_h_chain on component planes (D², E_pad) that XLA
// gathered and padded to 1,024-lane tiles beforehand.  K_e = -V k and
// H_e = -V h with k and h from the shared chain fem::material_chain
// (element_chain.cuh: formulas and their order unchanged from
// k_and_h_chain, its robust clamp and its material branches included).
//
// K6: per element, the explicit energy-gradient columns G_e = +V g with g
// from fem::material_grad_cols (the unclamped-log chain of grad_cols_chain,
// or the material's P R^T).  Replaces fem_tpu/ops/pallas_kernels.py:
// _grad_cols_kernel (reached through explicit_grad_columns_pallas), the
// same planar layout as K1's.
//
// K9a and K9b: the two halves of K1's Neo-Hookean chain as kernels of their
// own, for the callers that need one half: K9a the blocks K_e = -V k
// (replaces fem_tpu/ops/pallas_kernels.py:_hessian_kernel, reached through
// hessian_blocks_pallas; the port's rayleigh_damping_grad), K9b the rhs
// columns H_e = -V h with the log of det F^2 (replaces
// pallas_kernels.py:_implicit_force_kernel, reached through
// implicit_force_columns_pallas; the port's implicit_rhs).  Neo-Hookean and
// non-robust only, as the Pallas kernels are: fem::nh_prelude, then nh_k or
// nh_h of element_chain.cuh, the functions K1's nh_chain runs.  A K9 launch
// reads what K1 reads and writes half of it (36 B a tet) for about 300
// (K9a) or 150 (K9b) f32 operations a tet: bytes-bound like K1.
//
// All are templated on the dimension D in {2, 3}, as the Pallas kernels
// take `dim`, and on the material M (fem::Material: the seven base
// materials, and for K1 robust Neo-Hookean, as the Pallas chains take
// `material` and `robust`); each C entry takes `dim` and `material` and
// launches that instance with the material's numbers (fem::MaterialParams)
// as a kernel argument.  A library built with -DFEM_MATERIAL holds one
// material's instances.  A material layer's dynamic rest-edge inverse
// R^-1 F_i^-1 is simply the ref_inv the launch is given.  Outputs are
// (E, D, D) row-major, the layout the JAX entries return; V is the rest
// volume (area in 2D).
//
// Bound on the H100: bytes.  Per tet K1 reads 4 indices (16 B), 4 vertex
// positions (48 B, from L2 after first touch), R (36 B) and V (4 B), and
// writes 72 B (K6: 36 B); about 400 f32 operations per Neo-Hookean tet (K6:
// about 200; corotated adds its 12 Higham iterations, ~600 operations) is
// far below the card's operation-to-byte ratio.  A triangle moves
// 12 + 24 + 16 + 4 B in and 32 B out (K6: 16 B) for about 130 operations
// (K6: about 70).  Design: one thread per element, the vertex gather done
// directly (Hopper gathers, so the TPU's planar padding and the separate XLA
// gather pass are gone) and the whole chain in registers — nothing
// intermediate touches device memory.
//
// All four run in CTAs of kTile = 32 elements (a tile), one thread an
// element.  A thread's chain is long and serial (about 400 dependent
// operations a Neo-Hookean tet for K1, 300 for K9a, 200 for K6, 600
// corotated), so what hides its latency is the number of SMs running
// chains: the flagship's 4,068 tets fill 128 CTAs of 32 on 128 of the 132
// SMs, where CTAs of 256 put them on 16.  On the H100 tiles of 32 were the
// fastest of 32-256 at every size swept (200-4,068 elements, 2D and 3D),
// and neither d threads an element (one row of k and h each) nor staging
// the tile's rows through shared memory by 16-byte vectors gained
// (PERF.md, section 6).

#include <cuda_runtime.h>

#include "element_chain.cuh"

namespace {

// Edge matrix x[D*i + j] = p_{j+1}[i] - p_0[i] of element e.
template <int D>
__device__ __forceinline__ void element_edges(const float* __restrict__ pos,
                                              const int* __restrict__ elem,
                                              int e, float* x) {
  int v[D + 1];
  fem::load_element<D>(elem, e, v);
  float p0[D];
#pragma unroll
  for (int i = 0; i < D; ++i) p0[i] = pos[D * v[0] + i];
#pragma unroll
  for (int j = 0; j < D; ++j) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[D * i + j] = pos[D * v[j + 1] + i] - p0[i];
  }
}

// Elements a CTA of K1, K6, K9a and K9b (ops/element_kernels.ELEMENT_TILE).
constexpr int kTile = 32;

// tiled_hessian_and_force_kernel (K1): the name the profiler reports.
template <int D, int M>
__global__ void __launch_bounds__(kTile) tiled_hessian_and_force_kernel(
    const float* __restrict__ pos, const int* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, const fem::MaterialParams m, float* __restrict__ k_out,
    float* __restrict__ h_out) {
  constexpr int DD = D * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_elements) return;
  float x[DD];
  element_edges<D>(pos, elem, e, x);
  float r[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = ref_inv[DD * e + i];
  float k[DD], h[DD];
  fem::material_chain<D, M>(x, r, m, k, h);
  const float nv = -volume[e];
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    k_out[DD * e + i] = nv * k[i];
    h_out[DD * e + i] = nv * h[i];
  }
}

// tiled_explicit_grad_columns_kernel (K6): the name the profiler reports.
template <int D, int M>
__global__ void __launch_bounds__(kTile) tiled_explicit_grad_columns_kernel(
    const float* __restrict__ pos, const int* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, const fem::MaterialParams m, float* __restrict__ g_out) {
  constexpr int DD = D * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_elements) return;
  float x[DD], r[DD], g[DD];
  element_edges<D>(pos, elem, e, x);
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = ref_inv[DD * e + i];
  fem::material_grad_cols<D, M>(x, r, m, g);
  const float v = volume[e];
#pragma unroll
  for (int i = 0; i < DD; ++i) g_out[DD * e + i] = v * g[i];
}

// The body of K9a (K_HALF) and K9b: one thread an element.
template <int D, bool K_HALF>
__device__ __forceinline__ void nh_half(
    const float* __restrict__ pos, const int* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, const fem::MaterialParams& m, float* __restrict__ out) {
  constexpr int DD = D * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_elements) return;
  float x[DD], r[DD], f[DD], f_inv[DD], o[DD];
  element_edges<D>(pos, elem, e, x);
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = ref_inv[DD * e + i];
  const float det = fem::nh_prelude<D, false>(x, r, f, f_inv);
  if constexpr (K_HALF) {
    fem::nh_k<D>(f_inv, det, r, m.mu, m.lam, o);
  } else {
    fem::nh_h<D, false>(f, f_inv, det, r, m.mu, m.half_lam, o);
  }
  const float nv = -volume[e];
#pragma unroll
  for (int i = 0; i < DD; ++i) out[DD * e + i] = nv * o[i];
}

// tiled_hessian_blocks_kernel (K9a) and tiled_implicit_force_kernel (K9b):
// the names the profiler reports.
template <int D>
__global__ void __launch_bounds__(kTile) tiled_hessian_blocks_kernel(
    const float* __restrict__ pos, const int* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, const fem::MaterialParams m, float* __restrict__ out) {
  nh_half<D, true>(pos, elem, ref_inv, volume, num_elements, m, out);
}

template <int D>
__global__ void __launch_bounds__(kTile) tiled_implicit_force_kernel(
    const float* __restrict__ pos, const int* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, const fem::MaterialParams m, float* __restrict__ out) {
  nh_half<D, false>(pos, elem, ref_inv, volume, num_elements, m, out);
}

// One launch of K9a (K_HALF) or K9b over the elements, in CTAs of kTile.
template <bool K_HALF>
int launch_nh_half(int dim, const void* pos, const void* elem,
                   const void* ref_inv, const void* volume, int num_elements,
                   const fem::MaterialParams* params, void* out,
                   void* stream) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_elements + kTile - 1) / kTile;
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* p = static_cast<const float*>(pos);
    const int* el = static_cast<const int*>(elem);
    const float* r = static_cast<const float*>(ref_inv);
    const float* v = static_cast<const float*>(volume);
    float* o = static_cast<float*>(out);
    const fem::MaterialParams m = *params;
    if (dim == 3) {
      if constexpr (K_HALF) {
        tiled_hessian_blocks_kernel<3><<<blocks, kTile, 0, s>>>(p, el, r, v, num_elements, m, o);
      } else {
        tiled_implicit_force_kernel<3><<<blocks, kTile, 0, s>>>(p, el, r, v, num_elements, m, o);
      }
    } else {
      if constexpr (K_HALF) {
        tiled_hessian_blocks_kernel<2><<<blocks, kTile, 0, s>>>(p, el, r, v, num_elements, m, o);
      } else {
        tiled_implicit_force_kernel<2><<<blocks, kTile, 0, s>>>(p, el, r, v, num_elements, m, o);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 in CTAs of kTile elements: `dim` is 2 or 3 and `material` a
// fem::Material of this library (anything else: cudaErrorInvalidValue,
// nothing launched); `params` its numbers.
extern "C" int fem_hessian_and_force(int dim, int material, const void* pos,
                                     const void* elem, const void* ref_inv,
                                     const void* volume, int num_elements,
                                     const fem::MaterialParams* params,
                                     void* k_out, void* h_out, void* stream) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_elements + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const fem::MaterialParams m = *params;
  return fem::dispatch_material<true>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    if (blocks > 0) {
      const float* p = static_cast<const float*>(pos);
      const int* el = static_cast<const int*>(elem);
      const float* r = static_cast<const float*>(ref_inv);
      const float* v = static_cast<const float*>(volume);
      float* k = static_cast<float*>(k_out);
      float* h = static_cast<float*>(h_out);
      if (dim == 3) {
        tiled_hessian_and_force_kernel<3, M><<<blocks, kTile, 0, s>>>(
            p, el, r, v, num_elements, m, k, h);
      } else {
        tiled_hessian_and_force_kernel<2, M><<<blocks, kTile, 0, s>>>(
            p, el, r, v, num_elements, m, k, h);
      }
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// K6, the same for the gradient columns, in CTAs of kTile elements (no
// robust instance: the explicit chain has no robust variant).
extern "C" int fem_explicit_grad_columns(int dim, int material,
                                         const void* pos, const void* elem,
                                         const void* ref_inv,
                                         const void* volume, int num_elements,
                                         const fem::MaterialParams* params,
                                         void* g_out, void* stream) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_elements + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const fem::MaterialParams m = *params;
  return fem::dispatch_material<false>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    if (blocks > 0) {
      const float* p = static_cast<const float*>(pos);
      const int* el = static_cast<const int*>(elem);
      const float* r = static_cast<const float*>(ref_inv);
      const float* v = static_cast<const float*>(volume);
      float* g = static_cast<float*>(g_out);
      if (dim == 3) {
        tiled_explicit_grad_columns_kernel<3, M><<<blocks, kTile, 0, s>>>(
            p, el, r, v, num_elements, m, g);
      } else {
        tiled_explicit_grad_columns_kernel<2, M><<<blocks, kTile, 0, s>>>(
            p, el, r, v, num_elements, m, g);
      }
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// K9a: the Neo-Hookean blocks K_e of every element (`dim` 2 or 3; anything
// else: cudaErrorInvalidValue, nothing launched), in CTAs of kTile
// elements; `params` the Neo-Hookean numbers (mu, lam).
extern "C" int fem_hessian_blocks(int dim, const void* pos, const void* elem,
                                  const void* ref_inv, const void* volume,
                                  int num_elements,
                                  const fem::MaterialParams* params,
                                  void* k_out, void* stream) {
  return launch_nh_half<true>(dim, pos, elem, ref_inv, volume, num_elements,
                              params, k_out, stream);
}

// K9b: the Neo-Hookean rhs force columns of every element (mu, half_lam),
// in CTAs of kTile elements.
extern "C" int fem_implicit_force(int dim, const void* pos, const void* elem,
                                  const void* ref_inv, const void* volume,
                                  int num_elements,
                                  const fem::MaterialParams* params,
                                  void* h_out, void* stream) {
  return launch_nh_half<false>(dim, pos, elem, ref_inv, volume, num_elements,
                               params, h_out, stream);
}

extern "C" const char* fem_element_chain_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
