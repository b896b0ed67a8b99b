// The Neo-Hookean element chains over the mesh's elements, one thread per
// element (a tet in 3D, a triangle in 2D).
//
// K1: per element, the implicit system block K_e and the rhs force columns
// in one pass.  Replaces the TPU kernel fem_tpu/ops/pallas_kernels.py:
// _hessian_and_force_kernel (reached through hessian_and_force_pallas),
// which runs k_and_h_chain on component planes (D², E_pad) that XLA
// gathered and padded to 1,024-lane tiles beforehand.  K_e = -V k and
// H_e = -V h with k and h from the shared chain fem::nh_chain
// (element_chain.cuh: formulas and their order unchanged from
// k_and_h_chain).
//
// K6: per element, the explicit energy-gradient columns G_e = +V g with g
// from fem::nh_grad_cols (the unclamped-log chain of grad_cols_chain).
// Replaces fem_tpu/ops/pallas_kernels.py:_grad_cols_kernel (reached through
// explicit_grad_columns_pallas), the same planar layout as K1's.
//
// Both are templated on the dimension D in {2, 3}, as the Pallas kernels
// take `dim`, and on the material M (Neo-Hookean, or the stable
// Neo-Hookean of the inelastic extension's Maxwell branch, as the Pallas
// chains take `material`); each C entry takes `dim` and `material` and
// launches that instance.  A material layer's dynamic rest-edge inverse
// R^-1 F_i^-1 is simply the ref_inv the launch is given.  Outputs
// are (E, D, D) row-major, the layout the JAX entries return; V is the rest
// volume (area in 2D).
//
// Bound on the H100: bytes.  Per tet K1 reads 4 indices (16 B), 4 vertex
// positions (48 B, from L2 after first touch), R (36 B) and V (4 B), and
// writes 72 B (K6: 36 B); about 400 f32 operations per tet (K6: about 200)
// is far below the card's operation-to-byte ratio.  A triangle moves
// 12 + 24 + 16 + 4 B in and 32 B out (K6: 16 B) for about 130 operations
// (K6: about 70).  Design: one thread per element, the vertex gather done
// directly (Hopper gathers, so the TPU's planar padding and the separate XLA
// gather pass are gone) and the whole chain in registers — nothing
// intermediate touches device memory.

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

template <int D, int M>
__global__ void __launch_bounds__(256) hessian_and_force_kernel(
    const float* __restrict__ pos, const int* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, float mu, float lam, float half_lam,
    float* __restrict__ k_out, float* __restrict__ h_out) {
  constexpr int DD = D * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_elements) return;
  float x[DD];
  element_edges<D>(pos, elem, e, x);
  float r[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = ref_inv[DD * e + i];
  float k[DD], h[DD];
  fem::material_chain<D, M>(x, r, mu, lam, half_lam, k, h);
  const float nv = -volume[e];
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    k_out[DD * e + i] = nv * k[i];
    h_out[DD * e + i] = nv * h[i];
  }
}

template <int D, int M>
__global__ void __launch_bounds__(256) explicit_grad_columns_kernel(
    const float* __restrict__ pos, const int* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, float mu, float lam, float* __restrict__ g_out) {
  constexpr int DD = D * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_elements) return;
  float x[DD], r[DD], g[DD];
  element_edges<D>(pos, elem, e, x);
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = ref_inv[DD * e + i];
  fem::material_grad_cols<D, M>(x, r, mu, lam, g);
  const float v = volume[e];
#pragma unroll
  for (int i = 0; i < DD; ++i) g_out[DD * e + i] = v * g[i];
}

template <int D, int M>
void launch_hessian_and_force(int blocks, cudaStream_t s, const void* pos,
                              const void* elem, const void* ref_inv,
                              const void* volume, int num_elements, float mu,
                              float lam, float half_lam, void* k_out,
                              void* h_out) {
  hessian_and_force_kernel<D, M><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(pos), static_cast<const int*>(elem),
      static_cast<const float*>(ref_inv), static_cast<const float*>(volume),
      num_elements, mu, lam, half_lam, static_cast<float*>(k_out),
      static_cast<float*>(h_out));
}

template <int D, int M>
void launch_grad_columns(int blocks, cudaStream_t s, const void* pos,
                         const void* elem, const void* ref_inv,
                         const void* volume, int num_elements, float mu,
                         float lam, void* g_out) {
  explicit_grad_columns_kernel<D, M><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(pos), static_cast<const int*>(elem),
      static_cast<const float*>(ref_inv), static_cast<const float*>(volume),
      num_elements, mu, lam, static_cast<float*>(g_out));
}

bool bad_args(int dim, int material) {
  return (dim != 2 && dim != 3) ||
         (material != fem::kNeoHookean && material != fem::kStableNeoHookean);
}

}  // namespace

// `dim` is 2 or 3 and `material` a fem::Material (anything else:
// cudaErrorInvalidValue, nothing launched).
extern "C" int fem_hessian_and_force(int dim, int material, const void* pos,
                                     const void* elem, const void* ref_inv,
                                     const void* volume, int num_elements,
                                     float mu, float lam, float half_lam,
                                     void* k_out, void* h_out, void* stream) {
  if (bad_args(dim, material)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_elements + 255) / 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const bool snh = material == fem::kStableNeoHookean;
    auto launch = dim == 3
        ? (snh ? launch_hessian_and_force<3, fem::kStableNeoHookean>
               : launch_hessian_and_force<3, fem::kNeoHookean>)
        : (snh ? launch_hessian_and_force<2, fem::kStableNeoHookean>
               : launch_hessian_and_force<2, fem::kNeoHookean>);
    launch(blocks, s, pos, elem, ref_inv, volume, num_elements, mu, lam,
           half_lam, k_out, h_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fem_explicit_grad_columns(int dim, int material,
                                         const void* pos, const void* elem,
                                         const void* ref_inv,
                                         const void* volume, int num_elements,
                                         float mu, float lam, void* g_out,
                                         void* stream) {
  if (bad_args(dim, material)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_elements + 255) / 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const bool snh = material == fem::kStableNeoHookean;
    auto launch = dim == 3
        ? (snh ? launch_grad_columns<3, fem::kStableNeoHookean>
               : launch_grad_columns<3, fem::kNeoHookean>)
        : (snh ? launch_grad_columns<2, fem::kStableNeoHookean>
               : launch_grad_columns<2, fem::kNeoHookean>);
    launch(blocks, s, pos, elem, ref_inv, volume, num_elements, mu, lam,
           g_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_element_chain_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
