// The Neo-Hookean element chains over the mesh's tets, one thread per tet.
//
// K1: per tet, the implicit system block K_e and the rhs force columns in
// one pass.  Replaces the TPU kernel fem_tpu/ops/pallas_kernels.py:
// _hessian_and_force_kernel (reached through hessian_and_force_pallas),
// which runs k_and_h_chain on component planes (9, E_pad) that XLA gathered
// and padded to 1,024-lane tiles beforehand.  K_e = -V k and H_e = -V h with
// k and h from the shared chain fem::nh_chain (element_chain.cuh: formulas
// and their order unchanged from k_and_h_chain).
//
// K6: per tet, the explicit energy-gradient columns G_e = +V g with g from
// fem::nh_grad_cols (the unclamped-log chain of grad_cols_chain).  Replaces
// fem_tpu/ops/pallas_kernels.py:_grad_cols_kernel (reached through
// explicit_grad_columns_pallas), the same planar layout as K1's.
//
// Outputs are (E, 3, 3) row-major, the layout the JAX entries return; V is
// the rest volume.
//
// Bound on the H100: bytes.  Per tet K1 reads 4 indices (16 B), 4 vertex
// positions (48 B, from L2 after first touch), R (36 B) and V (4 B), and
// writes 72 B (K6: 36 B); about 400 f32 operations per tet (K6: about 200)
// is far below the card's operation-to-byte ratio.  Design: one thread per
// tet, the vertex gather done directly (Hopper gathers, so the TPU's planar
// padding and the separate XLA gather pass are gone) and the whole chain in
// registers — nothing intermediate touches device memory.

#include <cuda_runtime.h>

#include "element_chain.cuh"

namespace {

// Edge matrix x[3*i + j] = p_{j+1}[i] - p_0[i] of tet v.
__device__ __forceinline__ void tet_edges(const float* __restrict__ pos,
                                          int4 v, float* x) {
  const int vid[3] = {v.y, v.z, v.w};
  const float p0[3] = {pos[3 * v.x], pos[3 * v.x + 1], pos[3 * v.x + 2]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) x[3 * i + j] = pos[3 * vid[j] + i] - p0[i];
  }
}

__global__ void __launch_bounds__(256) hessian_and_force_kernel(
    const float* __restrict__ pos, const int4* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, float mu, float lam, float half_lam,
    float* __restrict__ k_out, float* __restrict__ h_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_elements) return;
  float x[9];
  tet_edges(pos, elem[e], x);
  float r[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = ref_inv[9 * e + i];
  float k[9], h[9];
  fem::nh_chain(x, r, mu, lam, half_lam, k, h);
  const float nv = -volume[e];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    k_out[9 * e + i] = nv * k[i];
    h_out[9 * e + i] = nv * h[i];
  }
}

__global__ void __launch_bounds__(256) explicit_grad_columns_kernel(
    const float* __restrict__ pos, const int4* __restrict__ elem,
    const float* __restrict__ ref_inv, const float* __restrict__ volume,
    int num_elements, float mu, float lam, float* __restrict__ g_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_elements) return;
  float x[9], r[9], g[9];
  tet_edges(pos, elem[e], x);
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = ref_inv[9 * e + i];
  fem::nh_grad_cols(x, r, mu, lam, g);
  const float v = volume[e];
#pragma unroll
  for (int i = 0; i < 9; ++i) g_out[9 * e + i] = v * g[i];
}

}  // namespace

extern "C" int fem_hessian_and_force(const void* pos, const void* elem,
                                     const void* ref_inv, const void* volume,
                                     int num_elements, float mu, float lam,
                                     float half_lam, void* k_out, void* h_out,
                                     void* stream) {
  const int threads = 256;
  const int blocks = (num_elements + threads - 1) / threads;
  if (blocks > 0) {
    hessian_and_force_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const int4*>(elem),
        static_cast<const float*>(ref_inv), static_cast<const float*>(volume),
        num_elements, mu, lam, half_lam, static_cast<float*>(k_out),
        static_cast<float*>(h_out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fem_explicit_grad_columns(const void* pos, const void* elem,
                                         const void* ref_inv,
                                         const void* volume, int num_elements,
                                         float mu, float lam, void* g_out,
                                         void* stream) {
  const int threads = 256;
  const int blocks = (num_elements + threads - 1) / threads;
  if (blocks > 0) {
    explicit_grad_columns_kernel<<<blocks, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const int4*>(elem),
        static_cast<const float*>(ref_inv), static_cast<const float*>(volume),
        num_elements, mu, lam, static_cast<float*>(g_out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_element_chain_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
