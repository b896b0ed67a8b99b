// K2, K7b, K3 and K7a: the blocked element prep (implicit and explicit
// modes), the blocked operator apply and the blocked assembly, over the
// locality blocks of fem_tpu_torch/ops/blocking.py.
//
// K2 replaces fem_tpu/ops/blocking.py:_prep_kernel in its implicit mode
// (reached through blocked_prep): per block, the tets' edge matrices, the
// shared element chain, the K blocks and the per-slot force partials.
// K7b is the same kernel's explicit mode (reached through
// blocked_grad_prep): per block, the edge matrices, the explicit gradient
// chain (+V scaling, unclamped log) and the per-slot gradient partials.
// K3 replaces fem_tpu/ops/blocking.py:_matvec_kernel (reached through
// blocked_graph_apply): per block, S_b^T (K_b o S_b x_b), then the sum of
// each particle's block slots — G(K) x, or G(K^T) x when `transpose`.
// K7a replaces fem_tpu/ops/blocking.py:_scatter_kernel (reached through
// blocked_assemble): per block, S_b^T t of given block-ordered columns,
// then the same per-particle slot sums.
//
// One thread block of 256 threads per locality block (17 on the flagship):
// it gathers its particles' rows into shared memory, runs one thread per
// tet, and sums the contribution rows per local slot through the block's
// local plan (blocked_common.cuh).  The per-particle kernel gives each
// particle one thread that sums its block slots through the slot plan.
// Padded element slots are skipped: they contribute nothing.  No float
// atomics, so two runs are bit-identical.
//
// Bound on the H100: bytes, and far below them in practice — K2 moves about
// 0.56 MB, K7b 0.45 MB, K3 0.41 MB and K7a 0.3 MB on the flagship, a tenth
// of a microsecond at 3.35 TB/s, while each launch fills only 17 of 132 SMs
// for a few microseconds of dependent shared-memory work.  A first kernel
// that is right; blocks split over more SMs is later work.

#include <cuda_runtime.h>

#include "blocked_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) blocked_prep_kernel(
    fem::BlockTables T, const float* __restrict__ pos, float mu, float lam,
    float half_lam, float* __restrict__ k_out, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + 3 * T.pb;
  const int b = blockIdx.x;
  fem::load_block_rows(T, b, pos, xs);
  __syncthreads();
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < T.eb; e += blockDim.x) {
    float* k = k_out + 9 * (static_cast<size_t>(b) * T.eb + e);
    if (e < nel) {
      fem::element_prep(T, b, e, xs, mu, lam, half_lam, k, t + 12 * e);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) k[i] = 0.0f;
    }
  }
  __syncthreads();
  fem::block_slot_sums(T, b, t, partials + 3 * b * T.pb);
}

__global__ void __launch_bounds__(kThreads) blocked_grad_prep_kernel(
    fem::BlockTables T, const float* __restrict__ pos, float mu, float lam,
    float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + 3 * T.pb;
  const int b = blockIdx.x;
  fem::load_block_rows(T, b, pos, xs);
  __syncthreads();
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < nel; e += blockDim.x) {
    fem::element_grad(T, b, e, xs, mu, lam, t + 12 * e);
  }
  __syncthreads();
  fem::block_slot_sums(T, b, t, partials + 3 * b * T.pb);
}

// Per-block partials of given block-ordered columns (B*Eb, 3, 3): the
// contribution rows of each real tet straight from `cols`, then the local
// slot sums.
__global__ void __launch_bounds__(kThreads) blocked_assemble_kernel(
    fem::BlockTables T, const float* __restrict__ cols,
    float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* t = smem;
  const int b = blockIdx.x;
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < nel; e += blockDim.x) {
    float h[9];
    const float* c = cols + 9 * (static_cast<size_t>(b) * T.eb + e);
#pragma unroll
    for (int i = 0; i < 9; ++i) h[i] = c[i];
    fem::column_rows(1.0f, h, t + 12 * e);
  }
  __syncthreads();
  fem::block_slot_sums(T, b, t, partials + 3 * b * T.pb);
}

__global__ void __launch_bounds__(kThreads) blocked_matvec_kernel(
    fem::BlockTables T, const float* __restrict__ k_in,
    const float* __restrict__ x, int transpose,
    float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + 3 * T.pb;
  const int b = blockIdx.x;
  fem::load_block_rows(T, b, x, xs);
  __syncthreads();
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < nel; e += blockDim.x) {
    fem::element_apply(T, b, e, xs, k_in + 9 * (static_cast<size_t>(b) * T.eb + e),
                       transpose != 0, t + 12 * e);
  }
  __syncthreads();
  fem::block_slot_sums(T, b, t, partials + 3 * b * T.pb);
}

__global__ void __launch_bounds__(kThreads) slot_sum_kernel(
    const int* __restrict__ ptr, const int* __restrict__ rows,
    const float* __restrict__ partials, int n, float* __restrict__ y) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) fem::particle_slot_sum(ptr, rows, partials, p, y + 3 * p);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  }
  return 0;
}

}  // namespace

// k_out (B*Eb, 3, 3) and partials (B*Pb, 3).
extern "C" int fem_blocked_prep(const fem::BlockTables* tables, const void* pos,
                                float mu, float lam, float half_lam,
                                void* k_out, void* partials, void* stream) {
  const fem::BlockTables T = *tables;
  const size_t smem = sizeof(float) * fem::block_work_floats(T.eb, T.pb);
  int rc = prepare(blocked_prep_kernel, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_prep_kernel<<<T.num_blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        T, static_cast<const float*>(pos), mu, lam, half_lam,
        static_cast<float*>(k_out), static_cast<float*>(partials));
  }
  return static_cast<int>(cudaGetLastError());
}

// y (N, 3) = G(K) x, or G(K^T) x when `transpose`; partials (B*Pb, 3) is
// scratch.
extern "C" int fem_blocked_matvec(const fem::BlockTables* tables,
                                  const void* k, const void* x, int transpose,
                                  const void* slot_ptr, const void* slot_rows,
                                  int num_particles, void* partials, void* y,
                                  void* stream) {
  const fem::BlockTables T = *tables;
  const size_t smem = sizeof(float) * fem::block_work_floats(T.eb, T.pb);
  int rc = prepare(blocked_matvec_kernel, smem);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T.num_blocks > 0) {
    blocked_matvec_kernel<<<T.num_blocks, kThreads, smem, s>>>(
        T, static_cast<const float*>(k), static_cast<const float*>(x),
        transpose, static_cast<float*>(partials));
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || num_particles <= 0) return rc;
  slot_sum_kernel<<<(num_particles + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int*>(slot_ptr), static_cast<const int*>(slot_rows),
      static_cast<const float*>(partials), num_particles,
      static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

// Per-slot explicit gradient partials (B*Pb, 3) at pos.
extern "C" int fem_blocked_grad_prep(const fem::BlockTables* tables,
                                     const void* pos, float mu, float lam,
                                     void* partials, void* stream) {
  const fem::BlockTables T = *tables;
  const size_t smem = sizeof(float) * fem::block_work_floats(T.eb, T.pb);
  int rc = prepare(blocked_grad_prep_kernel, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_grad_prep_kernel<<<T.num_blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        T, static_cast<const float*>(pos), mu, lam,
        static_cast<float*>(partials));
  }
  return static_cast<int>(cudaGetLastError());
}

// y (N, 3): the assembly of block-ordered columns (B*Eb, 3, 3); partials
// (B*Pb, 3) is scratch.
extern "C" int fem_blocked_assemble(const fem::BlockTables* tables,
                                    const void* cols, const void* slot_ptr,
                                    const void* slot_rows, int num_particles,
                                    void* partials, void* y, void* stream) {
  const fem::BlockTables T = *tables;
  const size_t smem = sizeof(float) * 12 * static_cast<size_t>(T.eb);
  int rc = prepare(blocked_assemble_kernel, smem);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T.num_blocks > 0) {
    blocked_assemble_kernel<<<T.num_blocks, kThreads, smem, s>>>(
        T, static_cast<const float*>(cols), static_cast<float*>(partials));
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || num_particles <= 0) return rc;
  slot_sum_kernel<<<(num_particles + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int*>(slot_ptr), static_cast<const int*>(slot_rows),
      static_cast<const float*>(partials), num_particles,
      static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_blocked_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
