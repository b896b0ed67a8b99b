// K2, K7b, K3 and K7a: the blocked element prep (implicit and explicit
// modes), the blocked operator apply and the blocked assembly, over the
// locality blocks of fem_tpu_torch/ops/blocking.py.
//
// K2 replaces fem_tpu/ops/blocking.py:_prep_kernel in its implicit mode
// (reached through blocked_prep): per block, the elements' edge matrices,
// the shared element chain, the K blocks and the per-slot force partials.
// K7b is the same kernel's explicit mode (reached through
// blocked_grad_prep): per block, the edge matrices, the explicit gradient
// chain (+V scaling, unclamped log) and the per-slot gradient partials.
// K3 replaces fem_tpu/ops/blocking.py:_matvec_kernel (reached through
// blocked_graph_apply): per block, S_b^T (K_b o S_b x_b), then the sum of
// each particle's block slots — G(K) x, or G(K^T) x when `transpose`.
// K7a replaces fem_tpu/ops/blocking.py:_scatter_kernel (reached through
// blocked_assemble): per block, S_b^T t of given block-ordered columns,
// then the same per-particle slot sums.
// K7b edges is _prep_kernel's edges mode (reached through
// blocked_edge_planes): per block, the edge matrix of every element slot in
// block order, for the inelastic update (ops/inelastic.py).  Padded slots
// carry the rest edge matrix (the inverse of their R^-1, as the Pallas
// kernel's _pad_x_rows computes it), so F = I downstream.  Its bound is
// bytes: it reads the block's rows and tables and writes D*D floats a slot.
//
// The two preps take one material layer: its material (fem::Material, the
// seven base materials and for K2 robust Neo-Hookean) is a template
// parameter chosen at launch, its numbers (fem::MaterialParams) a kernel
// argument, and an inelastic layer's dynamic rest-edge inverses R^-1 F_i^-1
// (B*Eb, D, D) arrive as the tables' ref_inv pointer, the pointer the
// static layer passes too.  A library built with -DFEM_MATERIAL holds one
// material's preps beside the material-independent kernels.
//
// Every kernel is templated on the dimension D in {2, 3} (the Pallas
// kernels take `dim`); the C entries launch the instance of tables->dim.
// One thread block of 256 threads per locality block (17 on the 3D
// flagship, 1 on the 2D default scene): it gathers its particles' rows into
// shared memory, runs one thread per element, and sums the contribution
// rows per local slot through the block's local plan (blocked_common.cuh).
// The per-particle kernel gives each particle one thread that sums its
// block slots through the slot plan.  Padded element slots are skipped:
// they contribute nothing.  No float atomics, so two runs are bit-identical.
//
// Bound on the H100: bytes, and far below them in practice — K2 moves about
// 0.56 MB, K7b 0.45 MB, K3 0.41 MB and K7a 0.3 MB on the 3D flagship, a
// tenth of a microsecond at 3.35 TB/s, while each launch fills only 17 of
// 132 SMs (one in 2D at the default scene) for a few microseconds of
// dependent shared-memory work.  A first kernel that is right; blocks split
// over more SMs is later work.

#include <cuda_runtime.h>

#include "blocked_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int D, int M>
__global__ void __launch_bounds__(kThreads) blocked_prep_kernel(
    fem::BlockTables T, const float* __restrict__ pos,
    const fem::MaterialParams m, float* __restrict__ k_out,
    float* __restrict__ partials) {
  constexpr int DD = D * D;
  constexpr int R = fem::rows_floats(D);
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + D * T.pb;
  const int b = blockIdx.x;
  fem::load_block_rows<D>(T, b, pos, xs);
  __syncthreads();
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < T.eb; e += blockDim.x) {
    float* k = k_out + DD * (static_cast<size_t>(b) * T.eb + e);
    if (e < nel) {
      fem::element_prep<D, M>(T, b, e, xs, m, k, t + R * e);
    } else {
#pragma unroll
      for (int i = 0; i < DD; ++i) k[i] = 0.0f;
    }
  }
  __syncthreads();
  fem::block_slot_sums<D>(T, b, t, partials + D * b * T.pb);
}

template <int D, int M>
__global__ void __launch_bounds__(kThreads) blocked_grad_prep_kernel(
    fem::BlockTables T, const float* __restrict__ pos,
    const fem::MaterialParams m, float* __restrict__ partials) {
  constexpr int R = fem::rows_floats(D);
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + D * T.pb;
  const int b = blockIdx.x;
  fem::load_block_rows<D>(T, b, pos, xs);
  __syncthreads();
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < nel; e += blockDim.x) {
    fem::element_grad<D, M>(T, b, e, xs, m, t + R * e);
  }
  __syncthreads();
  fem::block_slot_sums<D>(T, b, t, partials + D * b * T.pb);
}

// Edge matrices x (B*Eb, D, D) of every element slot of block b; padded
// slots get the inverse of their R^-1.
template <int D>
__global__ void __launch_bounds__(kThreads) blocked_edges_kernel(
    fem::BlockTables T, const float* __restrict__ pos, float* __restrict__ x) {
  constexpr int DD = D * D;
  extern __shared__ float smem[];
  float* xs = smem;
  const int b = blockIdx.x;
  fem::load_block_rows<D>(T, b, pos, xs);
  __syncthreads();
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < T.eb; e += blockDim.x) {
    const size_t slot = static_cast<size_t>(b) * T.eb + e;
    float m[DD];
    if (e < nel) {
      fem::block_edges<D>(T, b, e, xs, m);
    } else {
      float r[DD];
#pragma unroll
      for (int i = 0; i < DD; ++i) r[i] = T.ref_inv[DD * slot + i];
      fem::det_inv<D>(r, m);
    }
#pragma unroll
    for (int i = 0; i < DD; ++i) x[DD * slot + i] = m[i];
  }
}

// Per-block partials of given block-ordered columns (B*Eb, D, D): the
// contribution rows of each real element straight from `cols`, then the
// local slot sums.
template <int D>
__global__ void __launch_bounds__(kThreads) blocked_assemble_kernel(
    fem::BlockTables T, const float* __restrict__ cols,
    float* __restrict__ partials) {
  constexpr int DD = D * D;
  constexpr int R = fem::rows_floats(D);
  extern __shared__ float smem[];
  float* t = smem;
  const int b = blockIdx.x;
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < nel; e += blockDim.x) {
    float h[DD];
    const float* c = cols + DD * (static_cast<size_t>(b) * T.eb + e);
#pragma unroll
    for (int i = 0; i < DD; ++i) h[i] = c[i];
    fem::column_rows<D>(1.0f, h, t + R * e);
  }
  __syncthreads();
  fem::block_slot_sums<D>(T, b, t, partials + D * b * T.pb);
}

template <int D>
__global__ void __launch_bounds__(kThreads) blocked_matvec_kernel(
    fem::BlockTables T, const float* __restrict__ k_in,
    const float* __restrict__ x, int transpose,
    float* __restrict__ partials) {
  constexpr int DD = D * D;
  constexpr int R = fem::rows_floats(D);
  extern __shared__ float smem[];
  float* xs = smem;
  float* t = smem + D * T.pb;
  const int b = blockIdx.x;
  fem::load_block_rows<D>(T, b, x, xs);
  __syncthreads();
  const int nel = T.block_elements[b];
  for (int e = threadIdx.x; e < nel; e += blockDim.x) {
    fem::element_apply<D>(T, b, e, xs,
                          k_in + DD * (static_cast<size_t>(b) * T.eb + e),
                          transpose != 0, t + R * e);
  }
  __syncthreads();
  fem::block_slot_sums<D>(T, b, t, partials + D * b * T.pb);
}

template <int D>
__global__ void __launch_bounds__(kThreads) slot_sum_kernel(
    const int* __restrict__ ptr, const int* __restrict__ rows,
    const float* __restrict__ partials, int n, float* __restrict__ y) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) fem::particle_slot_sum<D>(ptr, rows, partials, p, y + D * p);
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

size_t work_smem(const fem::BlockTables& T) {
  return sizeof(float) * fem::block_work_floats(T.eb, T.pb, T.dim);
}

template <int D, int M>
int prep_launch(const fem::BlockTables& T, const void* pos,
                const fem::MaterialParams& m, void* k_out, void* partials,
                cudaStream_t s) {
  const size_t smem = work_smem(T);
  const int rc = prepare(blocked_prep_kernel<D, M>, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_prep_kernel<D, M><<<T.num_blocks, kThreads, smem, s>>>(
        T, static_cast<const float*>(pos), m, static_cast<float*>(k_out),
        static_cast<float*>(partials));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int slot_sum_launch(const void* slot_ptr, const void* slot_rows,
                    int num_particles, const void* partials, void* y,
                    cudaStream_t s) {
  if (num_particles <= 0) return 0;
  slot_sum_kernel<D><<<(num_particles + kThreads - 1) / kThreads, kThreads, 0,
                       s>>>(static_cast<const int*>(slot_ptr),
                            static_cast<const int*>(slot_rows),
                            static_cast<const float*>(partials), num_particles,
                            static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int matvec_launch(const fem::BlockTables& T, const void* k, const void* x,
                  int transpose, const void* slot_ptr, const void* slot_rows,
                  int num_particles, void* partials, void* y, cudaStream_t s) {
  const size_t smem = work_smem(T);
  int rc = prepare(blocked_matvec_kernel<D>, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_matvec_kernel<D><<<T.num_blocks, kThreads, smem, s>>>(
        T, static_cast<const float*>(k), static_cast<const float*>(x),
        transpose, static_cast<float*>(partials));
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return slot_sum_launch<D>(slot_ptr, slot_rows, num_particles, partials, y,
                            s);
}

template <int D, int M>
int grad_prep_launch(const fem::BlockTables& T, const void* pos,
                     const fem::MaterialParams& m, void* partials,
                     cudaStream_t s) {
  const size_t smem = work_smem(T);
  const int rc = prepare(blocked_grad_prep_kernel<D, M>, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_grad_prep_kernel<D, M><<<T.num_blocks, kThreads, smem, s>>>(
        T, static_cast<const float*>(pos), m, static_cast<float*>(partials));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int edges_launch(const fem::BlockTables& T, const void* pos, void* x,
                 cudaStream_t s) {
  const size_t smem = sizeof(float) * D * static_cast<size_t>(T.pb);
  const int rc = prepare(blocked_edges_kernel<D>, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_edges_kernel<D><<<T.num_blocks, kThreads, smem, s>>>(
        T, static_cast<const float*>(pos), static_cast<float*>(x));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int assemble_launch(const fem::BlockTables& T, const void* cols,
                    const void* slot_ptr, const void* slot_rows,
                    int num_particles, void* partials, void* y,
                    cudaStream_t s) {
  const size_t smem =
      sizeof(float) * fem::rows_floats(D) * static_cast<size_t>(T.eb);
  int rc = prepare(blocked_assemble_kernel<D>, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_assemble_kernel<D><<<T.num_blocks, kThreads, smem, s>>>(
        T, static_cast<const float*>(cols), static_cast<float*>(partials));
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return slot_sum_launch<D>(slot_ptr, slot_rows, num_particles, partials, y,
                            s);
}

bool bad_dim(const fem::BlockTables& T) { return T.dim != 2 && T.dim != 3; }

}  // namespace

// k_out (B*Eb, D, D) and partials (B*Pb, D); `material` a fem::Material of
// this library (robust Neo-Hookean included), `params` its numbers.
extern "C" int fem_blocked_prep(const fem::BlockTables* tables, const void* pos,
                                const fem::MaterialParams* params,
                                int material, void* k_out, void* partials,
                                void* stream) {
  const fem::BlockTables& T = *tables;
  if (bad_dim(T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fem::dispatch_material<true>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return T.dim == 3 ? prep_launch<3, M>(T, pos, *params, k_out, partials, s)
                      : prep_launch<2, M>(T, pos, *params, k_out, partials, s);
  });
}

// y (N, D) = G(K) x, or G(K^T) x when `transpose`; partials (B*Pb, D) is
// scratch.
extern "C" int fem_blocked_matvec(const fem::BlockTables* tables,
                                  const void* k, const void* x, int transpose,
                                  const void* slot_ptr, const void* slot_rows,
                                  int num_particles, void* partials, void* y,
                                  void* stream) {
  const fem::BlockTables& T = *tables;
  if (bad_dim(T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return T.dim == 3
             ? matvec_launch<3>(T, k, x, transpose, slot_ptr, slot_rows,
                                num_particles, partials, y, s)
             : matvec_launch<2>(T, k, x, transpose, slot_ptr, slot_rows,
                                num_particles, partials, y, s);
}

// Per-slot explicit gradient partials (B*Pb, D) at pos; `material` a
// fem::Material of this library (no robust instance), `params` its numbers.
extern "C" int fem_blocked_grad_prep(const fem::BlockTables* tables,
                                     const void* pos,
                                     const fem::MaterialParams* params,
                                     int material, void* partials,
                                     void* stream) {
  const fem::BlockTables& T = *tables;
  if (bad_dim(T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fem::dispatch_material<false>(material, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    return T.dim == 3 ? grad_prep_launch<3, M>(T, pos, *params, partials, s)
                      : grad_prep_launch<2, M>(T, pos, *params, partials, s);
  });
}

// Edge matrices x (B*Eb, D, D) of every element slot at pos.
extern "C" int fem_blocked_edges(const fem::BlockTables* tables,
                                 const void* pos, void* x, void* stream) {
  const fem::BlockTables& T = *tables;
  if (bad_dim(T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return T.dim == 3 ? edges_launch<3>(T, pos, x, s)
                    : edges_launch<2>(T, pos, x, s);
}

// y (N, D): the assembly of block-ordered columns (B*Eb, D, D); partials
// (B*Pb, D) is scratch.
extern "C" int fem_blocked_assemble(const fem::BlockTables* tables,
                                    const void* cols, const void* slot_ptr,
                                    const void* slot_rows, int num_particles,
                                    void* partials, void* y, void* stream) {
  const fem::BlockTables& T = *tables;
  if (bad_dim(T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return T.dim == 3 ? assemble_launch<3>(T, cols, slot_ptr, slot_rows,
                                         num_particles, partials, y, s)
                    : assemble_launch<2>(T, cols, slot_ptr, slot_rows,
                                         num_particles, partials, y, s);
}

extern "C" const char* fem_blocked_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
