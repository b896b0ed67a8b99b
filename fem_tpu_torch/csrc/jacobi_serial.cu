// J1, fem_jacobi_serial: the whole serial weighted-Jacobi solve of one
// implicit substep in one launch, 2D or 3D.
//
// Replaces no TPU kernel: the JAX package runs this solve as one XLA
// program, the lax.while_loop of fem_tpu/solvers/implicit.py:737
// (_jacobi_outer_loop) around the lax.scan over particle rows of
// jacobi_solve_serial_sparse (:888) or, over the dense system, of
// jacobi_solve_serial (:801).  Ported as PyTorch ops it would be a few
// launches a row, a sweep and a host read of the error a sweep; here it is
// one launch that reads nothing back before the solve ends.
//
// What it computes (reference solver/implicit.py:226-261, 391-404; the
// serial execution analysed in PARITY.md):
//   x = 0.5 b; err = |b - A x|; p_err = err; it = 0
//   while not done and err > tol and it < max_iter:
//     the sweep, rows i = 0..N-1 strictly in order, in place: row i reads
//       the x_j already updated this sweep for j < i and the old x_j for
//       j >= i (its own full old x_i included); per component k
//         num = (b_ik - (A_i x)_k) + A_ii[k,k] x_ik
//         x_ik = |A_ii[k,k]| >= 1e-6 ? omega num / A_ii[k,k] + (1 - omega) past_ik
//                                    : 0
//     e1 = |b - A x|; rollback = e1 >= p_err
//     rollback: x = past (and stop); else past = x, p_err = e1
//     err = e1; it += 1
//   outputs: x, past (the next substep's anchor), it, err
// Two row sources, one template parameter: the block-sparse rows
// (nb_ids (N, max_nb), blocks (N, max_nb, D, D); padded slots carry nb -1
// and zero blocks and are skipped) and the dense rows a_dense (N D, N D).
// The update is written with round-to-nearest intrinsics in the plain
// version's order (ops/jacobi_kernels.py); a row's product is summed in a
// fixed order (each lane's slots, then a butterfly over the warp), as is
// the error (each thread's rows, then the warps, then warp 0), so two runs
// are bit-identical.
//
// Bound on the H100: the serial chain.  A sweep's bytes are the rows (the
// flagship: 1,007 x 29 x 9 x 4 B = 1.05 MB) and b once and x written once,
// ~0.3 us at 3.35 TB/s; but its N rows are N dependent steps, each a few
// hundred cycles at least (a row's loads, its products, five shuffles a
// component, the update, two warp barriers): ~0.3-1 us a row, 0.3-1 ms a
// flagship sweep.
//
// Design (a simple right one first): one CTA of kThreads.  x, b, past and
// the diagonal A_ii[k,k] live in shared memory (4 N D floats: the
// flagship's 48 KB; opted in past 48 KB, up to a CTA's 227 KB).  Warp 0
// runs the sweep: lane l holds the row's slots l, l + 32, ... (S of them,
// S = ceil(max_nb / 32), a template parameter), and loads the next row's
// slots into registers while it works on this row, so that the blocks'
// loads (L2-resident after the first sweep) are in flight during a row's
// arithmetic.  The dense source strides the row's N D columns over the
// lanes.  The error takes the whole CTA: a thread a row (sparse) or a warp
// a row (dense), then the fixed-order reduction.  A level schedule, where
// rows whose lower neighbours are done run together, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;
// A CTA's 227 KB less room for the static shared memory (the reduction).
constexpr size_t kMaxSmem = 232448 - 1024;

struct JacobiArgs {
  const int* nb;         // (N, max_nb) sparse source; unused when dense
  const float* rows;     // (N, max_nb, D, D) sparse, or (N D, N D) dense
  const float* b;        // (N, D)
  const float* past_in;  // (N, D)
  float* x_out;          // (N, D)
  float* past_out;       // (N, D)
  int* iterations;       // (1,)
  float* error;          // (1,)
  int n;
  int max_nb;
  float omega;
  float tol;
  int max_iter;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// Row i's component k of the update from its product ax and old x_ik.
__device__ __forceinline__ float update(float b, float ax, float d, float xo,
                                        float past, float omega) {
  const float num = __fadd_rn(__fsub_rn(b, ax), __fmul_rn(d, xo));
  if (!(fabsf(d) >= 1e-6f)) return 0.0f;
  return __fadd_rn(__fdiv_rn(__fmul_rn(omega, num), d),
                   __fmul_rn(__fsub_rn(1.0f, omega), past));
}

// Lane `lane` of warp 0 writes row i from the warp's sums acc[0..D).
template <int D>
__device__ __forceinline__ void write_row(int i, int lane, const float* acc,
                                          float* x, const float* bs,
                                          const float* past, const float* dg,
                                          float omega) {
  float ax = acc[0];
#pragma unroll
  for (int k = 1; k < D; ++k)
    if (lane == k) ax = acc[k];
  const int r = D * i + lane;
  const float xo = lane < D ? x[r] : 0.0f;
  __syncwarp();
  if (lane < D) x[r] = update(bs[r], ax, dg[r], xo, past[r], omega);
  __syncwarp();
}

// The block-sparse rows, S slots a lane.
template <int D, int S>
struct Sparse {
  static __device__ float diag(const JacobiArgs& a, int r) {
    const int i = r / D, k = r % D;
    float v = 0.0f;
    for (int s = 0; s < a.max_nb; ++s)
      if (a.nb[static_cast<size_t>(i) * a.max_nb + s] == i)
        v = a.rows[((static_cast<size_t>(i) * a.max_nb + s) * D + k) * D + k];
    return v;
  }

  static __device__ __forceinline__ void load(const JacobiArgs& a, int i,
                                              int lane, float (&blk)[S][D * D],
                                              int (&nb)[S]) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int s = lane + 32 * q;
      nb[q] = -1;
      if (i < a.n && s < a.max_nb) {
        const size_t slot = static_cast<size_t>(i) * a.max_nb + s;
        nb[q] = a.nb[slot];
#pragma unroll
        for (int e = 0; e < D * D; ++e) blk[q][e] = a.rows[slot * D * D + e];
      }
    }
  }

  // Warp 0's sweep, in place on x.
  static __device__ void sweep(const JacobiArgs& a, float* x, const float* bs,
                               const float* past, const float* dg) {
    const int lane = threadIdx.x;
    float cur[S][D * D], nxt[S][D * D];
    int cur_nb[S], nxt_nb[S];
    load(a, 0, lane, cur, cur_nb);
    for (int i = 0; i < a.n; ++i) {
      load(a, i + 1, lane, nxt, nxt_nb);
      float acc[D];
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (cur_nb[q] >= 0) {
          const float* xj = x + D * cur_nb[q];
#pragma unroll
          for (int j = 0; j < D; ++j) {
            const float v = xj[j];
#pragma unroll
            for (int k = 0; k < D; ++k)
              acc[k] = __fmaf_rn(cur[q][D * k + j], v, acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = warp_sum(acc[k]);
      write_row<D>(i, lane, acc, x, bs, past, dg, a.omega);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        cur_nb[q] = nxt_nb[q];
#pragma unroll
        for (int e = 0; e < D * D; ++e) cur[q][e] = nxt[q][e];
      }
    }
  }

  // This thread's share of |b - A x|^2: a thread a row.
  static __device__ float residual(const JacobiArgs& a, const float* x,
                                   const float* bs) {
    float part = 0.0f;
    for (int r = threadIdx.x; r < a.n * D; r += kThreads) {
      const int i = r / D, k = r % D;
      float acc = 0.0f;
      for (int s = 0; s < a.max_nb; ++s) {
        const size_t slot = static_cast<size_t>(i) * a.max_nb + s;
        const int j = a.nb[slot];
        if (j < 0) continue;
        const float* blk = a.rows + (slot * D + k) * D;
#pragma unroll
        for (int jj = 0; jj < D; ++jj) acc = __fmaf_rn(blk[jj], x[D * j + jj], acc);
      }
      const float rr = __fsub_rn(bs[r], acc);
      part = __fmaf_rn(rr, rr, part);
    }
    return part;
  }
};

// The dense rows a_dense (N D, N D).
template <int D>
struct Dense {
  static __device__ float diag(const JacobiArgs& a, int r) {
    return a.rows[static_cast<size_t>(r) * a.n * D + r];
  }

  static __device__ void sweep(const JacobiArgs& a, float* x, const float* bs,
                               const float* past, const float* dg) {
    const int lane = threadIdx.x;
    const int nd = a.n * D;
    for (int i = 0; i < a.n; ++i) {
      const float* row = a.rows + static_cast<size_t>(D) * i * nd;
      float acc[D];
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = 0.0f;
      for (int c = lane; c < nd; c += 32) {
        const float v = x[c];
#pragma unroll
        for (int k = 0; k < D; ++k)
          acc[k] = __fmaf_rn(row[static_cast<size_t>(k) * nd + c], v, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = warp_sum(acc[k]);
      write_row<D>(i, lane, acc, x, bs, past, dg, a.omega);
    }
  }

  // A warp a row; lane 0 keeps the warp's share.
  static __device__ float residual(const JacobiArgs& a, const float* x,
                                   const float* bs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nd = a.n * D;
    float part = 0.0f;
    for (int r = warp; r < nd; r += kWarps) {
      const float* row = a.rows + static_cast<size_t>(r) * nd;
      float acc = 0.0f;
      for (int c = lane; c < nd; c += 32) acc = __fmaf_rn(row[c], x[c], acc);
      acc = warp_sum(acc);
      const float rr = __fsub_rn(bs[r], acc);
      if (lane == 0) part = __fmaf_rn(rr, rr, part);
    }
    return part;
  }
};

// |b - A x| over the CTA, in a fixed order; every thread returns it.
template <class Src>
__device__ float error_norm(const JacobiArgs& a, const float* x,
                            const float* bs, float* red, float* shared_err) {
  float v = warp_sum(Src::residual(a, x, bs));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < kWarps ? red[threadIdx.x] : 0.0f;
    w = warp_sum(w);
    if (threadIdx.x == 0) *shared_err = __fsqrt_rn(w);
  }
  __syncthreads();
  return *shared_err;
}

template <int D, class Src>
__global__ void __launch_bounds__(kThreads) jacobi_serial_kernel(
    const __grid_constant__ JacobiArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  __shared__ float shared_err;
  const int nd = a.n * D;
  float* x = smem;
  float* bs = x + nd;
  float* past = bs + nd;
  float* dg = past + nd;
  for (int r = threadIdx.x; r < nd; r += kThreads) {
    const float bv = a.b[r];
    bs[r] = bv;
    x[r] = __fmul_rn(0.5f, bv);
    past[r] = a.past_in[r];
    dg[r] = Src::diag(a, r);
  }
  __syncthreads();
  float err = error_norm<Src>(a, x, bs, red, &shared_err);
  float p_err = err;
  int it = 0;
  bool done = false;
  while (!done && err > a.tol && it < a.max_iter) {
    if (threadIdx.x < 32) Src::sweep(a, x, bs, past, dg);
    __syncthreads();
    const float e1 = error_norm<Src>(a, x, bs, red, &shared_err);
    const bool rollback = e1 >= p_err;
    for (int r = threadIdx.x; r < nd; r += kThreads) {
      if (rollback)
        x[r] = past[r];
      else
        past[r] = x[r];
    }
    if (!rollback) p_err = e1;
    err = e1;
    ++it;
    done = rollback;
    __syncthreads();
  }
  for (int r = threadIdx.x; r < nd; r += kThreads) {
    a.x_out[r] = x[r];
    a.past_out[r] = past[r];
  }
  if (threadIdx.x == 0) {
    *a.iterations = it;
    *a.error = err;
  }
}

using Kernel = void (*)(const JacobiArgs);

template <int D>
Kernel pick(int dense, int slots) {
  if (dense) return jacobi_serial_kernel<D, Dense<D>>;
  switch (slots) {
    case 1: return jacobi_serial_kernel<D, Sparse<D, 1>>;
    case 2: return jacobi_serial_kernel<D, Sparse<D, 2>>;
    case 4: return jacobi_serial_kernel<D, Sparse<D, 4>>;
    default: return nullptr;
  }
}

}  // namespace

// `dim` 2 or 3; `dense` 0 for the block-sparse rows (`nb`, `rows`), 1 for
// the dense rows (`rows`, `nb` unused); `slots` the sparse rows' slots a
// lane, 1, 2 or 4 (max_nb <= 32 slots).  One CTA of kThreads threads with
// 4 N dim floats of dynamic shared memory.  cudaErrorInvalidValue for an
// instance or a size the kernel does not take.
extern "C" int fem_jacobi_serial(int dim, int dense, int slots,
                                 const void* nb, const void* rows,
                                 const void* b, const void* past, int n,
                                 int max_nb, float omega, float tol,
                                 int max_iter, void* x_out, void* past_out,
                                 void* iterations, void* error, void* stream) {
  const Kernel k = dim == 3 ? pick<3>(dense, slots)
                   : dim == 2 ? pick<2>(dense, slots)
                              : nullptr;
  if (k == nullptr || n < 1 || (!dense && (max_nb < 1 || max_nb > 32 * slots)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(n) * dim;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const JacobiArgs a{static_cast<const int*>(nb),
                     static_cast<const float*>(rows),
                     static_cast<const float*>(b),
                     static_cast<const float*>(past),
                     static_cast<float*>(x_out),
                     static_cast<float*>(past_out),
                     static_cast<int*>(iterations),
                     static_cast<float*>(error),
                     n, max_nb, omega, tol, max_iter};
  k<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_jacobi_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
