// P1: the blocked operator's per-block product with PAIR locality blocks per
// thread block — the paired-block probe.
//
// Replaces the TPU kernel of fem_tpu's tools/probe_pairblock.py
// (paired_matvec), which runs K3's kernel body (blocking.py:_matvec_kernel)
// for `pair` blocks per Pallas grid step, to test whether independent
// blocks fill each other's MXU pipeline bubbles.  Per block b it computes
//   out_b = S_b^T (K o (S_b x_b))          (D, Pb), no slot sum
// with S_b the block's +-1 incidence rows (row e*D+j: +1 at the local slot
// of vertex j+1, -1 at that of vertex 0) and K o the per-row D x D product
// with the K planes (B, D^2, Eb*D) (row e*D+j carries K_e).  The Pallas
// kernel rebuilds S_b in VMEM as a bf16 one-hot table and splits the
// values into three bf16 planes for exact MXU dots; that is Mosaic
// mechanism, none of it carried over: this kernel computes in f32 from the
// plus/minus indices, one thread an element, and sums each local slot's
// contribution rows through the block's local plan in a fixed order (no
// atomics; padded element slots, whose S rows are zero, are skipped).
//
// The Hopper counterpart of the probe's question: one thread block of
// PAIR x 256 threads holds PAIR locality blocks, each in its own group of
// 256 threads and its own shared-memory working set, so that the SM
// interleaves the blocks' independent dependency chains; PAIR = 1 is K3's
// per-block kernel (blocked.cu:blocked_matvec_kernel) on the planar
// layouts.  Bound on the H100: bytes — at the flagship's 17 blocks a
// launch reads ~0.9 MB of K planes, vectors and tables, a few tenths of a
// microsecond, while the launch itself takes several.

#include <cuda_runtime.h>

#include "blocked_common.cuh"

namespace {

constexpr int kGroup = 256;  // threads per locality block

template <int D, int PAIR>
__global__ void __launch_bounds__(kGroup * PAIR) paired_matvec_kernel(
    fem::BlockTables T, const float* __restrict__ kplane,
    const float* __restrict__ xbt, float* __restrict__ out) {
  constexpr int R = fem::rows_floats(D);
  extern __shared__ float smem[];
  const int g = threadIdx.x / kGroup;
  const int lt = threadIdx.x % kGroup;
  const int b = blockIdx.x * PAIR + g;
  const int rb = T.eb * D;  // rows of S_b
  float* xs = smem + static_cast<size_t>(g) *
                         fem::block_work_floats(T.eb, T.pb, D);
  float* t = xs + D * T.pb;
  const float* xb = xbt + static_cast<size_t>(b) * D * T.pb;
  for (int i = lt; i < D * T.pb; i += kGroup) {
    const int c = i / T.pb;
    const int p = i - c * T.pb;
    xs[D * p + c] = xb[i];
  }
  __syncthreads();
  const int nel = T.block_elements[b];
  const float* kp = kplane + static_cast<size_t>(b) * D * D * rb;
  for (int e = lt; e < nel; e += kGroup) {
    const int row = (b * T.eb + e) * D;
    const float* x0 = xs + D * T.minus[row];
    float* te = t + R * e;
    float sum[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int col = e * D + j;
      const float* xj = xs + D * T.plus[row + j];
      float dv[D];
#pragma unroll
      for (int c = 0; c < D; ++c) dv[c] = xj[c] - x0[c];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float ti = kp[static_cast<size_t>(D * i) * rb + col] * dv[0];
#pragma unroll
        for (int c = 1; c < D; ++c) {
          ti = ti + kp[static_cast<size_t>(D * i + c) * rb + col] * dv[c];
        }
        te[D * (j + 1) + i] = ti;
        sum[i] = j == 0 ? ti : sum[i] + ti;
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) te[i] = -sum[i];
  }
  __syncthreads();
  const int* ptr = T.local_ptr + b * (T.pb + 1);
  const int* rows = T.local_rows + b * T.eb * (D + 1);
  float* ob = out + static_cast<size_t>(b) * D * T.pb;
  for (int p = lt; p < T.pb; p += kGroup) {
    float a[D];
#pragma unroll
    for (int c = 0; c < D; ++c) a[c] = 0.0f;
    const int end = ptr[p + 1];
    for (int q = ptr[p]; q < end; ++q) {
      const float* r = t + D * rows[q];
#pragma unroll
      for (int c = 0; c < D; ++c) a[c] += r[c];
    }
#pragma unroll
    for (int c = 0; c < D; ++c) ob[c * T.pb + p] = a[c];
  }
}

template <int D, int PAIR>
int launch(const fem::BlockTables& T, const float* kplane, const float* xbt,
           float* out, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * PAIR * fem::block_work_floats(T.eb, T.pb, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paired_matvec_kernel<D, PAIR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (T.num_blocks > 0) {
    paired_matvec_kernel<D, PAIR>
        <<<T.num_blocks / PAIR, kGroup * PAIR, smem, s>>>(T, kplane, xbt, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_pair(const fem::BlockTables& T, int pair, const float* kplane,
                const float* xbt, float* out, cudaStream_t s) {
  switch (pair) {
    case 1:
      return launch<D, 1>(T, kplane, xbt, out, s);
    case 2:
      return launch<D, 2>(T, kplane, xbt, out, s);
    case 4:
      return launch<D, 4>(T, kplane, xbt, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (B, D, Pb) = per block S_b^T (K o (S_b x_b)) of the K planes
// (B, D^2, Eb*D) and the block-local vectors xbt (B, D, Pb); `pair` is 1, 2
// or 4 and divides the block count (anything else: cudaErrorInvalidValue,
// nothing launched).
extern "C" int fem_paired_matvec(const fem::BlockTables* tables, int pair,
                                 const void* kplane, const void* xbt,
                                 void* out, void* stream) {
  const fem::BlockTables& T = *tables;
  if ((T.dim != 2 && T.dim != 3) || pair <= 0 || T.num_blocks % pair) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(kplane);
  const float* x = static_cast<const float*>(xbt);
  float* o = static_cast<float*>(out);
  return T.dim == 3 ? launch_pair<3>(T, pair, k, x, o, s)
                    : launch_pair<2>(T, pair, k, x, o, s);
}

extern "C" const char* fem_paired_matvec_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
