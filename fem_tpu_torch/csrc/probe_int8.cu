// P2: `reps` chained dots sum_r roll(a, r, rows) @ w of a small value side
// a (rows, n) with a +-1 table w (n, cols), in three type pairs — the int8
// table probe.
//
// Replaces the TPU kernel built in fem_tpu's tools/probe_int8.py (main),
// which asks whether the fused kernels' +-1 incidence tables could stream
// through the matrix unit as int8 at twice the bf16 rate.  Variants, each a
// hand-written warp-level mma.sync (Hopper's tensor cores as one warp
// drives them):
//   0 bf16 x bf16 -> f32: mma.m16n8k16.bf16, a and w bf16;
//   1 int8 x int8 -> int32: mma.m16n8k32.s8, a and w int8, exact;
//   2 int8 x bf16 -> f32: w int8 in shared memory, widened to bf16 in
//     registers for every fragment, then the bf16 MMA — Hopper has no
//     mixed-type MMA, and this is how an int8 weight stream would ride on
//     the bf16 path.
// Every rep is a real MMA pass over all of w: the value side rotates by one
// row each rep (a_r = roll(a, r) along rows, as the Pallas kernel's
// jnp.roll), so the chain cannot be folded into one product.  The rows are
// padded to the MMA's 16 inside the kernel (fragment rows >= rows are
// zero registers).
//
// Design: one thread block per 8-column tile of w, four warps each owning a
// quarter of the contraction; the block stages its column slice of w in
// shared memory once, transposed so that every B fragment register is one
// 32-bit load (bf16, int8) or two 16-bit loads (int8 -> bf16), and a whole
// in shared memory; each warp keeps four independent accumulators
// (k-steps interleaved, unrolled so that they stay in registers) so that
// four MMAs are in flight, and at the end the accumulators and then the
// warps are summed in a fixed order.  Bound on
// the H100: operations, the MMAs — 2 rows x n x cols x reps multiply-adds
// of the 6 real rows at the card's tensor rate (989 TFLOP/s bf16, 1,979
// TOP/s int8), though the kernel issues the padded 16 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;   // warps per thread block, each a quarter of n
constexpr int kAcc = 4;     // independent accumulators per warp
constexpr int kTile = 8;    // columns per thread block (the MMA's n)
constexpr int kPadWords = 4;  // padding of each staged column, in words

enum Variant { kBf16 = 0, kInt8 = 1, kInt8Bf16 = 2 };

template <int V>
struct Traits;
template <>
struct Traits<kBf16> {
  using A = uint16_t;  // bf16 bits
  using W = uint16_t;
  using Acc = float;
  static constexpr int kStep = 16;
};
template <>
struct Traits<kInt8> {
  using A = int8_t;
  using W = int8_t;
  using Acc = int;
  static constexpr int kStep = 32;
};
template <>
struct Traits<kInt8Bf16> {
  using A = uint16_t;
  using W = int8_t;
  using Acc = float;
  static constexpr int kStep = 16;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two int8 table entries widened to a bf16 pair (lower half the first).
__device__ __forceinline__ uint32_t widen2(uint16_t pair) {
  const float lo = static_cast<float>(static_cast<int8_t>(pair & 0xff));
  const float hi = static_cast<float>(static_cast<int8_t>(pair >> 8));
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32) chained_dot_kernel(
    const void* __restrict__ a_in, const void* __restrict__ w_in, int rows,
    int n, int cols, int reps, void* __restrict__ out) {
  using T = Traits<V>;
  using A = typename T::A;
  using W = typename T::W;
  using Acc = typename T::Acc;
  constexpr int kStep = T::kStep;
  extern __shared__ __align__(16) unsigned char smem[];
  // Staged: a (rows, n), then w's column slice transposed, (kTile, n + pad).
  A* a_s = reinterpret_cast<A*>(smem);
  const size_t a_bytes = (static_cast<size_t>(rows) * n * sizeof(A) + 15) /
                         16 * 16;
  W* w_s = reinterpret_cast<W*>(smem + a_bytes);
  const int ldw = n + kPadWords * 4 / static_cast<int>(sizeof(W));
  Acc* red = reinterpret_cast<Acc*>(
      smem + a_bytes + (static_cast<size_t>(kTile) * ldw * sizeof(W) + 15) /
                           16 * 16);
  const A* a = static_cast<const A*>(a_in);
  const W* w = static_cast<const W*>(w_in);
  const int col0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) a_s[i] = a[i];
  for (int i = threadIdx.x; i < kTile * n; i += blockDim.x) {
    const int c = i % kTile;
    const int k = i / kTile;
    w_s[c * ldw + k] = w[static_cast<size_t>(k) * cols + col0 + c];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (and B column)
  const int t = lane & 3;   // position in the quad
  const int k_per_warp = n / kWarps;
  const int k_begin = warp * k_per_warp;
  Acc acc[kAcc][4];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  }
  const W* wcol = w_s + g * ldw;
  for (int r = 0; r < reps; ++r) {
    // Row m of a_r is a[(m - r) mod rows]; rows >= `rows` are padding.
    const int shift = r % rows;
    const int m0 = g, m1 = g + 8;
    const A* row0 = m0 < rows ? a_s + ((m0 - shift + rows) % rows) * n
                              : nullptr;
    const A* row1 = m1 < rows ? a_s + ((m1 - shift + rows) % rows) * n
                              : nullptr;
    for (int k0 = k_begin; k0 < k_begin + k_per_warp; k0 += kStep * kAcc) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int k = k0 + j * kStep;
        uint32_t af[4], bf[2];
        if constexpr (V == kInt8) {
          const int ka = k + 4 * t;
          af[0] = row0 ? *reinterpret_cast<const uint32_t*>(row0 + ka) : 0u;
          af[1] = row1 ? *reinterpret_cast<const uint32_t*>(row1 + ka) : 0u;
          af[2] = row0 ? *reinterpret_cast<const uint32_t*>(row0 + ka + 16)
                       : 0u;
          af[3] = row1 ? *reinterpret_cast<const uint32_t*>(row1 + ka + 16)
                       : 0u;
          bf[0] = *reinterpret_cast<const uint32_t*>(wcol + ka);
          bf[1] = *reinterpret_cast<const uint32_t*>(wcol + ka + 16);
          mma_s8(acc[j], af, bf);
        } else {
          const int ka = k + 2 * t;
          af[0] = row0 ? *reinterpret_cast<const uint32_t*>(row0 + ka) : 0u;
          af[1] = row1 ? *reinterpret_cast<const uint32_t*>(row1 + ka) : 0u;
          af[2] = row0 ? *reinterpret_cast<const uint32_t*>(row0 + ka + 8)
                       : 0u;
          af[3] = row1 ? *reinterpret_cast<const uint32_t*>(row1 + ka + 8)
                       : 0u;
          if constexpr (V == kBf16) {
            bf[0] = *reinterpret_cast<const uint32_t*>(wcol + ka);
            bf[1] = *reinterpret_cast<const uint32_t*>(wcol + ka + 8);
          } else {
            bf[0] = widen2(*reinterpret_cast<const uint16_t*>(wcol + ka));
            bf[1] = widen2(*reinterpret_cast<const uint16_t*>(wcol + ka + 8));
          }
          mma_bf16(acc[j], af, bf);
        }
      }
    }
  }
  // The accumulators in order, then the warps in order, by warp 0.
  Acc sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum[i] = acc[0][i];
#pragma unroll
    for (int j = 1; j < kAcc; ++j) sum[i] += acc[j][i];
    red[(warp * 32 + lane) * 4 + i] = sum[i];
  }
  __syncthreads();
  if (warp != 0) return;
  Acc* o = static_cast<Acc*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Acc v = red[lane * 4 + i];
    for (int q = 1; q < kWarps; ++q) v += red[(q * 32 + lane) * 4 + i];
    const int m = g + (i >= 2 ? 8 : 0);
    const int col = col0 + 2 * t + (i & 1);
    if (m < rows) o[static_cast<size_t>(m) * cols + col] = v;
  }
}

template <int V>
int launch(const void* a, const void* w, int rows, int n, int cols, int reps,
           void* out, cudaStream_t s) {
  using T = Traits<V>;
  if (n % (kWarps * kAcc * T::kStep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t a_bytes =
      (static_cast<size_t>(rows) * n * sizeof(typename T::A) + 15) / 16 * 16;
  const int ldw = n + kPadWords * 4 / static_cast<int>(sizeof(typename T::W));
  const size_t w_bytes =
      (static_cast<size_t>(kTile) * ldw * sizeof(typename T::W) + 15) / 16 *
      16;
  const size_t smem =
      a_bytes + w_bytes + kWarps * 32 * 4 * sizeof(typename T::Acc);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chained_dot_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chained_dot_kernel<V><<<cols / kTile, kWarps * 32, smem, s>>>(
      a, w, rows, n, cols, reps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The contraction n must be a multiple of 4 warps x 4 accumulators x the
// k-step (256 for the bf16 MMA, 512 for the int8 one), cols a multiple of
// 8 and rows in 1 .. 16; anything else, or an unknown variant:
// cudaErrorInvalidValue, nothing launched.
extern "C" int fem_chained_dot(int variant, const void* a, const void* w,
                               int rows, int n, int cols, int reps, void* out,
                               void* stream) {
  if (rows < 1 || rows > 16 || n <= 0 || cols <= 0 || cols % kTile ||
      reps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBf16:
      return launch<kBf16>(a, w, rows, n, cols, reps, out, s);
    case kInt8:
      return launch<kInt8>(a, w, rows, n, cols, reps, out, s);
    case kInt8Bf16:
      return launch<kInt8Bf16>(a, w, rows, n, cols, reps, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fem_chained_dot_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
