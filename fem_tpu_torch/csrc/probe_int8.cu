// P2: `reps` chained dots sum_r roll(a, r, rows) @ w of a small value side
// a (rows, n) with a +-1 table w (n, cols), in three type pairs — the int8
// table probe.
//
// Replaces the TPU kernel built in fem_tpu's tools/probe_int8.py (main),
// which asks whether the fused kernels' +-1 incidence tables could stream
// through the matrix unit as int8 at twice the bf16 rate.  Variants, each on
// Hopper's warpgroup MMA (wgmma, sm_90a):
//   0 bf16 x bf16 -> f32: wgmma m64nNk16 .f32.bf16.bf16;
//   1 int8 x int8 -> int32: wgmma m64nNk32 .s32.s8.s8, exact;
//   2 int8 x bf16 -> f32: w travels to shared memory as int8 and is widened
//     to bf16 there once a CTA, then takes the bf16 wgmma of variant 0 —
//     Hopper has no mixed-type MMA, so this is how an int8 weight stream
//     would ride on the bf16 path.
// Every rep stays a real product on the tensor cores: nothing is folded by
// linearity (sum_r roll(a, r)) or by the rotation's period (r mod rows).
//
// Design: the reps are stacked along M, as one library GEMM over the stacked
// rotations would: stacked row G = r rows + i holds a[(i - r) mod rows].  A
// tile of 64 accumulator rows takes H = rows floor(64 / rows) stacked rows,
// i.e. whole reps, so accumulator row j always holds output row j mod rows
// and consecutive tiles accumulate into the SAME registers; rows j >= H and
// rows past the last rep are zero.  The epilogue sums each output row's
// accumulator rows in ascending j.  At the defaults (rows 6, n 1,024, cols
// 2,048, reps 200) that is 20 tiles of 64 rows for 1,200 real rows (94 %
// of the issued MACs real).
//   Grid: clusters of C CTAs per N-column slice of w (N = 256 where cols
// allows, else 64: the wgmma's N), the cluster splitting K — rank q takes
// the 64-row chunks [q NC / C, (q+1) NC / C) of w's NC = n / 64 — and every
// CTA running all the tiles over its chunk, so that one wgmma m64n256 does
// four m64n64's work for one A fragment.  A CTA stages its w chunk in
// shared memory once by TMA (cp.async.bulk.tensor, one mbarrier): bf16
// straight into the layout the wgmma reads (MN-major, 128-byte swizzle, 64
// columns an atom); int8 as it lies (N-major) and then, once, transposed
// into the K-major layout the s8 wgmma needs (variant 1) or widened into
// the bf16 layout (variant 2).  Its columns of a sit in shared memory with
// each 32-byte K chunk's words permuted so that a thread's A fragment of a
// k-step is one 8-byte load per row; the A operand comes from registers,
// read through the rotation's row map (a zero row stands for the padding).
// Two warpgroups split the CTA's K steps; each issues one wgmma a k-step,
// two in flight.  Epilogue: the two warpgroups' accumulators through shared
// memory, summed (warpgroup 0 + warpgroup 1) and folded by row in ascending
// j; then the cluster's ranks read each other's partial sums through
// distributed shared memory and add them in rank order.  Every order is
// fixed, so two runs are bit-identical (int8's sums are exact in any order).
//   The kernel counts the MACs it issues: each warpgroup adds its wgmmas x
// 64 x N x k to one 64-bit counter (zeroed by the launch), which at the end
// holds tiles x 64 x n x cols.
//
// Bound on the H100: operations, the MMAs — 2 rows n cols reps of the real
// rows at the card's tensor rate (989 TFLOP/s bf16, 1,979 TOP/s int8); the
// kernel issues 64 / H more.  Limits: rows 1..64, n and cols multiples of
// 64, the CTA's staging within its shared memory (fem_chained_dot_smem).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTileM = 64;     // the wgmma's M
constexpr int kChunk = 64;     // rows of w per K chunk and per TMA box
constexpr int kAtom = 64;      // bf16 columns of a 128-byte swizzle atom
constexpr int kAccPad = 8;     // words of padding per staged accumulator row
constexpr int kMaxCluster = 16;

enum Variant { kBf16 = 0, kInt8 = 1, kInt8Bf16 = 2 };

// Bytes per element of a, and K per wgmma, of each variant.
__host__ __device__ constexpr int a_size(int v) { return v == kInt8 ? 1 : 2; }
__host__ __device__ constexpr int k_step(int v) { return v == kInt8 ? 32 : 16; }

struct Layout {
  int kc;         // rows of w a CTA stages (its K chunks, at most)
  int b_bytes;    // the wgmma's B operand
  int raw_bytes;  // the int8 chunk as TMA brings it (variants 1, 2)
  int a_stride;   // bytes per staged row of a
  int a_bytes;    // rows + 1 (the zero row) staged rows
  int main_bytes;  // the MMA phase's region, or the staged accumulators
  int bar_off;    // the mbarrier
  int part_off;   // this CTA's partial sums (rows, N)
  int total;      // with 1,024 bytes of alignment slack
};

// The shared memory of a CTA of variant v at slice width bn: `rows` rows of
// a, K split over `cluster` ranks of n / 64 chunks.
__host__ __device__ inline Layout layout(int v, int bn, int rows, int n,
                                         int cluster) {
  Layout L;
  const int chunks = n / kChunk;
  L.kc = (chunks + cluster - 1) / cluster * kChunk;
  L.b_bytes = L.kc * bn * (v == kInt8 ? 1 : 2);
  L.raw_bytes = v == kBf16 ? 0 : L.kc * bn;
  L.a_stride = L.kc * a_size(v) + 32;
  L.a_bytes = (rows + 1) * L.a_stride;
  const int mma = L.b_bytes + L.raw_bytes + L.a_bytes;
  const int acc = 2 * kTileM * (bn + kAccPad) * 4;
  L.main_bytes = ((mma > acc ? mma : acc) + 15) / 16 * 16;
  L.bar_off = L.main_bytes;
  L.part_off = L.bar_off + 16;
  L.total = 1024 + L.part_off + rows * bn * 4;
  return L;
}

struct DotArgs {
  const void* a;     // (rows, n)
  void* out;         // (rows, cols) f32 or int32
  unsigned long long* macs;  // (1,) issued MACs, zeroed by the launch
  void* scratch;     // (slices, groups, rows, N) the tile groups' partials
  int* tickets;      // (slices, C) zeroed by the launch
  int rows;
  int n;
  int cols;
  int reps;
  int per_tile;  // H = rows floor(64 / rows)
  int tiles;     // ceil(reps rows / H)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode (0 none, 1 128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3ffff) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3ffff) >> 4) << 32) |
         (swizzle << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define FEM_F(x) "+f"(x)
#define FEM_R(x) "+r"(x)
#define FEM_ACC32(T) \
      T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]), T(c[5]), T(c[6]), T(c[7]), \
      T(c[8]), T(c[9]), T(c[10]), T(c[11]), T(c[12]), T(c[13]), T(c[14]), T(c[15]), \
      T(c[16]), T(c[17]), T(c[18]), T(c[19]), T(c[20]), T(c[21]), T(c[22]), T(c[23]), \
      T(c[24]), T(c[25]), T(c[26]), T(c[27]), T(c[28]), T(c[29]), T(c[30]), T(c[31])
#define FEM_ACC128(T) \
      T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]), T(c[5]), T(c[6]), T(c[7]), \
      T(c[8]), T(c[9]), T(c[10]), T(c[11]), T(c[12]), T(c[13]), T(c[14]), T(c[15]), \
      T(c[16]), T(c[17]), T(c[18]), T(c[19]), T(c[20]), T(c[21]), T(c[22]), T(c[23]), \
      T(c[24]), T(c[25]), T(c[26]), T(c[27]), T(c[28]), T(c[29]), T(c[30]), T(c[31]), \
      T(c[32]), T(c[33]), T(c[34]), T(c[35]), T(c[36]), T(c[37]), T(c[38]), T(c[39]), \
      T(c[40]), T(c[41]), T(c[42]), T(c[43]), T(c[44]), T(c[45]), T(c[46]), T(c[47]), \
      T(c[48]), T(c[49]), T(c[50]), T(c[51]), T(c[52]), T(c[53]), T(c[54]), T(c[55]), \
      T(c[56]), T(c[57]), T(c[58]), T(c[59]), T(c[60]), T(c[61]), T(c[62]), T(c[63]), \
      T(c[64]), T(c[65]), T(c[66]), T(c[67]), T(c[68]), T(c[69]), T(c[70]), T(c[71]), \
      T(c[72]), T(c[73]), T(c[74]), T(c[75]), T(c[76]), T(c[77]), T(c[78]), T(c[79]), \
      T(c[80]), T(c[81]), T(c[82]), T(c[83]), T(c[84]), T(c[85]), T(c[86]), T(c[87]), \
      T(c[88]), T(c[89]), T(c[90]), T(c[91]), T(c[92]), T(c[93]), T(c[94]), T(c[95]), \
      T(c[96]), T(c[97]), T(c[98]), T(c[99]), T(c[100]), T(c[101]), T(c[102]), T(c[103]), \
      T(c[104]), T(c[105]), T(c[106]), T(c[107]), T(c[108]), T(c[109]), T(c[110]), T(c[111]), \
      T(c[112]), T(c[113]), T(c[114]), T(c[115]), T(c[116]), T(c[117]), T(c[118]), T(c[119]), \
      T(c[120]), T(c[121]), T(c[122]), T(c[123]), T(c[124]), T(c[125]), T(c[126]), T(c[127])

// c += A B: A (64 x 16 bf16) from registers, B (16 x 64 bf16, MN-major)
// from shared memory.
__device__ __forceinline__ void mma_bf16_64(float (&c)[32], const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FEM_ACC32(FEM_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// c += A B: A (64 x 16 bf16) from registers, B (16 x 256 bf16, MN-major)
// from shared memory.
__device__ __forceinline__ void mma_bf16_256(float (&c)[128], const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : FEM_ACC128(FEM_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// c += A B: A (64 x 32 s8) from registers, B (32 x 64 s8, K-major) from
// shared memory.
__device__ __forceinline__ void mma_s8_64(int (&c)[32], const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : FEM_ACC32(FEM_R)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// c += A B: A (64 x 32 s8) from registers, B (32 x 256 s8, K-major) from
// shared memory.
__device__ __forceinline__ void mma_s8_256(int (&c)[128], const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      : FEM_ACC128(FEM_R)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One k-step of variant V at slice width BN from B's k-step at shared address
// b: bf16 MN-major with the 128-byte swizzle (8-row groups 1,024 bytes
// apart, 64-column atoms `lbo` apart), or int8 K-major unswizzled (16-byte
// K chunks `lbo` = 16 BN apart, 8-row groups 128).
template <int V, int BN, typename Acc>
__device__ __forceinline__ void mma(Acc (&c)[BN / 2], const uint32_t (&a)[4],
                                    uint32_t b, uint32_t lbo) {
  if constexpr (V == kInt8) {
    if constexpr (BN == 256) {
      mma_s8_256(c, a, desc(b, lbo, 128, 0));
    } else {
      mma_s8_64(c, a, desc(b, lbo, 128, 0));
    }
  } else {
    if constexpr (BN == 256) {
      mma_bf16_256(c, a, desc(b, lbo, 1024, 1));
    } else {
      mma_bf16_64(c, a, desc(b, lbo, 1024, 1));
    }
  }
}

// Pins the accumulators' registers, so that no access to them moves across
// a wgmma wait.
template <typename T, int N>
__device__ __forceinline__ void fence_acc(T (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same_v<T, float>) {
      asm volatile("" : "+f"(c[i])::"memory");
    } else {
      asm volatile("" : "+r"(c[i])::"memory");
    }
  }
}

// A thread's A fragment of one k-step: 8 bytes of each of its two rows (the
// chunk's words permuted at staging, see stage_a).
__device__ __forceinline__ void load_a(uint32_t (&f)[4],
                                       const unsigned char* r0,
                                       const unsigned char* r1, int off) {
  const uint2 x = *reinterpret_cast<const uint2*>(r0 + off);
  const uint2 y = *reinterpret_cast<const uint2*>(r1 + off);
  f[0] = x.x;
  f[2] = x.y;
  f[1] = y.x;
  f[3] = y.y;
}

// a's columns [k0, k0 + kc) into shared memory, rows of a_stride bytes,
// then one zero row.  Within each 32-byte K chunk (a bf16 k-step of 16
// values, an int8 one of 32) the logical 4-byte word w goes to word
// 2 (w mod 4) + w / 4: the wgmma's A fragment gives quad thread t words t
// and t + 4 of a row, now adjacent.
__device__ void stage_a(const DotArgs& p, int v, int k0, int kc,
                        unsigned char* a_s, int a_stride) {
  const uint32_t* a = static_cast<const uint32_t*>(p.a);
  const int size = a_size(v);
  const int row_words = p.n * size / 4;
  const int words = kc * size / 4;  // staged per row
  const int w0 = k0 * size / 4;
  const int stride_w = a_stride / 4;
  uint32_t* dst = reinterpret_cast<uint32_t*>(a_s);
  for (int i = threadIdx.x; i < (p.rows + 1) * stride_w; i += blockDim.x) {
    const int row = i / stride_w;
    const int pw = i - row * stride_w;  // physical word
    uint32_t val = 0;
    if (row < p.rows && pw < words) {
      const int chunk = pw & ~7;
      const int q = pw & 7;
      const int lw = (q >> 1) + 4 * (q & 1);  // logical word
      val = a[row * row_words + w0 + chunk + lw];
    }
    dst[i] = val;
  }
}

// The int8 chunk raw (kc rows of BN bytes, N-major) into the s8 wgmma's
// K-major layout without swizzle: byte (column c, k) at (k / 16) 16 BN +
// (c / 8) 128 + (c mod 8) 16 + k mod 16.  A thread takes 4 columns x 16 k.
template <int BN>
__device__ void transpose_int8(const unsigned char* raw, unsigned char* b,
                               int kc) {
  const int units = (kc / 16) * (BN / 4);
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int kb = u / (BN / 4);
    const int cq = u - kb * (BN / 4);
    uint32_t col[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[r] = *reinterpret_cast<const uint32_t*>(
            raw + (16 * kb + 4 * g + r) * BN + 4 * cq);
      }
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      col[0][g] = __byte_perm(t0, t1, 0x5410);
      col[1][g] = __byte_perm(t0, t1, 0x7632);
      col[2][g] = __byte_perm(t2, t3, 0x5410);
      col[3][g] = __byte_perm(t2, t3, 0x7632);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = 4 * cq + c;
      *reinterpret_cast<uint4*>(b + kb * 16 * BN + (cc >> 3) * 128 +
                                (cc & 7) * 16) =
          make_uint4(col[c][0], col[c][1], col[c][2], col[c][3]);
    }
  }
}

// The int8 chunk raw widened to bf16 in the layout TMA gives the bf16
// variant: 64-column atoms kc 128 bytes apart; in an atom, row k at 128 k
// bytes and its 16-byte chunk q at (q xor k mod 8).
template <int BN>
__device__ void widen_int8(const unsigned char* raw, unsigned char* b,
                           int kc) {
  for (int u = threadIdx.x; u < kc * (BN / 8); u += blockDim.x) {
    const int k = u / (BN / 8);
    const int c8 = u - k * (BN / 8);  // 8-column group
    const int atom = c8 >> 3;
    const int q = c8 & 7;
    const uint2 src = *reinterpret_cast<const uint2*>(raw + k * BN + 8 * c8);
    const int8_t* s = reinterpret_cast<const int8_t*>(&src);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(
          static_cast<float>(s[2 * i]), static_cast<float>(s[2 * i + 1]));
      o[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(b + atom * kc * 128 + k * 128 +
                              ((q ^ (k & 7)) << 4)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int V, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    chained_dot_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ DotArgs p) {
  using Acc = typename std::conditional<V == kInt8, int, float>::type;
  constexpr int kK = k_step(V);
  constexpr int kAccStride = BN + kAccPad;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const Layout L = layout(V, BN, p.rows, p.n, csize);
  unsigned char* b_s = smem;
  unsigned char* raw = smem + L.b_bytes;
  unsigned char* a_s = smem + L.b_bytes + L.raw_bytes;
  const uint32_t bar = smem_addr(smem + L.bar_off);
  Acc* part = reinterpret_cast<Acc*>(smem + L.part_off);
  const int col0 = blockIdx.x * BN;
  // This cluster's tile group, and this rank's K chunks.
  const int groups = static_cast<int>(gridDim.z);
  const int grp = static_cast<int>(blockIdx.z);
  const int t_begin = grp * p.tiles / groups;
  const int t_end = (grp + 1) * p.tiles / groups;
  const int chunks = p.n / kChunk;
  const int c_begin = rank * chunks / csize;
  const int kc = (rank + 1) * chunks / csize * kChunk - c_begin * kChunk;
  const int k0 = c_begin * kChunk;

  // w's chunk by TMA, one mbarrier for all its boxes: 64 rows x 64 bf16
  // columns (one swizzle atom), or 64 rows x BN int8 columns.
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && kc > 0) {
    const uint32_t bytes = static_cast<uint32_t>(kc * BN *
                                                 (V == kBf16 ? 2 : 1));
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
    const int atoms = V == kBf16 ? BN / kAtom : 1;
    for (int at = 0; at < atoms; ++at) {
      for (int kb = 0; kb < kc; kb += kChunk) {
        unsigned char* dst = V == kBf16 ? b_s + at * kc * 128 + kb * 128
                                        : raw + kb * BN;
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
                smem_addr(dst)),
            "l"(reinterpret_cast<uint64_t>(&wmap)),
            "r"(col0 + (V == kBf16 ? at * kAtom : 0)), "r"(k0 + kb), "r"(bar)
            : "memory");
      }
    }
  }
  stage_a(p, V, k0, kc, a_s, L.a_stride);
  if (kc > 0) mbar_wait(bar, 0);
  if constexpr (V == kInt8) transpose_int8<BN>(raw, b_s, kc);
  if constexpr (V == kInt8Bf16) widen_int8<BN>(raw, b_s, kc);
  if constexpr (V != kBf16) {
    // Generic-proxy writes of the operand, then the async proxy reads it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // Every tile over this warpgroup's half of the CTA's K steps.
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ks = kc / kK;
  const int k_begin = wg * (ks / 2);
  const int k_end = k_begin + ks / 2;
  const uint32_t b_addr = smem_addr(b_s);
  // B's k-step: 16 (bf16) or 32 (int8) rows of K on, and its atom stride.
  const uint32_t step = V == kInt8 ? 32 * BN : 2048;
  const uint32_t lbo = V == kInt8 ? 16 * BN : kc * 128;
  const int stacked = p.reps * p.rows;
  Acc c[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) c[i] = 0;
  int issued = 0;
  for (int tile = t_begin; tile < t_end && k_begin < k_end; ++tile) {
    // Row j of the tile is stacked row tile H + j: a[(i - r) mod rows]
    // with i = j mod rows and r its rep; the zero row past the end.
    const unsigned char* rp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 16 * warp + g + 8 * h;
      const int gi = tile * p.per_tile + j;
      int src = p.rows;
      if (j < p.per_tile && gi < stacked) {
        const int i = j % p.rows;
        const int r = (gi / p.rows) % p.rows;
        src = (i - r + p.rows) % p.rows;
      }
      rp[h] = a_s + src * L.a_stride + 8 * t;
    }
    uint32_t fa[4], fb[4];
    wg_wait<0>();  // the last tile's wgmmas have read fa and fb
    load_a(fa, rp[0], rp[1], k_begin * 32);
    for (int k = k_begin; k < k_end; k += 2) {
      wg_fence();
      fence_acc(c);
      mma<V, BN>(c, fa, b_addr + step * k, lbo);
      wg_commit();
      wg_wait<1>();  // the wgmma that read fb is done
      ++issued;
      if (k + 1 < k_end) {
        load_a(fb, rp[0], rp[1], (k + 1) * 32);
        wg_fence();
        fence_acc(c);
        mma<V, BN>(c, fb, b_addr + step * (k + 1), lbo);
        wg_commit();
        wg_wait<1>();  // the wgmma that read fa is done
        ++issued;
      }
      if (k + 2 < k_end) load_a(fa, rp[0], rp[1], (k + 2) * 32);
    }
  }
  wg_wait<0>();
  fence_acc(c);
  if ((threadIdx.x & 127) == 0 && issued > 0) {
    atomicAdd(p.macs,
              static_cast<unsigned long long>(issued) * kTileM * BN * kK);
  }
  __syncthreads();  // every wgmma has read B and a: the region is free
  // The accumulators by row: element (row, col) of fragment register
  // 4 q + e is row 16 warp + g + 8 (e / 2), column 8 q + 2 t + e mod 2.
  Acc* acc = reinterpret_cast<Acc*>(smem) + wg * kTileM * kAccStride;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e >> 1);
      acc[row * kAccStride + 8 * q + 2 * t + (e & 1)] = c[4 * q + e];
    }
  }
  __syncthreads();
  // This CTA's partial: output row i sums accumulator rows j = i mod rows
  // in ascending j, each warpgroup 0 + warpgroup 1.
  const Acc* acc0 = reinterpret_cast<const Acc*>(smem);
  const Acc* acc1 = acc0 + kTileM * kAccStride;
  for (int o = threadIdx.x; o < p.rows * BN; o += blockDim.x) {
    const int i = o / BN;
    const int col = o - i * BN;
    Acc v = 0;
    for (int j = i; j < p.per_tile; j += p.rows) {
      v += acc0[j * kAccStride + col] + acc1[j * kAccStride + col];
    }
    part[o] = v;
  }
  cluster.sync();
  // The ranks' partials in rank order; rank q takes outputs o = q mod C.
  // With one tile group they are the output; with several each group's go
  // to the scratch, and the last CTA of a slice's rank q to arrive (an
  // integer ticket) adds the groups' in group order.
  Acc* out = static_cast<Acc*>(p.out);
  Acc* scratch = static_cast<Acc*>(p.scratch) +
                 static_cast<size_t>(blockIdx.x) * groups * p.rows * BN;
  for (int o = rank + csize * threadIdx.x; o < p.rows * BN;
       o += csize * blockDim.x) {
    Acc v = *cluster.map_shared_rank(part + o, 0);
    for (int q = 1; q < csize; ++q) v += *cluster.map_shared_rank(part + o, q);
    if (groups == 1) {
      const int i = o / BN;
      out[static_cast<size_t>(i) * p.cols + col0 + (o - i * BN)] = v;
    } else {
      scratch[grp * p.rows * BN + o] = v;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its partials
  if (groups == 1) return;
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(p.tickets + blockIdx.x * csize + rank, 1) == groups - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = rank + csize * threadIdx.x; o < p.rows * BN;
       o += csize * blockDim.x) {
    Acc v = __ldcg(scratch + o);
    for (int q = 1; q < groups; ++q) v += __ldcg(scratch + q * p.rows * BN + o);
    const int i = o / BN;
    out[static_cast<size_t>(i) * p.cols + col0 + (o - i * BN)] = v;
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// Lets chained_dot_kernel<V, BN> take clusters above 8 CTAs and `smem`
// bytes of dynamic shared memory.
template <int V, int BN>
cudaError_t prepare(int smem) {
  const cudaError_t e = cudaFuncSetAttribute(
      chained_dot_kernel<V, BN>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(chained_dot_kernel<V, BN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// The most clusters of `cluster` CTAs of chained_dot_kernel<V, BN> with
// `smem` bytes of dynamic shared memory each that the device runs at once.
template <int V, int BN>
int active_clusters(int cluster, int smem, int* out) {
  *out = 0;
  cudaError_t e = prepare<V, BN>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(chained_dot_kernel<V, BN>), &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

template <int V, int BN>
int launch(const void* a, const void* w, int rows, int n, int cols, int reps,
           int cluster, int groups, void* out, void* scratch,
           unsigned long long* macs, cudaStream_t s) {
  const Layout L = layout(V, BN, rows, n, cluster);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > optin) return -2;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return -5;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(cols) * (V == kBf16 ? 2 : 1)};
  const cuuint32_t box[2] = {V == kBf16 ? kAtom : BN, kChunk};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      &map,
      V == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(w), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      V == kBf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -5;
  DotArgs p;
  p.a = a;
  p.out = out;
  p.macs = macs;
  p.scratch = scratch;
  p.tickets = reinterpret_cast<int*>(macs + 1);
  p.rows = rows;
  p.n = n;
  p.cols = cols;
  p.reps = reps;
  p.per_tile = rows * (kTileM / rows);
  p.tiles = (reps * rows + p.per_tile - 1) / p.per_tile;
  e = cudaMemsetAsync(
      macs, 0,
      sizeof(unsigned long long) + sizeof(int) * (cols / BN) * cluster, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = prepare<V, BN>(L.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cols / BN, cluster, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, chained_dot_kernel<V, BN>, map, p);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_width(const void* a, const void* w, int rows, int n, int cols,
                 int reps, int width, int cluster, int groups, void* out,
                 void* scratch, unsigned long long* macs, cudaStream_t s) {
  return width == 256 ? launch<V, 256>(a, w, rows, n, cols, reps, cluster,
                                       groups, out, scratch, macs, s)
                      : launch<V, 64>(a, w, rows, n, cols, reps, cluster,
                                      groups, out, scratch, macs, s);
}

}  // namespace

template <int V>
int active_width(int width, int cluster, int smem, int* out) {
  return width == 256 ? active_clusters<V, 256>(cluster, smem, out)
                      : active_clusters<V, 64>(cluster, smem, out);
}

// Bytes of dynamic shared memory a CTA of `variant` takes at (rows, n)
// with slices `width` columns wide and `cluster` CTAs a slice.
extern "C" int fem_chained_dot_smem(int variant, int rows, int n, int width,
                                    int cluster) {
  return layout(variant, width, rows, n, cluster).total;
}

// One launch: `groups` clusters of `cluster` CTAs (1 .. n / 64, at most
// 16) per `width`-column slice of w (64 or 256).  `scratch` holds
// (cols / width) groups rows width partials of the output's type (unused
// with one group); `macs` an 8-byte counter, then (cols / width) cluster
// int tickets: the launch zeroes both and leaves the MACs it issues in the
// counter.  rows must be 1..64, n a multiple of 64, cols of width, and the
// CTA's shared memory (fem_chained_dot_smem) within the device's opt-in
// limit; anything else, or an unknown variant: cudaErrorInvalidValue (-2:
// shared memory too large), nothing launched.
extern "C" int fem_chained_dot(int variant, const void* a, const void* w,
                               int rows, int n, int cols, int reps,
                               int width, int cluster, int groups, void* out,
                               void* scratch, void* macs, void* stream) {
  if (rows < 1 || rows > kTileM || n <= 0 || n % kChunk || cols <= 0 ||
      (width != 64 && width != 256) || cols % width ||
      reps < 0 || cluster < 1 || cluster > kMaxCluster ||
      cluster > n / kChunk || groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<unsigned long long*>(macs);
  switch (variant) {
    case kBf16:
      return launch_width<kBf16>(a, w, rows, n, cols, reps, width, cluster,
                                 groups, out, scratch, m, s);
    case kInt8:
      return launch_width<kInt8>(a, w, rows, n, cols, reps, width, cluster,
                                 groups, out, scratch, m, s);
    case kInt8Bf16:
      return launch_width<kInt8Bf16>(a, w, rows, n, cols, reps, width,
                                     cluster, groups, out, scratch, m, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of `cluster` CTAs of `variant` at slice width `width`
// (64 or 256), `smem` bytes of dynamic shared memory each, the device
// runs at once, into *out.  Returns 0 or a CUDA error.
extern "C" int fem_chained_dot_active_clusters(int variant, int width,
                                               int cluster, int smem,
                                               int* out) {
  switch (variant) {
    case kBf16:
      return active_width<kBf16>(width, cluster, smem, out);
    case kInt8:
      return active_width<kInt8>(width, cluster, smem, out);
    case kInt8Bf16:
      return active_width<kInt8Bf16>(width, cluster, smem, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fem_chained_dot_error(int code) {
  if (code == -2) return "the CTA's shared memory exceeds the device's limit";
  if (code == -5) return "encoding the TMA descriptor of w failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
