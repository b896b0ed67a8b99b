// P1: the blocked operator's per-block product, PAIR locality blocks to a
// thread-block cluster — the paired-block probe.
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
// atomics; padded element slots, whose S rows are zero, store nothing).
//
// Bound on the H100: bytes, but at the flagship's 17 blocks a launch reads
// ~0.9 MB (~0.2 us at 3.35 TB/s), far under the launch itself; at the
// probe's default 270 blocks ~11 MB (~3.3 us).  What a launch waits on is
// latency: the operand loads, the barriers and each slot's serial sum.
// The design:
// 1. A block's elements spread over a cluster of C = min(kMaxCtas,
//    ceil(Eb / kTile)) CTAs, one thread an element in tiles of kTile; an
//    Eb past C tiles takes rounds in the same CTAs, each element's
//    operands loaded a round ahead (the flagship's Eb 256: 2 CTAs of 64
//    threads a block, 2 rounds).  On the H100 (PERF.md) this was the one
//    setting of the sweep (tiles of 32, 64 and 128, 2 to 8 CTAs a block)
//    ahead of a CTA a block at every pair at both 17 and 270 blocks: 8
//    CTAs of 32 were the fastest at 17 blocks and up to half slower at
//    270, where their receive rows, replicated in every CTA, cap the CTAs
//    an SM holds.
// 2. Each thread loads its first two elements' K-plane columns and row
//    slots into registers, and each CTA its owned slots' plan offsets,
//    before the CTA stages the block's x (D Pb floats) and its plan rows
//    (16-byte vectors, all loads of a thread in flight before its stores)
//    and meets its one CTA barrier: no barrier sits before the operand
//    loads.
// 3. Contribution rows are stored into their reader: slot p is owned by
//    CTA p / ceil(Pb / C) of the cluster, and an element stores each of its
//    D + 1 rows, padded to one vector (fem::slot_stride), into its slot's
//    owner's shared memory at the row's id e (D+1) + v — row 0 under
//    minus[e D], row j+1 under plus[e D + j], the slots the local plan
//    files them under — through distributed shared memory (stores, since
//    DSMEM reads are transaction-bound); then one cluster barrier.
// 4. Each owner sums its slots' rows through the block's local plan in the
//    plan's order, one lane a slot, eight rows' loads in flight before
//    their adds: the same terms in the same order as a block-per-CTA
//    kernel, so the same bits.
// PAIR on Hopper: PAIR blocks share one cluster, each CTA holding a tile of
// each of them in PAIR groups of kTile threads, so that the blocks'
// independent dependency chains interleave on the same SMs — the TPU's
// question (do independent blocks fill each other's bubbles?) asked of the
// SM's warp schedulers.  At the flagship (17 blocks, padded to 18 and 20):
// 34 / 18 / 10 CTAs of 64 / 128 / 256 threads at PAIR 1 / 2 / 4.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "blocked_common.cuh"
#include "cluster.cuh"
#include "cluster_slots.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;        // elements a thread group, one thread each
constexpr int kMaxCtas = 2;      // CTAs a block at most (a cluster's size)
constexpr int kMaxDevices = 16;  // devices whose placed plans are kept

// CTAs a block of `eb` element slots: a tile each, at most kMaxCtas.
inline int block_ctas(int eb) {
  const int c = (eb + kTile - 1) / kTile;
  return c < 1 ? 1 : (c < kMaxCtas ? c : kMaxCtas);
}

// 4-byte words of one group's shared memory, each part rounded to 16
// bytes: the block's x (D, Pb) as in xbt, then the receive rows (Eb (D+1)
// rows of slot_stride(D) floats, at their row ids) and the block's plan
// rows (Eb (D+1)).
__host__ __device__ inline size_t round4(size_t words) {
  return (words + 3) / 4 * 4;
}
__host__ __device__ inline size_t x_words(int pb, int dim) {
  return round4(static_cast<size_t>(dim) * pb);
}
__host__ __device__ inline size_t group_words(int eb, int pb, int dim) {
  const size_t rows = static_cast<size_t>(eb) * (dim + 1);
  return x_words(pb, dim) + round4(rows * fem::slot_stride(dim) + rows);
}

// Copies n words from src (global) to dst (shared) with the kTile threads
// of a group, each with up to kBatch loads in flight before its stores.
template <int kBatch, typename W>
__device__ __forceinline__ void stage(const W* __restrict__ src, W* dst,
                                      int n, int lt) {
  for (int base = 0; base < n; base += kBatch * kTile) {
    W v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kTile + lt;
      if (i < n) v[k] = src[i];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kTile + lt;
      if (i < n) dst[i] = v[k];
    }
  }
}

// An element's operands: its K-plane entries, k[(D i + c) D + j] =
// kplane[b][D i + c][e D + j], and its rows' local slots (row 0: vertex 0,
// minus[e D]; row j+1: vertex j+1, plus[e D + j]).
template <int D>
struct Element {
  float k[D * D * D];
  int slot[D + 1];
};

template <int D>
__device__ __forceinline__ void load_element(const float* __restrict__ kp,
                                             const int* __restrict__ plus,
                                             const int* __restrict__ minus,
                                             int rb, int e, Element<D>& el) {
#pragma unroll
  for (int q = 0; q < D * D; ++q) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      el.k[q * D + j] = kp[static_cast<size_t>(q) * rb + e * D + j];
    }
  }
  el.slot[0] = minus[e * D];
#pragma unroll
  for (int j = 0; j < D; ++j) el.slot[j + 1] = plus[e * D + j];
}

// The element's D + 1 contribution rows, row v at t[D v], from the staged
// x (D, Pb): row j+1 = K (x_{j+1} - x_0), row 0 = -(row 1 + ... + row D).
template <int D>
__device__ __forceinline__ void element_rows(const float* xs, int pb,
                                             const Element<D>& el, float* t) {
  const float* x0 = xs + el.slot[0];
  float sum[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float* xj = xs + el.slot[j + 1];
    float dv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dv[c] = xj[c * pb] - x0[c * pb];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float ti = el.k[(D * i) * D + j] * dv[0];
#pragma unroll
      for (int c = 1; c < D; ++c) {
        ti = ti + el.k[(D * i + c) * D + j] * dv[c];
      }
      t[D * (j + 1) + i] = ti;
      sum[i] = j == 0 ? ti : sum[i] + ti;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) t[i] = -sum[i];
}

// Stores element e's rows, each one padded vector, at their row ids in the
// receive rows of their slots' owners (`recv` is this CTA's; slot p's
// owner is rank p / spr).
template <int D>
__device__ __forceinline__ void store_rows(cg::cluster_group& cl,
                                           int me, int spr, float* recv,
                                           const Element<D>& el,
                                           const float* t, int e) {
  constexpr int RS = fem::slot_stride(D);
#pragma unroll
  for (int v = 0; v <= D; ++v) {
    fem::SlotRow<D> r;
    r.x = t[D * v];
    r.y = t[D * v + 1];
    if constexpr (D == 3) {
      r.z = t[D * v + 2];
      r.w = 0.0f;
    }
    float* dst = recv + RS * (e * (D + 1) + v);
    const int owner = el.slot[v] / spr;
    if (owner != me) dst = cl.map_shared_rank(dst, owner);
    *reinterpret_cast<fem::SlotRow<D>*>(dst) = r;
  }
}

// Slot sum of the receive rows `rows[begin, end)` in that order into a:
// kBatch rows' ids and then their rows loaded before they are added.
template <int D>
__device__ __forceinline__ void slot_sum(const float* recv, const int* rows,
                                         int begin, int end, float* a) {
  constexpr int RS = fem::slot_stride(D);
  constexpr int kBatch = 8;
#pragma unroll
  for (int c = 0; c < D; ++c) a[c] = 0.0f;
  for (int q = begin; q < end; q += kBatch) {
    fem::SlotRow<D> r[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (q + k < end) {
        r[k] = *reinterpret_cast<const fem::SlotRow<D>*>(recv +
                                                         RS * rows[q + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (q + k < end) {
        a[0] += r[k].x;
        a[1] += r[k].y;
        if constexpr (D == 3) a[2] += r[k].z;
      }
    }
  }
}

// Cluster `blockIdx.x / C` holds blocks PAIR c .. PAIR c + PAIR - 1; group
// g of each of its CTAs works on block PAIR c + g.  Thread lt of rank r
// takes the block's elements r kTile + lt + k C kTile.
template <int D, int PAIR>
__global__ void __launch_bounds__(kTile * PAIR) cluster_paired_matvec_kernel(
    const __grid_constant__ fem::BlockTables T,
    const float* __restrict__ kplane, const float* __restrict__ xbt,
    float* __restrict__ out) {
  constexpr int R = D + 1;
  constexpr int RS = fem::slot_stride(D);
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int nr = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  // The barrier before any store into another CTA: arrive now.
  if (nr > 1) fem::cluster_arrive_relaxed();
  const int g = static_cast<int>(threadIdx.x) / kTile;
  const int lt = static_cast<int>(threadIdx.x) % kTile;
  const int b = static_cast<int>(blockIdx.x) / nr * PAIR + g;
  const int eb = T.eb;
  const int pb = T.pb;
  const int rb = eb * D;
  float* xs = smem + static_cast<size_t>(g) * group_words(eb, pb, D);
  float* recv = xs + x_words(pb, D);
  int* prow = reinterpret_cast<int*>(recv + static_cast<size_t>(eb) * R * RS);
  const float* kp = kplane + static_cast<size_t>(b) * D * D * rb;
  const int* plus = T.plus + static_cast<size_t>(b) * rb;
  const int* minus = T.minus + static_cast<size_t>(b) * rb;
  const int* ptr = T.local_ptr + static_cast<size_t>(b) * (pb + 1);
  // This CTA owns slots [lo, hi).
  const int spr = (pb + nr - 1) / nr;
  const int lo = min(pb, me * spr);
  const int hi = min(pb, lo + spr);
  // Loads before the barrier: the first two rounds' element operands
  // (padded slots too: they are in bounds, and the block's element count
  // is not waited for), this lane's first slot's span, x and the plan rows.
  const int step = nr * kTile;  // element slots a round
  const int e0 = me * kTile + lt;
  Element<D> el, next;
  if (e0 < eb) load_element<D>(kp, plus, minus, rb, e0, el);
  if (e0 + step < eb) load_element<D>(kp, plus, minus, rb, e0 + step, next);
  const int nel = T.block_elements[b];
  int s0 = 0, s1 = 0;
  if (lo + lt < hi) {
    s0 = ptr[lo + lt];
    s1 = ptr[lo + lt + 1];
  }
  const float* xb = xbt + static_cast<size_t>(b) * D * pb;
  if ((D * pb) % 4 == 0 && (reinterpret_cast<uintptr_t>(xbt) & 15) == 0) {
    stage<4>(reinterpret_cast<const float4*>(xb),
             reinterpret_cast<float4*>(xs), D * pb / 4, lt);
  } else {
    stage<8>(xb, xs, D * pb, lt);
  }
  const int* lrows = T.local_rows + static_cast<size_t>(b) * eb * R;
  if ((eb * R) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(T.local_rows) & 15) == 0) {
    stage<8>(reinterpret_cast<const int4*>(lrows),
             reinterpret_cast<int4*>(prow), eb * R / 4, lt);
  } else {
    stage<8>(lrows, prow, eb * R, lt);
  }
  __syncthreads();  // x and the plan rows are staged
  float t[R * D];
  const bool real = e0 < nel;
  if (real) element_rows<D>(xs, pb, el, t);
  if (nr > 1) fem::cluster_wait();  // every CTA of the cluster is running
  if (real) store_rows<D>(cl, me, spr, recv, el, t, e0);
  // Later rounds: each element's operands are loaded a round ahead.
  for (int e = e0 + step; e < nel; e += step) {
    el = next;
    if (e + step < nel) load_element<D>(kp, plus, minus, rb, e + step, next);
    element_rows<D>(xs, pb, el, t);
    store_rows<D>(cl, me, spr, recv, el, t, e);
  }
  // Every row is in its owner's receive rows (release / acquire; the CTA
  // barrier in a cluster of one).  No CTA reads another's shared memory
  // after it, so none waits before it leaves.
  if (nr > 1) {
    cl.sync();
  } else {
    __syncthreads();
  }
  float* ob = out + static_cast<size_t>(b) * D * pb;
  for (int p = lo + lt; p < hi; p += kTile) {
    if (p != lo + lt) {
      s0 = ptr[p];
      s1 = ptr[p + 1];
    }
    float a[D];
    slot_sum<D>(recv, prow, s0, s1, a);
#pragma unroll
    for (int c = 0; c < D; ++c) ob[c * pb + p] = a[c];
  }
}

// The last launch's grid: CTAs, threads a CTA, CTAs a cluster and bytes of
// dynamic shared memory a CTA.
int g_last_launch[4] = {0, 0, 0, 0};

template <int D, int PAIR>
int launch(const fem::BlockTables& T, const float* kplane, const float* xbt,
           float* out, cudaStream_t s) {
  if (T.num_blocks == 0) return 0;
  const auto kernel = cluster_paired_matvec_kernel<D, PAIR>;
  const int ctas = block_ctas(T.eb);
  const int threads = kTile * PAIR;
  const size_t smem = sizeof(float) * PAIR * group_words(T.eb, T.pb, D);
  // By device and cluster size, the most shared memory a CTA that
  // fem::cluster_fit has placed (and so prepared the kernel for): a plan
  // within it is placed too, and is not asked again.
  static size_t placed[kMaxDevices][kMaxCtas + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || smem > placed[dev][ctas]) {
    int active = 0;
    const int rc = fem::cluster_fit(kernel, threads, ctas, smem, &active);
    if (rc != 0) return rc;
    if (dev < kMaxDevices) placed[dev][ctas] = smem;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fem::cluster_config(ctas, threads, smem, s, &attr);
  cfg.gridDim = dim3(ctas * (T.num_blocks / PAIR));
  fem::BlockTables tables = T;
  void* params[] = {&tables, &kplane, &xbt, &out};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                          params);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(e);
  }
  g_last_launch[0] = static_cast<int>(cfg.gridDim.x);
  g_last_launch[1] = threads;
  g_last_launch[2] = ctas;
  g_last_launch[3] = static_cast<int>(smem);
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
// nothing launched).  A plan whose shared memory exceeds the device's
// limit returns -2, a cluster the device cannot place -4, before the
// launch.
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

// The last launch's grid, into out[4]: CTAs, threads a CTA, CTAs a cluster
// and bytes of dynamic shared memory a CTA (zeros before the first).
extern "C" void fem_paired_matvec_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = g_last_launch[i];
}

extern "C" const char* fem_paired_matvec_error(int code) {
  if (code == -2) return "the CTA's shared memory exceeds the device's limit";
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
