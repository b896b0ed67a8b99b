// C1, fem_contact_pairs: the dense penalty pair forces of one substep in one
// launch, 2D or 3D, over the concatenated vertex soup of every body.
//
// Replaces no TPU kernel: the JAX package computes this in XLA, one
// (ns_a, ns_b) pair matrix per body pair and per self-contact mask
// (fem_tpu/contact.py:92-218, the loop of contact_forces_all at :370-402).
// Ported as PyTorch ops it is a few matmuls and a dozen (ns_a, ns_b)
// elementwise passes per body pair; here it is one launch that writes no
// pair matrix.
//
// What it computes, for every soup vertex i (ops/contact_kernels.py holds
// the plain version): over every vertex j of another body, and over the
// vertices j of i's own body that its self-contact mask admits (the mask
// is built once on the host and read here, never recomputed),
//   without Coulomb friction (the matmul form of _pair_coefs):
//     d2 = max((|x_i|^2 + |x_j|^2) - 2 x_i.x_j, 1e-18), dist = sqrt(d2)
//     pen = max(r - dist, 0), coef = (k pen) / max(dist, 0.1 r)
//     f_i = (x_i S - T) - (v_i W - V)
//       with S = sum coef, T = sum coef x_j, W = sum c (pen / r),
//       V = sum c (pen / r) v_j (the dashpot only with friction c > 0)
//   with Coulomb friction (contact_mu > 0: _pair_mu_forces): direct
//     differences, f_i = sum_j f_ij with f_ij = coef (x_i - x_j)
//     - c (pen / r)(v_i - v_j) - (min(slope |v_t|, (mu k) pen) / |v_t|) v_t.
// Each pair's terms are written with round-to-nearest intrinsics in the
// plain version's order, so that FMA contraction does not move a pair
// across the radius; the cross term x_i.x_j is the one fused chain, as the
// plain version's float32 matrix product forms it.  The three-term
// distance cancels (its f32 error is ~1e-3 of d2 at |x| ~ 2 and r ~ 0.03),
// and x_i S - T cancels again, so kernel and plain agree to f32 rounding of
// those expressions, not bit for bit: the order of the sums over j differs.
//
// Bound on the H100: operations.  A pair costs ~25 f32 operations (one
// sqrt, one division); the blob's 2,780 surface vertices make 7.7 M
// ordered pairs a substep, the two shells 151 M unordered ones; the bytes
// (positions, velocities, ids once, the forces once, the masks) are a few
// MB at most.  The least work is the distance of every pair and the rest of
// the chain only for the pairs within the radius.
//
// Two variants, one library (ops/contact_kernels.py: contact_plan).
//
// The rows variant (contact_pairs_kernel, the first design): the N-body
// pattern.  A vertex row is summed by kSplit consecutive threads, each over
// every kSplit-th partner; partner tiles of positions, velocities and body
// ids are staged through shared memory; the row's partial sums are then
// added by a butterfly of two shuffles, which leaves the same value on
// every lane; masks are read a byte a pair.  Measured on the H100: latency-
// bound where few CTAs hold the rows (41 on two flagship surfaces, 87 on
// the blob, against 132 SMs), each thread walking some 300 partners with a
// root and a division apiece.
//
// The cluster variant (cluster_contact_pairs_kernel): each tile of kRows
// rows spreads its partner range over a thread-block cluster of P CTAs
// (P in {1, 2, 4, 8}, chosen on the host so that tiles x P fill the SMs
// about twice), CTA r summing the contiguous chunk r as the rows variant
// sums the whole range.  Each CTA's row partials (S, W, T, V or f, and the
// accepted-pair count) are stored into the leader CTA's shared memory
// (distributed shared memory: stores, not reads, cross the cluster), and
// after one cluster barrier the leader adds the P partials in rank order,
// so a run's sums have one fixed order and two runs are bit-identical; no
// atomics.  Self-contact masks are read as bits, one uint32 word per 32
// partners of a row (pair_tables packs them once on the host).  |x_j|^2 is
// staged once a partner tile (dot_rn, the same bits as the rows variant's)
// beside x_j, so that a pair reads its partner in one 16-byte load.
// A pre-test d2 < thr, thr >= r^2 rounded up on the host with a margin,
// rejects before the root only pairs whose exact test pen > 0 fails too,
// and the exact test runs unchanged on the pairs that pass: the pair set
// and every accepted pair's terms are the rows variant's; only the order of
// the sums over j changes (P chunk sums added in rank order), and with
// P = 1 the two variants are bit-identical.  Both variants can count each
// row's accepted partners into `accepted`.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 4;
constexpr int kRows = kThreads / kSplit;  // vertex rows a CTA
constexpr int kTile = kThreads;           // partners staged a round
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;  // CTAs a cluster of the cluster variant
// A row's partials in the leader's gather slots: S, W, T[3], V[3] (or
// f[3]) and the accepted-pair count.
constexpr int kValues = 9;

struct PairArgs {
  const float* pos;            // (N, D)
  const float* vel;            // (N, D) or null
  const int* body;             // (N,)
  const long long* table;      // (B, 3): first row, size, mask offset or -1
  const unsigned char* mask;   // the bodies' (n_b, n_b) masks, flat
  float* out;                  // (N, D)
  int n;
  float radius;
  float k;
  float floor;       // 0.1 r
  float friction_c;
  float mu_k;        // mu k
  float mu_slope;
  int friction;      // dashpot on (velocities given, c > 0)
  int coulomb;       // Coulomb cone on (velocities given, mu > 0)
  int* accepted;     // (N,) each row's accepted partners, or null
  // The cluster variant only.
  const unsigned* bits;       // the bodies' masks, a bit a pair, flat
  const long long* bit_off;   // (B,) word offset of each mask or -1
  float thr;                  // d2 >= thr: pen = 0 (host-computed)
};

template <int D>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(a[c], b[c]));
  return s;
}

// x_i . x_j as a float32 matrix product accumulates it: a fused
// multiply-add chain over the components from a rounded first product.
template <int D>
__device__ __forceinline__ float dot_fma(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) s = __fmaf_rn(a[c], b[c], s);
  return s;
}

__device__ __forceinline__ float butterfly(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ int butterfly_count(int v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// A row's sums over its accepted partners: S, W, T, V (the matmul form)
// or f (the Coulomb form), and the accepted-pair count.
template <int D>
struct RowSums {
  float s = 0.0f, w = 0.0f;
  float t[D] = {}, v[D] = {}, f[D] = {};
  int taken = 0;
};

// Partner j's terms added to row i's sums, in the plain version's order;
// both variants call it, so an accepted pair's terms are the same bits in
// both.  `sq_j` is dot_rn(x_j, x_j).  With Pretest, a pair whose squared
// distance reaches a.thr is rejected before the root: its exact test
// pen > 0 would fail too.
template <int D, bool Pretest>
__device__ __forceinline__ void add_pair(const PairArgs& a,
                                         const float (&xi)[D],
                                         const float (&vi)[D], float sq_i,
                                         const float* xj, float sq_j,
                                         const float* vj, RowSums<D>& r) {
  if (!a.coulomb) {
    const float d2 = fmaxf(
        __fsub_rn(__fadd_rn(sq_i, sq_j), __fmul_rn(2.0f, dot_fma<D>(xi, xj))),
        1e-18f);
    if (Pretest && !(d2 < a.thr)) return;
    const float dist = __fsqrt_rn(d2);
    const float pen = fmaxf(__fsub_rn(a.radius, dist), 0.0f);
    if (!(pen > 0.0f)) return;
    ++r.taken;
    const float coef = __fdiv_rn(__fmul_rn(a.k, pen), fmaxf(dist, a.floor));
    r.s = __fadd_rn(r.s, coef);
#pragma unroll
    for (int c = 0; c < D; ++c)
      r.t[c] = __fadd_rn(r.t[c], __fmul_rn(coef, xj[c]));
    if (a.friction) {
      const float cw = __fmul_rn(a.friction_c, __fdiv_rn(pen, a.radius));
      r.w = __fadd_rn(r.w, cw);
#pragma unroll
      for (int c = 0; c < D; ++c)
        r.v[c] = __fadd_rn(r.v[c], __fmul_rn(cw, vj[c]));
    }
    return;
  }
  float diff[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    diff[c] = __fsub_rn(xi[c], xj[c]);
    dv[c] = __fsub_rn(vi[c], vj[c]);
  }
  const float d2 = fmaxf(dot_rn<D>(diff, diff), 1e-18f);
  if (Pretest && !(d2 < a.thr)) return;
  const float dist = __fsqrt_rn(d2);
  const float pen = fmaxf(__fsub_rn(a.radius, dist), 0.0f);
  if (!(pen > 0.0f)) return;
  ++r.taken;
  const float coef = __fdiv_rn(__fmul_rn(a.k, pen), fmaxf(dist, a.floor));
  float fp[D], nh[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    fp[c] = __fmul_rn(coef, diff[c]);
    nh[c] = __fdiv_rn(diff[c], dist);
  }
  if (a.friction) {
    const float cw = __fmul_rn(a.friction_c, __fdiv_rn(pen, a.radius));
#pragma unroll
    for (int c = 0; c < D; ++c)
      fp[c] = __fsub_rn(fp[c], __fmul_rn(cw, dv[c]));
  }
  const float vn = dot_rn<D>(dv, nh);
  float vt[D];
#pragma unroll
  for (int c = 0; c < D; ++c) vt[c] = __fsub_rn(dv[c], __fmul_rn(vn, nh[c]));
  const float speed = __fsqrt_rn(fmaxf(dot_rn<D>(vt, vt), 1e-24f));
  const float mag =
      fminf(__fmul_rn(a.mu_slope, speed), __fmul_rn(a.mu_k, pen));
  const float scale = __fdiv_rn(mag, speed);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    fp[c] = __fsub_rn(fp[c], __fmul_rn(scale, vt[c]));
    r.f[c] = __fadd_rn(r.f[c], fp[c]);
  }
}

// The row's sums over its kSplit lanes, in a fixed butterfly that leaves
// the same value on every lane; every lane of the warp takes part (rows
// past N carry zeros).
template <int D>
__device__ __forceinline__ void butterfly_sums(RowSums<D>& r) {
  r.s = butterfly(r.s);
  r.w = butterfly(r.w);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    r.t[c] = butterfly(r.t[c]);
    r.v[c] = butterfly(r.v[c]);
    r.f[c] = butterfly(r.f[c]);
  }
  r.taken = butterfly_count(r.taken);
}

// Row i's force from its whole sums: (x_i S - T) - (v_i W - V), or f.
template <int D>
__device__ __forceinline__ void store_row(const PairArgs& a, int i,
                                          const float (&xi)[D],
                                          const float (&vi)[D],
                                          const RowSums<D>& r) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float o = r.f[c];
    if (!a.coulomb) {
      o = __fsub_rn(__fmul_rn(xi[c], r.s), r.t[c]);
      if (a.friction)
        o = __fsub_rn(o, __fsub_rn(__fmul_rn(vi[c], r.w), r.v[c]));
    }
    a.out[i * D + c] = o;
  }
  if (a.accepted != nullptr) a.accepted[i] = r.taken;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
contact_pairs_kernel(const PairArgs a) {
  __shared__ float s_pos[kTile * D];
  __shared__ float s_vel[kTile * D];
  __shared__ int s_body[kTile];
  const int lane = threadIdx.x % kSplit;
  const int i = blockIdx.x * kRows + threadIdx.x / kSplit;
  const bool live = i < a.n;
  const bool with_vel = a.friction || a.coulomb;
  float xi[D], vi[D];
  int bi = -1;
  long long first = 0, size = 0, moff = -1;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    xi[c] = live ? a.pos[i * D + c] : 0.0f;
    vi[c] = live && with_vel ? a.vel[i * D + c] : 0.0f;
  }
  if (live) {
    bi = a.body[i];
    first = a.table[3 * bi];
    size = a.table[3 * bi + 1];
    moff = a.table[3 * bi + 2];
  }
  const float sq_i = dot_rn<D>(xi, xi);
  // The mask row of i (admission of same-body partners j: row[j - first]).
  const long long row = moff + (static_cast<long long>(i) - first) * size;
  RowSums<D> r;

  for (int base = 0; base < a.n; base += kTile) {
    __syncthreads();
    const int j0 = base + threadIdx.x;
    if (j0 < a.n) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s_pos[threadIdx.x * D + c] = a.pos[j0 * D + c];
        if (with_vel) s_vel[threadIdx.x * D + c] = a.vel[j0 * D + c];
      }
      s_body[threadIdx.x] = a.body[j0];
    }
    __syncthreads();
    if (!live) continue;
    const int count = min(kTile, a.n - base);
    for (int tj = lane; tj < count; tj += kSplit) {
      const int j = base + tj;
      if (s_body[tj] == bi &&
          (moff < 0 || a.mask[row + (j - first)] == 0))
        continue;
      const float* xj = s_pos + tj * D;
      add_pair<D, false>(a, xi, vi, sq_i, xj, dot_rn<D>(xj, xj),
                         s_vel + tj * D, r);
    }
  }
  butterfly_sums(r);
  if (live && lane == 0) store_row(a, i, xi, vi, r);
}

// The cluster variant: tile blockIdx.x / P's rows over partner chunk
// rank of [0, n), the partials added in the leader (rank 0).
template <int D>
__global__ void __launch_bounds__(kThreads)
cluster_contact_pairs_kernel(const __grid_constant__ PairArgs a) {
  __shared__ float4 s_pj[kTile];  // x_j (z 0 in 2D) and |x_j|^2
  __shared__ float s_vel[kTile * D];
  __shared__ int s_body[kTile];
  __shared__ float gather[kMaxCluster][kRows][kValues];
  cg::cluster_group cl = cg::this_cluster();
  const int nr = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  // The barrier before any store into the leader: arrive now.
  if (nr > 1) fem::cluster_arrive_relaxed();
  const int lane = threadIdx.x % kSplit;
  const int row = threadIdx.x / kSplit;
  const int i = static_cast<int>(blockIdx.x) / nr * kRows + row;
  const bool live = i < a.n;
  const bool with_vel = a.friction || a.coulomb;
  const int chunk = (a.n + nr - 1) / nr;
  const int lo = min(a.n, me * chunk);
  const int hi = min(a.n, lo + chunk);
  float xi[D], vi[D];
  int bi = -1;
  long long first = 0, boff = -1, brow = 0;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    xi[c] = live ? a.pos[i * D + c] : 0.0f;
    vi[c] = live && with_vel ? a.vel[i * D + c] : 0.0f;
  }
  if (live) {
    bi = a.body[i];
    first = a.table[3 * bi];
    const long long size = a.table[3 * bi + 1];
    boff = a.bit_off[bi];
    // Row i's mask words: (size + 31) / 32 of them.
    brow = boff + (static_cast<long long>(i) - first) * ((size + 31) / 32);
  }
  const float sq_i = dot_rn<D>(xi, xi);
  RowSums<D> r;

  for (int base = lo; base < hi; base += kTile) {
    __syncthreads();
    const int j0 = base + threadIdx.x;
    if (j0 < hi) {
      float xj[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        xj[c] = a.pos[j0 * D + c];
        if (with_vel) s_vel[threadIdx.x * D + c] = a.vel[j0 * D + c];
      }
      float4 pj = make_float4(xj[0], xj[1], 0.0f, dot_rn<D>(xj, xj));
      if constexpr (D == 3) pj.z = xj[2];
      s_pj[threadIdx.x] = pj;
      s_body[threadIdx.x] = a.body[j0];
    }
    __syncthreads();
    if (!live) continue;
    const int count = min(kTile, hi - base);
    long long wcur = -1;
    unsigned word = 0;
    for (int tj = lane; tj < count; tj += kSplit) {
      const int j = base + tj;
      if (s_body[tj] == bi) {
        if (boff < 0) continue;
        const long long bit = static_cast<long long>(j) - first;
        if ((bit >> 5) != wcur) {
          wcur = bit >> 5;
          word = a.bits[brow + wcur];
        }
        if (!((word >> (bit & 31)) & 1u)) continue;
      }
      // One 16-byte load of the partner: x_j and |x_j|^2.
      const float4 pj = s_pj[tj];
      float xj[D];
      xj[0] = pj.x;
      xj[1] = pj.y;
      if constexpr (D == 3) xj[2] = pj.z;
      add_pair<D, true>(a, xi, vi, sq_i, xj, pj.w, s_vel + tj * D, r);
    }
  }
  // The chunk's sums of the row, stored into the leader's gather slots of
  // this rank, the row's values spread over its kSplit lanes: S, W, T (or
  // f), V and the count.
  butterfly_sums(r);
  float vals[kValues] = {};
  vals[0] = r.s;
  vals[1] = r.w;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    vals[2 + c] = a.coulomb ? r.f[c] : r.t[c];
    vals[5 + c] = r.v[c];
  }
  vals[kValues - 1] = __int_as_float(r.taken);
  if (nr > 1) fem::cluster_wait();  // every CTA of the cluster is running
  float* dst = &gather[me][row][0];
  if (me != 0) dst = cl.map_shared_rank(dst, 0);
  if (live) {
#pragma unroll
    for (int q = 0; q < kValues; ++q)
      if (q % kSplit == lane) dst[q] = vals[q];
  }
  // Every partial is in the leader (release / acquire; the CTA barrier in
  // a cluster of one).  No CTA reads another's shared memory after it, so
  // none waits before it leaves.
  if (nr > 1) {
    cl.sync();
  } else {
    __syncthreads();
  }
  if (me != 0 || !live || lane != 0) return;
  // The P partials in rank order.
  RowSums<D> sum;
  for (int k = 0; k < nr; ++k) {
    const float* g = gather[k][row];
    const bool add = k > 0;
    sum.s = add ? __fadd_rn(sum.s, g[0]) : g[0];
    sum.w = add ? __fadd_rn(sum.w, g[1]) : g[1];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      sum.t[c] = add ? __fadd_rn(sum.t[c], g[2 + c]) : g[2 + c];
      sum.v[c] = add ? __fadd_rn(sum.v[c], g[5 + c]) : g[5 + c];
      sum.f[c] = sum.t[c];
    }
    sum.taken += __float_as_int(g[kValues - 1]);
  }
  store_row(a, i, xi, vi, sum);
}

}  // namespace

// `cluster` 0 launches the rows variant (which reads `mask`, a byte a
// pair), 1, 2, 4 or 8 the cluster variant with that many CTAs a row tile
// (which reads `bits` and `bit_off`, and rejects d2 >= `thr` before the
// root).  `accepted` (N,) int32, or null, receives each row's accepted
// partners.
extern "C" int fem_contact_pairs(int dim, int n, int bodies, int cluster,
                                 const void* pos, const void* vel,
                                 const void* body, const void* table,
                                 const void* mask, const void* bits,
                                 const void* bit_off, float radius, float k,
                                 float floor, float thr, float friction_c,
                                 float mu_k, float mu_slope, int friction,
                                 int coulomb, void* accepted, void* out,
                                 void* stream) {
  if (n < 1 || bodies < 1 || (dim != 2 && dim != 3) ||
      ((friction || coulomb) && vel == nullptr) ||
      (cluster != 0 && cluster != 1 && cluster != 2 && cluster != 4 &&
       cluster != kMaxCluster) ||
      (cluster != 0 && bit_off == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PairArgs a{static_cast<const float*>(pos),
             static_cast<const float*>(vel),
             static_cast<const int*>(body),
             static_cast<const long long*>(table),
             static_cast<const unsigned char*>(mask),
             static_cast<float*>(out),
             n, radius, k, floor, friction_c, mu_k, mu_slope,
             friction, coulomb, static_cast<int*>(accepted)};
  a.bits = static_cast<const unsigned*>(bits);
  a.bit_off = static_cast<const long long*>(bit_off);
  a.thr = thr;
  const int tiles = (n + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    if (dim == 3)
      contact_pairs_kernel<3><<<tiles, kThreads, 0, s>>>(a);
    else
      contact_pairs_kernel<2><<<tiles, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const void* kernel =
      dim == 3 ? reinterpret_cast<const void*>(cluster_contact_pairs_kernel<3>)
               : reinterpret_cast<const void*>(cluster_contact_pairs_kernel<2>);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fem::cluster_config(cluster, kThreads, 0, stream,
                                               &attr);
  cfg.gridDim = dim3(tiles * cluster);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, params);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_contact_pairs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
