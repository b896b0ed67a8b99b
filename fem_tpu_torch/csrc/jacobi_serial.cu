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
// Bound on the H100: the chain of dependent steps.  A sweep's bytes are
// the rows (the flagship: 1,007 x 29 x 9 x 4 B = 1.05 MB) and b once and x
// written once, ~0.3 us at 3.35 TB/s; but the serial sweep's N rows are N
// dependent steps, each a few hundred cycles (a row's loads, its products,
// five shuffles a component, the update, two warp barriers), and the level
// schedule's L levels are L such steps (the flagship: N 1,007, L 70).
//
// Two variants, one library (ops/jacobi_kernels.py: jacobi_plan picks).
//
// The serial variant (jacobi_serial_kernel, the dense rows with no pattern
// and any rows whose level tables do not fit): one CTA of kThreads.  x, b, past
// and the diagonal A_ii[k,k] live in shared memory (4 N D floats: the
// flagship's 48 KB; opted in past 48 KB, up to a CTA's 227 KB).  Warp 0
// runs the sweep: lane l holds the row's slots l, l + 32, ... (S of them,
// S = ceil(max_nb / 32), a template parameter), and loads the next row's
// slots into registers while it works on this row, so that the blocks'
// loads (L2-resident after the first sweep) are in flight during a row's
// arithmetic.  The dense source strides the row's N D columns over the
// lanes.  The error takes the whole CTA: a thread a row (sparse) or a warp
// a row (dense), then the fixed-order reduction.  Measured on the H100: the
// chain of N dependent rows binds, ~0.3-0.4 us a row.
//
// The level variant (jacobi_levels_kernel: the sparse rows, and the dense
// rows with the table of their structural pattern): the sweep
// follows the host's level schedule (level_plan: level(i) = 1 + the
// largest level of the j < i with j in nb[i] or i in nb[j]), so the rows of
// one level share no entry, every lower neighbour of a row is done before
// its level and every upper one is not yet touched: a level's rows run
// together and read exactly the x values the serial sweep reads (the
// flagship: 70 dependent levels a sweep instead of 1,007 rows).  One CTA of
// kLevelThreads: within a level warp w takes the level's rows w, w + 32,
// ..., each with the serial variant's row arithmetic (the same slots a
// lane, the same butterfly's sums, taken in D + 4 shuffles instead of
// 5 D, the same update), and one __syncthreads() ends the level.  Each
// warp loads the blocks of the next row it will take — in this level or a
// later one, from the host's next_row table — into registers before it
// works on this row (and so before the level's barrier), and waits for
// them only when that row starts: those loads do not depend on x.  The
// rows and the table are staged in shared memory where they fit (the 2D
// meshes), else read from L2.  The error pass spreads the rows'
// residuals over the CTA into shared memory, then sums the squares in the
// serial variant's order (kThreads partial sums, each over the rows
// r = t mod kThreads, then the warps, then warp 0), so x,
// past, the iterations and the error are bit-identical to the serial
// variant's.  The kernel counts the levels it ran (L a sweep) into
// `levels_run`.  Measured on the H100 (tools/torch_j1_probe.py, the
// kernel's own clocks): the level barrier costs warp 0 ~8 ns; a level
// costs ~0.8 us on the flagship, about twice a serial row, as ~14 warps
// run their rows at once on the one SM; the error pass ~20 us, the
// flagship's rows read through that SM.
//
// The dense rows on the level schedule (DenseLevelRows): the dense
// backend assembles A from the sparse rows (solvers/dense.py), so every
// nonzero block lies in the Jacobi table (or is a lone particle's
// identity block, on the diagonal).  A dense row reads every column, but
// a level's rows differ from the serial sweep's reads only in columns
// where A is a structural zero, and for a finite x a zero times either
// value adds a zero: each lane keeps the serial variant's columns in its
// order and the butterfly its sums, so x, past, the iterations and the
// error are the serial variant's (a zero's sign aside, when a whole
// product is zero).  The error pass is the serial variant's dense one, its
// residuals spread over the CTA first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLevelThreads = 1024;
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
  // The level variant only.
  const int* order;        // (N,) the rows by level
  const int* next_row;     // (N,) the next position of a position's warp
  const int* first_row;    // (32,) each warp's first position
  const int* level_start;  // (L + 1,)
  int levels;              // L
  int staged;              // rows and table staged in shared memory
  int* levels_run;         // (1,) levels the kernel ran
  long long* clocks;       // (5,) SM clocks of the phases, or null
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// warp_sum of each of acc[0..D), bit for bit (the same pairs added at
// every step of the same butterfly), in D + 4 shuffles instead of 5 D:
// the first one or two steps exchange only the components a lane keeps,
// after which lanes 8 k .. 8 k + 7 (3D; 16 k .. in 2D) hold component k's
// partial and finish it alone.  Lane k < D returns component k's sum.
template <int D>
__device__ __forceinline__ float warp_sums_to_lane(const float (&acc)[D],
                                                   int lane) {
  const bool hi16 = lane & 16;
  float c;
  int stride;
  if constexpr (D == 3) {
    // Step 16: the lower half keeps components 0 and 1, the upper half 2
    // and a zero pad.
    const float r0 = __shfl_xor_sync(kFull, hi16 ? acc[0] : acc[2], 16);
    const float r1 = __shfl_xor_sync(kFull, hi16 ? acc[1] : 0.0f, 16);
    const float b0 = __fadd_rn(hi16 ? acc[2] : acc[0], r0);
    const float b1 = __fadd_rn(hi16 ? 0.0f : acc[1], r1);
    // Step 8: each lane keeps one of its two.
    const bool hi8 = lane & 8;
    c = __fadd_rn(hi8 ? b1 : b0, __shfl_xor_sync(kFull, hi8 ? b0 : b1, 8));
#pragma unroll
    for (int m = 4; m > 0; m >>= 1)
      c = __fadd_rn(c, __shfl_xor_sync(kFull, c, m));
    stride = 8;
  } else {
    c = __fadd_rn(hi16 ? acc[1] : acc[0],
                  __shfl_xor_sync(kFull, hi16 ? acc[0] : acc[1], 16));
#pragma unroll
    for (int m = 8; m > 0; m >>= 1)
      c = __fadd_rn(c, __shfl_xor_sync(kFull, c, m));
    stride = 16;
  }
  return __shfl_sync(kFull, c, (stride * lane) & 31);
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

  // Lane `lane`'s slots of row i (none past row n - 1) into registers.
  static __device__ __forceinline__ void load(const int* nbs,
                                              const float* rows, int n,
                                              int max_nb, int i, int lane,
                                              float (&blk)[S][D * D],
                                              int (&nb)[S]) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int s = lane + 32 * q;
      nb[q] = -1;
      if (i < n && s < max_nb) {
        const size_t slot = static_cast<size_t>(i) * max_nb + s;
        nb[q] = nbs[slot];
#pragma unroll
        for (int e = 0; e < D * D; ++e) blk[q][e] = rows[slot * D * D + e];
      }
    }
  }

  // The warp's product of row i's slots (in registers) with x, summed over
  // the lanes: acc[k] = (A_i x)_k on every lane.
  static __device__ __forceinline__ void product(const float (&blk)[S][D * D],
                                                 const int (&nb)[S],
                                                 const float* x,
                                                 float (&acc)[D]) {
    lane_product(blk, nb, x, acc);
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = warp_sum(acc[k]);
  }

  // This lane's part of the product: its slots' terms, in slot order.
  static __device__ __forceinline__ void lane_product(
      const float (&blk)[S][D * D], const int (&nb)[S], const float* x,
      float (&acc)[D]) {
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      if (nb[q] >= 0) {
        const float* xj = x + D * nb[q];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float v = xj[j];
#pragma unroll
          for (int k = 0; k < D; ++k)
            acc[k] = __fmaf_rn(blk[q][D * k + j], v, acc[k]);
        }
      }
    }
  }

  // b_r - (A x)_r of row component r = D i + k, the slots in order.
  static __device__ __forceinline__ float residual_row(const int* nbs,
                                                       const float* rows,
                                                       int max_nb,
                                                       const float* x,
                                                       const float* bs,
                                                       int r) {
    const int i = r / D, k = r % D;
    float acc = 0.0f;
    for (int s = 0; s < max_nb; ++s) {
      const size_t slot = static_cast<size_t>(i) * max_nb + s;
      const int j = nbs[slot];
      if (j < 0) continue;
      const float* blk = rows + (slot * D + k) * D;
#pragma unroll
      for (int jj = 0; jj < D; ++jj)
        acc = __fmaf_rn(blk[jj], x[D * j + jj], acc);
    }
    return __fsub_rn(bs[r], acc);
  }

  // Warp 0's sweep, in place on x.
  static __device__ void sweep(const JacobiArgs& a, float* x, const float* bs,
                               const float* past, const float* dg) {
    const int lane = threadIdx.x;
    float cur[S][D * D], nxt[S][D * D];
    int cur_nb[S], nxt_nb[S];
    load(a.nb, a.rows, a.n, a.max_nb, 0, lane, cur, cur_nb);
    for (int i = 0; i < a.n; ++i) {
      load(a.nb, a.rows, a.n, a.max_nb, i + 1, lane, nxt, nxt_nb);
      float acc[D];
      product(cur, cur_nb, x, acc);
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
      const float rr = residual_row(a.nb, a.rows, a.max_nb, x, bs, r);
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

// One level-scheduled sweep, in place on x; every thread of the CTA takes
// part (one barrier a level).  Returns the levels it ran.  With
// `a.clocks`, adds warp 0's clocks at its rows (`work`) and at the level
// barriers (`wait`).  `Rows` is the row source (SparseLevelRows,
// DenseLevelRows): a row's operands in registers and this lane's part of
// its product.
template <int D, class Rows>
__device__ int level_sweep(const JacobiArgs& a, const int* nbs,
                           const float* rows, const int* order,
                           const int* next_row, const int* first_row,
                           const int* ls, float* x, const float* bs,
                           const float* past, const float* dg,
                           long long& work, long long& wait) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  typename Rows::Regs cur, nxt;
  // The warp's rows: positions first_row[warp], next_row[...], ... of the
  // order (the level's rows warp, warp + 32, ..., then a later level's).
  // Each row's operands are loaded into nxt a row ahead and moved into cur
  // only when that row starts, so the loads of a warp's next row stay in
  // flight across the level barriers between.
  int p = first_row[warp];
  if (p >= 0) Rows::load(a, nbs, rows, order[p], lane, nxt);
  int ran = 0;
  for (int l = 0; l < a.levels; ++l, ++ran) {
    const int end = ls[l + 1];
    const long long t0 = a.clocks != nullptr ? clock64() : 0;
    while (p >= 0 && p < end) {
      const int i = order[p];
      cur = nxt;
      const int q = next_row[p];
      if (q >= 0) Rows::load(a, nbs, rows, order[q], lane, nxt);
      float acc[D];
      Rows::lane_product(a, rows, i, lane, cur, x, acc);
      const float ax = warp_sums_to_lane<D>(acc, lane);
      // Lane k < D writes x_ik.  Every lane's reads of x feed ax, so they
      // are done; no row of this level reads x_i (a dense row reads it
      // through a structural zero of A, where either value gives the same
      // product).
      if (lane < D) {
        const int r = D * i + lane;
        x[r] = update(bs[r], ax, dg[r], x[r], past[r], a.omega);
      }
      p = q;
    }
    if (a.clocks != nullptr) {
      const long long t1 = clock64();
      __syncthreads();
      work += t1 - t0;
      wait += clock64() - t1;
    } else {
      __syncthreads();
    }
  }
  return ran;
}

// |b - A x| in the serial variant's order, every thread of the CTA
// computing rows' residuals into `res` first; every thread returns it.
template <int D, int S>
__device__ float level_error(const JacobiArgs& a, const int* nbs,
                             const float* rows, const float* x,
                             const float* bs, float* res, float* red,
                             float* shared_err) {
  using Src = Sparse<D, S>;
  const int nd = a.n * D;
  for (int r = threadIdx.x; r < nd; r += kLevelThreads)
    res[r] = Src::residual_row(nbs, rows, a.max_nb, x, bs, r);
  __syncthreads();
  float part = 0.0f;
  if (threadIdx.x < kThreads)
    for (int r = threadIdx.x; r < nd; r += kThreads)
      part = __fmaf_rn(res[r], res[r], part);
  const float v = warp_sum(part);
  if ((threadIdx.x & 31) == 0 && threadIdx.x < kThreads)
    red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < kWarps ? red[threadIdx.x] : 0.0f;
    w = warp_sum(w);
    if (threadIdx.x == 0) *shared_err = __fsqrt_rn(w);
  }
  __syncthreads();
  return *shared_err;
}

// The level variant's sparse rows: a row's S slots a lane in registers
// (the serial variant's Sparse<D, S> split) and the error pass above.
template <int D, int S>
struct SparseLevelRows {
  struct Regs {
    float blk[S][D * D];
    int nb[S];
  };

  static __device__ __forceinline__ void load(const JacobiArgs& a,
                                              const int* nbs,
                                              const float* rows, int i,
                                              int lane, Regs& r) {
    Sparse<D, S>::load(nbs, rows, a.n, a.max_nb, i, lane, r.blk, r.nb);
  }

  static __device__ __forceinline__ void lane_product(const JacobiArgs&,
                                                      const float*, int, int,
                                                      const Regs& r,
                                                      const float* x,
                                                      float (&acc)[D]) {
    Sparse<D, S>::lane_product(r.blk, r.nb, x, acc);
  }

  static __device__ float diag(const JacobiArgs& a, int r) {
    return Sparse<D, S>::diag(a, r);
  }

  static __device__ float error(const JacobiArgs& a, const int* nbs,
                                const float* rows, const float* x,
                                const float* bs, float* res, float* red,
                                float* shared_err) {
    return level_error<D, S>(a, nbs, rows, x, bs, res, red, shared_err);
  }
};

// The level variant's dense rows (a_dense, N D by N D): the serial
// variant's Dense<D> split, lane l taking the columns l, l + 32, ... of
// each of the row's D components in that order, the first kHeld of them
// held in registers a row ahead (default.json's 242 columns: all 8) and
// the rest read when the row runs.  Exact wherever A's nonzero blocks lie
// in the level plan's table (the host's pattern): a row reads every
// column, and the others are structural zeros, read while other warps of
// the level may write their x.  For a finite x either value's product is
// a zero and the sums keep their bits; an inf or a NaN in x makes that
// product a NaN or a zero by the timing, so a diverging solve is not
// reproducible here (ops/jacobi_kernels.jacobi_plan).  The rows stay in
// L2 (a CTA's shared memory cannot hold default.json's 234 KB).
template <int D>
struct DenseLevelRows {
  static constexpr int kHeld = D == 2 ? 8 : 4;
  struct Regs {
    float v[kHeld][D];
  };

  static __device__ __forceinline__ void load(const JacobiArgs& a,
                                              const int*, const float* rows,
                                              int i, int lane, Regs& r) {
    const int nd = a.n * D;
    const float* row = rows + static_cast<size_t>(D) * i * nd;
#pragma unroll
    for (int q = 0; q < kHeld; ++q) {
      const int c = lane + 32 * q;
#pragma unroll
      for (int k = 0; k < D; ++k)
        r.v[q][k] = c < nd ? row[static_cast<size_t>(k) * nd + c] : 0.0f;
    }
  }

  static __device__ __forceinline__ void lane_product(const JacobiArgs& a,
                                                      const float* rows,
                                                      int i, int lane,
                                                      const Regs& r,
                                                      const float* x,
                                                      float (&acc)[D]) {
    const int nd = a.n * D;
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < kHeld; ++q) {
      const int c = lane + 32 * q;
      if (c < nd) {
        const float v = x[c];
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] = __fmaf_rn(r.v[q][k], v, acc[k]);
      }
    }
    const float* row = rows + static_cast<size_t>(D) * i * nd;
    for (int c = lane + 32 * kHeld; c < nd; c += 32) {
      const float v = x[c];
#pragma unroll
      for (int k = 0; k < D; ++k)
        acc[k] = __fmaf_rn(row[static_cast<size_t>(k) * nd + c], v, acc[k]);
    }
  }

  static __device__ float diag(const JacobiArgs& a, int r) {
    return Dense<D>::diag(a, r);
  }

  // |b - A x| in Dense<D>::residual's order: every warp of the CTA puts
  // rows' residuals (a warp a row, its lanes' columns and the butterfly)
  // into `res`, then warp 0's lane w < kWarps sums the squares of the rows
  // r = w mod kWarps, as the serial variant's warp w does, and the
  // butterfly adds the kWarps partials.
  static __device__ float error(const JacobiArgs& a, const int*,
                                const float* rows, const float* x,
                                const float* bs, float* res, float*,
                                float* shared_err) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nd = a.n * D;
    for (int r = warp; r < nd; r += kLevelThreads / 32) {
      const float* row = rows + static_cast<size_t>(r) * nd;
      float acc = 0.0f;
      for (int c = lane; c < nd; c += 32) acc = __fmaf_rn(row[c], x[c], acc);
      acc = warp_sum(acc);
      if (lane == 0) res[r] = __fsub_rn(bs[r], acc);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      float part = 0.0f;
      if (lane < kWarps)
        for (int r = lane; r < nd; r += kWarps)
          part = __fmaf_rn(res[r], res[r], part);
      const float w = warp_sum(part);
      if (lane == 0) *shared_err = __fsqrt_rn(w);
    }
    __syncthreads();
    return *shared_err;
  }
};

template <int D, class Rows>
__global__ void __launch_bounds__(kLevelThreads) jacobi_levels_kernel(
    const __grid_constant__ JacobiArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  __shared__ float shared_err;
  // SM clocks (thread 0's, with a.clocks): set-up, error passes, sweeps,
  // warp 0's rows and its waits at the level barriers.
  const bool timed = a.clocks != nullptr;
  long long c_start = timed ? clock64() : 0;
  long long c_init = 0, c_err = 0, c_sweep = 0, c_work = 0, c_wait = 0;
  const int nd = a.n * D;
  const size_t slots = static_cast<size_t>(a.n) * a.max_nb;
  float* x = smem;
  float* bs = x + nd;
  float* past = bs + nd;
  float* dg = past + nd;
  float* res = dg + nd;
  const float* rows = a.rows;
  const int* nbs = a.nb;
  int* tail = reinterpret_cast<int*>(res + nd);
  if (a.staged) {
    float* srows = res + nd;
    for (size_t e = threadIdx.x; e < slots * D * D; e += kLevelThreads)
      srows[e] = a.rows[e];
    int* snb = reinterpret_cast<int*>(srows + slots * D * D);
    for (size_t e = threadIdx.x; e < slots; e += kLevelThreads)
      snb[e] = a.nb[e];
    rows = srows;
    nbs = snb;
    tail = snb + slots;
  }
  int* order = tail;
  int* next_row = order + a.n;
  int* first_row = next_row + a.n;
  int* ls = first_row + 32;
  for (int r = threadIdx.x; r < a.n; r += kLevelThreads) {
    order[r] = a.order[r];
    next_row[r] = a.next_row[r];
  }
  if (threadIdx.x < 32) first_row[threadIdx.x] = a.first_row[threadIdx.x];
  for (int r = threadIdx.x; r <= a.levels; r += kLevelThreads)
    ls[r] = a.level_start[r];
  for (int r = threadIdx.x; r < nd; r += kLevelThreads) {
    const float bv = a.b[r];
    bs[r] = bv;
    x[r] = __fmul_rn(0.5f, bv);
    past[r] = a.past_in[r];
    dg[r] = Rows::diag(a, r);
  }
  __syncthreads();
  if (timed) {
    c_init = clock64() - c_start;
    c_start = clock64();
  }
  float err = Rows::error(a, nbs, rows, x, bs, res, red, &shared_err);
  if (timed) c_err += clock64() - c_start;
  float p_err = err;
  int it = 0, levels = 0;
  bool done = false;
  while (!done && err > a.tol && it < a.max_iter) {
    if (timed) c_start = clock64();
    levels += level_sweep<D, Rows>(a, nbs, rows, order, next_row, first_row,
                                ls, x, bs, past, dg, c_work, c_wait);
    if (timed) {
      c_sweep += clock64() - c_start;
      c_start = clock64();
    }
    const float e1 =
        Rows::error(a, nbs, rows, x, bs, res, red, &shared_err);
    if (timed) c_err += clock64() - c_start;
    const bool rollback = e1 >= p_err;
    for (int r = threadIdx.x; r < nd; r += kLevelThreads) {
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
  for (int r = threadIdx.x; r < nd; r += kLevelThreads) {
    a.x_out[r] = x[r];
    a.past_out[r] = past[r];
  }
  if (threadIdx.x == 0) {
    *a.iterations = it;
    *a.error = err;
    *a.levels_run = levels;
    if (timed) {
      a.clocks[0] = c_init;
      a.clocks[1] = c_err;
      a.clocks[2] = c_sweep;
      a.clocks[3] = c_work;
      a.clocks[4] = c_wait;
    }
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

template <int D>
Kernel pick_levels(int dense, int slots) {
  if (dense) return jacobi_levels_kernel<D, DenseLevelRows<D>>;
  switch (slots) {
    case 1: return jacobi_levels_kernel<D, SparseLevelRows<D, 1>>;
    case 2: return jacobi_levels_kernel<D, SparseLevelRows<D, 2>>;
    case 4: return jacobi_levels_kernel<D, SparseLevelRows<D, 4>>;
    default: return nullptr;
  }
}

// Sets `k`'s dynamic shared memory above the default where `smem` needs it.
cudaError_t allow_smem(Kernel k, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  const cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
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

// The level variant: `dense` 0 for the block-sparse rows (`nb`, `rows`,
// `slots` a lane as fem_jacobi_serial's), 1 for the dense rows (`rows`;
// `nb`, `slots` and `max_nb` unused, nothing staged), whose nonzero blocks
// must lie in the table the schedule was built from; `order` (n,),
// `next_row` (n,), `first_row` (32,) and `level_start` (levels + 1,) int32
// the host's level schedule; `staged` 1 to stage the sparse rows and the
// table in shared memory.  One CTA of kLevelThreads with 5 n dim floats
// and 2 n + levels + 33 ints of dynamic shared memory (and the staged rows
// and table).  `levels_run` (1,) int32 receives the levels the sweeps ran.
// `clocks` (5,) int64, or null, receives the SM clocks of thread 0 in the
// set-up, the error passes and the sweeps, and of warp 0 at its rows and
// at the level barriers (tools/torch_j1_probe.py).  cudaErrorInvalidValue
// for an instance or a size the kernel does not take.
extern "C" int fem_jacobi_levels(int dim, int dense, int slots, int staged,
                                 const void* nb, const void* rows,
                                 const void* b, const void* past,
                                 const void* order, const void* next_row,
                                 const void* first_row,
                                 const void* level_start, int n, int max_nb,
                                 int levels, float omega,
                                 float tol, int max_iter, void* x_out,
                                 void* past_out, void* iterations,
                                 void* error, void* levels_run,
                                 void* clocks, void* stream) {
  const Kernel k = dim == 3 ? pick_levels<3>(dense, slots)
                   : dim == 2 ? pick_levels<2>(dense, slots)
                              : nullptr;
  if (dense) {
    max_nb = 0;
    if (staged) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == nullptr || n < 1 || levels < 1 ||
      (!dense && (max_nb < 1 || max_nb > 32 * slots)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t slots_n = static_cast<size_t>(n) * max_nb;
  size_t smem = sizeof(float) * 5 * static_cast<size_t>(n) * dim +
                sizeof(int) * (2 * static_cast<size_t>(n) + levels + 33);
  if (staged) smem += slots_n * (sizeof(float) * dim * dim + sizeof(int));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  JacobiArgs a{static_cast<const int*>(nb),
               static_cast<const float*>(rows),
               static_cast<const float*>(b),
               static_cast<const float*>(past),
               static_cast<float*>(x_out),
               static_cast<float*>(past_out),
               static_cast<int*>(iterations),
               static_cast<float*>(error),
               n, max_nb, omega, tol, max_iter};
  a.order = static_cast<const int*>(order);
  a.next_row = static_cast<const int*>(next_row);
  a.first_row = static_cast<const int*>(first_row);
  a.level_start = static_cast<const int*>(level_start);
  a.levels = levels;
  a.staged = staged;
  a.levels_run = static_cast<int*>(levels_run);
  a.clocks = static_cast<long long*>(clocks);
  k<<<1, kLevelThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_jacobi_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
