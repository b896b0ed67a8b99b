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
// K2, K7b, K3 and K7a are four row sources of one cluster template
// (cluster_blocked_body): what a block's element computes before the slot
// sums — apply (K3: K_e times the edge differences of the gathered x),
// prep (K2: the implicit chain from the gathered positions, K_e into k_out
// and the -V h force rows), grad (K7b: the explicit gradient rows) and
// columns (K7a: the rows of given block-ordered columns, no gather).  Each
// ends in the per-particle sum: y (N, D) is G(K) x, the assembled force,
// the assembled gradient or the assembly of the columns.  Each has two
// variants, chosen by size before the launch (ops/blocked_kernels.py:
// blocked_plan), never one in place of the other after a failure.  The
// cluster variant, for every blocking whose receive slots fit one
// thread-block cluster (<= 16 CTAs on the H100; the flagship's 17 blocks:
// 16 CTAs, default.json's 1 block: 1): one launch, the whole grid one
// cluster, on K8's ownership (ops/frame_kernels.py: explicit_assignment) —
// CTA `rank` owns the blocks b = rank (mod C), one or two thread groups of
// 256 threads each on one block at a time, and the particles whose first
// slot lies in its blocks.  Each group stages its block's table slices
// (contiguous in device memory: plus, minus, the layer's R^-1 and the
// volumes or the columns, the local plan's rows and offsets, the slots'
// destinations) into shared memory in one pass of independent loads —
// plain loads for apply, TMA bulk copies into an mbarrier for the other
// sources, the faster of the two for each on the H100 (PERF.md) — beside the
// rows it gathers, computes its elements' rows and each block slot's sum
// through the block's local plan, and stores that sum into a receive slot
// of the CTA that owns the slot's particle (cluster_slots.cuh, shared with
// K8; the receive slots of a particle lie in the slot plan's order); after
// a cluster barrier each owner sums its particles' receive slots in that
// order and writes y.  Two cluster barriers a launch: one before the first
// store into another CTA (no CTA stores into one that has not started;
// arrived at the start, waited for after the first block's rows), and one
// after the stores; no CTA touches another's shared memory after that, so
// none needs a barrier before it leaves.  A cluster of one CTA needs only
// the second, a CTA barrier.  The kernel counts them.  The two-kernel
// (grid) variant, for blockings that do not fit: one CTA a block writes
// per-block partials through device memory (blocked_matvec_kernel,
// blocked_prep_kernel, blocked_grad_prep_kernel, blocked_assemble_kernel),
// then slot_sum_kernel gives each particle one thread.  Both compute the
// same two sums in the same order, so their outputs are bit-identical.
// The preps' partials forms (fem_blocked_prep, fem_blocked_grad_prep) are
// the grid variant's first kernel alone.
//
// Every kernel is templated on the dimension D in {2, 3} (the Pallas
// kernels take `dim`); the C entries launch the instance of tables->dim.
// Padded element slots are skipped: they contribute nothing.  No float
// atomics, so two runs are bit-identical.
//
// Bound on the H100: bytes, and far below them in practice — K2 moves about
// 0.56 MB, K7b 0.45 MB, K3 0.41 MB and K7a 0.3 MB on the 3D flagship, a
// tenth of a microsecond at 3.35 TB/s, while a launch fills 16 or 17 of 132
// SMs (one in 2D at the default scene) for a few microseconds: the time is
// latency, dependent loads and barriers.  The cluster variant takes out the
// slot sum's launch and the partials' round trip through device memory, and
// the staging takes the chains of dependent device loads out of each
// phase.  K7b edges has no sum: B x kEdgeParts CTAs (blocked_edges_kernel).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "blocked_common.cuh"
#include "cluster.cuh"
#include "cluster_slots.cuh"

// The row sources of the cluster kernel: what a block's element computes
// before the slot sums.  apply (K3): K_e (x_{v_j+1} - x_{v_0}) from the
// gathered x; prep (K2): the implicit chain from the gathered positions, K_e
// to k_out and the -V h force rows; grad (K7b): the explicit gradient rows;
// columns (K7a): the rows of given block-ordered columns, no gather.  The
// Python side mirrors these ids (ops/blocked_kernels.py: SOURCES).
enum BlockedSource : int { kApply = 0, kPrep = 1, kGrad = 2, kColumns = 3 };

// The arguments of every source, both variants; the Python side mirrors
// this layout (ops/blocked_kernels.py: BlockedArgsC).
struct FemBlockedArgs {
  fem::BlockTables T;    // T.dim is D; T.ref_inv a layer's R^-1 (prep, grad)
  const float* k;        // apply: (B*Eb, D, D) block-ordered K
  const float* x;        // apply: x (N, D); prep, grad: positions (N, D);
                         // columns: block-ordered columns (B*Eb, D, D)
  int transpose;         // apply: G(K^T) x
  int n;                 // particles
  const int* slot_ptr;   // (N+1,) slot plan (the two-kernel variant)
  const int* slot_rows;  // flat block slots b*Pb+p
  float* partials;       // (B*Pb, D) scratch of the two-kernel variant
  float* y;              // (N, D) the per-particle sums
  // The cluster variant's plan (ops/blocked_kernels.py: BlockedBinding,
  // from ops/frame_kernels.py: explicit_assignment).
  const int* cl_owned_ptr;  // (C+1,) each rank's span of cl_owned_ids
  const int* cl_owned_ids;  // (N,) the particles each rank owns, flat
  const int* cl_recv_ptr;   // (N+1,) each owned particle's span of its
                            // rank's receive slots, slot plan order
  const int* cl_slot_dest;  // (B*Pb,) where each block slot's sum goes:
                            // owner rank * 65536 + receive slot (-1:
                            // padding)
  int cl_entries;           // most receive slots of a rank
  int* barriers;  // (1,) or null: the cluster variant's barriers, written
                  // by thread 0 of CTA 0
  float* k_out;   // prep: (B*Eb, D, D) K_e = -V k (padded slots 0)
  fem::MaterialParams m;  // prep, grad: the layer's material numbers
};

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// K3's cluster variant: a CTA is 1 or 2 groups of kThreads, each group
// working on one of the CTA's locality blocks at a time.
constexpr int kMaxGroups = 2;
constexpr int kClusterThreads = kMaxGroups * kThreads;

// Loads in batches: each thread loads its kBatch words of a pass before it
// stores any, so that their latencies overlap (a loop that stored each
// word before loading the next would wait on every load in turn).
constexpr int kBatch = 4;

// xs[D*p + c] = src[D*ids[p] + c] for the block's pb slots, by the n
// threads of a group (thread tid): a pass's slot ids, then its rows, then
// its stores.
template <int D>
__device__ __forceinline__ void gather_rows(const int* __restrict__ ids,
                                            const float* __restrict__ src,
                                            int pb, float* xs, int tid,
                                            int n) {
  const int total = D * pb;
  for (int base = 0; base < total; base += kBatch * n) {
    int id[kBatch];
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * n + tid;
      if (i < total) id[k] = ids[i / D];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * n + tid;
      if (i < total) v[k] = src[D * id[k] + i % D];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * n + tid;
      if (i < total) xs[i] = v[k];
    }
  }
}

// apply's staging of block b: its rows of x gathered and its table slices
// copied into the group's share by plain loads, in passes of kBatch words a
// thread from every slice at once: a pass loads the slot ids and every
// slice's words, then the rows of those ids, then stores it all.  The
// slices: plus and minus, the local plan's rows and offsets and the slots'
// destinations.
template <int D>
__device__ __forceinline__ void load_block(const FemBlockedArgs& a, int b,
                                           int gtid, float* xs, int* plus,
                                           int* minus, int* lrows, int* lptr,
                                           int* dest) {
  const fem::BlockTables& T = a.T;
  const int eb = T.eb;
  const int pb = T.pb;
  const int* __restrict__ ids = T.block_particles + b * pb;
  const int* __restrict__ gp = T.plus + b * D * eb;
  const int* __restrict__ gm = T.minus + b * D * eb;
  const int* __restrict__ gr = T.local_rows + b * (D + 1) * eb;
  const int* __restrict__ gl = T.local_ptr + b * (pb + 1);
  const int* __restrict__ gd = a.cl_slot_dest + b * pb;
  const float* __restrict__ x = a.x;
  int most = (D + 1) * eb;
  if (D * pb > most) most = D * pb;
  if (pb + 1 > most) most = pb + 1;
  for (int base = 0; base < most; base += kBatch * kThreads) {
    int id[kBatch], vp[kBatch], vm[kBatch], vr[kBatch], vl[kBatch],
        vd[kBatch];
    float vx[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads + gtid;
      if (i < D * pb) id[k] = ids[i / D];
      if (i < D * eb) {
        vp[k] = gp[i];
        vm[k] = gm[i];
      }
      if (i < (D + 1) * eb) vr[k] = gr[i];
      if (i <= pb) vl[k] = gl[i];
      if (i < pb) vd[k] = gd[i];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads + gtid;
      if (i < D * pb) vx[k] = x[D * id[k] + i % D];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads + gtid;
      if (i < D * pb) xs[i] = vx[k];
      if (i < D * eb) {
        plus[i] = vp[k];
        minus[i] = vm[k];
      }
      if (i < (D + 1) * eb) lrows[i] = vr[k];
      if (i <= pb) lptr[i] = vl[k];
      if (i < pb) dest[i] = vd[k];
    }
  }
}


// K2's and K7b's rows of one real element (the edge matrix from the
// block's rows xs through its plus row and minus entry, then the chain),
// compiled once and called by both variants' kernels, so that the two run
// the same instructions: inlined into two kernels, the compiler fused a
// material chain's multiplies and adds differently in each (St.
// Venant-Kirchhoff in 2D), and the variants' K differed in the last bit.
template <int D, int M>
__device__ __noinline__ void prep_rows(const float* xs, const int* plus,
                                       const int* minus, const float* r,
                                       float volume, fem::MaterialParams m,
                                       float* k_out, float* t) {
  float x[D * D];
  const float* x0 = xs + D * minus[0];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float* xj = xs + D * plus[j];
#pragma unroll
    for (int i = 0; i < D; ++i) x[D * i + j] = xj[i] - x0[i];
  }
  fem::element_prep_from<D, M>(x, r, volume, m, k_out, t);
}

template <int D, int M>
__device__ __noinline__ void grad_rows(const float* xs, const int* plus,
                                       const int* minus, const float* r,
                                       float volume, fem::MaterialParams m,
                                       float* t) {
  float x[D * D];
  const float* x0 = xs + D * minus[0];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float* xj = xs + D * plus[j];
#pragma unroll
    for (int i = 0; i < D; ++i) x[D * i + j] = xj[i] - x0[i];
  }
  fem::element_grad_from<D, M>(x, r, volume, m, t);
}

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
      const size_t slot = static_cast<size_t>(b) * T.eb + e;
      prep_rows<D, M>(xs, T.plus + D * slot, T.minus + D * slot,
                      T.ref_inv + DD * slot, T.volume[slot], m, k,
                      t + R * e);
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
    const size_t slot = static_cast<size_t>(b) * T.eb + e;
    grad_rows<D, M>(xs, T.plus + D * slot, T.minus + D * slot,
                    T.ref_inv + D * D * slot, T.volume[slot], m, t + R * e);
  }
  __syncthreads();
  fem::block_slot_sums<D>(T, b, t, partials + D * b * T.pb);
}

// CTAs a block of K7b edges: the faster of 1, 2, 4 and 8 on the H100
// (PERF.md, K7b edges).
constexpr int kEdgeParts = 2;

// Edge matrices x (B*Eb, D, D) of every element slot: padded slots get the
// inverse of their R^-1.  The launch gives each block `parts` (kEdgeParts)
// CTAs of ceil(Eb / parts) threads, thread i of CTA (b, part) on slot
// part * blockDim.x + i, so that B * parts CTAs spread over the SMs.
// `parts` is a kernel argument: compiled in as a constant, the 2D launch
// took 0.0019 ms on the H100 against 0.0016 (PERF.md, K7b edges).
// Every operand is loaded in one pass of independent loads before the
// barrier: the block's real-element count, the slot's plus and minus rows
// and its R^-1 (used by a padded slot) into registers, and the block's
// particle rows gathered into shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads) blocked_edges_kernel(
    fem::BlockTables T, const float* __restrict__ pos, float* __restrict__ x,
    int parts) {
  constexpr int DD = D * D;
  extern __shared__ float smem[];
  float* xs = smem;
  const int b = blockIdx.x / parts;
  const int e = (blockIdx.x - b * parts) * blockDim.x + threadIdx.x;
  const bool live = e < T.eb;
  const int nel = T.block_elements[b];
  const size_t slot = static_cast<size_t>(b) * T.eb + e;
  int pl[D], mi = 0;
  float r[DD];
  if (live) {
    const int row = (b * T.eb + e) * D;
    mi = T.minus[row];
#pragma unroll
    for (int j = 0; j < D; ++j) pl[j] = T.plus[row + j];
    // Every slot's R^-1, though only a padded slot's is used: a load that
    // waited for `nel` would hold back the gather behind it.
#pragma unroll
    for (int i = 0; i < DD; ++i) r[i] = T.ref_inv[DD * slot + i];
  }
  gather_rows<D>(T.block_particles + b * T.pb, pos, T.pb, xs,
                 static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x));
  __syncthreads();
  if (!live) return;
  float m[DD];
  if (e < nel) {
    const float* x0 = xs + D * mi;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float* xj = xs + D * pl[j];
#pragma unroll
      for (int i = 0; i < D; ++i) m[D * i + j] = xj[i] - x0[i];
    }
  } else {
    fem::det_inv<D>(r, m);
  }
#pragma unroll
  for (int i = 0; i < DD; ++i) x[DD * slot + i] = m[i];
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

// Offsets (4-byte words) of the segments of one thread group's share of
// the cluster CTA, and its size, by source.  apply keeps K3's packed
// layout: xs (Pb*D), t (Eb*(D+1)*D), plus and minus (Eb*D each), the local
// plan's rows (Eb*(D+1)) and offsets (Pb+1), each slot's destination (Pb).
// The other sources start every segment on a 16-byte boundary (a TMA bulk
// copy needs one): xs (the gather sources), t, tab (prep, grad: the
// layer's R^-1, Eb*D*D; columns: the block's columns), vol (prep, grad:
// Eb), plus and minus (the gather sources), rows, offsets, destinations.
struct GroupLayout {
  int xs, t, tab, vol, plus, minus, lrows, lptr, dest, words;
};

__host__ __device__ inline int pad4(int words) { return (words + 3) & ~3; }

__host__ __device__ inline int take(GroupLayout& L, int words, bool packed) {
  const int at = L.words;
  L.words += packed ? words : pad4(words);
  return at;
}

__host__ __device__ inline GroupLayout group_layout(int source, int eb, int pb,
                                                   int dim) {
  GroupLayout L{};
  const bool packed = source == kApply;
  const bool gather = source != kColumns;
  const bool chain = source == kPrep || source == kGrad;
  if (gather) L.xs = take(L, dim * pb, packed);
  L.t = take(L, fem::rows_floats(dim) * eb, packed);
  if (chain || source == kColumns) L.tab = take(L, dim * dim * eb, packed);
  if (chain) L.vol = take(L, eb, packed);
  if (gather) {
    L.plus = take(L, dim * eb, packed);
    L.minus = take(L, dim * eb, packed);
  }
  L.lrows = take(L, (dim + 1) * eb, packed);
  L.lptr = take(L, pb + 1, packed);
  L.dest = take(L, pb, packed);
  return L;
}

// 4-byte words of the receive slots (`entries` rows of slot_stride floats)
// that open the cluster CTA's dynamic shared memory.
__host__ __device__ inline int recv_words(int source, int dim, int entries) {
  const int w = fem::slot_stride(dim) * entries;
  return source == kApply ? w : pad4(w);
}

// 4-byte words of the cluster CTA's dynamic shared memory: its receive
// slots, then one share per thread group.
inline size_t cluster_words(int source, int eb, int pb, int dim, int groups,
                            int entries) {
  return static_cast<size_t>(recv_words(source, dim, entries)) +
         static_cast<size_t>(groups) * group_layout(source, eb, pb, dim).words;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One table segment of a block: `words` 4-byte words from device memory to
// the group's share.
struct Segment {
  void* dst;
  const void* src;
  int words;
};

// Stages a block's `n` segments into shared memory in one pass: each whose
// addresses and size are 16-byte multiples by a TMA bulk copy into the
// group's mbarrier `bar`, all issued by the group's thread 0; every other
// segment (a block's local plan offsets, Pb + 1 words) by the group's
// plain loads.  Returns whether a bulk copy was issued: the group then
// waits on `bar` before it reads the share.
template <int N>
__device__ __forceinline__ bool stage_segments(const Segment (&seg)[N], int n,
                                               uint64_t* bar, int gtid) {
  bool bulk[N];
  uint32_t bytes = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uintptr_t ends = reinterpret_cast<uintptr_t>(seg[i].dst) |
                           reinterpret_cast<uintptr_t>(seg[i].src) |
                           static_cast<uintptr_t>(4 * seg[i].words);
    bulk[i] = i < n && seg[i].words > 0 && (ends & 15) == 0;
    if (bulk[i]) bytes += 4u * static_cast<uint32_t>(seg[i].words);
  }
  if (bytes > 0 && gtid == 0) {
    // The last round's reads of the share (generic proxy) before the bulk
    // copies' writes (async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!bulk[i]) continue;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(seg[i].dst)),
          "l"(seg[i].src), "r"(4 * seg[i].words), "r"(smem_addr(bar))
          : "memory");
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= n || bulk[i]) continue;
    uint32_t* dst = static_cast<uint32_t*>(seg[i].dst);
    const uint32_t* src = static_cast<const uint32_t*>(seg[i].src);
    for (int w = gtid; w < seg[i].words; w += kThreads) dst[w] = src[w];
  }
  return bytes > 0;
}

// The cluster variant of every source: the grid is one cluster (the launch
// sets the cluster dimension to the grid), of kThreads or kClusterThreads
// threads a CTA, on K8's ownership (file comment).  Every operand a phase
// reads is loaded before the phase, in one pass of independent loads: a
// block's table slices (contiguous in device memory) are staged into
// shared memory beside its gathered rows (stage_segments), apply reads each
// thread's first element's K and every source each thread's first owned
// particle's span into registers at the start, and the barrier that keeps
// stores out of CTAs that have not started is split, its arrival at the
// start and its wait before the first store, so that no phase waits on a
// chain of dependent device-memory reads.  Then each block slot's sum is
// stored into its particle's owner and each owner sums its receive slots in
// the slot plan's order into y.  apply stages by plain loads (load_block),
// the other sources by TMA bulk copies: the faster of the two for each on
// the H100 (PERF.md).
template <int D, int S, int M>
__device__ __forceinline__ void cluster_blocked_body(const FemBlockedArgs& a) {
  constexpr bool TMA = S != kApply;
  constexpr bool kGather = S != kColumns;
  constexpr bool kChain = S == kPrep || S == kGrad;
  constexpr int DD = D * D;
  constexpr int R = fem::rows_floats(D);
  constexpr int RS = fem::slot_stride(D);
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[kMaxGroups];
  const fem::BlockTables& T = a.T;
  cg::cluster_group cl = cg::this_cluster();
  const int nr = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  // The barrier before any store into another CTA (none in a cluster of
  // one): arrive now.
  if (nr > 1) fem::cluster_arrive_relaxed();
  int barriers = 0;
  const int groups = static_cast<int>(blockDim.x) / kThreads;
  const int grp = static_cast<int>(threadIdx.x) / kThreads;
  const int gtid = static_cast<int>(threadIdx.x) % kThreads;
  const int bpc = (T.num_blocks + nr - 1) / nr;
  const int rounds = (bpc + groups - 1) / groups;
  const int eb = T.eb;
  const int pb = T.pb;
  const GroupLayout L = group_layout(S, eb, pb, D);
  float* recv = smem;  // first: 16-byte aligned rows
  float* share = recv + recv_words(S, D, a.cl_entries) +
                 static_cast<size_t>(grp) * L.words;
  float* xs = share + L.xs;
  float* t = share + L.t;
  float* tab = share + L.tab;
  float* vol = share + L.vol;
  int* plus = reinterpret_cast<int*>(share + L.plus);
  int* minus = reinterpret_cast<int*>(share + L.minus);
  int* lrows = reinterpret_cast<int*>(share + L.lrows);
  int* lptr = reinterpret_cast<int*>(share + L.lptr);
  int* dest = reinterpret_cast<int*>(share + L.dest);
  // The block's tables in shared memory: the element functions read them
  // as block 0 of this view.
  fem::BlockTables Tb = T;
  Tb.plus = plus;
  Tb.minus = minus;
  uint64_t* bar = bars + grp;
  if constexpr (TMA) {
    if (gtid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  uint32_t phase = 0;
  // Registers loaded ahead: apply's K of this thread's element of its first
  // block (padded slots hold zeros), and this thread's first owned
  // particle.
  const int b0 = me + grp * nr;
  float k0[DD];
  if constexpr (S == kApply) {
    if (b0 < T.num_blocks && gtid < eb) {
      const float* k = a.k + DD * (static_cast<size_t>(b0) * eb + gtid);
#pragma unroll
      for (int i = 0; i < DD; ++i) k0[i] = k[i];
    }
  }
  const int first = a.cl_owned_ptr[me];
  const int owned = a.cl_owned_ptr[me + 1] - first;
  const int base = a.cl_recv_ptr[first];
  int span0 = 0, span1 = 0, id0 = 0;
  if (static_cast<int>(threadIdx.x) < owned) {
    span0 = a.cl_recv_ptr[first + threadIdx.x];
    span1 = a.cl_recv_ptr[first + threadIdx.x + 1];
    id0 = a.cl_owned_ids[first + threadIdx.x];
  }
  for (int round = 0; round < rounds; ++round) {
    const int b = me + (round * groups + grp) * nr;
    const bool on = b < T.num_blocks;
    if (round > 0) __syncthreads();  // the last round's shares are read
    bool wait = false;
    if constexpr (TMA) {
      if (on) {
        Segment seg[7] = {};
        int ns = 0;
        if constexpr (kChain) {
          seg[ns++] = {tab, T.ref_inv + static_cast<size_t>(b) * eb * DD,
                       DD * eb};
          seg[ns++] = {vol, T.volume + static_cast<size_t>(b) * eb, eb};
        }
        if constexpr (S == kColumns) {
          seg[ns++] = {tab, a.x + static_cast<size_t>(b) * eb * DD,
                       DD * eb};
        }
        if constexpr (kGather) {
          seg[ns++] = {plus, T.plus + b * D * eb, D * eb};
          seg[ns++] = {minus, T.minus + b * D * eb, D * eb};
        }
        seg[ns++] = {lrows, T.local_rows + b * (D + 1) * eb, (D + 1) * eb};
        seg[ns++] = {lptr, T.local_ptr + b * (pb + 1), pb + 1};
        seg[ns++] = {dest, a.cl_slot_dest + b * pb, pb};
        wait = stage_segments(seg, ns, bar, gtid);
        if constexpr (kGather) {
          gather_rows<D>(T.block_particles + b * pb, a.x, pb, xs, gtid,
                         kThreads);
        }
      }
    } else if (on) {
      load_block<D>(a, b, gtid, xs, plus, minus, lrows, lptr, dest);
    }
    const int nel = on ? T.block_elements[b] : 0;
    if constexpr (TMA) {
      if (wait) {
        mbar_wait(bar, phase);
        phase ^= 1u;
      }
    }
    __syncthreads();  // the share is complete
    const int count = S == kPrep && on ? eb : nel;
    for (int e = gtid; e < count; e += kThreads) {
      if constexpr (S == kApply) {
        float k[DD];
        if (round == 0 && e == gtid) {
#pragma unroll
          for (int i = 0; i < DD; ++i) k[i] = k0[i];
        } else {
          const float* kg = a.k + DD * (static_cast<size_t>(b) * eb + e);
#pragma unroll
          for (int i = 0; i < DD; ++i) k[i] = kg[i];
        }
        fem::element_apply<D>(Tb, 0, e, xs, k, a.transpose != 0, t + R * e);
      } else if constexpr (S == kPrep) {
        float* ko = a.k_out + DD * (static_cast<size_t>(b) * eb + e);
        if (e < nel) {
          prep_rows<D, M>(xs, plus + D * e, minus + D * e, tab + DD * e,
                          vol[e], a.m, ko, t + R * e);
        } else {
#pragma unroll
          for (int i = 0; i < DD; ++i) ko[i] = 0.0f;
        }
      } else if constexpr (S == kGrad) {
        grad_rows<D, M>(xs, plus + D * e, minus + D * e, tab + DD * e, vol[e],
                        a.m, t + R * e);
      } else {
        fem::column_rows<D>(1.0f, tab + DD * e, t + R * e);
      }
    }
    __syncthreads();
    if (round == 0 && nr > 1) {
      fem::cluster_wait();  // every CTA is running
      ++barriers;
    }
    if (on) {
      for (int p = gtid; p < pb; p += kThreads) {
        const int to = dest[p];
        if (to < 0) continue;
        float* slot = recv + RS * (to & 0xffff);
        fem::store_slot_sum<D>(
            lptr, lrows, t, p,
            (to >> 16) == me ? slot : cl.map_shared_rank(slot, to >> 16));
      }
    }
  }
  // Every slot sum is in its owner's receive slots (release / acquire; the
  // CTA barrier in a cluster of one).
  ++barriers;
  if (nr > 1) {
    cl.sync();
  } else {
    __syncthreads();
  }
  for (int l = threadIdx.x; l < owned; l += blockDim.x) {
    if (l != static_cast<int>(threadIdx.x)) {
      span0 = a.cl_recv_ptr[first + l];
      span1 = a.cl_recv_ptr[first + l + 1];
      id0 = a.cl_owned_ids[first + l];
    }
    float acc[D];
    fem::receive_sum<D>(recv, span0 - base, span1 - base, acc);
#pragma unroll
    for (int c = 0; c < D; ++c) a.y[D * id0 + c] = acc[c];
  }
  if (a.barriers != nullptr && me == 0 && threadIdx.x == 0) {
    *a.barriers = barriers;
  }
}

// One kernel a source, so that the profiler names each.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_blocked_matvec_kernel(const __grid_constant__ FemBlockedArgs a) {
  cluster_blocked_body<D, kApply, 0>(a);
}

template <int D, int M>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_blocked_prep_kernel(const __grid_constant__ FemBlockedArgs a) {
  cluster_blocked_body<D, kPrep, M>(a);
}

template <int D, int M>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_blocked_grad_kernel(const __grid_constant__ FemBlockedArgs a) {
  cluster_blocked_body<D, kGrad, M>(a);
}

template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_blocked_assemble_kernel(const __grid_constant__ FemBlockedArgs a) {
  cluster_blocked_body<D, kColumns, 0>(a);
}

// f(the cluster kernel of `source` in `dim`, of `material` for prep (robust
// Neo-Hookean included) and grad); anything else returns
// cudaErrorInvalidValue.
template <typename F>
int with_cluster_kernel(int source, int dim, int material, F&& f) {
  auto by_dim = [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    switch (source) {
      case kApply:
        return f(cluster_blocked_matvec_kernel<D>);
      case kColumns:
        return f(cluster_blocked_assemble_kernel<D>);
      case kPrep:
        return fem::dispatch_material<true>(material, [&](auto mc) {
          return f(cluster_blocked_prep_kernel<D, decltype(mc)::value>);
        });
      case kGrad:
        return fem::dispatch_material<false>(material, [&](auto mc) {
          return f(cluster_blocked_grad_kernel<D, decltype(mc)::value>);
        });
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (dim == 3) return by_dim(std::integral_constant<int, 3>{});
  if (dim == 2) return by_dim(std::integral_constant<int, 2>{});
  return static_cast<int>(cudaErrorInvalidValue);
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
int matvec_launch(const FemBlockedArgs& a, cudaStream_t s) {
  const fem::BlockTables& T = a.T;
  const size_t smem = work_smem(T);
  int rc = prepare(blocked_matvec_kernel<D>, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_matvec_kernel<D><<<T.num_blocks, kThreads, smem, s>>>(
        T, a.k, a.x, a.transpose, a.partials);
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return slot_sum_launch<D>(a.slot_ptr, a.slot_rows, a.n, a.partials, a.y,
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
  const int threads = ((T.eb + kEdgeParts - 1) / kEdgeParts + 31) / 32 * 32;
  if (threads > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * D * static_cast<size_t>(T.pb);
  const int rc = prepare(blocked_edges_kernel<D>, smem);
  if (rc != 0) return rc;
  if (T.num_blocks > 0) {
    blocked_edges_kernel<D><<<T.num_blocks * kEdgeParts, threads, smem, s>>>(
        T, static_cast<const float*>(pos), static_cast<float*>(x), kEdgeParts);
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

// The two-kernel (grid) variant of `source` in D: one CTA a block writes
// its per-slot partials (prep also K), then one thread a particle sums
// them into y.
template <int D>
int grid_launch(const FemBlockedArgs& a, int source, int material,
                cudaStream_t s) {
  int rc;
  switch (source) {
    case kApply:
      return matvec_launch<D>(a, s);
    case kColumns:
      return assemble_launch<D>(a.T, a.x, a.slot_ptr, a.slot_rows, a.n,
                                a.partials, a.y, s);
    case kPrep:
      rc = fem::dispatch_material<true>(material, [&](auto mc) {
        return prep_launch<D, decltype(mc)::value>(a.T, a.x, a.m, a.k_out,
                                                   a.partials, s);
      });
      break;
    case kGrad:
      rc = fem::dispatch_material<false>(material, [&](auto mc) {
        return grad_prep_launch<D, decltype(mc)::value>(a.T, a.x, a.m,
                                                        a.partials, s);
      });
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return slot_sum_launch<D>(a.slot_ptr, a.slot_rows, a.n, a.partials, a.y,
                            s);
}

bool bad_dim(const fem::BlockTables& T) { return T.dim != 2 && T.dim != 3; }

}  // namespace

// K2's partials form: k_out (B*Eb, D, D) and partials (B*Pb, D);
// `material` a fem::Material of this library (robust Neo-Hookean
// included), `params` its numbers.
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

// K7b's partials form: per-slot explicit gradient partials (B*Pb, D) at
// pos; `material` a fem::Material of this library (no robust instance),
// `params` its numbers.
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

// The two-kernel variant of `source` (BlockedSource): y (N, D) the
// per-particle sums (apply: G(K) x or G(K^T) x; prep: the -V h force, and
// K into k_out; grad: the gradient; columns: the assembly of the columns);
// args->partials (B*Pb, D) is scratch.
extern "C" int fem_blocked_grid(const FemBlockedArgs* args, int source,
                                int material, void* stream) {
  const FemBlockedArgs& a = *args;
  if (bad_dim(a.T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.T.dim == 3 ? grid_launch<3>(a, source, material, s)
                      : grid_launch<2>(a, source, material, s);
}

// The device's limits for the cluster kernel of `source` in `dim` (and
// `material`, for prep and grad): the most CTAs
// a cluster of it can have, the most dynamic shared memory a CTA can take
// and the SMs.  Returns 0 or a CUDA error.
extern "C" int fem_blocked_cluster_limits(int source, int dim, int material,
                                          int* max_cluster, int* smem_optin,
                                          int* sms) {
  return with_cluster_kernel(source, dim, material, [&](auto kernel) {
    return fem::cluster_limits(kernel, kClusterThreads, max_cluster,
                               smem_optin, sms);
  });
}

// Bytes of dynamic shared memory of the cluster CTA of `source`: `groups`
// thread groups, `entries` receive slots.
extern "C" long long fem_blocked_cluster_smem(int source, int eb, int pb,
                                              int dim, int groups,
                                              int entries) {
  return static_cast<long long>(
      sizeof(float) * cluster_words(source, eb, pb, dim, groups, entries));
}

// Checks that one cluster of `cluster` CTAs of the cluster kernel of
// `source` in `dim` (and `material`), `threads` threads and `smem`
// bytes of dynamic shared memory each, can be placed on the device; writes
// how many could be active at once.  Returns 0, a CUDA error, -2 (shared
// memory too large) or -4 (the cluster cannot be scheduled).
extern "C" int fem_blocked_cluster_fit(int source, int material, int cluster,
                                       int threads, int smem, int dim,
                                       int* max_active) {
  *max_active = 0;
  return with_cluster_kernel(source, dim, material, [&](auto kernel) {
    return fem::cluster_fit(kernel, threads, cluster,
                            static_cast<size_t>(smem), max_active);
  });
}

// The cluster variant of `source`: one cluster of `cluster` CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory each.
extern "C" int fem_blocked_cluster(const FemBlockedArgs* args, int source,
                                   int material, int cluster, int threads,
                                   int smem, void* stream) {
  FemBlockedArgs a = *args;
  if (bad_dim(a.T)) return static_cast<int>(cudaErrorInvalidValue);
  return with_cluster_kernel(source, a.T.dim, material, [&](auto kernel) {
    return fem::cluster_launch(kernel, &a, cluster, threads, smem, stream);
  });
}

// Edge matrices x (B*Eb, D, D) of every element slot at pos, kEdgeParts
// CTAs a block.
extern "C" int fem_blocked_edges(const fem::BlockTables* tables,
                                 const void* pos, void* x, void* stream) {
  const fem::BlockTables& T = *tables;
  if (bad_dim(T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return T.dim == 3 ? edges_launch<3>(T, pos, x, s)
                    : edges_launch<2>(T, pos, x, s);
}

extern "C" const char* fem_blocked_error(int code) {
  if (code == -2) return "the CTA's shared memory exceeds the device's limit";
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
