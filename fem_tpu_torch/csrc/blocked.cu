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
// K3 has two variants of one apply, chosen by size before the launch
// (ops/blocked_kernels.py: matvec_plan), never one in place of the other
// after a failure.  The cluster variant (cluster_blocked_matvec_kernel), for
// every blocking whose receive slots fit one thread-block cluster (<= 16
// CTAs on the H100; the flagship's 17 blocks: 16 CTAs, default.json's 1
// block: 1): one launch, the whole grid one cluster, on K8's ownership
// (ops/frame_kernels.py: explicit_assignment) — CTA `rank` owns the blocks
// b = rank (mod C), one or two thread groups of 256 threads each on one
// block at a time, and the particles whose first slot lies in its blocks.
// Each group stages its block's x rows and tables into shared memory,
// computes its elements' rows and each block slot's sum through the
// block's local plan, and stores that sum into a receive slot of the CTA
// that owns the slot's particle (cluster_slots.cuh, shared with K8; the
// receive slots of a particle lie in the slot plan's order); after a
// cluster barrier each owner sums its particles' receive slots in that
// order and writes y.  Two cluster barriers an apply: one before the first
// store into another CTA (no CTA stores into one that has not started;
// arrived at the start, waited for after the first block's rows), and one
// after the stores; no CTA touches another's shared memory after that, so
// none needs a barrier before it leaves.  A cluster of one CTA needs only
// the second, a CTA barrier.  The kernel counts them.  The
// two-kernel variant (blocked_matvec_kernel + slot_sum_kernel), for
// blockings that do not fit: per-block partials through device memory,
// then one thread a particle.  Both compute the same two sums in the same
// order, so their outputs are bit-identical.
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
// over more SMs is later work.  K3's cluster variant takes out the second
// launch and the partials' round trip through device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "blocked_common.cuh"
#include "cluster.cuh"
#include "cluster_slots.cuh"

// K3's arguments, both variants; the Python side mirrors this layout
// (ops/blocked_kernels.py: MatvecArgsC).
struct FemMatvecArgs {
  fem::BlockTables T;    // T.dim is D
  const float* k;        // (B*Eb, D, D) block-ordered K
  const float* x;        // (N, D)
  int transpose;         // G(K^T) x
  int n;                 // particles
  const int* slot_ptr;   // (N+1,) slot plan (the two-kernel variant)
  const int* slot_rows;  // flat block slots b*Pb+p
  float* partials;       // (B*Pb, D) scratch of the two-kernel variant
  float* y;              // (N, D) the product
  // The cluster variant's plan (ops/blocked_kernels.py: matvec_binding,
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
};

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// K3's cluster variant: a CTA is 1 or 2 groups of kThreads, each group
// working on one of the CTA's locality blocks at a time.
constexpr int kMaxGroups = 2;
constexpr int kClusterThreads = kMaxGroups * kThreads;

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

// 4-byte words of one thread group's share of K3's cluster CTA: its
// block's working set (xs, t) and the block's tables staged from device
// memory — plus and minus (Eb*D each), the local plan's rows (Eb*(D+1)) and
// offsets (Pb+1), and each slot's destination (Pb).
__host__ __device__ inline size_t matvec_group_words(int eb, int pb,
                                                     int dim) {
  return fem::block_work_floats(eb, pb, dim) +
         static_cast<size_t>(3 * dim + 1) * eb + 2 * static_cast<size_t>(pb) +
         1;
}

// 4-byte words of K3's cluster CTA's dynamic shared memory: its receive
// slots (`entries` rows of slot_stride floats), then one share per thread
// group.
inline size_t matvec_cluster_words(int eb, int pb, int dim, int groups,
                                   int entries) {
  return static_cast<size_t>(fem::slot_stride(dim)) * entries +
         groups * matvec_group_words(eb, pb, dim);
}

// The hardware cluster barrier in two halves: every thread of the cluster
// arrives (relaxed: it orders no memory, so it only says the CTA is
// running) and later waits for all.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// K3's cluster variant: the grid is one cluster (the launch sets the
// cluster dimension to the grid), of kThreads or kClusterThreads threads a
// CTA.  Every operand a phase reads is loaded before the phase, in one
// pass of independent loads: a block's tables are staged into shared memory
// beside its x rows, each thread's first element's K and first owned
// particle's span are read into registers at the start, and the barrier
// that keeps stores out of CTAs that have not started is split, its arrival
// at the start and its wait before the first store, so that no phase waits
// on a chain of dependent device-memory reads.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_blocked_matvec_kernel(const __grid_constant__ FemMatvecArgs a) {
  constexpr int DD = D * D;
  constexpr int R = fem::rows_floats(D);
  constexpr int RS = fem::slot_stride(D);
  extern __shared__ __align__(16) float smem[];
  const fem::BlockTables& T = a.T;
  cg::cluster_group cl = cg::this_cluster();
  const int nr = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  // The barrier before any store into another CTA (none in a cluster of
  // one): arrive now.
  if (nr > 1) cluster_arrive_relaxed();
  int barriers = 0;
  const int groups = static_cast<int>(blockDim.x) / kThreads;
  const int grp = static_cast<int>(threadIdx.x) / kThreads;
  const int gtid = static_cast<int>(threadIdx.x) % kThreads;
  const int bpc = (T.num_blocks + nr - 1) / nr;
  const int rounds = (bpc + groups - 1) / groups;
  const int eb = T.eb;
  const int pb = T.pb;
  float* recv = smem;  // first: 16-byte aligned rows
  float* xs = recv + RS * static_cast<size_t>(a.cl_entries) +
              grp * matvec_group_words(eb, pb, D);
  float* t = xs + D * pb;
  int* plus = reinterpret_cast<int*>(t + R * eb);
  int* minus = plus + D * eb;
  int* lrows = minus + D * eb;
  int* lptr = lrows + (D + 1) * eb;
  int* dest = lptr + pb + 1;
  // The block's tables in shared memory: element_apply reads them as block
  // 0 of this view.
  fem::BlockTables Tb = T;
  Tb.plus = plus;
  Tb.minus = minus;
  // Registers loaded ahead: this thread's element of its first block (its
  // K; padded slots hold zeros) and its first owned particle.
  const int b0 = me + grp * nr;
  float k0[DD];
  if (b0 < T.num_blocks && gtid < eb) {
    const float* k = a.k + DD * (static_cast<size_t>(b0) * eb + gtid);
#pragma unroll
    for (int i = 0; i < DD; ++i) k0[i] = k[i];
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
    if (on) {
      const int* ids = T.block_particles + b * pb;
      for (int i = gtid; i < D * pb; i += kThreads) {
        const int p = i / D;
        xs[i] = a.x[D * ids[p] + (i - D * p)];
      }
      for (int i = gtid; i < D * eb; i += kThreads) {
        plus[i] = T.plus[b * D * eb + i];
        minus[i] = T.minus[b * D * eb + i];
      }
      for (int i = gtid; i < (D + 1) * eb; i += kThreads) {
        lrows[i] = T.local_rows[b * (D + 1) * eb + i];
      }
      for (int i = gtid; i <= pb; i += kThreads) {
        lptr[i] = T.local_ptr[b * (pb + 1) + i];
        if (i < pb) dest[i] = a.cl_slot_dest[b * pb + i];
      }
    }
    const int nel = on ? T.block_elements[b] : 0;
    __syncthreads();  // the share is complete
    for (int e = gtid; e < nel; e += kThreads) {
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
    }
    __syncthreads();
    if (round == 0 && nr > 1) {
      cluster_wait();  // every CTA is running
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

template <typename F>
int with_matvec_cluster_kernel(int dim, F&& f) {
  if (dim == 3) return f(cluster_blocked_matvec_kernel<3>);
  if (dim == 2) return f(cluster_blocked_matvec_kernel<2>);
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
int matvec_launch(const FemMatvecArgs& a, cudaStream_t s) {
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

// K3's two-kernel variant: y (N, D) = G(K) x, or G(K^T) x when
// `transpose`; args->partials (B*Pb, D) is scratch.
extern "C" int fem_blocked_matvec(const FemMatvecArgs* args, void* stream) {
  const FemMatvecArgs& a = *args;
  if (bad_dim(a.T)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.T.dim == 3 ? matvec_launch<3>(a, s) : matvec_launch<2>(a, s);
}

// The device's limits for K3's cluster variant's instance of `dim`: the most
// CTAs a cluster of it can have, the most dynamic shared memory a CTA can
// take and the SMs.  Returns 0 or a CUDA error.
extern "C" int fem_blocked_matvec_limits(int dim, int* max_cluster,
                                         int* smem_optin, int* sms) {
  return with_matvec_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_limits(kernel, kClusterThreads, max_cluster,
                               smem_optin, sms);
  });
}

// Bytes of dynamic shared memory of K3's cluster CTA: `groups` thread
// groups, `entries` receive slots.
extern "C" long long fem_blocked_matvec_cluster_smem(int eb, int pb, int dim,
                                                     int groups,
                                                     int entries) {
  return static_cast<long long>(
      sizeof(float) * matvec_cluster_words(eb, pb, dim, groups, entries));
}

// Checks that one cluster of `cluster` CTAs of K3's cluster variant's
// instance of `dim`, `threads` threads and `smem` bytes of dynamic shared
// memory each, can be placed on the device; writes how many could be active
// at once.  Returns 0, a CUDA error, -2 (shared memory too large) or -4
// (the cluster cannot be scheduled).
extern "C" int fem_blocked_matvec_cluster_fit(int cluster, int threads,
                                              int smem, int dim,
                                              int* max_active) {
  *max_active = 0;
  return with_matvec_cluster_kernel(dim, [&](auto kernel) {
    return fem::cluster_fit(kernel, threads, cluster,
                            static_cast<size_t>(smem), max_active);
  });
}

// K3's cluster variant: one cluster of `cluster` CTAs of `threads` threads
// and `smem` bytes of dynamic shared memory each.
extern "C" int fem_blocked_matvec_cluster(const FemMatvecArgs* args,
                                          int cluster, int threads, int smem,
                                          void* stream) {
  FemMatvecArgs a = *args;
  if (bad_dim(a.T)) return static_cast<int>(cudaErrorInvalidValue);
  return with_matvec_cluster_kernel(a.T.dim, [&](auto kernel) {
    return fem::cluster_launch(kernel, &a, cluster, threads, smem, stream);
  });
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
  if (code == -2) return "the CTA's shared memory exceeds the device's limit";
  if (code == -4) return "the cluster cannot be scheduled on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
