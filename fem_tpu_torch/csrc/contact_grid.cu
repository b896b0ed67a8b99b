// C2, fem_contact_grid: the uniform grid's narrow phase of one substep in
// one launch, 2D or 3D, over the concatenated vertex soup of every body.
//
// Replaces no TPU kernel: the JAX package computes this in XLA
// (fem_tpu/broadphase.py:82-232): a gather of (ns, (3^d+1)/2 cap)
// candidate rows, the pair forces, a row sum for +f and a scatter-add of
// -f onto every candidate.  The sort of the cell ids and the lookup of
// each forward neighbour cell's start stay the library calls of the
// wrapper (torch.argsort(stable=True), torch.searchsorted), the
// counterparts of the JAX package's XLA sort and lookup.
//
// What it computes (ops/contact_kernels.py holds the plain version).  The
// vertices are sorted by cell id (stable); rank i's forward stencil is the
// JAX package's: the next cap ranks of its own cell, then cap ranks from
// the start of each forward cell (the (3^d - 1)/2 offsets of {-1,0,1}^d
// whose linearized id delta is positive, the last axis fastest), a
// candidate counting where its cell id equals the target.  Every pair that
// stencil finds gets its force (the plain version's formulas: direct
// differences, k pen / max(dist, 0.1 r), the dashpot, the Coulomb cone),
// +f on the finder i and -f on the candidate j.  Same-body pairs need
// self-contact and a rest distance past the exclusion radius.
//
// The -f half without atomics.  i is a candidate of k exactly when
//   (a) both are in one cell and 1 <= rank_i - rank_k <= cap, or
//   (b) cell_i - cell_k is a forward linearized offset and
//       rank_i - start(cell_i) < cap;
// so thread i also sums, over every k that finds it, the force that k's
// pair puts on i.  That force is -f(k, i) = f(i, k) bit for bit (the
// difference vectors negate exactly and every other term is symmetric), so
// thread i sums f(i, j) over its whole pair set in a fixed order: forward
// own cell, forward cells, backward own cell, backward cells.  The pair
// set is the JAX package's, truncation at cap included, Newton's third law
// holds pair by pair, and two runs are bit-identical.  The force is
// written to the vertex's input row (order[i]).
//
// Bound on the H100: the candidate reads.  Each vertex reads its
// (3^d+1)/2 cap forward candidates (position, velocity, body, rest: up to
// 40 B each) and as many backward ones, ~10-20 KB a vertex row group
// through L2; at the shells' 24,576 vertices ~8 MB a launch, a few us.
//
// Design (a simple right one first): one thread a sorted vertex, in CTAs
// of kThreads; the backward cells' ranges by binary search over the sorted
// cell ids.  Near-empty candidate slots end a cell's scan at its first
// mismatch (the ids are sorted).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct GridArgs {
  const float* pos;        // (N, D) input order
  const float* vel;        // (N, D) or null
  const float* rest;       // (N, D) or null (self-contact off)
  const int* body;         // (N,)
  const int* cell;         // (N,) sorted cell ids
  const long long* order;  // (N,) sorted rank -> input row
  const int* start;        // (N, n_off) forward cells' starts
  float* out;              // (N, D) input order
  int n;
  int m;
  int cap;
  int n_off;
  float radius;
  float k;
  float floor;  // 0.1 r
  float friction_c;
  float mu;
  float mu_slope;
  float excl2;  // exclusion radius squared
  int friction;
  int coulomb;
  int self_contact;
};

template <int D>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(a[c], b[c]));
  return s;
}

// First sorted rank whose cell id is not below c.
__device__ __forceinline__ int lower_bound(const int* cell, int n, int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cell[mid] < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The linearized id delta of forward offset o (the JAX package's order).
template <int D>
__device__ __forceinline__ int offset_of(int dx, int dy, int dz, int m) {
  return D == 3 ? (dx * m + dy) * m + dz : dx * m + dy;
}

template <int D>
struct Vertex {
  float x[D], v[D], r[D];
  int body;
};

template <int D>
__device__ __forceinline__ void load_vertex(const GridArgs& a, long long row,
                                            Vertex<D>& p) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    p.x[c] = a.pos[row * D + c];
    p.v[c] = (a.friction || a.coulomb) ? a.vel[row * D + c] : 0.0f;
    p.r[c] = a.self_contact ? a.rest[row * D + c] : 0.0f;
  }
  p.body = a.body[row];
}

// f(i, j) added to acc when the pair is admitted and overlaps.
template <int D>
__device__ __forceinline__ void add_pair(const GridArgs& a,
                                         const Vertex<D>& pi, int rank_j,
                                         float* acc) {
  Vertex<D> pj;
  load_vertex<D>(a, a.order[rank_j], pj);
  if (pj.body == pi.body) {
    if (!a.self_contact) return;
    float rd[D];
#pragma unroll
    for (int c = 0; c < D; ++c) rd[c] = __fsub_rn(pj.r[c], pi.r[c]);
    if (!(dot_rn<D>(rd, rd) > a.excl2)) return;
  }
  float diff[D];
#pragma unroll
  for (int c = 0; c < D; ++c) diff[c] = __fsub_rn(pi.x[c], pj.x[c]);
  const float dist = __fsqrt_rn(fmaxf(dot_rn<D>(diff, diff), 1e-18f));
  const float pen = fmaxf(__fsub_rn(a.radius, dist), 0.0f);
  if (!(pen > 0.0f)) return;
  const float coef = __fdiv_rn(__fmul_rn(a.k, pen), fmaxf(dist, a.floor));
  float fp[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    fp[c] = __fmul_rn(coef, diff[c]);
    dv[c] = __fsub_rn(pi.v[c], pj.v[c]);
  }
  if (a.friction) {
    const float cw = __fmul_rn(a.friction_c, __fdiv_rn(pen, a.radius));
#pragma unroll
    for (int c = 0; c < D; ++c) fp[c] = __fsub_rn(fp[c], __fmul_rn(cw, dv[c]));
  }
  if (a.coulomb) {
    float nh[D], vt[D];
#pragma unroll
    for (int c = 0; c < D; ++c) nh[c] = __fdiv_rn(diff[c], dist);
    const float vn = dot_rn<D>(dv, nh);
#pragma unroll
    for (int c = 0; c < D; ++c) vt[c] = __fsub_rn(dv[c], __fmul_rn(vn, nh[c]));
    const float speed = __fsqrt_rn(fmaxf(dot_rn<D>(vt, vt), 1e-24f));
    const float mag = fminf(__fmul_rn(a.mu_slope, speed),
                            __fmul_rn(a.mu, __fmul_rn(a.k, pen)));
    const float scale = __fdiv_rn(mag, speed);
#pragma unroll
    for (int c = 0; c < D; ++c) fp[c] = __fsub_rn(fp[c], __fmul_rn(scale, vt[c]));
  }
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = __fadd_rn(acc[c], fp[c]);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
contact_grid_kernel(const GridArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int ci = a.cell[i];
  const long long oi = a.order[i];
  Vertex<D> pi;
  load_vertex<D>(a, oi, pi);
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  const int dz_lo = D == 3 ? -1 : 0, dz_hi = D == 3 ? 1 : 0;

  // Forward, own cell: the next cap ranks.
  for (int s = 0; s < a.cap; ++s) {
    const int kr = i + 1 + s;
    if (kr >= a.n || a.cell[kr] != ci) break;
    add_pair<D>(a, pi, kr, acc);
  }
  // Forward cells: cap ranks from each start.
  int o = 0;
  for (int dx = -1; dx <= 1; ++dx)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dz = dz_lo; dz <= dz_hi; ++dz) {
        const int off = offset_of<D>(dx, dy, dz, a.m);
        if (off <= 0) continue;
        const int st = a.start[static_cast<long long>(i) * a.n_off + o++];
        const int target = ci + off;
        for (int s = 0; s < a.cap; ++s) {
          const int kr = st + s;
          if (kr >= a.n || a.cell[kr] != target) break;
          add_pair<D>(a, pi, kr, acc);
        }
      }
  // Backward, own cell: the ranks whose next cap ranks hold i.
  for (int kr = max(0, i - a.cap); kr < i; ++kr)
    if (a.cell[kr] == ci) add_pair<D>(a, pi, kr, acc);
  // Backward cells: every rank of cell ci - off finds i when i is among
  // the first cap ranks of its own cell.
  if (i - lower_bound(a.cell, a.n, ci) < a.cap) {
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = dz_lo; dz <= dz_hi; ++dz) {
          const int off = offset_of<D>(dx, dy, dz, a.m);
          if (off <= 0) continue;
          const int target = ci - off;
          for (int kr = lower_bound(a.cell, a.n, target);
               kr < a.n && a.cell[kr] == target; ++kr)
            add_pair<D>(a, pi, kr, acc);
        }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) a.out[oi * D + c] = acc[c];
}

}  // namespace

extern "C" int fem_contact_grid(int dim, int n, int m, int cap,
                                const void* pos, const void* vel,
                                const void* rest, const void* body,
                                const void* cell, const void* order,
                                const void* start, float radius, float k,
                                float floor, float friction_c, float mu,
                                float mu_slope, float excl2, int friction,
                                int coulomb, int self_contact, void* out,
                                void* stream) {
  if (n < 1 || cap < 1 || m < 3 || (dim != 2 && dim != 3) ||
      ((friction || coulomb) && vel == nullptr) ||
      (self_contact && rest == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_off = dim == 3 ? 13 : 4;
  const GridArgs a{static_cast<const float*>(pos),
                   static_cast<const float*>(vel),
                   static_cast<const float*>(rest),
                   static_cast<const int*>(body),
                   static_cast<const int*>(cell),
                   static_cast<const long long*>(order),
                   static_cast<const int*>(start),
                   static_cast<float*>(out),
                   n, m, cap, n_off, radius, k, floor, friction_c, mu,
                   mu_slope, excl2, friction, coulomb, self_contact};
  const int grid = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3)
    contact_grid_kernel<3><<<grid, kThreads, 0, s>>>(a);
  else
    contact_grid_kernel<2><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_contact_grid_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
