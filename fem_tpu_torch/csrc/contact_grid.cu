// C2, fem_contact_grid: the uniform grid's narrow phase of one substep in
// one launch, 2D or 3D, over the concatenated vertex soup of every body.
//
// Replaces no TPU kernel: the JAX package computes this in XLA
// (fem_tpu/broadphase.py:82-232): a gather of (ns, (3^d+1)/2 cap)
// candidate rows, the pair forces, a row sum for +f and a scatter-add of
// -f onto every candidate.  The sort of the cell ids and the lookups of
// the neighbour cells' runs stay the library calls of the wrapper
// (torch.argsort(stable=True), torch.searchsorted), the counterparts of
// the JAX package's XLA sort and lookup.
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
// so vertex i also sums, over every k that finds it, the force that k's
// pair puts on i.  That force is -f(k, i) = f(i, k) bit for bit (the
// difference vectors negate exactly and every other term is symmetric), so
// vertex i sums f(i, j) over its whole pair set in a fixed order: forward
// own cell, forward cells, backward own cell, backward cells.  The pair
// set is the JAX package's, truncation at cap included, Newton's third law
// holds pair by pair, and two runs are bit-identical.  The force is
// written to the vertex's input row (order[i]).
//
// Bound on the H100: the candidate reads.  Each vertex reads its
// (3^d+1)/2 cap forward candidates (position, velocity, body, rest: up to
// 48 B each) and as many backward ones, ~10-20 KB a vertex row group
// through L2; at the shells' 24,576 vertices ~8 MB a launch, a few us.
// What binds in practice is latency: a vertex's candidates are chains of
// dependent loads, and the small soups fill few SMs.
//
// Two variants, one library (ops/contact_kernels.grid_plan picks).
//
// The warp variant (grid_soup_kernel, then grid_warp_kernel; every path's):
// a first kernel gathers each sorted rank's position and body (one float4:
// x, y, z or 0, the body's bits), velocity and rest position (one float4
// each, in rows of the soup that exist only where friction, the Coulomb
// cone or self-contact read them) into rank order, so that a candidate
// costs one 16-byte load at its rank and no order[] hop.  Then a warp takes
// a sorted vertex.  The wrapper's lookup gives each rank its run table
// (runs: for each row of the 3^d neighbourhood, the first ranks of its
// three cells and the rank past the last, 4 3^(d-1) ints), so lane s reads
// segment s's first rank and count with no binary search and no cell[] read
// a candidate (a slot is in its cell exactly when its rank is below the
// cell's end): forward own cell, the forward cells, backward own cell, the
// backward cells (whole, when i is among the first cap ranks of its cell).
// A warp scan of the counts places the segments; the candidates then go to
// the lanes 32 at a time in that order (each lane finds its segment by a
// 5-step search over the lanes' offsets), each lane rejects its pair on d2
// against a threshold that rejects only what the exact pen > 0 test rejects
// (ops/contact_kernels.d2_threshold), runs the thread variant's exact test
// and force on the rest, and the warp adds the hits' forces one after
// another, in candidate order, through shuffles.  Every pair's terms are
// the thread variant's bits and each vertex sums them in the same order, so
// the two variants' outputs are bit-identical.  The backward cells hold no
// cap (F8's collapse), so a warp loops in chunks of 32 until its list ends.
//
// The thread variant (contact_grid_kernel, the first design, kept for the
// checks): one thread a sorted vertex, in CTAs of kThreads; the forward
// cells' starts read from the same run table, the backward cells' ranges
// by binary search over the sorted cell ids.  Near-empty
// candidate slots end a cell's scan at its first mismatch (the ids are
// sorted).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // the thread variant's CTA
constexpr int kWarpThreads = 64;   // the warp variant's CTA: a warp a vertex
constexpr int kSoupThreads = 256;  // the soup gather's CTA
constexpr unsigned kFull = 0xffffffffu;

struct GridArgs {
  const float* pos;        // (N, D) input order
  const float* vel;        // (N, D) or null
  const float* rest;       // (N, D) or null (self-contact off)
  const int* body;         // (N,)
  const int* cell;         // (N,) sorted cell ids
  const long long* order;  // (N,) sorted rank -> input row
  const int* runs;         // (N, 4 3^(D-1)) each rank's neighbour runs
  float* out;              // (N, D) input order
  int n;
  int m;
  int cap;
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
  // The warp variant only: the soup by rank, its velocity and rest rows
  // null where no term reads them.
  float4* soup;       // (N,) position and body
  float4* soup_vel;   // (N,) velocity, or null
  float4* soup_rest;  // (N,) rest position, or null
  float d2_max;       // the pre-test's threshold on d2
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

// The run table's column of the first rank of neighbourhood cell `cell`
// (its index in {-1,0,1}^D, the last axis fastest): row cell / 3 holds
// the first ranks of its three cells and the rank past the last, so the
// cell's end is the next column.
__device__ __forceinline__ int run_col(int cell) { return cell + cell / 3; }

// The run table's width and the own cell's index in {-1,0,1}^D; the
// forward cells are the next kOff indices and the backward ones the kOff
// before it, mirrored.
template <int D>
struct Stencil {
  static constexpr int kCenter = D == 3 ? 13 : 4;
  static constexpr int kOff = kCenter;
  static constexpr int kRuns = D == 3 ? 36 : 12;
};

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

// f(i, j) into fp when the pair is admitted and overlaps (returns true).
template <int D>
__device__ __forceinline__ bool pair_term(const GridArgs& a,
                                          const Vertex<D>& pi,
                                          const Vertex<D>& pj, float* fp) {
  if (pj.body == pi.body) {
    if (!a.self_contact) return false;
    float rd[D];
#pragma unroll
    for (int c = 0; c < D; ++c) rd[c] = __fsub_rn(pj.r[c], pi.r[c]);
    if (!(dot_rn<D>(rd, rd) > a.excl2)) return false;
  }
  float diff[D];
#pragma unroll
  for (int c = 0; c < D; ++c) diff[c] = __fsub_rn(pi.x[c], pj.x[c]);
  const float dist = __fsqrt_rn(fmaxf(dot_rn<D>(diff, diff), 1e-18f));
  const float pen = fmaxf(__fsub_rn(a.radius, dist), 0.0f);
  if (!(pen > 0.0f)) return false;
  const float coef = __fdiv_rn(__fmul_rn(a.k, pen), fmaxf(dist, a.floor));
  float dv[D];
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
  return true;
}

// f(i, j) added to acc when the pair is admitted and overlaps.
template <int D>
__device__ __forceinline__ void add_pair(const GridArgs& a,
                                         const Vertex<D>& pi, int rank_j,
                                         float* acc) {
  Vertex<D> pj;
  load_vertex<D>(a, a.order[rank_j], pj);
  float fp[D];
  if (!pair_term<D>(a, pi, pj, fp)) return;
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
  const int* run = a.runs + static_cast<size_t>(i) * Stencil<D>::kRuns;
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
        const int st = run[run_col(Stencil<D>::kCenter + 1 + o++)];
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

// The warp variant's first kernel: rank i's position and body, velocity
// and rest position, gathered from its input row order[i].
template <int D>
__global__ void __launch_bounds__(kSoupThreads)
grid_soup_kernel(const GridArgs a) {
  const int i = blockIdx.x * kSoupThreads + threadIdx.x;
  if (i >= a.n) return;
  const long long row = a.order[i];
  const float* p = a.pos + row * D;
  a.soup[i] = make_float4(p[0], p[1], D == 3 ? p[D - 1] : 0.0f,
                          __int_as_float(a.body[row]));
  if (a.soup_vel) {
    const float* v = a.vel + row * D;
    a.soup_vel[i] = make_float4(v[0], v[1], D == 3 ? v[D - 1] : 0.0f, 0.0f);
  }
  if (a.soup_rest) {
    const float* r = a.rest + row * D;
    a.soup_rest[i] = make_float4(r[0], r[1], D == 3 ? r[D - 1] : 0.0f, 0.0f);
  }
}

// Rank j's vertex from the soup (velocity and rest as load_vertex reads
// them: zero where no term uses them).
template <int D>
__device__ __forceinline__ void soup_vertex(const GridArgs& a, int j,
                                            Vertex<D>& p) {
  const float4 x = a.soup[j];
  const float xs[3] = {x.x, x.y, x.z};
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r = v;
  if (a.soup_vel) v = a.soup_vel[j];
  if (a.soup_rest) r = a.soup_rest[j];
  const float vs[3] = {v.x, v.y, v.z}, rs[3] = {r.x, r.y, r.z};
#pragma unroll
  for (int c = 0; c < D; ++c) {
    p.x[c] = xs[c];
    p.v[c] = vs[c];
    p.r[c] = rs[c];
  }
  p.body = __float_as_int(x.w);
}

template <int D>
__global__ void __launch_bounds__(kWarpThreads)
grid_warp_kernel(const GridArgs a) {
  constexpr int kCenter = Stencil<D>::kCenter;
  constexpr int kOff = Stencil<D>::kOff;
  constexpr int kRuns = Stencil<D>::kRuns;
  constexpr int kSegments = 2 * kOff + 2;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (i >= a.n) return;  // the whole warp
  const int* run = a.runs + static_cast<size_t>(i) * kRuns;
  const long long oi = a.order[i];
  const int own_lo = run[run_col(kCenter)];
  const int own_hi = run[run_col(kCenter) + 1];
  // Lane s < kSegments: segment s's first rank and its count, in the
  // thread variant's order.
  int first = 0, count = 0;
  if (lane == 0) {
    first = i + 1;
    count = min(a.cap, own_hi - i - 1);
  } else if (lane <= kOff) {
    const int c = run_col(kCenter + lane);
    first = run[c];
    count = min(a.cap, run[c + 1] - first);
  } else if (lane == kOff + 1) {
    first = max(own_lo, i - a.cap);
    count = i - first;
  } else if (lane < kSegments && i - own_lo < a.cap) {
    const int c = run_col(kCenter - (lane - kOff - 1));
    first = run[c];
    count = run[c + 1] - first;
  }
  Vertex<D> pi;
  soup_vertex<D>(a, i, pi);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int excl = incl - count;  // lanes past the segments: total
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  for (int base = 0; base < total; base += 32) {
    // Candidate t of the list: segment seg, the last whose offset <= t.
    const int t = base + lane;
    int seg = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, excl, seg + step) <= t) seg += step;
    }
    const int seg_first = __shfl_sync(kFull, first, seg);
    const int seg_excl = __shfl_sync(kFull, excl, seg);
    float fp[D];
#pragma unroll
    for (int c = 0; c < D; ++c) fp[c] = 0.0f;
    bool hit = false;
    if (t < total) {
      Vertex<D> pj;
      soup_vertex<D>(a, seg_first + (t - seg_excl), pj);
      float diff[D];
#pragma unroll
      for (int c = 0; c < D; ++c) diff[c] = __fsub_rn(pi.x[c], pj.x[c]);
      // d2 >= d2_max: the exact test's pen is 0.  A NaN goes on to it.
      if (!(dot_rn<D>(diff, diff) >= a.d2_max))
        hit = pair_term<D>(a, pi, pj, fp);
    }
    // The hits' forces added one after another in candidate order (the
    // lanes' order), every lane keeping the same sums.
    unsigned hits = __ballot_sync(kFull, hit);
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1;
#pragma unroll
      for (int c = 0; c < D; ++c)
        acc[c] = __fadd_rn(acc[c], __shfl_sync(kFull, fp[c], src));
    }
  }
  if (lane < D) {
    float v = acc[0];
#pragma unroll
    for (int c = 1; c < D; ++c)
      if (lane == c) v = acc[c];
    a.out[oi * D + lane] = v;
  }
}

}  // namespace

// The thread variant: `cell` (n,) int32 the sorted cell ids, `order` (n,)
// int64 the stable sort, `runs` (n, 4 3^(dim-1)) int32 each sorted rank's
// neighbour runs (ops/contact_kernels.grid_runs), of which it reads the
// forward cells' first ranks.  One launch, a thread a sorted vertex.
extern "C" int fem_contact_grid(int dim, int n, int m, int cap,
                                const void* pos, const void* vel,
                                const void* rest, const void* body,
                                const void* cell, const void* order,
                                const void* runs, float radius, float k,
                                float floor, float friction_c, float mu,
                                float mu_slope, float excl2, int friction,
                                int coulomb, int self_contact, void* out,
                                void* stream) {
  if (n < 1 || cap < 1 || m < 3 || (dim != 2 && dim != 3) ||
      ((friction || coulomb) && vel == nullptr) ||
      (self_contact && rest == nullptr) || runs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const GridArgs a{static_cast<const float*>(pos),
                   static_cast<const float*>(vel),
                   static_cast<const float*>(rest),
                   static_cast<const int*>(body),
                   static_cast<const int*>(cell),
                   static_cast<const long long*>(order),
                   static_cast<const int*>(runs),
                   static_cast<float*>(out),
                   n, m, cap, radius, k, floor, friction_c, mu,
                   mu_slope, excl2, friction, coulomb, self_contact};
  const int grid = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3)
    contact_grid_kernel<3><<<grid, kThreads, 0, s>>>(a);
  else
    contact_grid_kernel<2><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The warp variant: `runs` as above, `soup` (rows n, 4) float32 scratch
// with a row block of n each for the positions, the velocities where
// friction or the Coulomb cone is on, and the rest positions where
// self-contact is (in that order), `d2_max` the pre-test's threshold
// (d2_threshold).  Two launches: the soup gather, then a warp a sorted
// vertex.
extern "C" int fem_contact_grid_warp(int dim, int n, int cap,
                                     const void* pos, const void* vel,
                                     const void* rest, const void* body,
                                     const void* order, const void* runs,
                                     void* soup, float radius, float k,
                                     float floor, float friction_c, float mu,
                                     float mu_slope, float excl2,
                                     float d2_max, int friction, int coulomb,
                                     int self_contact, void* out,
                                     void* stream) {
  if (n < 1 || cap < 1 || (dim != 2 && dim != 3) || runs == nullptr ||
      soup == nullptr || ((friction || coulomb) && vel == nullptr) ||
      (self_contact && rest == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  GridArgs a{static_cast<const float*>(pos),
             static_cast<const float*>(vel),
             static_cast<const float*>(rest),
             static_cast<const int*>(body),
             nullptr,
             static_cast<const long long*>(order),
             static_cast<const int*>(runs),
             static_cast<float*>(out),
             n, 0, cap, radius, k, floor, friction_c, mu,
             mu_slope, excl2, friction, coulomb, self_contact};
  float4* rows = static_cast<float4*>(soup);
  a.soup = rows;
  rows += n;
  a.soup_vel = (friction || coulomb) ? rows : nullptr;
  if (a.soup_vel) rows += n;
  a.soup_rest = self_contact ? rows : nullptr;
  a.d2_max = d2_max;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int soup_grid = (n + kSoupThreads - 1) / kSoupThreads;
  const int warps = kWarpThreads / 32;
  const int grid = (n + warps - 1) / warps;
  if (dim == 3) {
    grid_soup_kernel<3><<<soup_grid, kSoupThreads, 0, s>>>(a);
    grid_warp_kernel<3><<<grid, kWarpThreads, 0, s>>>(a);
  } else {
    grid_soup_kernel<2><<<soup_grid, kSoupThreads, 0, s>>>(a);
    grid_warp_kernel<2><<<grid, kWarpThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_contact_grid_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
