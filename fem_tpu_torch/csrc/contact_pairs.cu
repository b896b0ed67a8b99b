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
// MB at most.
//
// Design (a simple right one first): the N-body pattern.  A vertex row is
// summed by kSplit consecutive threads, each over every kSplit-th partner;
// partner tiles of positions, velocities and body ids are staged through
// shared memory; the row's partial sums are then added by a butterfly of
// two shuffles, which leaves the same value on every lane.  The partners
// are taken in a fixed order and there are no atomics, so two runs are
// bit-identical.  No (ns, ns) or (ns, ns, d) matrix is written: the pair
// set is decided per pair from the body ids and the uint8 masks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 4;
constexpr int kRows = kThreads / kSplit;  // vertex rows a CTA
constexpr int kTile = kThreads;           // partners staged a round
constexpr unsigned kFull = 0xffffffffu;

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
  float s = 0.0f, w = 0.0f;
  float t[D], v[D], f[D];
#pragma unroll
  for (int c = 0; c < D; ++c) t[c] = v[c] = f[c] = 0.0f;

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
      const float* vj = s_vel + tj * D;
      if (!a.coulomb) {
        const float d2 = fmaxf(
            __fsub_rn(__fadd_rn(sq_i, dot_rn<D>(xj, xj)),
                      __fmul_rn(2.0f, dot_fma<D>(xi, xj))),
            1e-18f);
        const float dist = __fsqrt_rn(d2);
        const float pen = fmaxf(__fsub_rn(a.radius, dist), 0.0f);
        if (!(pen > 0.0f)) continue;
        const float coef =
            __fdiv_rn(__fmul_rn(a.k, pen), fmaxf(dist, a.floor));
        s = __fadd_rn(s, coef);
#pragma unroll
        for (int c = 0; c < D; ++c) t[c] = __fadd_rn(t[c], __fmul_rn(coef, xj[c]));
        if (a.friction) {
          const float cw = __fmul_rn(a.friction_c, __fdiv_rn(pen, a.radius));
          w = __fadd_rn(w, cw);
#pragma unroll
          for (int c = 0; c < D; ++c) v[c] = __fadd_rn(v[c], __fmul_rn(cw, vj[c]));
        }
        continue;
      }
      float diff[D], dv[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        diff[c] = __fsub_rn(xi[c], xj[c]);
        dv[c] = __fsub_rn(vi[c], vj[c]);
      }
      const float dist = __fsqrt_rn(fmaxf(dot_rn<D>(diff, diff), 1e-18f));
      const float pen = fmaxf(__fsub_rn(a.radius, dist), 0.0f);
      if (!(pen > 0.0f)) continue;
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
        for (int c = 0; c < D; ++c) fp[c] = __fsub_rn(fp[c], __fmul_rn(cw, dv[c]));
      }
      const float vn = dot_rn<D>(dv, nh);
      float vt[D];
#pragma unroll
      for (int c = 0; c < D; ++c) vt[c] = __fsub_rn(dv[c], __fmul_rn(vn, nh[c]));
      const float speed = __fsqrt_rn(fmaxf(dot_rn<D>(vt, vt), 1e-24f));
      const float mag = fminf(__fmul_rn(a.mu_slope, speed),
                              __fmul_rn(a.mu_k, pen));
      const float scale = __fdiv_rn(mag, speed);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        fp[c] = __fsub_rn(fp[c], __fmul_rn(scale, vt[c]));
        f[c] = __fadd_rn(f[c], fp[c]);
      }
    }
  }
  // The row's kSplit partial sums, in a fixed butterfly; every lane of the
  // warp takes part (rows past N carry zeros).
  float out[D];
  if (!a.coulomb) {
    s = butterfly(s);
    w = butterfly(w);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float tc = butterfly(t[c]);
      const float vc = butterfly(v[c]);
      out[c] = __fsub_rn(__fmul_rn(xi[c], s), tc);
      if (a.friction)
        out[c] = __fsub_rn(out[c], __fsub_rn(__fmul_rn(vi[c], w), vc));
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) out[c] = butterfly(f[c]);
  }
  if (live && lane == 0) {
#pragma unroll
    for (int c = 0; c < D; ++c) a.out[i * D + c] = out[c];
  }
}

}  // namespace

extern "C" int fem_contact_pairs(int dim, int n, int bodies, const void* pos,
                                 const void* vel, const void* body,
                                 const void* table, const void* mask,
                                 float radius, float k, float floor,
                                 float friction_c, float mu_k, float mu_slope,
                                 int friction, int coulomb, void* out,
                                 void* stream) {
  if (n < 1 || bodies < 1 || (dim != 2 && dim != 3) ||
      ((friction || coulomb) && vel == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairArgs a{static_cast<const float*>(pos),
                   static_cast<const float*>(vel),
                   static_cast<const int*>(body),
                   static_cast<const long long*>(table),
                   static_cast<const unsigned char*>(mask),
                   static_cast<float*>(out),
                   n, radius, k, floor, friction_c, mu_k, mu_slope,
                   friction, coulomb};
  const int grid = (n + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3)
    contact_pairs_kernel<3><<<grid, kThreads, 0, s>>>(a);
  else
    contact_pairs_kernel<2><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fem_contact_pairs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
