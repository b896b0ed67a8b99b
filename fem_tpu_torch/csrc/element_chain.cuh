// The Neo-Hookean element chains of one element (a tet in 3D, a triangle in
// 2D), shared by every kernel that needs them.  nh_chain (implicit: K1 in
// element_chain.cu, the blocked prep K2 in blocked.cu, the whole-frame
// kernel K5 in blocked_frame.cu) is the counterpart of the JAX package's
// single k_and_h_chain, nh_grad_cols (explicit: K6 in element_chain.cu, K7b
// in blocked.cu, K8 in explicit_frame.cu) of its grad_cols_chain
// (fem_tpu/ops/pallas_kernels.py).  One function each, templated on the
// dimension D in {2, 3} as the Pallas chains take `dim` (_planar_ops), so
// that the formulas cannot drift between kernels or dimensions.
//
// With X the edge matrix (x[D*i + j] = p_{j+1}[i] - p_0[i]) and R = ref_inv:
//   F = X R
//   k = [mu R + (mu - lam log max(det F, 1e-4)) F^-T R^T F^-T
//        + lam tr(F^-1 R) F^-T] R^T
//   h = [mu F + (lam/2 log(det F * det F) - mu) F^-T] R^T
// unscaled: callers multiply both by -V.  Note the two logarithms: K clamps
// det F at 1e-4, the rhs squares it (finite for an inverted element).  The
// explicit columns
//   g = [mu F + (lam log det F - mu) F^-T] R^T
// take the log unclamped, so an inverted element gives NaN, as in the
// reference; callers multiply by +V.  Every product sums k = 0 .. D-1 left
// to right and the inverse is the adjugate times 1/det in both dimensions:
// the plain versions' order, which the kernels are held to.
//
// snh_chain and snh_grad_cols are the stable Neo-Hookean counterparts, the
// material of the inelastic extension's Maxwell branch (inelastic.cuh;
// the JAX package's _material_p_dp_chain): with lam' = lam + mu,
//   P = mu F + (lam'(J - 1) - mu) cof F
//   DP[D] = mu D + lam'(cof F : D) cof F + (lam'(J - 1) - mu) Dcof(F)[D]
//   k = DP[R] R^T   (R as the direction, as the Neo-Hookean K has it)
//   h = g = P R^T
// polynomial, so finite for every F.  The kernels choose the material at
// launch (the Material template parameter), never per element.

#pragma once

#include <cuda_runtime.h>

namespace fem {

// o = a b, row-major D x D.
template <int D>
__device__ __forceinline__ void mul(const float* a, const float* b, float* o) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = a[D * i] * b[j];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + a[D * i + k] * b[D * k + j];
      o[D * i + j] = s;
    }
  }
}

template <int D>
__device__ __forceinline__ void transpose(const float* m, float* o) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) o[D * i + j] = m[D * j + i];
  }
}

// det F, and F^-1 as the adjugate times 1/det (no clamp) into f_inv.  The
// 2D inverse follows the Pallas chain's _mat2_inv: 1/det first, then the
// four products.
template <int D>
__device__ __forceinline__ float det_inv(const float* f, float* f_inv) {
  if constexpr (D == 2) {
    const float det = f[0] * f[3] - f[1] * f[2];
    const float inv_det = 1.0f / det;
    f_inv[0] = f[3] * inv_det;
    f_inv[1] = -f[1] * inv_det;
    f_inv[2] = -f[2] * inv_det;
    f_inv[3] = f[0] * inv_det;
    return det;
  } else {
    const float det = f[0] * (f[4] * f[8] - f[5] * f[7]) -
                      f[1] * (f[3] * f[8] - f[5] * f[6]) +
                      f[2] * (f[3] * f[7] - f[4] * f[6]);
    const float inv_det = 1.0f / det;
    f_inv[0] = (f[4] * f[8] - f[5] * f[7]) * inv_det;
    f_inv[1] = (f[2] * f[7] - f[1] * f[8]) * inv_det;
    f_inv[2] = (f[1] * f[5] - f[2] * f[4]) * inv_det;
    f_inv[3] = (f[5] * f[6] - f[3] * f[8]) * inv_det;
    f_inv[4] = (f[0] * f[8] - f[2] * f[6]) * inv_det;
    f_inv[5] = (f[2] * f[3] - f[0] * f[5]) * inv_det;
    f_inv[6] = (f[3] * f[7] - f[4] * f[6]) * inv_det;
    f_inv[7] = (f[1] * f[6] - f[0] * f[7]) * inv_det;
    f_inv[8] = (f[0] * f[4] - f[1] * f[3]) * inv_det;
    return det;
  }
}

// The kernels' material selector; the Python side mirrors it
// (ops/element.py: MATERIAL_IDS).
enum Material { kNeoHookean = 0, kStableNeoHookean = 1 };

template <int D>
__device__ __forceinline__ float det(const float* f) {
  if constexpr (D == 2) {
    return f[0] * f[3] - f[1] * f[2];
  } else {
    return f[0] * (f[4] * f[8] - f[5] * f[7]) -
           f[1] * (f[3] * f[8] - f[5] * f[6]) +
           f[2] * (f[3] * f[7] - f[4] * f[6]);
  }
}

// The symmetrized bilinear 3x3 cofactor form: cof2(m, m) = 2 cof(m) and
// cof2(m, d) = Dcof(m)[d] (row-major, entry i*3 + j).
__device__ __forceinline__ void cof2(const float* a, const float* b,
                                     float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int p = i == 0 ? 1 : 0, q = i == 2 ? 1 : 2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int r = j == 0 ? 1 : 0, s = j == 2 ? 1 : 2;
      const float v = a[3 * p + r] * b[3 * q + s] + b[3 * p + r] * a[3 * q + s] -
                      a[3 * p + s] * b[3 * q + r] - b[3 * p + s] * a[3 * q + r];
      o[3 * i + j] = (i + j) % 2 == 0 ? v : -v;
    }
  }
}

// cof m into o.
template <int D>
__device__ __forceinline__ void cof(const float* m, float* o) {
  if constexpr (D == 2) {
    o[0] = m[3];
    o[1] = -m[2];
    o[2] = -m[1];
    o[3] = m[0];
  } else {
    cof2(m, m, o);
#pragma unroll
    for (int i = 0; i < 9; ++i) o[i] = 0.5f * o[i];
  }
}

// Stable Neo-Hookean P(F) into p and, when d_dir is not null, DP(F)[d_dir]
// into dp.
template <int D>
__device__ __forceinline__ void snh_p_dp(const float* f, const float* d_dir,
                                         float mu, float lam, float* p,
                                         float* dp) {
  constexpr int DD = D * D;
  const float lam_p = lam + mu;
  float g[DD];
  cof<D>(f, g);
  const float s = lam_p * (det<D>(f) - 1.0f) - mu;
#pragma unroll
  for (int i = 0; i < DD; ++i) p[i] = mu * f[i] + s * g[i];
  if (d_dir == nullptr) return;
  float dj = 0.0f;
#pragma unroll
  for (int i = 0; i < DD; ++i) dj = dj + g[i] * d_dir[i];
  float dg[DD];
  if constexpr (D == 2) {
    cof<D>(d_dir, dg);
  } else {
    cof2(f, d_dir, dg);
  }
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    dp[i] = mu * d_dir[i] + lam_p * dj * g[i] + s * dg[i];
  }
}

// Stable Neo-Hookean k and h of one element from its edge matrix x and R.
template <int D>
__device__ __forceinline__ void snh_chain(const float* x, const float* r,
                                          float mu, float lam, float* k,
                                          float* h) {
  constexpr int DD = D * D;
  float f[DD], p[DD], dp[DD], r_t[DD];
  mul<D>(x, r, f);
  snh_p_dp<D>(f, r, mu, lam, p, dp);
  transpose<D>(r, r_t);
  mul<D>(dp, r_t, k);
  mul<D>(p, r_t, h);
}

// Stable Neo-Hookean gradient columns g of one element.
template <int D>
__device__ __forceinline__ void snh_grad_cols(const float* x, const float* r,
                                              float mu, float lam, float* g) {
  constexpr int DD = D * D;
  float f[DD], p[DD], r_t[DD];
  mul<D>(x, r, f);
  snh_p_dp<D>(f, nullptr, mu, lam, p, nullptr);
  transpose<D>(r, r_t);
  mul<D>(p, r_t, g);
}

// k and h (row-major D x D) of one element from its edge matrix x and R = r.
template <int D>
__device__ __forceinline__ void nh_chain(const float* x, const float* r,
                                         float mu, float lam, float half_lam,
                                         float* k, float* h) {
  constexpr int DD = D * D;
  float f[DD];
  mul<D>(x, r, f);
  float f_inv[DD];
  const float det = det_inv<D>(f, f_inv);
  float f_inv_t[DD], r_t[DD];
  transpose<D>(f_inv, f_inv_t);
  transpose<D>(r, r_t);
  // jnp.maximum propagates NaN; fmaxf would not.
  const float log_j = logf(det != det ? det : fmaxf(det, 1e-4f));
  float tmp[DD], term2[DD];
  mul<D>(f_inv_t, r_t, tmp);
  mul<D>(tmp, f_inv_t, term2);
  mul<D>(f_inv, r, tmp);
  float tr = tmp[0];
#pragma unroll
  for (int i = 1; i < D; ++i) tr = tr + tmp[(D + 1) * i];
  const float c2 = mu - lam * log_j;
  const float c3 = lam * tr;
  float blk[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) blk[i] = mu * r[i] + c2 * term2[i] + c3 * f_inv_t[i];
  mul<D>(blk, r_t, k);

  const float log_gram = logf(det * det);
  const float cp = half_lam * log_gram - mu;
  float p[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) p[i] = mu * f[i] + cp * f_inv_t[i];
  mul<D>(p, r_t, h);
}

// Explicit gradient columns g (row-major D x D, unscaled) of one element
// from its edge matrix x and R = r.
template <int D>
__device__ __forceinline__ void nh_grad_cols(const float* x, const float* r,
                                             float mu, float lam, float* g) {
  constexpr int DD = D * D;
  float f[DD], f_inv[DD], f_inv_t[DD], r_t[DD], p[DD];
  mul<D>(x, r, f);
  const float det = det_inv<D>(f, f_inv);
  transpose<D>(f_inv, f_inv_t);
  transpose<D>(r, r_t);
  const float cp = lam * logf(det) - mu;  // unclamped: NaN when inverted
#pragma unroll
  for (int i = 0; i < DD; ++i) p[i] = mu * f[i] + cp * f_inv_t[i];
  mul<D>(p, r_t, g);
}

// k and h of material M (the half-lambda argument serves Neo-Hookean only).
template <int D, int M>
__device__ __forceinline__ void material_chain(const float* x, const float* r,
                                               float mu, float lam,
                                               float half_lam, float* k,
                                               float* h) {
  if constexpr (M == kStableNeoHookean) {
    snh_chain<D>(x, r, mu, lam, k, h);
  } else {
    nh_chain<D>(x, r, mu, lam, half_lam, k, h);
  }
}

// Gradient columns of material M.
template <int D, int M>
__device__ __forceinline__ void material_grad_cols(const float* x,
                                                   const float* r, float mu,
                                                   float lam, float* g) {
  if constexpr (M == kStableNeoHookean) {
    snh_grad_cols<D>(x, r, mu, lam, g);
  } else {
    nh_grad_cols<D>(x, r, mu, lam, g);
  }
}

// The D+1 vertex ids of element e from the (E, D+1) int32 table: one
// 16-byte load in 3D (the table is 16-byte aligned), three loads in 2D.
template <int D>
__device__ __forceinline__ void load_element(const int* elem, int e, int* v) {
  if constexpr (D == 3) {
    const int4 q = reinterpret_cast<const int4*>(elem)[e];
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int l = 0; l < D + 1; ++l) v[l] = elem[(D + 1) * e + l];
  }
}

}  // namespace fem
