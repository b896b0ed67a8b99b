// The Neo-Hookean element chains of one tet, shared by every kernel that
// needs them.  nh_chain (implicit: K1 in element_chain.cu, the blocked prep
// K2 in blocked.cu, the whole-frame kernel K5 in blocked_frame.cu) is the
// counterpart of the JAX package's single k_and_h_chain, nh_grad_cols
// (explicit: K6 in element_chain.cu, K7b in blocked.cu, K8 in
// explicit_frame.cu) of its grad_cols_chain (fem_tpu/ops/pallas_kernels.py).
// One function each, so that the formulas cannot drift between kernels.
//
// With X the edge matrix (x[3*i + j] = p_{j+1}[i] - p_0[i]) and R = ref_inv:
//   F = X R
//   k = [mu R + (mu - lam log max(det F, 1e-4)) F^-T R^T F^-T
//        + lam tr(F^-1 R) F^-T] R^T
//   h = [mu F + (lam/2 log(det F * det F) - mu) F^-T] R^T
// unscaled: callers multiply both by -V.  Note the two logarithms: K clamps
// det F at 1e-4, the rhs squares it (finite for an inverted tet).  The
// explicit columns
//   g = [mu F + (lam log det F - mu) F^-T] R^T
// take the log unclamped, so an inverted tet gives NaN, as in the
// reference; callers multiply by +V.

#pragma once

#include <cuda_runtime.h>

namespace fem {

__device__ __forceinline__ void mul3(const float* a, const float* b, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[3 * i + j] =
          a[3 * i + 0] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
    }
  }
}

__device__ __forceinline__ void transpose3(const float* m, float* o) {
  o[0] = m[0]; o[1] = m[3]; o[2] = m[6];
  o[3] = m[1]; o[4] = m[4]; o[5] = m[7];
  o[6] = m[2]; o[7] = m[5]; o[8] = m[8];
}

// det F, and F^-1 as the adjugate times 1/det (no clamp) into f_inv.
__device__ __forceinline__ float det_inv3(const float* f, float* f_inv) {
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

// k and h (row-major 3x3) of one tet from its edge matrix x and R = r.
__device__ __forceinline__ void nh_chain(const float* x, const float* r,
                                         float mu, float lam, float half_lam,
                                         float* k, float* h) {
  float f[9];
  mul3(x, r, f);
  float f_inv[9];
  const float det = det_inv3(f, f_inv);
  float f_inv_t[9], r_t[9];
  transpose3(f_inv, f_inv_t);
  transpose3(r, r_t);
  // jnp.maximum propagates NaN; fmaxf would not.
  const float log_j = logf(det != det ? det : fmaxf(det, 1e-4f));
  float tmp[9], term2[9];
  mul3(f_inv_t, r_t, tmp);
  mul3(tmp, f_inv_t, term2);
  mul3(f_inv, r, tmp);
  const float tr = tmp[0] + tmp[4] + tmp[8];
  const float c2 = mu - lam * log_j;
  const float c3 = lam * tr;
  float blk[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) blk[i] = mu * r[i] + c2 * term2[i] + c3 * f_inv_t[i];
  mul3(blk, r_t, k);

  const float log_gram = logf(det * det);
  const float cp = half_lam * log_gram - mu;
  float p[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) p[i] = mu * f[i] + cp * f_inv_t[i];
  mul3(p, r_t, h);
}

// Explicit gradient columns g (row-major 3x3, unscaled) of one tet from its
// edge matrix x and R = r.
__device__ __forceinline__ void nh_grad_cols(const float* x, const float* r,
                                             float mu, float lam, float* g) {
  float f[9], f_inv[9], f_inv_t[9], r_t[9], p[9];
  mul3(x, r, f);
  const float det = det_inv3(f, f_inv);
  transpose3(f_inv, f_inv_t);
  transpose3(r, r_t);
  const float cp = lam * logf(det) - mu;  // unclamped: NaN when inverted
#pragma unroll
  for (int i = 0; i < 9; ++i) p[i] = mu * f[i] + cp * f_inv_t[i];
  mul3(p, r_t, g);
}

}  // namespace fem
