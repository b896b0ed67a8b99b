// The element chains of one element (a tet in 3D, a triangle in 2D), for
// every material, shared by every kernel that needs them.  material_chain
// (implicit: K1 in element_chain.cu, the blocked prep K2 in blocked.cu, the
// whole-frame kernel K5 in blocked_frame.cu) is the counterpart of the JAX
// package's single k_and_h_chain, material_grad_cols (explicit: K6 in
// element_chain.cu, K7b in blocked.cu, K8 in explicit_frame.cu) of its
// grad_cols_chain (fem_tpu/ops/pallas_kernels.py).  One function each,
// templated on the dimension D in {2, 3} as the Pallas chains take `dim`
// (_planar_ops) and on the material M as they take `material`, so that the
// formulas cannot drift between kernels, dimensions or materials.  The
// kernels choose the material at launch (the Material template parameter),
// never per element: an instance carries only its own material's code.
//
// Neo-Hookean, with X the edge matrix (x[D*i + j] = p_{j+1}[i] - p_0[i])
// and R = ref_inv:
//   F = X R
//   k = [mu R + (mu - lam log max(det F, 1e-4)) F^-T R^T F^-T
//        + lam tr(F^-1 R) F^-T] R^T
//   h = [mu F + (lam/2 log(det F * det F) - mu) F^-T] R^T
// unscaled: callers multiply both by -V.  Note the two logarithms: K clamps
// det F at 1e-4, the rhs squares it (finite for an inverted element).  The
// robust instance (robust_inversion) clamps |det F| >= 1e-6, sign kept,
// inside F^-1 and det F^2 >= 1e-8 in the rhs log.  The explicit columns
//   g = [mu F + (lam log det F - mu) F^-T] R^T
// take the log unclamped, so an inverted element gives NaN, as in the
// reference; callers multiply by +V.  Every product sums k = 0 .. D-1 left
// to right and the inverse is the adjugate times 1/det in both dimensions:
// the plain versions' order, which the kernels are held to.
//
// Every other material (material_p_dp, the counterparts of the branches of
// the Pallas _material_p_dp_chain, pallas_kernels.py:158-300) gives P(F) and
// DP(F)[D], and then
//   k = DP[R] R^T   (R as the direction, as the Neo-Hookean K has it)
//   h = g = P R^T
// with robust unused, as in the Pallas chain.  Stable Neo-Hookean (lam' =
// lam + mu; also the inelastic extension's Maxwell branch, inelastic.cuh):
//   P = mu F + (lam'(J - 1) - mu) cof F
//   DP[D] = mu D + lam'(cof F : D) cof F + (lam'(J - 1) - mu) Dcof(F)[D]
// fiber: stable Neo-Hookean + 2k (I4 - 1) (F a) a^T, I4 = |F a|^2, and its
// exact DP; Mooney-Rivlin: 2 C1 F + 2 C2 (I1 F - F C) + (lam_log log J -
// k_log) F^-T, its DP with the log clamped at det F >= 1e-4; corotated: R
// from 12 Higham iterations (polar_rotation), P = 2 mu (F - R) + lam
// tr(R^T F - I) R, DP with R held fixed; linear and stvk exact.  The numbers
// each chain closes over (MaterialParams) come from the host, computed in
// f64 and rounded once, as the Pallas chains close over Python floats.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

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

// o = adj(f) * s: the adjugate's entries, each times s.
template <int D>
__device__ __forceinline__ void adj_scaled(const float* f, float s, float* o) {
  if constexpr (D == 2) {
    o[0] = f[3] * s;
    o[1] = -f[1] * s;
    o[2] = -f[2] * s;
    o[3] = f[0] * s;
  } else {
    o[0] = (f[4] * f[8] - f[5] * f[7]) * s;
    o[1] = (f[2] * f[7] - f[1] * f[8]) * s;
    o[2] = (f[1] * f[5] - f[2] * f[4]) * s;
    o[3] = (f[5] * f[6] - f[3] * f[8]) * s;
    o[4] = (f[0] * f[8] - f[2] * f[6]) * s;
    o[5] = (f[2] * f[3] - f[0] * f[5]) * s;
    o[6] = (f[3] * f[7] - f[4] * f[6]) * s;
    o[7] = (f[1] * f[6] - f[0] * f[7]) * s;
    o[8] = (f[0] * f[4] - f[1] * f[3]) * s;
  }
}

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

// det F, and F^-1 as the adjugate times 1/det (no clamp) into f_inv.  The
// 2D inverse follows the Pallas chain's _mat2_inv: 1/det first, then the
// four products.
template <int D>
__device__ __forceinline__ float det_inv(const float* f, float* f_inv) {
  const float dt = det<D>(f);
  adj_scaled<D>(f, 1.0f / dt, f_inv);
  return dt;
}

// The kernels' material selector; the Python side mirrors it
// (ops/element.py: MATERIAL_IDS, ROBUST_NEO_HOOKEAN_ID).
enum Material {
  kNeoHookean = 0,
  kStableNeoHookean = 1,
  kStvk = 2,
  kLinear = 3,
  kCorotated = 4,
  kMooneyRivlin = 5,
  kFiber = 6,
  kNeoHookeanRobust = 7,
};

// The numbers a material's chain closes over; the Python side mirrors it
// (ops/element_kernels.py: MaterialParamsC, filled from
// ops/element.material_constants).
struct MaterialParams {
  float mu, lam, half_lam;  // half_lam = lam / 2 (Neo-Hookean rhs)
  float lam_p;              // lam + mu (stable Neo-Hookean, fiber)
  float two_mu;             // 2 mu (corotated, linear, stvk)
  float c1x2, c2x2, lam_log, k_log;  // Mooney-Rivlin: 2 C1, 2 C2, ...
  float a0, a1, a2;         // fiber: the unit direction (a2 unused in 2D)
  float two_k;              // fiber: 2 kappa mu
};

// The Maxwell branch's layer (inelastic.cuh): stable Neo-Hookean with lam 0.
__host__ __device__ inline MaterialParams branch_params(float mu) {
  MaterialParams m{};
  m.mu = mu;
  m.lam_p = mu;
  return m;
}

// A library built with -DFEM_MATERIAL=<id> holds that material's instances
// only (utils/cuda_build.py builds one library per material, in parallel).
#ifdef FEM_MATERIAL
__host__ __device__ constexpr bool material_compiled(int m) {
  return m == FEM_MATERIAL;
}
#else
__host__ __device__ constexpr bool material_compiled(int) { return true; }
#endif

// f(std::integral_constant<int, M>{}) for the instance of `material`: the
// materials of the library, robust Neo-Hookean only when ROBUST (the
// implicit chains); anything else returns cudaErrorInvalidValue.
template <bool ROBUST, typename F>
int dispatch_material(int material, F&& f) {
#define FEM_MATERIAL_CASE(M)                                      \
  case M:                                                         \
    if constexpr (material_compiled(M)) {                         \
      return f(std::integral_constant<int, M>{});                 \
    }                                                             \
    break;
  switch (material) {
    FEM_MATERIAL_CASE(kNeoHookean)
    FEM_MATERIAL_CASE(kStableNeoHookean)
    FEM_MATERIAL_CASE(kStvk)
    FEM_MATERIAL_CASE(kLinear)
    FEM_MATERIAL_CASE(kCorotated)
    FEM_MATERIAL_CASE(kMooneyRivlin)
    FEM_MATERIAL_CASE(kFiber)
    case kNeoHookeanRobust:
      if constexpr (ROBUST && material_compiled(kNeoHookeanRobust)) {
        return f(std::integral_constant<int, kNeoHookeanRobust>{});
      }
      break;
    default:
      break;
  }
#undef FEM_MATERIAL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
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

template <int D>
__device__ __forceinline__ float trace(const float* m) {
  float t = m[0];
#pragma unroll
  for (int i = 1; i < D; ++i) t = t + m[(D + 1) * i];
  return t;
}

// Stable Neo-Hookean P(F) into p and, when d_dir is not null, DP(F)[d_dir]
// into dp; lam_p = lam + mu.
template <int D>
__device__ __forceinline__ void snh_p_dp(const float* f, const float* d_dir,
                                         float mu, float lam_p, float* p,
                                         float* dp) {
  constexpr int DD = D * D;
  float g[DD];
  cof<D>(f, g);
  const float s = lam_p * (det<D>(f) - 1.0f) - mu;
#pragma unroll
  for (int i = 0; i < DD; ++i) p[i] = mu * f[i] + s * g[i];
  if (d_dir == nullptr) return;
  float dj = g[0] * d_dir[0];
#pragma unroll
  for (int i = 1; i < DD; ++i) dj = dj + g[i] * d_dir[i];
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

// The rotation of the polar decomposition of f by Higham's iteration
// r <- (r + r^-T) / 2, exactly 12 times (no convergence exit), the inverse
// as det_inv's 1/det times the adjugate: the Pallas chain's _planar_polar.
template <int D>
__device__ __forceinline__ void polar_rotation(const float* f, float* r) {
  constexpr int DD = D * D;
#pragma unroll
  for (int i = 0; i < DD; ++i) r[i] = f[i];
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    float r_inv[DD];
    det_inv<D>(r, r_inv);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        r[D * i + j] = 0.5f * (r[D * i + j] + r_inv[D * j + i]);
      }
    }
  }
}

// (F a)_i = sum_j a_j m_ij, j in order.
template <int D>
__device__ __forceinline__ void fiber_vec(const float* m, const float* a,
                                          float* out) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = a[0] * m[D * i];
#pragma unroll
    for (int j = 1; j < D; ++j) s = s + a[j] * m[D * i + j];
    out[i] = s;
  }
}

// P(F) of material M (not Neo-Hookean) into p and, when d_dir is not null,
// DP(F)[d_dir] into dp, in the order of the Pallas _material_p_dp_chain.
template <int D, int M>
__device__ __forceinline__ void material_p_dp(const float* f,
                                              const float* d_dir,
                                              const MaterialParams& m,
                                              float* p, float* dp) {
  constexpr int DD = D * D;
  if constexpr (M == kStableNeoHookean || M == kFiber) {
    snh_p_dp<D>(f, d_dir, m.mu, m.lam_p, p, dp);
    if constexpr (M == kFiber) {
      const float a[3] = {m.a0, m.a1, m.a2};
      float fa[D];
      fiber_vec<D>(f, a, fa);
      float i4 = fa[0] * fa[0];
#pragma unroll
      for (int i = 1; i < D; ++i) i4 = i4 + fa[i] * fa[i];
      const float coef = m.two_k * (i4 - 1.0f);
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j < D; ++j) p[D * i + j] = p[D * i + j] + coef * fa[i] * a[j];
      }
      if (d_dir == nullptr) return;
      float da[D];
      fiber_vec<D>(d_dir, a, da);
      float w = fa[0] * da[0];
#pragma unroll
      for (int i = 1; i < D; ++i) w = w + fa[i] * da[i];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float v = m.two_k * (2.0f * w * fa[i] + (i4 - 1.0f) * da[i]);
#pragma unroll
        for (int j = 0; j < D; ++j) dp[D * i + j] = dp[D * i + j] + v * a[j];
      }
    }
  } else if constexpr (M == kMooneyRivlin) {
    float ft[DD], c[DD], fc[DD], f_inv[DD], f_inv_t[DD];
    transpose<D>(f, ft);
    mul<D>(ft, f, c);
    const float i1 = trace<D>(c);
    mul<D>(f, c, fc);
    const float dt = det_inv<D>(f, f_inv);
    transpose<D>(f_inv, f_inv_t);
    const float coef_p = m.lam_log * logf(dt) - m.k_log;  // unclamped
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      p[i] = m.c1x2 * f[i] + m.c2x2 * (i1 * f[i] - fc[i]) + coef_p * f_inv_t[i];
    }
    if (d_dir == nullptr) return;
    float fd = f[0] * d_dir[0];
#pragma unroll
    for (int i = 1; i < DD; ++i) fd = fd + f[i] * d_dir[i];
    float d_t[DD], dtf[DD], dc[DD], dcm[DD], fdc[DD], tmp[DD], inv_term[DD];
    transpose<D>(d_dir, d_t);
    mul<D>(d_t, f, dtf);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) dc[D * i + j] = dtf[D * i + j] + dtf[D * j + i];
    }
    mul<D>(d_dir, c, dcm);
    mul<D>(f, dc, fdc);
    mul<D>(f_inv_t, d_t, tmp);
    mul<D>(tmp, f_inv_t, inv_term);
    mul<D>(f_inv, d_dir, tmp);
    const float tr_fid = trace<D>(tmp);
    // jnp.maximum propagates NaN; fmaxf would not.
    const float log_j = logf(dt != dt ? dt : fmaxf(dt, 1e-4f));
    const float coef = m.k_log - m.lam_log * log_j;
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      dp[i] = m.c1x2 * d_dir[i] +
              m.c2x2 * (2.0f * fd * f[i] + i1 * d_dir[i] - dcm[i] - fdc[i]) +
              coef * inv_term[i] + m.lam_log * tr_fid * f_inv_t[i];
    }
  } else if constexpr (M == kCorotated) {
    float rot[DD], rot_t[DD], tmp[DD];
    polar_rotation<D>(f, rot);
    transpose<D>(rot, rot_t);
    mul<D>(rot_t, f, tmp);
    const float s_tr = trace<D>(tmp) - static_cast<float>(D);
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      p[i] = m.two_mu * (f[i] - rot[i]) + m.lam * s_tr * rot[i];
    }
    if (d_dir == nullptr) return;
    mul<D>(rot_t, d_dir, tmp);
    const float tr_rd = trace<D>(tmp);
#pragma unroll
    for (int i = 0; i < DD; ++i) dp[i] = m.two_mu * d_dir[i] + m.lam * tr_rd * rot[i];
  } else if constexpr (M == kLinear) {
    float eps[DD];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float e = 0.5f * (f[D * i + j] + f[D * j + i]);
        eps[D * i + j] = i == j ? e - 1.0f : e;
      }
    }
    const float tr_e = trace<D>(eps);
#pragma unroll
    for (int i = 0; i < DD; ++i) p[i] = m.two_mu * eps[i];
#pragma unroll
    for (int i = 0; i < D; ++i) p[(D + 1) * i] = p[(D + 1) * i] + m.lam * tr_e;
    if (d_dir == nullptr) return;
    const float tr_d = trace<D>(d_dir);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float v = m.mu * (d_dir[D * i + j] + d_dir[D * j + i]);
        dp[D * i + j] = i == j ? v + m.lam * tr_d : v;
      }
    }
  } else if constexpr (M == kStvk) {
    float ft[DD], c[DD], g[DD], s[DD];
    transpose<D>(f, ft);
    mul<D>(ft, f, c);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        g[D * i + j] = 0.5f * (i == j ? c[D * i + j] - 1.0f : c[D * i + j]);
      }
    }
    const float tr_g = trace<D>(g);
#pragma unroll
    for (int i = 0; i < DD; ++i) s[i] = m.two_mu * g[i];
#pragma unroll
    for (int i = 0; i < D; ++i) s[(D + 1) * i] = s[(D + 1) * i] + m.lam * tr_g;
    mul<D>(f, s, p);
    if (d_dir == nullptr) return;
    float d_t[DD], dtf[DD], ds[DD], a[DD], b[DD];
    transpose<D>(d_dir, d_t);
    mul<D>(d_t, f, dtf);
    const float tr_dtf = trace<D>(dtf);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float v = m.mu * (dtf[D * i + j] + dtf[D * j + i]);
        ds[D * i + j] = i == j ? v + m.lam * tr_dtf : v;
      }
    }
    mul<D>(d_dir, s, a);
    mul<D>(f, ds, b);
#pragma unroll
    for (int i = 0; i < DD; ++i) dp[i] = a[i] + b[i];
  } else {
    static_assert(M == kStableNeoHookean, "no P/DP chain for this material");
  }
}

// The start of the Neo-Hookean chain of one element: F = x R, det F and
// F^-1 (ROBUST: |det F| clamped at 1e-6, sign kept, inside F^-1).
template <int D, bool ROBUST>
__device__ __forceinline__ float nh_prelude(const float* x, const float* r,
                                            float* f, float* f_inv) {
  mul<D>(x, r, f);
  if constexpr (ROBUST) {
    // F^-1 = adj(F) / (sign(det) max(|det|, 1e-6)); NaN kept, as
    // jnp.maximum keeps it.
    const float det = fem::det<D>(f);
    const float mag = fabsf(det);
    const float clamped = mag != mag ? mag : fmaxf(mag, 1e-6f);
    adj_scaled<D>(f, 1.0f / (det < 0.0f ? -clamped : clamped), f_inv);
    return det;
  } else {
    return det_inv<D>(f, f_inv);
  }
}

// The K half of the Neo-Hookean chain (unscaled k) from F^-1, det F and R.
template <int D>
__device__ __forceinline__ void nh_k(const float* f_inv, float det,
                                     const float* r, float mu, float lam,
                                     float* k) {
  constexpr int DD = D * D;
  float f_inv_t[DD], r_t[DD];
  transpose<D>(f_inv, f_inv_t);
  transpose<D>(r, r_t);
  // jnp.maximum propagates NaN; fmaxf would not.
  const float log_j = logf(det != det ? det : fmaxf(det, 1e-4f));
  float tmp[DD], term2[DD];
  mul<D>(f_inv_t, r_t, tmp);
  mul<D>(tmp, f_inv_t, term2);
  mul<D>(f_inv, r, tmp);
  const float tr = trace<D>(tmp);
  const float c2 = mu - lam * log_j;
  const float c3 = lam * tr;
  float blk[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) blk[i] = mu * r[i] + c2 * term2[i] + c3 * f_inv_t[i];
  mul<D>(blk, r_t, k);
}

// The rhs half of the Neo-Hookean chain (unscaled h) from F, F^-1, det F
// and R: the log of det F^2 (ROBUST: det F^2 clamped at 1e-8).
template <int D, bool ROBUST>
__device__ __forceinline__ void nh_h(const float* f, const float* f_inv,
                                     float det, const float* r, float mu,
                                     float half_lam, float* h) {
  constexpr int DD = D * D;
  float f_inv_t[DD], r_t[DD];
  transpose<D>(f_inv, f_inv_t);
  transpose<D>(r, r_t);
  float gram = det * det;
  if constexpr (ROBUST) gram = gram != gram ? gram : fmaxf(gram, 1e-8f);
  const float log_gram = logf(gram);
  const float cp = half_lam * log_gram - mu;
  float p[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) p[i] = mu * f[i] + cp * f_inv_t[i];
  mul<D>(p, r_t, h);
}

// k and h (row-major D x D) of one Neo-Hookean element from its edge matrix
// x and R = r; ROBUST clamps det F inside F^-1 and det F^2 in the rhs log.
// The element-chain kernel K1 runs it whole; its entries K9a and K9b run
// the prelude and one half each.
template <int D, bool ROBUST>
__device__ __forceinline__ void nh_chain(const float* x, const float* r,
                                         float mu, float lam, float half_lam,
                                         float* k, float* h) {
  constexpr int DD = D * D;
  float f[DD], f_inv[DD];
  const float det = nh_prelude<D, ROBUST>(x, r, f, f_inv);
  nh_k<D>(f_inv, det, r, mu, lam, k);
  nh_h<D, ROBUST>(f, f_inv, det, r, mu, half_lam, h);
}

// Explicit Neo-Hookean gradient columns g (row-major D x D, unscaled) of
// one element from its edge matrix x and R = r.
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

// k and h of material M from the edge matrix x and R = r.
template <int D, int M>
__device__ __forceinline__ void material_chain(const float* x, const float* r,
                                               const MaterialParams& m,
                                               float* k, float* h) {
  if constexpr (M == kNeoHookean || M == kNeoHookeanRobust) {
    nh_chain<D, M == kNeoHookeanRobust>(x, r, m.mu, m.lam, m.half_lam, k, h);
  } else {
    constexpr int DD = D * D;
    float f[DD], p[DD], dp[DD], r_t[DD];
    mul<D>(x, r, f);
    material_p_dp<D, M>(f, r, m, p, dp);
    transpose<D>(r, r_t);
    mul<D>(dp, r_t, k);
    mul<D>(p, r_t, h);
  }
}

// Gradient columns of material M.
template <int D, int M>
__device__ __forceinline__ void material_grad_cols(const float* x,
                                                   const float* r,
                                                   const MaterialParams& m,
                                                   float* g) {
  if constexpr (M == kNeoHookean || M == kNeoHookeanRobust) {
    nh_grad_cols<D>(x, r, m.mu, m.lam, g);
  } else {
    constexpr int DD = D * D;
    float f[DD], p[DD], r_t[DD];
    mul<D>(x, r, f);
    material_p_dp<D, M>(f, nullptr, m, p, nullptr);
    transpose<D>(r, r_t);
    mul<D>(p, r_t, g);
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
