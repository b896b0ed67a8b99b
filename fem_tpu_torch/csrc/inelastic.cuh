// The per-element update of the inelastic extension (ops/inelastic.py),
// shared by the whole-frame kernels K5 (blocked_frame.cu) and K8
// (explicit_frame.cu): the plastic return map and the Maxwell relaxation,
// after each substep's advection, from the end-of-substep positions.
//
// Replaces the in-kernel internal_update of the TPU kernels
// ops/pallas_blocked_frame.py (_frame_kernel and _explicit_frame_kernel),
// which run the JAX package's plane functions (ops/inelastic.py _p_*) on
// (d^2, B*Eb) VMEM planes.  Here one thread updates one element in
// registers, in the plane functions' order of operations:
//   F = X R^-1 against the ORIGINAL rest state; ok = det F > 1e-9; the
//   guarded inverse F^-1 = adj(F_safe) / det(F_safe) with F_safe = F where
//   ok, else I;
//   plastic: F_e = F F_p^-1; C = F_e^T F_e; the Jacobi eigensolve of C
//   (2D one rotation, 3D six sweeps over (0,1), (0,2), (1,2)); principal
//   log strains eps = log max(sqrt max(w, 1e-12), 1e-6); dev = eps - mean;
//   where |dev| > yield, scale the deviator onto the yield surface
//   (yield / max(|dev|, 1e-30)); F_e' = F_e V diag(exp delta) V^T;
//   F_p^-1 <- F^-1 F_e' where ok and yielded;
//   viscous: the same for F_be = F F_v^-1 with delta = eps (exp(-dt/tau) - 1),
//   the constant computed once on the host in f32 as the JAX package
//   rounds it; F_v^-1 <- F^-1 F_be' where ok.
// Every step rounds to nearest in the plain order (__f*_rn, no fused
// multiply-adds): the yield test is a threshold and the Jacobi rotations
// are the steps most sensitive to a reordered sum, so the kernel rounds as
// the plain version (ops/inelastic.update_planes) does; only logf, expf and
// sqrtf round as the CUDA library does.
//
// Bound: operations — about 1,500 f32 operations a tet for one state (the
// six Jacobi sweeps are ~800 of them), ~250 a triangle.

#pragma once

#include <cuda_runtime.h>

#include "element_chain.cuh"

namespace fem {

// The inelastic tail of both whole frames' arguments; the Python side
// mirrors it (ops/frame_kernels.py: _INELASTIC_FIELDS).  The state lives in
// the outputs, mesh element order (E, D, D); a slot s of the blocking holds
// mesh element element_perm[s].  A null plastic (viscous) means the branch
// is off.
struct InelasticArgs {
  const int* element_perm;  // (B*Eb,)
  const float* plastic_in;  // (E, D, D) F_p^-1 at the frame's start
  const float* viscous_in;  // (E, D, D) F_v^-1
  float* plastic;           // (E, D, D) outputs, the state through the frame
  float* viscous;
  float plastic_yield;
  float viscous_mu;
  float relax;              // exp(-dt/tau) - 1
};

namespace rn {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// o = a b, row-major D x D, each entry summed k = 0 .. D-1 left to right.
template <int D>
__device__ __forceinline__ void matmul(const float* a, const float* b,
                                       float* o) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = mul(a[D * i], b[j]);
#pragma unroll
      for (int k = 1; k < D; ++k) s = add(s, mul(a[D * i + k], b[D * k + j]));
      o[D * i + j] = s;
    }
  }
}

template <int D>
__device__ __forceinline__ float det(const float* a) {
  if constexpr (D == 2) {
    return sub(mul(a[0], a[3]), mul(a[1], a[2]));
  } else {
    const float c0 = sub(mul(a[4], a[8]), mul(a[5], a[7]));
    const float c1 = sub(mul(a[3], a[8]), mul(a[5], a[6]));
    const float c2 = sub(mul(a[3], a[7]), mul(a[4], a[6]));
    return add(sub(mul(a[0], c0), mul(a[1], c1)), mul(a[2], c2));
  }
}

template <int D>
__device__ __forceinline__ void adjugate(const float* a, float* o) {
  if constexpr (D == 2) {
    o[0] = a[3];
    o[1] = -a[1];
    o[2] = -a[2];
    o[3] = a[0];
  } else {
    o[0] = sub(mul(a[4], a[8]), mul(a[5], a[7]));
    o[1] = sub(mul(a[2], a[7]), mul(a[1], a[8]));
    o[2] = sub(mul(a[1], a[5]), mul(a[2], a[4]));
    o[3] = sub(mul(a[5], a[6]), mul(a[3], a[8]));
    o[4] = sub(mul(a[0], a[8]), mul(a[2], a[6]));
    o[5] = sub(mul(a[2], a[3]), mul(a[0], a[5]));
    o[6] = sub(mul(a[3], a[7]), mul(a[4], a[6]));
    o[7] = sub(mul(a[1], a[6]), mul(a[0], a[7]));
    o[8] = sub(mul(a[0], a[4]), mul(a[1], a[3]));
  }
}

}  // namespace rn

// Cyclic Jacobi on the symmetric a (D x D, both halves kept equal): on
// return a's diagonal holds the eigenvalues and v the rotation, a_in =
// V diag(w) V^T.  The JAX package's sym_eigh_core step for step, guards
// included: a_pq = 0 is the identity rotation, tau = 0 with a_pq != 0 a
// 45-degree one (the sign of tau >= 0 is +1).
template <int D>
__device__ __forceinline__ void sym_eigh(float (&a)[D][D], float (&v)[D][D]) {
  using namespace rn;
  constexpr int kPairs = D == 2 ? 1 : 3;
  constexpr int kSweeps = D == 2 ? 1 : 6;
  constexpr int P[3] = {0, 0, 1};
  constexpr int Q[3] = {1, 2, 2};
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int p = P[k], q = Q[k];
      const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
      const bool off = fabsf(apq) > 0.0f;
      const float tau = div(sub(aqq, app), mul(2.0f, off ? apq : 1.0f));
      const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
      const float t = off
          ? div(sgn, add(fabsf(tau), __fsqrt_rn(add(1.0f, mul(tau, tau)))))
          : 0.0f;
      const float c = div(1.0f, __fsqrt_rn(add(1.0f, mul(t, t))));
      const float s = mul(t, c);
      const float cc = mul(c, c), ss = mul(s, s);
      const float sc2 = mul(mul(2.0f, s), c);
      a[p][p] = add(sub(mul(cc, app), mul(sc2, apq)), mul(ss, aqq));
      a[q][q] = add(add(mul(ss, app), mul(sc2, apq)), mul(cc, aqq));
      a[p][q] = a[q][p] = 0.0f;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r == p || r == q) continue;
        const float apr = a[p][r], aqr = a[q][r];
        a[p][r] = a[r][p] = sub(mul(c, apr), mul(s, aqr));
        a[q][r] = a[r][q] = add(mul(s, apr), mul(c, aqr));
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float vip = v[i][p], viq = v[i][q];
        v[i][p] = sub(mul(c, vip), mul(s, viq));
        v[i][q] = add(mul(s, vip), mul(c, viq));
      }
    }
  }
}

// Principal log strains eps and the rotation v of f (the plane
// _p_log_strain): C = f^T f, then the eigensolve.
template <int D>
__device__ __forceinline__ void log_strain(const float* f, float* eps,
                                           float (&v)[D][D]) {
  using namespace rn;
  float a[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = i; j < D; ++j) {
      float s = mul(f[i], f[j]);
#pragma unroll
      for (int k = 1; k < D; ++k) s = add(s, mul(f[k * D + i], f[k * D + j]));
      a[i][j] = a[j][i] = s;
    }
  }
  sym_eigh<D>(a, v);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    eps[k] = logf(fmaxf(__fsqrt_rn(fmaxf(a[k][k], 1e-12f)), 1e-6f));
  }
}

// f_new = f V diag(exp delta) V^T (the plane _p_principal_rescale).
template <int D>
__device__ __forceinline__ void principal_rescale(const float* f,
                                                  const float* delta,
                                                  const float (&v)[D][D],
                                                  float* f_new) {
  using namespace rn;
  float e[D], m[D * D];
#pragma unroll
  for (int k = 0; k < D; ++k) e[k] = expf(delta[k]);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = mul(mul(v[i][0], e[0]), v[j][0]);
#pragma unroll
      for (int k = 1; k < D; ++k) s = add(s, mul(mul(v[i][k], e[k]), v[j][k]));
      m[D * i + j] = s;
    }
  }
  rn::matmul<D>(f, m, f_new);
}

// The radial return of f_e onto the yield surface; returns whether it
// yielded (the plane _p_plastic_return).
template <int D>
__device__ __forceinline__ bool plastic_return(const float* fe,
                                               float yield_eps,
                                               float* fe_new) {
  using namespace rn;
  float eps[D], v[D][D];
  log_strain<D>(fe, eps, v);
  float mean = eps[0];
#pragma unroll
  for (int k = 1; k < D; ++k) mean = add(mean, eps[k]);
  mean = div(mean, static_cast<float>(D));
  float dev[D];
#pragma unroll
  for (int k = 0; k < D; ++k) dev[k] = sub(eps[k], mean);
  float nrm2 = mul(dev[0], dev[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) nrm2 = add(nrm2, mul(dev[k], dev[k]));
  const float nrm = __fsqrt_rn(nrm2);
  const bool yielded = nrm > yield_eps;
  const float scale = yielded ? div(yield_eps, fmaxf(nrm, 1e-30f)) : 1.0f;
  float delta[D];
#pragma unroll
  for (int k = 0; k < D; ++k) delta[k] = mul(dev[k], sub(scale, 1.0f));
  principal_rescale<D>(fe, delta, v, fe_new);
  return yielded;
}

// One substep of Maxwell relaxation of f_be (the plane _p_viscous_relax).
template <int D>
__device__ __forceinline__ void viscous_relax(const float* fbe, float relax,
                                              float* fbe_new) {
  float eps[D], v[D][D], delta[D];
  log_strain<D>(fbe, eps, v);
#pragma unroll
  for (int k = 0; k < D; ++k) delta[k] = rn::mul(eps[k], relax);
  principal_rescale<D>(fbe, delta, v, fbe_new);
}

// The update of one element from its edge matrix x at the end of a
// substep and its ORIGINAL rest-edge inverse r; plastic and viscous point
// at its state (D*D floats, updated in place) or are null.
template <int D>
__device__ __forceinline__ void internal_update(const float* x, const float* r,
                                                float* plastic, float* viscous,
                                                float plastic_yield,
                                                float relax) {
  constexpr int DD = D * D;
  float f[DD];
  rn::matmul<D>(x, r, f);
  const bool ok = rn::det<D>(f) > 1e-9f;
  float f_safe[DD], adj[DD], f_inv[DD];
#pragma unroll
  for (int c = 0; c < DD; ++c) {
    f_safe[c] = ok ? f[c] : ((c / D) == (c % D) ? 1.0f : 0.0f);
  }
  rn::adjugate<D>(f_safe, adj);
  const float det_safe = rn::det<D>(f_safe);
#pragma unroll
  for (int c = 0; c < DD; ++c) f_inv[c] = rn::div(adj[c], det_safe);
  float trial[DD], trial_new[DD], fi_new[DD];
  if (plastic != nullptr) {
    rn::matmul<D>(f, plastic, trial);
    const bool yielded = plastic_return<D>(trial, plastic_yield, trial_new);
    rn::matmul<D>(f_inv, trial_new, fi_new);
    if (ok && yielded) {
#pragma unroll
      for (int c = 0; c < DD; ++c) plastic[c] = fi_new[c];
    }
  }
  if (viscous != nullptr) {
    rn::matmul<D>(f, viscous, trial);
    viscous_relax<D>(trial, relax, trial_new);
    rn::matmul<D>(f_inv, trial_new, fi_new);
    if (ok) {
#pragma unroll
      for (int c = 0; c < DD; ++c) viscous[c] = fi_new[c];
    }
  }
}

// The effective rest-edge inverses of element slot `slot` (static r): the
// base layer's r F_p^-1 into r_base (r itself without plasticity) and the
// Maxwell layer's r F_v^-1 into r_branch; `fp`/`fv` receive the element's
// state (for the update), read from the mesh-order state through
// element_perm.
template <int D>
__device__ __forceinline__ void layer_refs(const InelasticArgs& in, int slot,
                                           const float* r, float* r_base,
                                           float* r_branch) {
  constexpr int DD = D * D;
  const size_t m = static_cast<size_t>(in.element_perm[slot]) * DD;
  if (in.plastic != nullptr) {
    mul<D>(r, in.plastic + m, r_base);
  } else {
#pragma unroll
    for (int c = 0; c < DD; ++c) r_base[c] = r[c];
  }
  if (in.viscous != nullptr) mul<D>(r, in.viscous + m, r_branch);
}

// Copies element slot `slot`'s state from the inputs into the outputs (the
// frame's first step; each real slot is one mesh element).
template <int D>
__device__ __forceinline__ void copy_state(const InelasticArgs& in, int slot) {
  constexpr int DD = D * D;
  const size_t m = static_cast<size_t>(in.element_perm[slot]) * DD;
#pragma unroll
  for (int c = 0; c < DD; ++c) {
    if (in.plastic != nullptr) in.plastic[m + c] = in.plastic_in[m + c];
    if (in.viscous != nullptr) in.viscous[m + c] = in.viscous_in[m + c];
  }
}

// The update of element slot `slot` from its edge matrix x and static r.
template <int D>
__device__ __forceinline__ void update_slot(const InelasticArgs& in, int slot,
                                            const float* x, const float* r) {
  constexpr int DD = D * D;
  const size_t m = static_cast<size_t>(in.element_perm[slot]) * DD;
  float p[DD], v[DD];
#pragma unroll
  for (int c = 0; c < DD; ++c) {
    if (in.plastic != nullptr) p[c] = in.plastic[m + c];
    if (in.viscous != nullptr) v[c] = in.viscous[m + c];
  }
  internal_update<D>(x, r, in.plastic != nullptr ? p : nullptr,
                     in.viscous != nullptr ? v : nullptr, in.plastic_yield,
                     in.relax);
#pragma unroll
  for (int c = 0; c < DD; ++c) {
    if (in.plastic != nullptr) in.plastic[m + c] = p[c];
    if (in.viscous != nullptr) in.viscous[m + c] = v[c];
  }
}

}  // namespace fem
