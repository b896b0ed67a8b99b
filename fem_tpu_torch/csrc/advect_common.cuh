// One particle of the implicit advection, shared by the fused advection
// kernel K10b (advect.cu) and the unblocked whole frame K11b
// (fused_frame.cu), so that the two cannot drift apart.
//
// The step (reference solver/implicit.py:407-438, the Pallas kernels'
// form): vel *= decay; vel_g = (vel_g + g dt) decay; v = vel + vel_g; the
// lower wall zeroes vel, vel_g and v, the upper wall zeroes vel and v but
// NOT vel_g (implicit.py:422); per circle in order, when the particle is
// inside it, moves toward its center and the radius is > 0, v, vel and
// vel_g each lose their component along disp with 1/max(|disp|^2, 1e-30)
// multiplied; pos' = pos + v dt.  g is 9.8 g_dir and decay exp(-dt
// damping), both f32 from the host.  Written with round-to-nearest
// intrinsics in the plain version's order, so that no multiply-add is
// contracted.

#pragma once

#include <cuda_runtime.h>

namespace fem {

// sum_i a_i b_i, i = 0 .. D-1 left to right, round-to-nearest.
template <int D>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < D; ++i) s = __fadd_rn(s, __fmul_rn(a[i], b[i]));
  return s;
}

// The implicit advection of one particle from its row of positions `pos`,
// velocities `vel` and gravity channel `vel_g` into the rows `pos_out`,
// `vel_out` and `vel_g_out` (which may alias the inputs: every input is
// read before the first write).
template <int D>
__device__ __forceinline__ void advect_implicit_particle(
    const float* pos, const float* vel, const float* vel_g,
    const float* centers, const float* radii, int num_circles,
    const float* gravity, float dt, float decay, float* pos_out,
    float* vel_out, float* vel_g_out) {
  float x[D], u[D], w[D], v[D];  // u = vel, w = vel_g, v = u + w
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = pos[i];
    u[i] = __fmul_rn(vel[i], decay);
    w[i] = __fmul_rn(__fadd_rn(vel_g[i], __fmul_rn(gravity[i], dt)), decay);
    v[i] = __fadd_rn(u[i], w[i]);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (x[i] < 0.0f && v[i] < 0.0f) {
      u[i] = 0.0f;
      w[i] = 0.0f;
      v[i] = 0.0f;
    }
    if (x[i] > 1.0f && v[i] > 0.0f) {  // vel_g kept (implicit.py:422)
      u[i] = 0.0f;
      v[i] = 0.0f;
    }
  }
  for (int b = 0; b < num_circles; ++b) {
    const float r = radii[b];
    float disp[D], neg[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      disp[i] = __fsub_rn(x[i], centers[D * b + i]);
      neg[i] = -disp[i];
    }
    const float dist_sq = dot_rn<D>(disp, disp);
    const bool hit = dist_sq < __fmul_rn(r, r) && dot_rn<D>(v, neg) > 0.0f &&
                     r > 0.0f;
    if (hit) {
      const float inv_d = __frcp_rn(fmaxf(dist_sq, 1e-30f));
      const float cv = __fmul_rn(dot_rn<D>(v, disp), inv_d);
      const float cu = __fmul_rn(dot_rn<D>(u, disp), inv_d);
      const float cw = __fmul_rn(dot_rn<D>(w, disp), inv_d);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        v[i] = __fsub_rn(v[i], __fmul_rn(cv, disp[i]));
        u[i] = __fsub_rn(u[i], __fmul_rn(cu, disp[i]));
        w[i] = __fsub_rn(w[i], __fmul_rn(cw, disp[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    pos_out[i] = __fadd_rn(x[i], __fmul_rn(v[i], dt));
    vel_out[i] = u[i];
    vel_g_out[i] = w[i];
  }
}

}  // namespace fem
