// The two per-particle sums of a blocked operator's cluster variant, shared
// by the blocked operator apply K3 (blocked.cu) and the explicit whole
// frame K8 (explicit_frame.cu), so that the order of their sums cannot
// drift apart from each other or from the two-kernel form
// (blocked_common.cuh: block_slot_sums, then particle_slot_sum).
//
// A block slot's sum of its contribution rows, through the block's local
// plan, is stored whole into a receive slot of the CTA that owns the slot's
// particle (distributed shared memory when that is another CTA); the
// owner's receive slots of a particle lie in the slot plan's order
// (ops/frame_kernels.py: explicit_assignment), and the owner sums them in
// that order.  The same terms in the same order as the two-kernel form, so
// the results are bit-identical to it.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace fem {

// Floats of a receive slot: D padded to a whole vector (16 bytes in 3D, 8
// in 2D), so that a slot stored into another CTA's shared memory is one
// transaction.
__host__ __device__ constexpr int slot_stride(int dim) {
  return dim == 3 ? 4 : 2;
}

template <int D>
using SlotRow = typename std::conditional<D == 3, float4, float2>::type;

// Slot p's sum of the block's contribution rows t ((D+1) x D an element)
// through the block's local plan (`ptr`, `rows`: the block's offsets and
// rows), in the plan's order — block_slot_sums' arithmetic — stored as one
// padded row at `dst` (a receive slot here or in another CTA).
template <int D>
__device__ __forceinline__ void store_slot_sum(const int* ptr,
                                               const int* rows,
                                               const float* t, int p,
                                               float* dst) {
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  const int end = ptr[p + 1];
  for (int q = ptr[p]; q < end; ++q) {
    const float* row = t + D * rows[q];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] += row[c];
  }
  SlotRow<D> v;
  v.x = acc[0];
  v.y = acc[1];
  if constexpr (D == 3) {
    v.z = acc[2];
    v.w = 0.0f;
  }
  *reinterpret_cast<SlotRow<D>*>(dst) = v;
}

// The sum of receive slots [begin, end) of `recv`, in order —
// particle_slot_sum's arithmetic — into out (D floats).
template <int D>
__device__ __forceinline__ void receive_sum(const float* recv, int begin,
                                            int end, float* out) {
#pragma unroll
  for (int c = 0; c < D; ++c) out[c] = 0.0f;
  for (int k = begin; k < end; ++k) {
    const SlotRow<D> v =
        *reinterpret_cast<const SlotRow<D>*>(recv + slot_stride(D) * k);
    out[0] += v.x;
    out[1] += v.y;
    if constexpr (D == 3) out[2] += v.z;
  }
}

}  // namespace fem
