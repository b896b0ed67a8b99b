// H1, fem_stiffness_apply_two_phase: the exact elastic stiffness applied to
// a block of columns, K W, 2D or 3D, float or double.
//
// Replaces no TPU kernel: the JAX package takes this product as jax.jvp of
// the assembled analytic force (fem_tpu/solvers/modal.py:68,
// make_stiffness_hvp), vmapped over a block of columns, which XLA compiles.
// The port forms each element's Jacobian of its force (or gradient) columns
// in its D edge vectors once (solvers/implicit.element_linearization: one
// torch.func.jvp over the D*D unit tangents of vertices 1..D), and every
// apply is then this kernel.  Plain PyTorch takes about eight launches an
// apply (the gather and edge differences, a batched product, the vertex-0
// sum, the plan gather and its sum); the modal analyses apply it a few
// hundred to a few thousand times a solve.
//
// What it computes (ops/stiffness_kernels.stiffness_apply_plain):
//   dw    = the edge differences of W   (E, D*D, C): row j D + a is
//           W[elem[e, j+1], a] - W[elem[e, 0], a]
//   dcols = J dw                        (E, D*D, C), read as (E, D, D, C)
//   rows  = element_contrib_full(dcols): local vertex l >= 1 gets column
//           l - 1 (component i: dcols[e, i, l-1]); local vertex 0 gets
//           -(dcols[e, i, 0] + dcols[e, i, 1] + ...), summed in that order
//   out   = each particle's rows summed in the order of its plan slots
// with J (E, D*D, D*D), W and out (N, D, C), element_indices (E, D+1)
// int32 and the gather plan in CSR form (ptr (N+1,), rows (E (D+1),) int32:
// row r is local vertex r % (D+1) of element r / (D+1)).
//
// Two variants, bit-identical: each row value is the same fused
// multiply-adds in the same order (row_dot), and each particle sums the
// same values over the same slots in the same order.
//
// "rows" (the default; fem_stiffness_apply_two_phase), two launches:
//   A. stiffness_rows_kernel, one thread an (element e, component i,
//      column c): the element's edge differences of W once, J_e's D rows
//      of component i once, the D column values and vertex 0's -sum, each
//      stored straight to its slot, R[slot_of_row[e (D+1) + l], i, c], of
//      a scratch R (E (D+1), D, C) in the plan's slot order.  slot_of_row
//      is the inverse of the plan's rows, so the stores are a permutation:
//      no atomics.
//   B. stiffness_sum_kernel, one thread an output entry (particle p,
//      component i, column c): R[s, i, c] summed over p's slots ptr[p] ..
//      ptr[p+1]-1 in order, from zero.  The slots are contiguous and no
//      load depends on another, so a thread issues kBatch of them before
//      it adds any (the flagship's busiest particle, 56 slots: 4 batches).
// "slots" (the first design; fem_stiffness_apply), one launch: one thread
//   an output entry walks its particle's plan slots in order and recomputes
//   each slot's row from J_e and the element's edge differences (one dot
//   product of length D*D for a vertex l >= 1, D of them for vertex 0).
//
// Neighbouring threads sit on neighbouring columns in both, so that a
// warp's threads read the same J entries (one broadcast) and neighbouring
// W, R and output entries.  The edge differences keep a smooth W's common
// translation out of the sums (the JAX package's jvp differentiates
// through them too).  Two runs are bit-identical.
//
// Bound on the H100: the bytes.  J is read once (the flagship: 4,068 x 9 x
// 9 x 4 B = 1.32 MB), W read and out written once (1,007 x 3 x C x 4 B
// each); at C = 9, ~0.5 us at 3.35 TB/s.  The first design reads J_e
// through L2 once per slot of every particle of the element (4 times a tet
// in 3D) and, worse, its busiest particle (56 slots on the flagship) waits
// out three dependent L2 loads a slot, one slot after another (rows[s] ->
// elem[e] -> W and J_e).  The two-phase design reads J once an apply, and
// its longest chain is a particle's slots in batches of kBatch independent
// loads.  R (1.76 MB on the flagship at C = 9, f32) stays in L2 between
// the two launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 16;  // phase B's loads in flight a thread

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// we[j D + a] = W[elem[e, j+1], a, c] - W[elem[e, 0], a, c]
template <int D, typename T>
__device__ __forceinline__ void edge_differences(const T* __restrict__ w,
                                                 const int* __restrict__ elem,
                                                 int e, int cols, int c,
                                                 T* we) {
  T w0[D];
  const int q0 = elem[e * (D + 1)];
#pragma unroll
  for (int a = 0; a < D; ++a)
    w0[a] = w[(static_cast<long long>(q0) * D + a) * cols + c];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int q = elem[e * (D + 1) + j + 1];
#pragma unroll
    for (int a = 0; a < D; ++a)
      we[j * D + a] =
          w[(static_cast<long long>(q) * D + a) * cols + c] - w0[a];
  }
}

// One row of J_e times the edge differences: sum over m of row[m] we[m],
// from zero, in order, each step one fused multiply-add.  Both variants
// take every row value from here, so their values agree bit for bit.
template <int D, typename T>
__device__ __forceinline__ T row_dot(const T* __restrict__ row,
                                     const T* we) {
  T dot = T(0);
#pragma unroll
  for (int m = 0; m < D * D; ++m) dot = fmadd(row[m], we[m], dot);
  return dot;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
stiffness_rows_kernel(const T* __restrict__ jac, const T* __restrict__ w,
                      const int* __restrict__ elem,
                      const int* __restrict__ slot_of_row, int elements,
                      int cols, T* __restrict__ rows) {
  constexpr int K = D * D;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(elements) * D * cols;
  if (t >= total) return;
  const int c = static_cast<int>(t % cols);
  const int i = static_cast<int>((t / cols) % D);
  const int e = static_cast<int>(t / (static_cast<long long>(cols) * D));
  T we[K];
  edge_differences<D>(w, elem, e, cols, c, we);
  // J_e's rows i D + j, j = 0..D-1: column j of component i.
  const T* je = jac + (static_cast<long long>(e) * D + i) * D * K;
  const int* slot = slot_of_row + e * (D + 1);
  T sum = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const T dot = row_dot<D>(je + j * K, we);
    rows[(static_cast<long long>(slot[j + 1]) * D + i) * cols + c] = dot;
    sum = j == 0 ? dot : sum + dot;
  }
  rows[(static_cast<long long>(slot[0]) * D + i) * cols + c] = -sum;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
stiffness_sum_kernel(const T* __restrict__ rows, const int* __restrict__ ptr,
                     int n, int cols, T* __restrict__ out) {
  const int width = D * cols;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * width) return;
  const int p = static_cast<int>(t / width);
  const T* r = rows + (t - static_cast<long long>(p) * width);
  const int end = ptr[p + 1];
  T acc = T(0);
  int s = ptr[p];
  // Every load of a batch is unconditional, so that all kBatch are in
  // flight before the first add: a load under the add's condition is moved
  // beside its add, and the slots become a chain of dependent round trips
  // again (phase B 2-5x slower on the flagship, H100).
  for (; s + kBatch <= end; s += kBatch) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = r[static_cast<long long>(s + u) * width];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += v[u];
  }
  if (s < end) {
    // The last, partial batch: loads clamped to the particle's last slot,
    // the surplus added as +0, which leaves acc as it is (acc starts at +0
    // and a sum in round-to-nearest is -0 only of two -0).
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = r[static_cast<long long>(min(s + u, end - 1)) * width];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += s + u < end ? v[u] : T(0);
  }
  out[t] = acc;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
stiffness_apply_kernel(const T* __restrict__ jac, const T* __restrict__ w,
                       const int* __restrict__ elem,
                       const int* __restrict__ ptr,
                       const int* __restrict__ rows, int n, int cols,
                       T* __restrict__ out) {
  constexpr int K = D * D;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(n) * D * cols;
  if (t >= total) return;
  const int c = static_cast<int>(t % cols);
  const int i = static_cast<int>((t / cols) % D);
  const int p = static_cast<int>(t / (static_cast<long long>(cols) * D));
  T acc = T(0);
  const int end = ptr[p + 1];
  for (int s = ptr[p]; s < end; ++s) {
    const int r = rows[s];
    const int e = r / (D + 1);
    const int l = r - e * (D + 1);
    T we[K];
    edge_differences<D>(w, elem, e, cols, c, we);
    const T* je = jac + (static_cast<long long>(e) * D + i) * D * K;
    T val;
    if (l > 0) {
      // Column l - 1 of the element's D x D block, component i.
      val = row_dot<D>(je + (l - 1) * K, we);
    } else {
      // -(col_0 + col_1 + ...), each column's component i, in order.
      T sum = T(0);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const T dot = row_dot<D>(je + j * K, we);
        sum = j == 0 ? dot : sum + dot;
      }
      val = -sum;
    }
    acc += val;
  }
  out[t] = acc;
}

// CTAs of kThreads for `total` threads, or 0 when they pass a grid.
unsigned ctas_for(long long total) {
  const long long ctas = (total + kThreads - 1) / kThreads;
  return ctas > 0x7fffffffLL ? 0u : static_cast<unsigned>(ctas);
}

template <int D, typename T>
int launch_slots(const void* jac, const void* w, const void* elem,
                 const void* ptr, const void* rows, int n, int cols,
                 void* out, cudaStream_t stream) {
  const unsigned ctas = ctas_for(static_cast<long long>(n) * D * cols);
  if (ctas == 0) return static_cast<int>(cudaErrorInvalidValue);
  stiffness_apply_kernel<D, T><<<ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(jac), static_cast<const T*>(w),
      static_cast<const int*>(elem), static_cast<const int*>(ptr),
      static_cast<const int*>(rows), n, cols, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_two_phase(const void* jac, const void* w, const void* elem,
                     const void* slot_of_row, const void* ptr, int elements,
                     int n, int cols, void* rows, void* out,
                     cudaStream_t stream) {
  const unsigned sum_ctas = ctas_for(static_cast<long long>(n) * D * cols);
  const unsigned row_ctas =
      ctas_for(static_cast<long long>(elements) * D * cols);
  if (sum_ctas == 0 || row_ctas == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  stiffness_rows_kernel<D, T><<<row_ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(jac), static_cast<const T*>(w),
      static_cast<const int*>(elem), static_cast<const int*>(slot_of_row),
      elements, cols, static_cast<T*>(rows));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stiffness_sum_kernel<D, T><<<sum_ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const int*>(ptr), n, cols,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K W, the two-phase variant: `dim` 2 or 3, `dtype` 0 for float and 1 for
// double; `jac` (E, dim^2, dim^2), `w` and `out` (n, dim, cols), `elem`
// (E, dim+1), `slot_of_row` (E (dim+1),) the inverse of the plan's rows,
// `ptr` (n+1,) int32, `rows` the scratch (E (dim+1), dim, cols) of `jac`'s
// type, all contiguous on the stream's device.  Launches phase A, then
// phase B, on the stream.  cudaErrorInvalidValue for an instance or a size
// the kernels do not take.
extern "C" int fem_stiffness_apply_two_phase(
    int dim, int dtype, const void* jac, const void* w, const void* elem,
    const void* slot_of_row, const void* ptr, int elements, int n, int cols,
    void* rows, void* out, void* stream) {
  if (n < 1 || cols < 1 || elements < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dim == 3)
    return launch_two_phase<3, float>(jac, w, elem, slot_of_row, ptr,
                                      elements, n, cols, rows, out, s);
  if (dtype == 0 && dim == 2)
    return launch_two_phase<2, float>(jac, w, elem, slot_of_row, ptr,
                                      elements, n, cols, rows, out, s);
  if (dtype == 1 && dim == 3)
    return launch_two_phase<3, double>(jac, w, elem, slot_of_row, ptr,
                                       elements, n, cols, rows, out, s);
  if (dtype == 1 && dim == 2)
    return launch_two_phase<2, double>(jac, w, elem, slot_of_row, ptr,
                                       elements, n, cols, rows, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K W, the slots variant (the first design): the same operands but the
// scratch and the slot order, and the plan's `rows` (E (dim+1),) int32.
// One launch, CTAs of kThreads, one thread an output entry.
extern "C" int fem_stiffness_apply(int dim, int dtype, const void* jac,
                                   const void* w, const void* elem,
                                   const void* ptr, const void* rows, int n,
                                   int cols, void* out, void* stream) {
  if (n < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dim == 3)
    return launch_slots<3, float>(jac, w, elem, ptr, rows, n, cols, out, s);
  if (dtype == 0 && dim == 2)
    return launch_slots<2, float>(jac, w, elem, ptr, rows, n, cols, out, s);
  if (dtype == 1 && dim == 3)
    return launch_slots<3, double>(jac, w, elem, ptr, rows, n, cols, out,
                                   s);
  if (dtype == 1 && dim == 2)
    return launch_slots<2, double>(jac, w, elem, ptr, rows, n, cols, out,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fem_stiffness_threads() { return kThreads; }

extern "C" const char* fem_stiffness_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
