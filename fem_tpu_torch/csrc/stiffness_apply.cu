// H1, fem_stiffness_apply: the exact elastic stiffness applied to a block of
// columns, K W, in one launch, 2D or 3D, float or double.
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
// Design: one thread an output entry (particle p, component i, column c),
// neighbouring threads on neighbouring columns of one particle, so that a
// warp's threads read the same J entries (one broadcast) and neighbouring
// W entries, and write neighbouring outputs.  A thread walks its particle's
// plan slots in order and recomputes the slot's row from J_e and the
// element's edge differences: one dot product of length D*D for a vertex
// l >= 1, D of them for vertex 0.  The edge differences keep a smooth W's
// common translation out of the sums (the JAX package's jvp differentiates
// through them too).  No atomics and no scratch: two runs are
// bit-identical.
//
// Bound on the H100: the bytes.  J is read once (the flagship: 4,068 x 9 x
// 9 x 4 B = 1.32 MB), W read and out written once (1,007 x 3 x C x 4 B
// each); at C = 9, ~0.5 us at 3.35 TB/s.  This first version reads J_e
// through L2 once per slot of every particle of the element (4 times a tet
// in 3D) and recomputes row 0's D dot products, so it is launch- and
// latency-bound at a few microseconds; staging J through shared memory a
// tile of elements a CTA, and the (D*D, D*D) x (D*D, C) products on
// tensor cores, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
    // we[j D + a] = W[elem[e, j+1], a, c] - W[elem[e, 0], a, c]
    T we[K];
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
    const T* je = jac + static_cast<long long>(e) * D * D * K;
    T val;
    if (l > 0) {
      // Column l - 1 of the element's D x D block, component i.
      const T* row = je + (i * D + (l - 1)) * K;
      T dot = T(0);
#pragma unroll
      for (int m = 0; m < K; ++m) dot += row[m] * we[m];
      val = dot;
    } else {
      // -(col_0 + col_1 + ...), each column's component i, in order.
      T sum = T(0);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const T* row = je + (i * D + j) * K;
        T dot = T(0);
#pragma unroll
        for (int m = 0; m < K; ++m) dot += row[m] * we[m];
        sum = j == 0 ? dot : sum + dot;
      }
      val = -sum;
    }
    acc += val;
  }
  out[t] = acc;
}

using KernelF = void (*)(const float*, const float*, const int*, const int*,
                         const int*, int, int, float*);
using KernelD = void (*)(const double*, const double*, const int*,
                         const int*, const int*, int, int, double*);

template <typename T, typename Kernel>
int launch(Kernel k, const void* jac, const void* w, const void* elem,
           const void* ptr, const void* rows, int n, int dim, int cols,
           void* out, void* stream) {
  const long long total = static_cast<long long>(n) * dim * cols;
  const long long ctas = (total + kThreads - 1) / kThreads;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k<<<static_cast<unsigned>(ctas), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(jac), static_cast<const T*>(w),
      static_cast<const int*>(elem), static_cast<const int*>(ptr),
      static_cast<const int*>(rows), n, cols, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K W: `dim` 2 or 3, `dtype` 0 for float and 1 for double; `jac` (E, dim^2,
// dim^2), `w` and `out` (n, dim, cols), `elem` (E, dim+1), `ptr`
// (n+1,) and `rows` int32, all contiguous on the stream's device.  CTAs of
// kThreads, one thread an output entry.  cudaErrorInvalidValue for an
// instance or a size the kernel does not take.
extern "C" int fem_stiffness_apply(int dim, int dtype, const void* jac,
                                   const void* w, const void* elem,
                                   const void* ptr, const void* rows, int n,
                                   int cols, void* out, void* stream) {
  if (n < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const KernelF k = dim == 3   ? stiffness_apply_kernel<3, float>
                      : dim == 2 ? stiffness_apply_kernel<2, float>
                                 : nullptr;
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<float>(k, jac, w, elem, ptr, rows, n, dim, cols, out,
                         stream);
  }
  if (dtype == 1) {
    const KernelD k = dim == 3   ? stiffness_apply_kernel<3, double>
                      : dim == 2 ? stiffness_apply_kernel<2, double>
                                 : nullptr;
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<double>(k, jac, w, elem, ptr, rows, n, dim, cols, out,
                          stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fem_stiffness_threads() { return kThreads; }

extern "C" const char* fem_stiffness_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
