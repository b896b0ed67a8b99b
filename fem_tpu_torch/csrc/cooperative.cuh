// Planning and launching a cooperative grid, shared by the whole-frame
// kernels K5 (blocked_frame.cu) and K8 (explicit_frame.cu).  Their grid
// barriers (cooperative_groups::this_grid().sync()) hang unless every CTA
// of the grid is resident at once, so a grid that cannot be is refused
// here, before the launch, and the launch itself is cooperative.

#pragma once

#include <cuda_runtime.h>

namespace fem {

// The grid of a launch over `num_blocks` locality blocks: `grid` CTAs, or
// with 0 one per locality block and at most one per SM.  Returns 0, a CUDA
// error, or -1 when the device has no cooperative launch.
inline int cooperative_grid(int num_blocks, int grid, int* grid_out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return -1;
  if (grid <= 0) grid = num_blocks < sms ? num_blocks : sms;
  *grid_out = grid > 0 ? grid : 1;
  return 0;
}

// Checks that `grid` CTAs of `kernel`, `threads` threads and `smem` bytes of
// dynamic shared memory each, fit the device at once; writes the most CTAs
// that can be co-resident.  Returns 0, a CUDA error, or -2 (shared memory
// too large), -3 (the grid cannot be co-resident).
template <typename Kernel>
int cooperative_fit(Kernel kernel, int threads, int grid, size_t smem,
                    int* max_grid_out) {
  *max_grid_out = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0, optin = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(optin)) return -2;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *max_grid_out = per_sm * sms;
  return grid > per_sm * sms ? -3 : 0;
}

// One cooperative launch of `kernel(*args)`; returns 0 or the CUDA error,
// which it clears.
template <typename Kernel, typename Args>
int cooperative_launch(Kernel kernel, Args* args, int grid, int threads,
                       int smem, void* stream) {
  void* params[] = {args};
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                  dim3(threads), params,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

inline const char* cooperative_error(int code) {
  if (code == -1) return "the device does not support cooperative launches";
  if (code == -2) return "one CTA's working set exceeds its shared memory";
  if (code == -3) return "the grid cannot be co-resident on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace fem
