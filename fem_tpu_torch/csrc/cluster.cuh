// Planning and launching one thread-block cluster, for the cluster variant
// of the whole-frame kernel K5 (blocked_frame.cu).  A cluster's CTAs are
// co-scheduled by the hardware (on neighbouring SMs of one GPC), read each
// other's shared memory (distributed shared memory) and meet at a hardware
// cluster barrier (cooperative_groups::this_cluster().sync()).  The whole
// grid is one cluster, but for P1 (probe_pairblock.cu), whose launch
// widens cluster_config's grid to many clusters of the same size.  A
// cluster the device cannot place is refused here,
// before the launch (-4), and a launch that fails returns its error: the
// caller raises, it never retries another way.

#pragma once

#include <cuda_runtime.h>

namespace fem {

// Lets `kernel` take clusters above the portable 8 CTAs (Hopper: 16) and
// `smem` bytes of dynamic shared memory.  The attributes stay set on the
// device; the callers below set the most `smem` the device allows, so that
// no later call lowers it under a larger plan.
template <typename Kernel>
cudaError_t cluster_prepare(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

// A launch of `cluster` CTAs of `threads` threads as one cluster.
inline cudaLaunchConfig_t cluster_config(int cluster, int threads, size_t smem,
                                         void* stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The most dynamic shared memory a CTA of `kernel` can take: the device's
// opt-in limit less the kernel's static shared memory.  Returns 0 or a
// CUDA error.
template <typename Kernel>
int dynamic_smem_limit(Kernel kernel, int* out) {
  *out = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// The device's limits for `kernel` at `threads` threads a CTA: the most CTAs
// one cluster of it can have when each CTA takes the most shared memory
// (`max_cluster`), that most dynamic shared memory (`optin`, bytes) and the
// SMs.  Returns 0 or a CUDA error.
template <typename Kernel>
int cluster_limits(Kernel kernel, int threads, int* max_cluster, int* optin,
                   int* sms) {
  *max_cluster = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  const int rc = dynamic_smem_limit(kernel, optin);
  if (rc != 0) return rc;
  e = cluster_prepare(kernel, static_cast<size_t>(*optin));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(*optin);
  e = cudaOccupancyMaxPotentialClusterSize(
      max_cluster, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// Checks that one cluster of `cluster` CTAs of `kernel`, `threads` threads
// and `smem` bytes of dynamic shared memory each, can be placed on the
// device; writes how many such clusters could be active at once.  Returns
// 0, a CUDA error, -2 (shared memory too large) or -4 (the cluster cannot
// be scheduled).
template <typename Kernel>
int cluster_fit(Kernel kernel, int threads, int cluster, size_t smem,
                int* max_active) {
  *max_active = 0;
  int optin = 0;
  const int rc = dynamic_smem_limit(kernel, &optin);
  if (rc != 0) return rc;
  if (smem > static_cast<size_t>(optin)) return -2;
  cudaError_t e = cluster_prepare(kernel, static_cast<size_t>(optin));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem, nullptr, &attr);
  // The occupancy query below does not refuse a cluster above the most
  // CTAs one can have (it answered for 17 on the H100, whose launch then
  // failed), so that limit is checked first.
  cfg.numAttrs = 0;
  int most = 0;
  e = cudaOccupancyMaxPotentialClusterSize(
      &most, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  if (cluster > most) return -4;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(
      max_active, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller reports -4 or the error
    if (e == cudaErrorInvalidClusterSize || e == cudaErrorInvalidValue) {
      return -4;
    }
    return static_cast<int>(e);
  }
  return *max_active > 0 ? 0 : -4;
}

// The hardware cluster barrier in two halves: every thread of the cluster
// arrives (relaxed: it orders no memory, so it only says the CTA is
// running) and later waits for all.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One launch of `kernel(*args)` as a single cluster of `cluster` CTAs;
// returns 0 or the CUDA error, which it clears.  cluster_fit has accepted
// the plan on this device before, and so prepared the kernel.
template <typename Kernel, typename Args>
int cluster_launch(Kernel kernel, Args* args, int cluster, int threads,
                   int smem, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      cluster, threads, static_cast<size_t>(smem), stream, &attr);
  void* params[] = {args};
  cudaError_t e = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), params);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fem
