// Cell-independent pieces of the scans that split W_hid over a
// thread-block cluster: K3's cluster path (gru_cluster.cuh) and the
// training scans' cluster paths (scan_train_cluster.cuh). CTA q of a
// C-CTA cluster owns the hidden units [unit_begin(q), unit_begin(q + 1))
// (any H: the split may be uneven); a value every CTA needs is stored into
// each CTA's buffer through distributed shared memory, and one split
// cluster barrier a step orders those stores before the reads.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kClusterMax = 8;  // the portable cluster size
constexpr int kClusterWarps = 8;
constexpr int kClusterThreads = 32 * kClusterWarps;

// first unit of CTA q of C over H hidden units
__host__ __device__ inline int unit_begin(int q, int H, int C) { return q * H / C; }
// row stride of the h buffers: H padded to a float4
__host__ __device__ inline int h_stride(int H) { return (H + 3) & ~3; }

// Arrive at the cluster barrier (the stores before it are released to
// the cluster) / wait for every CTA to arrive (and acquire their stores).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The configuration of `clusters` clusters of C CTAs of kClusterThreads
// threads with `smem` bytes of dynamic shared memory each; `attr` holds
// the cluster size and must outlive the configuration.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters, int C,
                                         size_t smem, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * (unsigned)C);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes on the
// current device, once: later calls with as much or less set nothing.
inline int allow_smem_once(const void* kernel, size_t smem) {
  struct Seen {
    const void* kernel;
    int dev;
    size_t bytes;
  };
  static Seen seen[128];
  static int n_seen = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> guard(lock);
  Seen* entry = nullptr;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].kernel == kernel && seen[i].dev == dev) entry = &seen[i];
  }
  if (entry != nullptr && entry->bytes >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (entry == nullptr && n_seen < 128) entry = &seen[n_seen++];
  if (entry != nullptr) *entry = {kernel, dev, smem};
  return 0;
}

// Launch `kernel` in that configuration, its shared-memory limit raised
// once (allow_smem_once); returns the launch error (a refused launch is
// reported, never replaced).
template <typename... Params, typename... Args>
int cluster_launch(void (*kernel)(Params...), int clusters, int C, size_t smem,
                   cudaStream_t stream, Args... args) {
  int err = allow_smem_once((const void*)kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, clusters, C, smem, stream);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace
