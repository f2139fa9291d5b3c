// The ordered sum of partial results over catalog or row splits, shared by
// the training scans' dW products and dpeep sums (scan_train.cuh) and K2's dh
// (streaming_cce.cu). No atomics: the same bits run after run.

#pragma once

#include <cuda_runtime.h>

namespace {

// out[i] = sum_s part[s * count + i], in split order (deterministic).
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int n_splits, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int s = 0; s < n_splits; ++s) acc += part[(size_t)s * count + i];
  out[i] = acc;
}

inline int launch_sum_splits(const float* part, float* out, int n_splits, size_t count,
                             cudaStream_t stream) {
  const int threads = 256;
  const unsigned grid = (unsigned)((count + threads - 1) / threads);
  if (grid) sum_splits_kernel<<<grid, threads, 0, stream>>>(part, out, n_splits, count);
  return (int)cudaGetLastError();
}

}  // namespace
