// Pieces shared by the time scans (gru_forward.cuh, gru_scan_train.cu,
// lstm_forward.cuh, lstm_scan_train.cu): one block per tile of at most
// kMaxRows batch rows walks all L steps; a step's [rows, K] x [K, N]
// product has threads own output columns, so one weight element feeds
// every row of the tile from a register; the weights sit in shared memory
// when they fit beside the block's state and are read through L2
// otherwise.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// out[r, c] = sum_k a[r, k] w[k, c] for r < rows, c < N (a [rows, K] and
// out [rows, N] in shared memory, w [K, N] in shared or device memory);
// out rows with keep[r] == 0 are left as they are when keep is given.
__device__ __forceinline__ void rows_product(const float* __restrict__ a,
                                             const float* __restrict__ w,
                                             float* __restrict__ out,
                                             const float* __restrict__ keep, int rows, int K,
                                             int N) {
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wk = w[(size_t)k * N + c];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) acc[r] = fmaf(a[r * K + k], wk, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows && (keep == nullptr || keep[r] > 0.0f)) out[r * N + c] = acc[r];
    }
  }
}

// Rows of one block: about one block per SM, at most kMaxRows.
inline int scan_rows_per_block(int B) {
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int rows = (B + n_sm - 1) / n_sm;
  return rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
}

// Launch `grid` blocks of `shared_w` (weights staged in shared memory) when
// `w_bytes` fit beside `base` bytes of per-block state, else of `l2_w`,
// with the dynamic shared memory the chosen one needs; returns the launch
// error.
template <typename Kernel, typename... Args>
int launch_scan(Kernel shared_w, Kernel l2_w, size_t base, size_t w_bytes, int grid,
                cudaStream_t stream, Args... args) {
  int dev = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (base > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  const bool w_shared = base + w_bytes <= (size_t)smem_optin;
  const size_t smem = base + (w_shared ? w_bytes : 0);
  Kernel kernel = w_shared ? shared_w : l2_w;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
