// A 64 x 64 f32 tile product on the CUDA cores for the training scans' dW
// products (gru_scan_train.cu, lstm_scan_train.cu); K2 and K4 take their
// products from block_mma.cuh.
//
// A block of kTileThreads threads owns one 64 x 64 output tile; thread
// (ty, tx) = (tid / 16, tid % 16) holds the 4 x 4 outputs (ty + 16 i,
// tx + 16 j) in registers. Operands sit in shared memory k-major with a
// row stride of kTS = 65 floats, so a transposed store into a tile (column
// by column) hits 32 different banks:
//   acc[i][j] += sum_k As[k][ty + 16 i] * Bs[k][tx + 16 j].
// Every step reads 4 + 4 shared floats for 16 FMAs; the callers accept
// that (about a quarter of the f32 peak) for a first, simple kernel.

#pragma once

#include <cuda_runtime.h>

#include "split_sum.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kTS = kTile + 1;
constexpr int kTileThreads = 256;

__device__ __forceinline__ void tile_mma(const float* __restrict__ As, const float* __restrict__ Bs,
                                         int kn, float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < kn; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[k * kTS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[k * kTS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
}

// dst[k][c] = src[(k0 + k) * ld + c0 + c] for k < 64, c < 64; zero where
// k0 + k >= k_end or c0 + c >= c_end. Reads are contiguous in c.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          size_t ld, int k0, int k_end, int c0, int c_end) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kTileThreads) {
    const int k = e / kTile, c = e - k * kTile;
    const bool ok = k0 + k < k_end && c0 + c < c_end;
    dst[k * kTS + c] = ok ? src[(size_t)(k0 + k) * ld + c0 + c] : 0.0f;
  }
}

// part[split, m, n] = sum over k of this split of A[k, m] Bm[k, n]
// (A [K, M], Bm [K, N], row-major): the dW = hs^T dhid product of the training scans.
__global__ void __launch_bounds__(kTileThreads) atb_partial_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm, float* __restrict__ part,
    int K, int M, int N, int k_per_split) {
  __shared__ float As[kTile * kTS];
  __shared__ float Bs[kTile * kTS];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  float acc[4][4];
  zero_acc(acc);
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile(As, A, M, k0, k_end, m0, M);
    load_tile(Bs, Bm, N, k0, k_end, n0, N);
    __syncthreads();
    tile_mma(As, Bs, min(kTile, k_end - k0), acc);
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out [M, N] = A^T Bm for A [K, M], Bm [K, N]: the K rows cut into n_splits
// ranges of k_per_split rows, one partial each in part [n_splits, M, N],
// then summed in split order. No atomics: the same bits run after run.
inline int launch_atb(const float* A, const float* Bm, float* part, float* out, int K, int M,
                      int N, int n_splits, int k_per_split, cudaStream_t stream) {
  dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile, n_splits);
  atb_partial_kernel<<<grid, kTileThreads, 0, stream>>>(A, Bm, part, K, M, N, k_per_split);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_sum_splits(part, out, n_splits, (size_t)M * N, stream);
}

}  // namespace
