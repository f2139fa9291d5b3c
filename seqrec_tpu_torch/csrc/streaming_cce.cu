// Streaming full-catalog cross-entropy: log-sum-exp stats and gradients
// without writing the [B, N] logits (kernel K2).
//
// Replaces seqrec_tpu/ops/pallas_streaming_cce.py:_fwd_kernel (through
// stats_pallas) and _bwd_kernel (through grads_pallas). For h [B, H],
// W [H, N], b [N]:
//   stats: m[i] = max_j z[i, j], s[i] = sum_j exp(z[i, j] - m[i]), z = h W + b
//   grads: p = exp(z - logz), dz = g (p - onehot(target)),
//          dh = dz W^T, dW = h^T dz, db = sum_i dz[i, :].
// The one-hot is a compare of the column index with the row's target;
// rows with g = 0 contribute nothing.
//
// What bounds it on an H100: f32 operations. At B=1024, H=128, N=50,000
// the stats are 2 B H N = 13 GFLOP and the gradients need three products,
// 39 GFLOP, against a few MB of inputs and outputs.
//
// Design: every kernel computes 64 x 64 logit tiles with tile_mma.cuh
// (h^T and W staged through shared memory, 64 values of H at a time) and
// consumes them in registers or shared memory; no logit reaches device
// memory. The TPU kernel carries its sums across a sequential grid; CUDA
// blocks run in no order, so:
// - stats: the catalog is cut into splits; the block of (row tile, split)
//   keeps an online (m, s) per row over its split's column tiles (m starts
//   at -inf; every tile holds at least one real column, so m is finite
//   after the first tile and the first rescale is exp(-inf) = 0). A merge
//   kernel combines the splits, as K4 merges its partial top-k.
// - dW and db: the block of a column tile owns dW[:, tile] and db[tile]
//   and walks every row tile, so each is written once, with no atomics.
// - dh: the block of (row tile, split) walks its split's column tiles and
//   writes its partial dh [B, H]; a second kernel sums the splits in order.
// dW and dh each recompute the logits, so the gradients do 4 products
// (52 GFLOP at that shape) for two simple, deterministic kernels. f32 FMA
// on the CUDA cores throughout: no TF32, no tensor cores yet.

#include <math.h>

#include "tile_mma.cuh"

namespace {

// acc[i][j] = z[row0 + ty + 16 i, col0 + tx + 16 j] (h W + b); rows past B
// and columns past N hold b or 0 and must be masked by the caller.
__device__ __forceinline__ void logits_tile(const float* __restrict__ h, const float* __restrict__ W,
                                            const float* __restrict__ bias, int B, int H, int N,
                                            int row0, int col0, float* As, float* Bs,
                                            float acc[4][4]) {
  zero_acc(acc);
  for (int k0 = 0; k0 < H; k0 += kTile) {
    __syncthreads();
    // As[k][r] = h[row0 + r, k0 + k]; Bs[k][c] = W[k0 + k, col0 + c]
    for (int e = threadIdx.x; e < kTile * kTile; e += kTileThreads) {
      const int r = e / kTile, k = e - r * kTile;
      const bool ok = row0 + r < B && k0 + k < H;
      As[k * kTS + r] = ok ? h[(size_t)(row0 + r) * H + k0 + k] : 0.0f;
    }
    load_tile(Bs, W, N, k0, H, col0, N);
    __syncthreads();
    tile_mma(As, Bs, min(kTile, H - k0), acc);
  }
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + tx + 16 * j;
    const float bj = col < N ? bias[col] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] += bj;
  }
}

__device__ __forceinline__ float reduce16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float reduce16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (row tiles, splits): part_m/part_s [n_splits, B]
__global__ void __launch_bounds__(kTileThreads) stats_partial_kernel(
    const float* __restrict__ h, const float* __restrict__ W, const float* __restrict__ bias,
    float* __restrict__ part_m, float* __restrict__ part_s, int B, int H, int N,
    int cols_per_split) {
  __shared__ float As[kTile * kTS];
  __shared__ float Bs[kTile * kTS];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kTile;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(N, c_begin + cols_per_split);
  float m_run[4], s_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    s_run[i] = 0.0f;
  }
  for (int col0 = c_begin; col0 < c_end; col0 += kTile) {
    logits_tile(h, W, bias, B, H, N, row0, col0, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4], cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = col0 + tx + 16 * j < c_end ? acc[i][j] : -INFINITY;
        cm = fmaxf(cm, v[j]);
      }
      const float m_new = fmaxf(m_run[i], reduce16_max(cm));
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps += expf(v[j] - m_new);
      s_run[i] = s_run[i] * expf(m_run[i] - m_new) + reduce16_sum(ps);
      m_run[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row < B) {
        part_m[(size_t)blockIdx.y * B + row] = m_run[i];
        part_s[(size_t)blockIdx.y * B + row] = s_run[i];
      }
    }
  }
}

__global__ void stats_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                                   float* __restrict__ m, float* __restrict__ s, int B,
                                   int n_splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float mx = -INFINITY;
  for (int k = 0; k < n_splits; ++k) mx = fmaxf(mx, part_m[(size_t)k * B + row]);
  float acc = 0.0f;
  for (int k = 0; k < n_splits; ++k)
    acc += part_s[(size_t)k * B + row] * expf(part_m[(size_t)k * B + row] - mx);
  m[row] = mx;
  s[row] = acc;
}

// dz of one logit tile, 0 outside the real rows and columns [.., c_end)
__device__ __forceinline__ void dlogits_tile(float acc[4][4], const int* __restrict__ targets,
                                             const float* __restrict__ logz,
                                             const float* __restrict__ g, int B, int row0,
                                             int col0, int c_end) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    const bool real = row < B;
    const float lz = real ? logz[row] : 0.0f;
    const float gr = real ? g[row] : 0.0f;
    const int tg = real ? targets[row] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      float d = 0.0f;
      if (real && col < c_end) d = gr * (expf(acc[i][j] - lz) - (col == tg ? 1.0f : 0.0f));
      acc[i][j] = d;
    }
  }
}

// grid (column tiles): dW [H, N], db [N]; kHC = ceil(H / 64) register tiles
template <int kHC>
__global__ void __launch_bounds__(kTileThreads) grads_dw_kernel(
    const float* __restrict__ h, const float* __restrict__ W, const float* __restrict__ bias,
    const int* __restrict__ targets, const float* __restrict__ logz, const float* __restrict__ g,
    float* __restrict__ dW, float* __restrict__ db, int B, int H, int N) {
  __shared__ float As[kTile * kTS];
  __shared__ float Bs[kTile * kTS];
  float* Ds = Bs;  // Ds[r][c] = dz[row0 + r, col0 + c], once the logits are done with Bs
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int col0 = blockIdx.x * kTile;
  float accW[kHC][4][4], acc[4][4];
#pragma unroll
  for (int q = 0; q < kHC; ++q) zero_acc(accW[q]);
  float db_acc = 0.0f;
  for (int row0 = 0; row0 < B; row0 += kTile) {
    logits_tile(h, W, bias, B, H, N, row0, col0, As, Bs, acc);
    dlogits_tile(acc, targets, logz, g, B, row0, col0, N);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) Ds[(ty + 16 * i) * kTS + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      for (int r = 0; r < kTile; ++r) db_acc += Ds[r * kTS + threadIdx.x];
    }
    // dW[q*64 + a, col0 + c] += sum_r h[row0 + r, q*64 + a] Ds[r][c]
#pragma unroll
    for (int q = 0; q < kHC; ++q) {
      if (q * kTile < H) {
        __syncthreads();
        load_tile(As, h + q * kTile, H, row0, B, 0, H - q * kTile);
        __syncthreads();
        tile_mma(As, Ds, kTile, accW[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kHC; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hh = q * kTile + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        if (hh < H && col < N) dW[(size_t)hh * N + col] = accW[q][i][j];
      }
    }
  }
  if (threadIdx.x < kTile && col0 + threadIdx.x < N) db[col0 + threadIdx.x] = db_acc;
}

// grid (row tiles, splits): part_dh [n_splits, B, H]
template <int kHC>
__global__ void __launch_bounds__(kTileThreads) grads_dh_partial_kernel(
    const float* __restrict__ h, const float* __restrict__ W, const float* __restrict__ bias,
    const int* __restrict__ targets, const float* __restrict__ logz, const float* __restrict__ g,
    float* __restrict__ part_dh, int B, int H, int N, int cols_per_split) {
  __shared__ float As[kTile * kTS];
  __shared__ float Bs[kTile * kTS];
  float* Dt = As;  // Dt[c][r] = dz[row0 + r, col0 + c], once the logits are done with As
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kTile;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(N, c_begin + cols_per_split);
  float accH[kHC][4][4], acc[4][4];
#pragma unroll
  for (int q = 0; q < kHC; ++q) zero_acc(accH[q]);
  for (int col0 = c_begin; col0 < c_end; col0 += kTile) {
    logits_tile(h, W, bias, B, H, N, row0, col0, As, Bs, acc);
    dlogits_tile(acc, targets, logz, g, B, row0, col0, c_end);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) Dt[(tx + 16 * j) * kTS + ty + 16 * i] = acc[i][j];
    }
    // dh[row0 + r, q*64 + a] += sum_c Dt[c][r] W[q*64 + a, col0 + c]
#pragma unroll
    for (int q = 0; q < kHC; ++q) {
      if (q * kTile < H) {
        __syncthreads();
        load_tile_t(Bs, W + (size_t)q * kTile * N, N, 0, H - q * kTile, col0, c_end);
        __syncthreads();
        tile_mma(Dt, Bs, kTile, accH[q]);
      }
    }
  }
  float* out = part_dh + (size_t)blockIdx.y * B * H;
#pragma unroll
  for (int q = 0; q < kHC; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hh = q * kTile + tx + 16 * j;
        if (row < B && hh < H) out[(size_t)row * H + hh] = accH[q][i][j];
      }
    }
  }
}

template <int kHC>
int launch_grads(const float* h, const float* W, const float* bias, const int* targets,
                 const float* logz, const float* g, float* dh, float* dW, float* db,
                 float* part_dh, int B, int H, int N, int n_splits, int cols_per_split,
                 cudaStream_t s) {
  grads_dw_kernel<kHC><<<(N + kTile - 1) / kTile, kTileThreads, 0, s>>>(h, W, bias, targets, logz,
                                                                         g, dW, db, B, H, N);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid((B + kTile - 1) / kTile, n_splits);
  grads_dh_partial_kernel<kHC><<<grid, kTileThreads, 0, s>>>(h, W, bias, targets, logz, g, part_dh,
                                                              B, H, N, cols_per_split);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_sum_splits(part_dh, dh, n_splits, (size_t)B * H, s);
}

bool valid_plan(int B, int H, int N, int n_splits, int cols_per_split) {
  return B > 0 && H > 0 && N > 0 && n_splits > 0 && cols_per_split > 0 &&
         cols_per_split % kTile == 0 && (long long)(n_splits - 1) * cols_per_split < N &&
         (long long)n_splits * cols_per_split >= N;
}

}  // namespace

// (m, s) [B] from h [B, H], W [H, N], b [N]; scratch part_m, part_s
// [n_splits, B]; the catalog is cut into n_splits ranges of cols_per_split
// (a multiple of 64) columns, none empty.
extern "C" int seqrec_cce_stats_f32(const float* h, const float* W, const float* bias,
                                    float* part_m, float* part_s, float* m, float* s, int B,
                                    int H, int N, int n_splits, int cols_per_split,
                                    void* stream) {
  if (!valid_plan(B, H, N, n_splits, cols_per_split)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((B + kTile - 1) / kTile, n_splits);
  stats_partial_kernel<<<grid, kTileThreads, 0, st>>>(h, W, bias, part_m, part_s, B, H, N,
                                                      cols_per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  stats_merge_kernel<<<(B + 255) / 256, 256, 0, st>>>(part_m, part_s, m, s, B, n_splits);
  return (int)cudaGetLastError();
}

// dh [B, H], dW [H, N], db [N] from h, W, b, targets int32 [B] (each in
// [0, N)), logz [B] and the upstream cotangent g [B]; scratch part_dh
// [n_splits, B, H]. H up to 256.
extern "C" int seqrec_cce_grads_f32(const float* h, const float* W, const float* bias,
                                    const int* targets, const float* logz, const float* g,
                                    float* dh, float* dW, float* db, float* part_dh, int B,
                                    int H, int N, int n_splits, int cols_per_split,
                                    void* stream) {
  if (!valid_plan(B, H, N, n_splits, cols_per_split) || H > 4 * kTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (H <= kTile)
    return launch_grads<1>(h, W, bias, targets, logz, g, dh, dW, db, part_dh, B, H, N, n_splits,
                           cols_per_split, st);
  if (H <= 2 * kTile)
    return launch_grads<2>(h, W, bias, targets, logz, g, dh, dW, db, part_dh, B, H, N, n_splits,
                           cols_per_split, st);
  return launch_grads<4>(h, W, bias, targets, logz, g, dh, dW, db, part_dh, B, H, N, n_splits,
                         cols_per_split, st);
}
