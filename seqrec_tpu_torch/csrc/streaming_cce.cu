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
// What bounds it on an H100: operations. At B=1024, H=128, N=50,000 the
// stats are 2 B H N = 13 GFLOP (0.20 ms as f32 FMA at 67 TFLOP/s, 0.08 ms
// as three TF32 passes at 495 TFLOP/s) and the gradients need three
// products, 39 GFLOP (0.59 ms as f32 FMA, 0.24 ms as three TF32 passes),
// against a few MB of inputs and outputs.
//
// The TPU kernel carries its sums across a sequential grid; CUDA blocks
// run in no order, so the catalog is cut into splits, and every product is
// a 128 x 128 logits tile from block_mma.cuh's logits_block: 3xTF32 on the
// tensor cores (about f32 accuracy), the streamed operands in a
// three-stage ring of 16-byte cp.async copies (h and W come with row
// strides that are multiples of 4 floats: the wrapper pads them once a
// step).
// - stats: the block of (row tile, split) walks its split's column tiles.
//   Each thread keeps an online (m, s) for each of its 8 rows over its 8
//   columns of every tile (m starts at -inf; a thread may see only masked
//   columns, and then rescales against 0, not -inf). At the end the 4
//   lanes that share a row merge theirs by shuffles, then the 4 warps
//   through shared memory, in a fixed order. A merge kernel combines the
//   splits, as K4 merges its partial top-k.
// - gradients: dz never leaves shared memory.
//   - dW and db: the block of (column tile, H chunk) owns
//     dW[chunk, tile] (and db[tile] in the first chunk) and walks every
//     row tile: logits, dz, dW += h^T dz. Each output is written once.
//   - dh: the block of (row tile, split, H chunk) walks its split's
//     column tiles: logits, dz, dh += dz W^T, and writes its partial dh;
//     a second kernel sums the splits in order.
//   Both recompute the logits: 4 products (52 GFLOP at that shape) rather
//   than 3 and a partial of dh per column tile (about 200 MB at 128
//   columns) or of dW per row tile. An H of 256 is two 128-wide chunks,
//   each recomputing the logits. No atomics: the same bits run after run.

#include <math.h>

#include "block_mma.cuh"
#include "split_sum.cuh"

namespace {

// the bias of the thread's 8 columns (frag_col(nt, e)) of a column tile,
// 0 at and past end
__device__ __forceinline__ void load_col_bias(float bj[4][2], const float* __restrict__ bias,
                                              int end, int col0) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + frag_col(nt, e);
      bj[nt][e] = col < end ? bias[col] : 0.0f;
    }
  }
}

// (m, s) of one row merged with (mo, so); m = -inf (no column yet) has
// s = 0. Symmetric to the bit, so two lanes that swap theirs agree.
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo, float so) {
  const float mx = fmaxf(m, mo);
  const float ref = mx == -INFINITY ? 0.0f : mx;
  s = s * expf(m - ref) + so * expf(mo - ref);
  m = mx;
}

constexpr size_t kStatsSmem = (size_t)(kStages * kSlot + 2 * 4 * kBT) * sizeof(float);

// grid (row tiles, splits): part_m/part_s [n_splits, B]
__global__ void __launch_bounds__(kBThreads, 1) stats_partial_kernel(
    const float* __restrict__ h, size_t ldh, const float* __restrict__ W, size_t ldw,
    const float* __restrict__ bias, float* __restrict__ part_m, float* __restrict__ part_s, int B,
    int H, int N, int cols_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* red = ring + kStages * kSlot;  // [m of warp column 0..3 | s of 0..3][row]
  const int row0 = blockIdx.x * kBT;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(N, c_begin + cols_per_split);
  float m_run[4][2], s_run[4][2], acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m_run[mt][half] = -INFINITY;
      s_run[mt][half] = 0.0f;
    }
  }
  for (int col0 = c_begin; col0 < c_end; col0 += kBT) {
    float bj[4][2];
    load_col_bias(bj, bias, c_end, col0);
    logits_block(h, ldh, W, ldw, B, H, N, row0, col0, ring, acc);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[8], cm = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool real = col0 + frag_col(nt, e) < c_end;
            v[2 * nt + e] = real ? acc[mt][nt][2 * half + e] + bj[nt][e] : -INFINITY;
            cm = fmaxf(cm, v[2 * nt + e]);
          }
        }
        const float mx = fmaxf(m_run[mt][half], cm);
        const float ref = mx == -INFINITY ? 0.0f : mx;
        float ps = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) ps += expf(v[j] - ref);
        s_run[mt][half] = s_run[mt][half] * expf(m_run[mt][half] - ref) + ps;
        m_run[mt][half] = mx;
      }
    }
  }
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float m = m_run[mt][half], s = s_run[mt][half];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of the row
        const float mo = __shfl_xor_sync(0xffffffffu, m, off);
        const float so = __shfl_xor_sync(0xffffffffu, s, off);
        lse_merge(m, s, mo, so);
      }
      if ((lane & 3) == 0) {
        const int r = frag_row(mt, 2 * half);
        red[wn * kBT + r] = m;
        red[(4 + wn) * kBT + r] = s;
      }
    }
  }
  __syncthreads();
  const int r = threadIdx.x, row = row0 + r;
  if (r < kBT && row < B) {  // the 4 warp columns, in order
    float m = red[r], s = red[4 * kBT + r];
    for (int q = 1; q < 4; ++q) lse_merge(m, s, red[q * kBT + r], red[(4 + q) * kBT + r]);
    part_m[(size_t)blockIdx.y * B + row] = m;
    part_s[(size_t)blockIdx.y * B + row] = s;
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

// What dz needs of the thread's 8 rows (frag_row(mt, 2 half)) of a row
// tile, loaded before the tile's logits so their latency hides behind it.
struct RowTerms {
  float lz[4][2], g[4][2];
  int tg[4][2];
};

__device__ __forceinline__ void load_row_terms(RowTerms& rt, const int* __restrict__ targets,
                                               const float* __restrict__ logz,
                                               const float* __restrict__ g, int B, int row0) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + frag_row(mt, 2 * half);
      const bool real = row < B;
      rt.lz[mt][half] = real ? logz[row] : 0.0f;
      rt.g[mt][half] = real ? g[row] : 0.0f;  // 0 outside the batch: dz = 0 there
      rt.tg[mt][half] = real ? targets[row] : -1;
    }
  }
}

// dz of the tile into D[r * kLd + c]: g (exp(z - logz) - onehot), 0
// outside the real rows and columns
template <int kLd>
__device__ __forceinline__ void dlogits_block(const float acc[4][4][4], const RowTerms& rt,
                                              const float bj[4][2], int N, int col0, float* D) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = frag_row(mt, 2 * half);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + frag_col(nt, e);
          const float p = expf(acc[mt][nt][2 * half + e] + bj[nt][e] - rt.lz[mt][half]);
          d[e] = col < N ? rt.g[mt][half] * (p - (col == rt.tg[mt][half] ? 1.0f : 0.0f)) : 0.0f;
        }
        *reinterpret_cast<float2*>(D + r * kLd + frag_col(nt, 0)) = make_float2(d[0], d[1]);
      }
    }
  }
}

// sum over the 128 rows of column threadIdx.x (< 128) of D [128][kLd],
// in a fixed order (rows of a thread, then lanes, then the two warp rows);
// scratch holds 256 floats. Every thread must call it.
template <int kLd>
__device__ __forceinline__ float tile_column_sum(const float* D, float* scratch) {
  __syncthreads();  // D is complete
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = 0.0f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) v += D[frag_row(mt, 2 * half) * kLd + frag_col(nt, e)];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < 4) scratch[(warp >> 2) * kBT + frag_col(nt, e)] = v;
    }
  }
  __syncthreads();
  return threadIdx.x < kBT ? scratch[threadIdx.x] + scratch[kBT + threadIdx.x] : 0.0f;
}

constexpr int kDwLd = kKS;      // dz [row][col] as dW's k-major B operand
constexpr int kDhLd = kBT + 4;  // dz [row][col] as dh's x-major A operand
constexpr size_t kGradsSmem = (size_t)(kStages * kSlot + kBT * kKS) * sizeof(float);

// grid (column tiles, H chunks of 128): dW [H, N]; db [N] from chunk 0
__global__ void __launch_bounds__(kBThreads, 1) grads_dw_kernel(
    const float* __restrict__ h, size_t ldh, const float* __restrict__ W, size_t ldw,
    const float* __restrict__ bias, const int* __restrict__ targets,
    const float* __restrict__ logz, const float* __restrict__ g, float* __restrict__ dW,
    float* __restrict__ db, int B, int H, int N) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* D = ring + kStages * kSlot;  // D[r][c] = dz[row0 + r, col0 + c]
  const int col0 = blockIdx.x * kBT, hc0 = blockIdx.y * kBT;
  float accW[4][4][4], acc[4][4][4], bj[4][2];
  zero_block(accW);
  load_col_bias(bj, bias, N, col0);
  float db_acc = 0.0f;
  for (int row0 = 0; row0 < B; row0 += kBT) {
    RowTerms rt;
    load_row_terms(rt, targets, logz, g, B, row0);
    // the logits' pipeline starts with a barrier: the last dW product has read D
    logits_block(h, ldh, W, ldw, B, H, N, row0, col0, ring, acc);
    dlogits_block<kDwLd>(acc, rt, bj, N, col0, D);
    const int rows = min(kBT, B - row0);
    if (blockIdx.y == 0) db_acc += tile_column_sum<kDwLd>(D, ring);
    // dW[hc0 + a, col0 + c] += sum_r h[row0 + r, hc0 + a] D[r][c]
    pipeline(
        (rows + kBK - 1) / kBK, ring,
        [&](int s, float* slot) { stage_k_major(slot, h, ldh, hc0, H, row0 + s * kBK, B); },
        [&](int s, const float* slot) {
          mma_slice<false, kKS, false, kDwLd>(slot, D + s * kBK * kDwLd, accW);
        });
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = hc0 + frag_row(mt, e), col = col0 + frag_col(nt, e);
        if (hh < H && col < N) dW[(size_t)hh * N + col] = accW[mt][nt][e];
      }
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < kBT && col0 + threadIdx.x < N) db[col0 + threadIdx.x] = db_acc;
}

// grid (row tiles, splits, H chunks of 128): part_dh [n_splits, B, H]
__global__ void __launch_bounds__(kBThreads, 1) grads_dh_partial_kernel(
    const float* __restrict__ h, size_t ldh, const float* __restrict__ W, size_t ldw,
    const float* __restrict__ bias, const int* __restrict__ targets,
    const float* __restrict__ logz, const float* __restrict__ g, float* __restrict__ part_dh,
    int B, int H, int N, int cols_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* D = ring + kStages * kSlot;  // D[r][c] = dz[row0 + r, col0 + c]
  const int row0 = blockIdx.x * kBT, hc0 = blockIdx.z * kBT;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(N, c_begin + cols_per_split);
  float accH[4][4][4], acc[4][4][4];
  zero_block(accH);
  RowTerms rt;
  load_row_terms(rt, targets, logz, g, B, row0);
  for (int col0 = c_begin; col0 < c_end; col0 += kBT) {
    float bj[4][2];
    load_col_bias(bj, bias, N, col0);
    logits_block(h, ldh, W, ldw, B, H, N, row0, col0, ring, acc);
    dlogits_block<kDhLd>(acc, rt, bj, N, col0, D);
    // dh[row0 + r, hc0 + a] += sum_c D[r][c] W[hc0 + a, col0 + c]
    pipeline(
        (min(kBT, c_end - col0) + kBK - 1) / kBK, ring,
        [&](int s, float* slot) { stage_x_major(slot, W, ldw, hc0, H, col0 + s * kBK, c_end); },
        [&](int s, const float* slot) {
          mma_slice<true, kDhLd, true, kXS>(D + s * kBK, slot, accH);
        });
  }
  float* out = part_dh + (size_t)blockIdx.y * B * H;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + frag_row(mt, e), hh = hc0 + frag_col(nt, e);
        if (row < B && hh < H) out[(size_t)row * H + hh] = accH[mt][nt][e];
      }
    }
  }
}

int launch_grads(const float* h, int ldh, const float* W, int ldw, const float* bias,
                 const int* targets, const float* logz, const float* g, float* dh, float* dW,
                 float* db, float* part_dh, int B, int H, int N, int n_splits,
                 int cols_per_split, cudaStream_t s) {
  const int n_chunks = (H + kBT - 1) / kBT;
  int err = (int)cudaFuncSetAttribute(grads_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)kGradsSmem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(grads_dh_partial_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGradsSmem);
  if (err) return err;
  grads_dw_kernel<<<dim3((N + kBT - 1) / kBT, n_chunks), kBThreads, kGradsSmem, s>>>(
      h, ldh, W, ldw, bias, targets, logz, g, dW, db, B, H, N);
  err = (int)cudaGetLastError();
  if (err) return err;
  grads_dh_partial_kernel<<<dim3((B + kBT - 1) / kBT, n_splits, n_chunks), kBThreads, kGradsSmem,
                            s>>>(h, ldh, W, ldw, bias, targets, logz, g, part_dh, B, H, N,
                                 cols_per_split);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_sum_splits(part_dh, dh, n_splits, (size_t)B * H, s);
}

// the catalog cut into n_splits ranges of cols_per_split (a multiple of
// 128) columns, none empty; h and W read with row strides ldh >= H and
// ldw >= N, multiples of 4, from 16-byte aligned addresses
bool valid_call(const float* h, int ldh, const float* W, int ldw, int B, int H, int N,
                int n_splits, int cols_per_split) {
  return B > 0 && H > 0 && N > 0 && n_splits > 0 && cols_per_split > 0 &&
         cols_per_split % kBT == 0 && (long long)(n_splits - 1) * cols_per_split < N &&
         (long long)n_splits * cols_per_split >= N && ldh >= H && ldw >= N && ldh % 4 == 0 &&
         ldw % 4 == 0 && (uintptr_t)h % 16 == 0 && (uintptr_t)W % 16 == 0;
}

}  // namespace

// (m, s) [B] from h [B, H], W [H, N], b [N] (h and W as valid_call
// says); scratch part_m, part_s [n_splits, B].
extern "C" int seqrec_cce_stats_f32(const float* h, int ldh, const float* W, int ldw,
                                    const float* bias, float* part_m, float* part_s, float* m,
                                    float* s, int B, int H, int N, int n_splits,
                                    int cols_per_split, void* stream) {
  if (!valid_call(h, ldh, W, ldw, B, H, N, n_splits, cols_per_split)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(stats_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)kStatsSmem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  stats_partial_kernel<<<dim3((B + kBT - 1) / kBT, n_splits), kBThreads, kStatsSmem, st>>>(
      h, ldh, W, ldw, bias, part_m, part_s, B, H, N, cols_per_split);
  err = (int)cudaGetLastError();
  if (err) return err;
  stats_merge_kernel<<<(B + 255) / 256, 256, 0, st>>>(part_m, part_s, m, s, B, n_splits);
  return (int)cudaGetLastError();
}

// dh [B, H], dW [H, N], db [N] from h, W, b (h and W as valid_call says),
// targets int32 [B] (each in [0, N)), logz [B] and the upstream cotangent
// g [B]; scratch part_dh [n_splits, B, H]. H up to 256.
extern "C" int seqrec_cce_grads_f32(const float* h, int ldh, const float* W, int ldw,
                                    const float* bias, const int* targets, const float* logz,
                                    const float* g, float* dh, float* dW, float* db,
                                    float* part_dh, int B, int H, int N, int n_splits,
                                    int cols_per_split, void* stream) {
  if (!valid_call(h, ldh, W, ldw, B, H, N, n_splits, cols_per_split) || H > 2 * kBT)
    return (int)cudaErrorInvalidValue;
  return launch_grads(h, ldh, W, ldw, bias, targets, logz, g, dh, dW, db, part_dh, B, H, N,
                      n_splits, cols_per_split, (cudaStream_t)stream);
}
