// Fused catalog scoring + seen-item masking + top-k: the serving head.
//
// Replaces seqrec_tpu/ops/pallas_topk.py:_topk_kernel (reached through
// fused_score_topk). For each row b it returns the k best (value, id) of
//   score[b, n] = h[b] . W_out[:, n] + b_out[n],  n < N,
// with score = -inf at the row's seen ids (where seen_mask > 0), in the
// order (value descending, id ascending); an empty slot is (-inf, INT_MAX).
// That is what the JAX package's CPU path (masked_top_k -> lax.top_k)
// returns, rows with fewer than k unmasked items included. The [B, N]
// scores never reach device memory.
//
// What bounds it on an H100: the f32 product, 2*B*H*N operations on the
// CUDA cores (TF32 stays off). At B=512, H=256, N=200,000 that is 52.4
// GFLOP, about 0.8 ms at 67 TFLOP/s, against 61 us to read W_out once.
//
// Design. The TPU kernel carries its running top-k across a sequential
// grid axis; Hopper blocks run in no order, so there is no carry and the
// work is split in two kernels:
// 1. score_topk_partial, grid (row tiles of kRows, catalog splits). A
//    block stages its h rows (transposed, so one k step reads the tile's
//    rows as float4s) and their seen ids in shared memory, then walks its
//    column range in tiles of kThreads columns. Each thread scores one
//    column for all kRows rows: every W_out element is read once per
//    block, coalesced, and used kRows times from a register. The tile's
//    scores go to shared memory; then each warp merges one row's tile
//    into that row's sorted top-k list: a ballot finds the columns that
//    beat the list's k-th entry (after warm-up, few do), each such
//    candidate is compared with the row's seen ids (no scatter; a seen
//    candidate becomes -inf) and inserted by the warp. Columns >= N are
//    never visited. Each block writes its rows' lists to [B, splits, k].
// 2. score_topk_merge, one block per row: each of the splits*k candidates
//    counts the candidates that order before it; that rank is its output
//    slot if it is below k.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // also the columns of one catalog tile
constexpr int kRows = 16;      // batch rows of one block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kMergeThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Insert (v, id) into the sorted list (lv, li)[k] in shared memory; the
// whole warp calls it with the same (v, id), which orders before lv[k-1].
__device__ void warp_insert(float* lv, int* li, int k, float v, int id, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int e = base + lane;
    pos += __popc(__ballot_sync(kFull, e < k && before(lv[e], li[e], v, id)));
  }
  const int e0 = lane, e1 = lane + 32;
  const bool m0 = e0 >= pos && e0 < k - 1, m1 = e1 >= pos && e1 < k - 1;
  float v0 = 0.0f, v1 = 0.0f;
  int i0 = 0, i1 = 0;
  if (m0) { v0 = lv[e0]; i0 = li[e0]; }
  if (m1) { v1 = lv[e1]; i1 = li[e1]; }
  __syncwarp();
  if (m0) { lv[e0 + 1] = v0; li[e0 + 1] = i0; }
  if (m1) { lv[e1 + 1] = v1; li[e1 + 1] = i1; }
  if (lane == 0) { lv[pos] = v; li[pos] = id; }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) score_topk_partial(
    const float* __restrict__ h,          // [B, H]
    const float* __restrict__ w,          // [H, N]
    const float* __restrict__ bias,       // [N]
    const int* __restrict__ seen_ids,     // [B, S] or null when S == 0
    const float* __restrict__ seen_mask,  // [B, S] or null when S == 0
    float* __restrict__ part_v,           // [B, splits, k]
    int* __restrict__ part_i,             // [B, splits, k]
    int B, int H, int N, int S, int k, int cols_per_split) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [H, kRows] (h transposed)
  float* scores = hs + H * kRows;                // [kRows, kThreads]
  float* topv = scores + kRows * kThreads;       // [kRows, k]
  int* topi = reinterpret_cast<int*>(topv + kRows * k);  // [kRows, k]
  int* seen = topi + kRows * k;                  // [kRows, S], -1 = no id

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int split = blockIdx.y;
  const int c_lo = split * cols_per_split;
  const int c_hi = min(N, c_lo + cols_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
    const int kk = i / kRows, r = i - kk * kRows;
    hs[i] = r < rows ? h[(size_t)(row0 + r) * H + kk] : 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * S; i += kThreads) {
    const int r = i / S;
    const size_t g = (size_t)row0 * S + i;
    seen[i] = (r < rows && seen_mask[g] > 0.0f) ? seen_ids[g] : -1;
  }
  for (int i = threadIdx.x; i < kRows * k; i += kThreads) {
    topv[i] = -INFINITY;
    topi[i] = INT_MAX;
  }
  __syncthreads();

  for (int tile = c_lo; tile < c_hi; tile += kThreads) {
    const int col = tile + threadIdx.x;
    if (col < c_hi) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const float4* hp = reinterpret_cast<const float4*>(hs);
      for (int kk = 0; kk < H; ++kk) {
        const float wv = __ldg(w + (size_t)kk * N + col);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 hv = hp[kk * (kRows / 4) + q];
          acc[4 * q + 0] = fmaf(hv.x, wv, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(hv.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(hv.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(hv.w, wv, acc[4 * q + 3]);
        }
      }
      const float bv = __ldg(bias + col);
#pragma unroll
      for (int r = 0; r < kRows; ++r) scores[r * kThreads + threadIdx.x] = acc[r] + bv;
    }
    __syncthreads();

    const int n_cols = min(kThreads, c_hi - tile);
    for (int r = warp; r < rows; r += kWarps) {
      float* lv = topv + r * k;
      int* li = topi + r * k;
      const int* sr = seen + r * S;
      for (int j = 0; j < n_cols; j += 32) {
        const int c = j + lane;
        const bool valid = c < n_cols;
        const float v = valid ? scores[r * kThreads + c] : -INFINITY;
        const int id = tile + c;
        unsigned pending = __ballot_sync(kFull, valid && before(v, id, lv[k - 1], li[k - 1]));
        while (pending) {
          const int src = __ffs(pending) - 1;
          pending &= pending - 1;
          float cv = __shfl_sync(kFull, v, src);
          const int cid = __shfl_sync(kFull, id, src);
          bool hit = false;
          for (int s = lane; s < S; s += 32) hit |= sr[s] == cid;
          if (__any_sync(kFull, hit)) cv = -INFINITY;
          if (before(cv, cid, lv[k - 1], li[k - 1])) warp_insert(lv, li, k, cv, cid, lane);
          // candidates that no longer beat the k-th entry drop out
          pending &= __ballot_sync(kFull, valid && before(v, id, lv[k - 1], li[k - 1]));
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * k; i += kThreads) {
    const int r = i / k, j = i - r * k;
    const size_t o = ((size_t)(row0 + r) * gridDim.y + split) * k + j;
    part_v[o] = topv[r * k + j];
    part_i[o] = topi[r * k + j];
  }
}

__global__ void __launch_bounds__(kMergeThreads) score_topk_merge(
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    float* __restrict__ out_v, int* __restrict__ out_i, int n_cand, int k) {
  extern __shared__ float merge_smem[];
  float* cv = merge_smem;
  int* ci = reinterpret_cast<int*>(cv + n_cand);
  const size_t base = (size_t)blockIdx.x * n_cand;
  for (int i = threadIdx.x; i < n_cand; i += kMergeThreads) {
    cv[i] = part_v[base + i];
    ci[i] = part_i[base + i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_cand; c += kMergeThreads) {
    const float v = cv[c];
    const int id = ci[c];
    int rank = 0;
    for (int j = 0; j < n_cand; ++j) {
      // equal keys (empty slots) are ordered by position
      rank += before(cv[j], ci[j], v, id) || (cv[j] == v && ci[j] == id && j < c);
    }
    if (rank < k) {
      out_v[(size_t)blockIdx.x * k + rank] = v;
      out_i[(size_t)blockIdx.x * k + rank] = id;
    }
  }
}

}  // namespace

extern "C" int seqrec_score_topk_f32(const float* h, const float* w, const float* bias,
                                     const int* seen_ids, const float* seen_mask,
                                     float* part_v, int* part_i, float* out_v, int* out_i,
                                     int B, int H, int N, int S, int k, int n_splits,
                                     int cols_per_split, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || S < 0 || k < 1 || k > kMaxK || n_splits < 1 ||
      cols_per_split % kThreads != 0 || (long long)n_splits * cols_per_split < N) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = sizeof(float) * ((size_t)H * kRows + (size_t)kRows * kThreads +
                                       (size_t)2 * kRows * k + (size_t)kRows * S);
  const int n_cand = n_splits * k;
  const size_t merge_smem = (size_t)n_cand * (sizeof(float) + sizeof(int));
  if (smem > (size_t)smem_optin || merge_smem > (size_t)smem_optin) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(score_topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (merge_smem > 48 * 1024) {
    cudaFuncSetAttribute(score_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)merge_smem);
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((B + kRows - 1) / kRows, n_splits);
  score_topk_partial<<<grid, kThreads, smem, s>>>(h, w, bias, seen_ids, seen_mask, part_v,
                                                  part_i, B, H, N, S, k, cols_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_topk_merge<<<B, kMergeThreads, merge_smem, s>>>(part_v, part_i, out_v, out_i, n_cand, k);
  return (int)cudaGetLastError();
}
