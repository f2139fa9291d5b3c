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
// What bounds it on an H100: the product, 2*B*H*N operations. At B=512,
// H=256, N=200,000 that is 52.4 GFLOP: 0.78 ms as f32 FMA on the CUDA
// cores, 0.32 ms as three TF32 passes on the tensor cores, against 61 us
// to read W_out once. At B=64, H=50, N=3,706 (the flagship's serving
// chunk) it is latency: the work is 24 MFLOP, and the time goes to the
// per-row list inserts and the launches.
//
// Design. The TPU kernel carries its running top-k across a sequential
// grid axis; Hopper blocks run in no order, so there is no carry and the
// work is split in two kernels:
// 1. score_topk_partial, grid (row tiles of 128, catalog splits, row
//    groups). A block walks its split's 128-column tiles: logits_block
//    (block_mma.cuh: 3xTF32 mma.sync, about f32 accuracy, operands in a
//    cp.async ring; h and W_out come with 16-byte rows, padded by the
//    wrapper), then the tile plus bias is spilled into shared memory over
//    the ring. Each warp then takes its rows of the block's row group: it
//    ballots the columns that order before the row's sorted list's k-th
//    entry (after warm-up, few do); only for a row with such candidates
//    does it read the row's S seen ids (one coalesced read) and write -inf
//    at those in the tile, ballot again, and insert the candidates into
//    the list, held in the warp's registers for the tile (lane l holds
//    entry l, and l + 32 where k > 32). Columns >= N are never visited. Each block writes its rows' lists to
//    [B, splits, k]. Row groups (only where the logits tiles alone would
//    leave most SMs idle, as at B=64 on a 3,706-item catalog) let several
//    blocks share one logits tile, each inserting for a slice of its
//    rows: the warm-up inserts, not the product, set the time there.
// 2. score_topk_merge, one block per row: each of the splits*k candidates
//    counts the candidates that order before it; that rank is its output
//    slot if it is below k.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "block_mma.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kWarps = kBThreads / 32;
constexpr int kDLd = kKS;  // row stride of the spilled tile (float2 stores: no bank conflict)
constexpr int kMergeThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBT * kDLd <= kStages * kSlot, "the spilled tile lives in the ring");

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// One row's sorted list (value desc, id asc) of k entries, held by a
// warp: lane l has entries l (v0, i0) and, where k > 32 (kWide), l + 32
// (v1, i1). Entries past k stay sorted after entry k - 1 and are never
// stored.
struct WarpList {
  float v0, v1;
  int i0, i1;
};

template <bool kWide>
__device__ __forceinline__ void load_list(WarpList& L, const float* lv, const int* li, int k, int lane) {
  L.v0 = lane < k ? lv[lane] : -INFINITY;
  L.i0 = lane < k ? li[lane] : INT_MAX;
  if (kWide) {
    L.v1 = lane + 32 < k ? lv[lane + 32] : -INFINITY;
    L.i1 = lane + 32 < k ? li[lane + 32] : INT_MAX;
  }
}

template <bool kWide>
__device__ __forceinline__ void store_list(const WarpList& L, float* lv, int* li, int k, int lane) {
  if (lane < k) {
    lv[lane] = L.v0;
    li[lane] = L.i0;
  }
  if (kWide && lane + 32 < k) {
    lv[lane + 32] = L.v1;
    li[lane + 32] = L.i1;
  }
}

// entry k - 1 of the list, in every lane
template <bool kWide>
__device__ __forceinline__ void list_last(const WarpList& L, int k, float& tv, int& ti) {
  tv = __shfl_sync(kFull, kWide ? L.v1 : L.v0, (k - 1) & 31);
  ti = __shfl_sync(kFull, kWide ? L.i1 : L.i0, (k - 1) & 31);
}

// insert (v, id), which orders before entry k - 1; the whole warp calls it
// with the same (v, id)
template <bool kWide>
__device__ __forceinline__ void list_insert(WarpList& L, float v, int id, int lane) {
  int pos = __popc(__ballot_sync(kFull, before(L.v0, L.i0, v, id)));
  if (kWide) {
    pos += __popc(__ballot_sync(kFull, before(L.v1, L.i1, v, id)));
    float u1 = __shfl_up_sync(kFull, L.v1, 1);
    int j1 = __shfl_up_sync(kFull, L.i1, 1);
    const float c0 = __shfl_sync(kFull, L.v0, 31);
    const int d0 = __shfl_sync(kFull, L.i0, 31);
    if (lane == 0) {  // entry 32 takes entry 31
      u1 = c0;
      j1 = d0;
    }
    if (lane + 32 > pos) {
      L.v1 = u1;
      L.i1 = j1;
    } else if (lane + 32 == pos) {
      L.v1 = v;
      L.i1 = id;
    }
  }
  const float u0 = __shfl_up_sync(kFull, L.v0, 1);
  const int j0 = __shfl_up_sync(kFull, L.i0, 1);
  if (lane > pos) {
    L.v0 = u0;
    L.i0 = j0;
  } else if (lane == pos) {
    L.v0 = v;
    L.i0 = id;
  }
}

// the tile's columns of one row (spilled in D, n_cols real ones from col0)
// that order before (tv, ti): a ballot of each 32
__device__ __forceinline__ unsigned row_ballots(const float* D, int n_cols, int col0, float tv, int ti,
                                                int lane, float v[4], unsigned pending[4]) {
  unsigned any = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 32 * j + lane;
    v[j] = c < n_cols ? D[c] : -INFINITY;
    pending[j] = __ballot_sync(kFull, c < n_cols && before(v[j], col0 + c, tv, ti));
    any |= pending[j];
  }
  return any;
}

// Merge one row's tile into the row's list (lv, li)[k] in shared memory.
// Only where some column beats the list's entry k - 1 (after warm-up,
// rarely) are the row's seen ids read: those in the tile become -inf in D
// before the candidates are taken again.
template <bool kWide>
__device__ __forceinline__ void row_epilogue(float* D, float* lv, int* li, int k, int col0, int n_cols,
                                             const int* __restrict__ seen_ids,
                                             const float* __restrict__ seen_mask, int S, int lane) {
  float tv = lv[k - 1];
  int ti = li[k - 1];
  float v[4];
  unsigned pending[4];
  if (!row_ballots(D, n_cols, col0, tv, ti, lane, v, pending)) return;
  bool masked = false;
  for (int s = lane; s < S; s += 32) {
    const int id = __ldg(seen_ids + s);
    if (__ldg(seen_mask + s) > 0.0f && id >= col0 && id < col0 + n_cols) {
      D[id - col0] = -INFINITY;
      masked = true;
    }
  }
  if (__any_sync(kFull, masked)) {
    __syncwarp();
    if (!row_ballots(D, n_cols, col0, tv, ti, lane, v, pending)) return;
  }
  WarpList L;
  load_list<kWide>(L, lv, li, k, lane);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int id = col0 + 32 * j + lane;
    while (pending[j]) {
      const int src = __ffs(pending[j]) - 1;
      list_insert<kWide>(L, __shfl_sync(kFull, v[j], src), col0 + 32 * j + src, lane);
      list_last<kWide>(L, k, tv, ti);
      // the inserted column and those that no longer beat entry k - 1 drop out
      pending[j] &= (pending[j] - 1) & __ballot_sync(kFull, before(v[j], id, tv, ti));
    }
    if (j < 3) pending[j + 1] &= __ballot_sync(kFull, before(v[j + 1], id + 32, tv, ti));
  }
  store_list<kWide>(L, lv, li, k, lane);
}

template <bool kWide>
__global__ void __launch_bounds__(kBThreads, 1) score_topk_partial(
    const float* __restrict__ h, size_t ldh,  // [B, H], row stride ldh
    const float* __restrict__ w, size_t ldw,  // [H, N], row stride ldw
    const float* __restrict__ bias,           // [N]
    const int* __restrict__ seen_ids,         // [B, S] or null when S == 0
    const float* __restrict__ seen_mask,      // [B, S] or null when S == 0
    float* __restrict__ part_v,               // [B, splits, k]
    int* __restrict__ part_i,                 // [B, splits, k]
    int B, int H, int N, int S, int k, int cols_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                   // the copy ring, then the spilled tile D [kBT][kDLd]
  float* topv = ring + kStages * kSlot;  // [kBT, k]
  int* topi = reinterpret_cast<int*>(topv + kBT * k);  // [kBT, k]

  const int row0 = blockIdx.x * kBT;
  const int tile_rows = min(kBT, B - row0);
  const int group_rows = (tile_rows + gridDim.z - 1) / gridDim.z;
  const int r_lo = blockIdx.z * group_rows;
  const int r_hi = min(r_lo + group_rows, tile_rows);
  if (r_lo >= r_hi) return;  // a row group past a ragged tile's rows
  const int split = blockIdx.y;
  const int c_lo = split * cols_per_split;
  const int c_hi = min(N, c_lo + cols_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kBT * k; i += kBThreads) {
    topv[i] = -INFINITY;
    topi[i] = INT_MAX;
  }
  float acc[4][4][4];
  for (int col0 = c_lo; col0 < c_hi; col0 += kBT) {
    float bj[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + frag_col(nt, e);
        bj[nt][e] = col < c_hi ? __ldg(bias + col) : 0.0f;
      }
    }
    // starts with a barrier: the last tile's D has been read
    logits_block(h, ldh, w, ldw, B, H, N, row0, col0, ring, acc);
    __syncthreads();  // every warp's last product has read the ring
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = frag_row(mt, 2 * half);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          *reinterpret_cast<float2*>(ring + r * kDLd + frag_col(nt, 0)) =
              make_float2(acc[mt][nt][2 * half] + bj[nt][0], acc[mt][nt][2 * half + 1] + bj[nt][1]);
        }
      }
    }
    __syncthreads();
    const int n_cols = min(kBT, c_hi - col0);
    for (int r = r_lo + warp; r < r_hi; r += kWarps) {
      const size_t so = (size_t)(row0 + r) * S;
      row_epilogue<kWide>(ring + r * kDLd, topv + r * k, topi + r * k, k, col0, n_cols, seen_ids + so,
                          seen_mask + so, S, lane);
    }
  }
  __syncwarp();
  for (int r = r_lo + warp; r < r_hi; r += kWarps) {
    const size_t o = ((size_t)(row0 + r) * gridDim.y + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_v[o + j] = topv[r * k + j];
      part_i[o + j] = topi[r * k + j];
    }
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

// bytes of shared memory of the partial kernel: the ring and the lists
size_t partial_smem(int k) { return sizeof(float) * ((size_t)kStages * kSlot + (size_t)2 * kBT * k); }

}  // namespace

// Top-k of h [B, H] W [H, N] + bias [N] with the seen ids masked; h and W
// are read with row strides ldh >= H and ldw >= N, multiples of 4, from
// 16-byte aligned addresses. The catalog is cut into n_splits ranges of
// cols_per_split (a multiple of 128) columns, none empty; groups blocks
// share each logits tile, each inserting for its slice of the tile's rows. Scratch part_v, part_i
// [B, n_splits, k]; out_v, out_i [B, k].
extern "C" int seqrec_score_topk_f32(const float* h, int ldh, const float* w, int ldw,
                                     const float* bias, const int* seen_ids, const float* seen_mask,
                                     float* part_v, int* part_i, float* out_v, int* out_i, int B,
                                     int H, int N, int S, int k, int n_splits, int cols_per_split,
                                     int groups, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || S < 0 || k < 1 || k > kMaxK || n_splits < 1 ||
      cols_per_split <= 0 || cols_per_split % kBT != 0 ||
      (long long)(n_splits - 1) * cols_per_split >= N || (long long)n_splits * cols_per_split < N ||
      groups < 1 || groups > kBT || ldh < H || ldw < N ||
      ldh % 4 || ldw % 4 || (uintptr_t)h % 16 || (uintptr_t)w % 16) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, smem_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = partial_smem(k);
  const int n_cand = n_splits * k;
  const size_t merge_smem = (size_t)n_cand * (sizeof(float) + sizeof(int));
  if (smem > (size_t)smem_optin || merge_smem > (size_t)smem_optin) {
    return (int)cudaErrorInvalidValue;
  }
  // lists of up to 32 entries take one register pair a lane
  const auto partial = k > 32 ? score_topk_partial<true> : score_topk_partial<false>;
  int err = (int)cudaFuncSetAttribute(partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  if (merge_smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(score_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)merge_smem);
    if (err) return err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((B + kBT - 1) / kBT, n_splits, groups);
  partial<<<grid, kBThreads, smem, s>>>(h, ldh, w, ldw, bias, seen_ids, seen_mask, part_v, part_i, B, H, N,
                                        S, k, cols_per_split);
  err = (int)cudaGetLastError();
  if (err) return err;
  score_topk_merge<<<B, kMergeThreads, merge_smem, s>>>(part_v, part_i, out_v, out_i, n_cand, k);
  return (int)cudaGetLastError();
}
