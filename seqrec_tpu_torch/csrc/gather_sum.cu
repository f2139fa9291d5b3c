// Multi-hot gather-sum of an input table, and its dense table gradient:
// the input layer of every recurrent tower (models/recurrent.py: the
// embedding and each first layer's W_in), forward and backward; LTM's and
// the factorization family's table updates run the backward alone.
//
// Replaces the XLA gather and scatter-add that
// seqrec_tpu/ops/core.py:gather_sum (:54) compiles to; it is not a Pallas
// kernel. With ids [P0, F] (pad slots < 0) and an optional id_mask [P0, F]:
//   out[p, :]    = sum_f [ids[p, f] >= 0] id_mask[p, f] table[ids[p, f], :]
//   dtable[i, :] = sum over slots (p, f) with ids[p, f] == i of
//                  id_mask[p, f] g[p, :]
//
// What bounds it on an H100: bytes. At the GRU-128 step's shape (P0 =
// 30,720 positions, F = 1, D = 384, N = 49,999 rows) the backward reads 47
// MB of cotangent rows and writes the 77 MB dense gradient: 0.037 ms at
// 3.35 TB/s. The runs of one id are long: the compact batch wire writes id
// 0 at every padded step, and a side feature (a user's sex) can hold a
// slot at every step of a batch.
//
// Forward: L lanes a position, each with loads of V floats (V = 4 where D
// and the pointers allow, else 2, else 1): L is the fewest power of two
// with V L >= D, so at D = 32 a warp holds 4 positions of 8 lanes; where
// that would take all 32 lanes, one warp a position, each lane with the
// fewest loads I (a power of two) that cover D, at most 512 columns a
// column group (D = 150: 4 float2 loads a lane). The F slots are added in
// slot order into registers; one store. The backward's row kernels map
// lanes to columns the same way.
//
// Backward, three launches and no host work:
// 1. order_kernel sorts the slots by row, stably, on the device: a
//    cluster of 8 CTAs owns 8192 / W rows (W warps a CTA: 32 for
//    catalogs of up to 8,192 rows, else 8) and reads all P = P0 F ids
//    twice, each CTA an eighth of them and each of its warps a W-th of
//    that, in slot order. The first sweep counts each (row, CTA, warp)
//    triple's slots; the CTAs exchange their row totals and counts of
//    lower rows through distributed shared memory; an exclusive scan in
//    (row, CTA, warp) order gives each triple its first sorted position;
//    the second sweep places each slot there, ranked among its warp's
//    earlier slots of the same row by __match_any_sync. So row i's slots
//    sit at the sorted positions [row_start[i], row_start[i + 1]) in
//    ascending slot order, pad slots nowhere. Counts are integers; nothing
//    depends on timing.
// 2. chunk_sums_kernel: a row of n > S = 32 slots is cut into chunks of S
//    sorted positions, the k-th from row_start[i] + k S, the last one
//    shorter. One warp a window of S sorted positions finds the chunks
//    that start in it (one lane a position) and sums each chunk's rows,
//    times id_mask, in slot order into a partial. A window holds at most
//    one first chunk (k = 0) and one later chunk (k > 0), so the chunk
//    starting at position c keeps its partial at part[2 (c / S) + (k ==
//    0)]: no prefix sum over the chunks is needed.
// 3. dense_rows_kernel writes each row of the dense gradient once: for a
//    row of at most S slots, the sum of its rows in slot order (zeros for
//    a row with no slot); for a row of K chunks, the block's 8 warps
//    cooperate: warp j sums the partials of chunks j, j + 8, j + 16, ...
//    in that order, and the row is the sum of those 8 sums in j order.
// Every sum starts from 0 and is a fixed sequence of round-to-nearest adds
// (no contraction into FMAs) in the order above, which the ids alone fix,
// so two calls give the same bits. No float atomics, and no counter shared
// between clusters.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "cluster_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupCols = 512;  // columns of one column group (grid.y) with a warp a row
constexpr int kUnroll = 4;       // rows loaded before they are added
constexpr int kS = 32;           // S: the most slots one chunk sums (a window's positions, one a lane)
constexpr int kOrderCTAs = 8;    // order_kernel: CTAs a cluster, each over an eighth of the slots
constexpr int kOrderPairs = 8192;  // order_kernel: (row, warp) pairs a CTA counts: rows = 8192 / warps
constexpr int kWideRows = 8192;  // order_kernel: 32 warps a CTA up to this many rows, else 8
constexpr int kAhead = 8;        // order_kernel: rounds of 32 ids loaded before they are used

// A lane's columns of a row: I loads of V floats at c, c + stride, ...;
// columns at or past D read as 0 (V divides D, so a load is all in or out).
template <int V, int I>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int c, int stride, int D,
                                         float v[V * I]) {
#pragma unroll
  for (int i = 0; i < I; ++i, c += stride) {
    if constexpr (V == 4) {
      const float4 q = c < D ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    } else if constexpr (V == 2) {
      const float2 q = c < D ? __ldg(reinterpret_cast<const float2*>(row + c)) : make_float2(0.f, 0.f);
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    } else {
      v[i] = c < D ? __ldg(row + c) : 0.0f;
    }
  }
}

template <int V, int I>
__device__ __forceinline__ void store_row(float* __restrict__ row, int c, int stride, int D,
                                          const float v[V * I]) {
#pragma unroll
  for (int i = 0; i < I; ++i, c += stride) {
    if (c >= D) continue;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(row + c) = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(row + c) = make_float2(v[2 * i], v[2 * i + 1]);
    } else {
      row[c] = v[i];
    }
  }
}

// acc += m v, as a round-to-nearest product and add (m = 1 without id_mask)
template <int K>
__device__ __forceinline__ void add_scaled(float acc[K], const float v[K], float m) {
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], m));
}

// acc += the rows of g of the n <= S slots at sorted positions [s0, s0 +
// n), each times its id_mask, in position order. The 1 << lg lanes of a
// group (one row's) load as many positions' slots and masks at a time and
// pass them round by shuffles; kRunUnroll rows are loaded, then added
// (8 where a lane holds at most 8 floats of a row, else 4).
template <int V, int I>
__device__ __forceinline__ void sum_run(const float* __restrict__ g, const int* __restrict__ perm,
                                        const float* __restrict__ id_mask, int s0, int n, int F, int D,
                                        int c, int stride, int lg, float acc[V * I]) {
  constexpr int kRunUnroll = V * I > 8 ? 4 : 8;
  const int L = 1 << lg, lane = threadIdx.x & 31, gl = lane & (L - 1);
  const unsigned group = L == 32 ? 0xffffffffu : ((1u << L) - 1) << (lane & ~(L - 1));
  for (int j0 = 0; j0 < n; j0 += L) {
    const int cnt = min(L, n - j0);
    const int my_slot = gl < cnt ? __ldg(perm + s0 + j0 + gl) : 0;
    const float my_m = gl < cnt && id_mask != nullptr ? __ldg(id_mask + my_slot) : 1.0f;
    for (int j = 0; j < cnt; j += kRunUnroll) {
      float v[kRunUnroll][V * I], m[kRunUnroll];
#pragma unroll
      for (int u = 0; u < kRunUnroll; ++u) {
        const int slot = __shfl_sync(group, my_slot, j + u, L);
        m[u] = __shfl_sync(group, my_m, j + u, L);
        if (j + u < cnt) load_row<V, I>(g + (size_t)(slot / F) * D, c, stride, D, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kRunUnroll; ++u)
        if (j + u < cnt) add_scaled<V * I>(acc, v[u], m[u]);
    }
  }
}

// Forward: 1 << lanes_log2 lanes a position (fewer than 32: I = 1 and V L
// >= D; 32: a warp, with I loads covering D up to a 512-column group, and
// the groups on grid.y).
template <int V, int I, typename Id>
__global__ void __launch_bounds__(kThreads) gather_sum_fwd_kernel(
    const float* __restrict__ table,    // [N, D]
    const Id* __restrict__ ids,         // [P0, F]
    const float* __restrict__ id_mask,  // [P0, F] or null
    float* __restrict__ out,            // [P0, D]
    long long P0, int F, int N, int D, int lanes_log2) {
  const int lane = threadIdx.x & 31;
  const long long p = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 >> lanes_log2) +
                      (lane >> lanes_log2);
  if (p >= P0) return;
  const int c = blockIdx.y * kGroupCols + V * (lane & ((1 << lanes_log2) - 1));
  const int stride = V << lanes_log2;
  float acc[V * I];
#pragma unroll
  for (int i = 0; i < V * I; ++i) acc[i] = 0.0f;
  // slots' rows loaded before they are added; one where a lane holds 16
  // floats of a row (D > 256), for the occupancy that keeps more positions'
  // loads in flight
  constexpr int kSlots = V * I > 8 ? 1 : kUnroll;
  for (int f0 = 0; f0 < F; f0 += kSlots) {
    float v[kSlots][V * I], m[kSlots];
    bool real[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const long long id = f0 + u < F ? (long long)ids[p * F + f0 + u] : -1;
      if (id >= N) __trap();  // an id outside the table: fail loudly, as indexing does
      real[u] = id >= 0;      // a pad slot adds nothing
      m[u] = real[u] && id_mask != nullptr ? id_mask[p * F + f0 + u] : 1.0f;
      if (real[u]) load_row<V, I>(table + (size_t)id * D, c, stride, D, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (real[u]) add_scaled<V * I>(acc, v[u], m[u]);
  }
  store_row<V, I>(out + (size_t)p * D, c, stride, D, acc);
}

// order_kernel's (row u, warp w) entry; rows of R + 1 keep the leaders'
// updates of one round and the scan's reads on distinct banks
template <int R>
__device__ __forceinline__ int& pair(int* base, int u, int w) { return base[w * (R + 1) + u]; }

// Backward 1: the slots sorted by row, stably (see the note at the top):
// row_start [N + 1], and at each sorted position its slot (perm) and row
// (srow). The cluster b of kOrderCTAs CTAs of W warps owns the rows [R b,
// R b + R), R = kOrderPairs / W.
template <int W, typename Id>
__global__ void __cluster_dims__(kOrderCTAs, 1, 1) __launch_bounds__(32 * W) order_kernel(
    const Id* __restrict__ ids,  // [P]
    long long P, int N,
    int* __restrict__ row_start,  // [N + 1]
    int* __restrict__ perm,       // [P], the first row_start[N] written
    int* __restrict__ srow) {     // [P], the same
  constexpr int R = kOrderPairs / W, kThreadsW = 32 * W, kEach = kOrderPairs / kThreadsW;
  __shared__ int base[W * (R + 1)];  // counts of (row, warp), then first positions
  __shared__ int row_cta[R];         // this CTA's count of each row (read by the cluster)
  __shared__ int row_all[R];         // the cluster's count of each row
  __shared__ int row_lower[R];       // the count of each row in the CTAs of lower rank
  __shared__ int warp_sum[W];
  __shared__ int cta_below;          // this CTA's real slots of rows under the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (int)(blockIdx.x / kOrderCTAs) * R;
  const int rows = min(R, N - r0);
  for (int i = threadIdx.x; i < W * (R + 1); i += kThreadsW) base[i] = 0;
  __syncthreads();
  const long long cta_share = (P + kOrderCTAs - 1) / kOrderCTAs, share = (cta_share + W - 1) / W;
  const long long cta_hi = min(P, (q + 1) * cta_share);
  const long long lo = min(cta_hi, q * cta_share + warp * share), hi = min(cta_hi, lo + share);
  const unsigned below_lane = (1u << lane) - 1;

  // sweep 1: each (row, warp) pair's count; slots of lower rows
  int below = 0;
  for (long long s0 = lo; s0 < hi; s0 += 32 * kAhead) {
    long long id[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long s = s0 + 32 * j + lane;
      id[j] = s < hi ? (long long)ids[s] : -1;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (id[j] >= N) __trap();  // an id outside the table
      below += id[j] >= 0 && id[j] < r0;
      const long long u = id[j] - r0;
      const bool hit = u >= 0 && u < rows;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hits == 0) continue;
      if (hit) {
        const unsigned same = __match_any_sync(hits, (int)u);
        if (lane == __ffs(same) - 1) pair<R>(base, (int)u, warp) += __popc(same);
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
  if (lane == 0) warp_sum[warp] = below;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = 0;
    for (int w = 0; w < W; ++w) b += warp_sum[w];
    cta_below = b;
  }
  for (int u = threadIdx.x; u < R; u += kThreadsW) {
    int t = 0;
    for (int w = 0; w < W; ++w) t += pair<R>(base, u, w);
    row_cta[u] = t;
  }
  cluster_arrive();  // this CTA's totals are out
  cluster_wait();    // and every other CTA's

  // the cluster's totals, the counts of lower-rank CTAs, and the real slots
  // of rows under the cluster's, through distributed shared memory
  int below_all = 0;
  for (int p = 0; p < kOrderCTAs; ++p) below_all += *cluster.map_shared_rank(&cta_below, p);
  for (int u = threadIdx.x; u < R; u += kThreadsW) {
    int all = 0, lower = 0;
    for (int p = 0; p < kOrderCTAs; ++p) {
      const int t = cluster.map_shared_rank(row_cta, p)[u];
      all += t;
      lower += p < q ? t : 0;
    }
    row_all[u] = all;
    row_lower[u] = lower;
  }
  cluster_arrive();  // done with the other CTAs' memory; waited for before exit
  __syncthreads();

  // exclusive scan in (row, warp) order, each row's last entry carrying the
  // other CTAs' count of it, so that a row's entries add up to the
  // cluster's; thread t holds the entries [kEach t, kEach t + kEach)
  int cnt[kEach], sum = 0;
#pragma unroll
  for (int e = 0; e < kEach; ++e) {
    const int i = threadIdx.x * kEach + e, u = i / W, w = i % W;
    cnt[e] = pair<R>(base, u, w) + (w == W - 1 ? row_all[u] - row_cta[u] : 0);
    sum += cnt[e];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  __syncthreads();  // every warp has read warp_sum
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int start = below_all + incl - sum;
  for (int w = 0; w < warp; ++w) start += warp_sum[w];
#pragma unroll
  for (int e = 0; e < kEach; ++e) {
    const int i = threadIdx.x * kEach + e, u = i / W, w = i % W;
    pair<R>(base, u, w) = start + row_lower[u];
    start += cnt[e];
  }
  __syncthreads();
  if (q == 0) {
    for (int u = threadIdx.x; u < rows; u += kThreadsW) row_start[r0 + u] = pair<R>(base, u, 0);
    if (r0 + rows == N && threadIdx.x == kThreadsW - 1) row_start[N] = start;  // every real slot
  }

  // sweep 2: each slot at its pair's next position, in slot order
  for (long long s0 = lo; s0 < hi; s0 += 32 * kAhead) {
    long long id[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long s = s0 + 32 * j + lane;
      id[j] = s < hi ? (long long)ids[s] : -1;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long u = id[j] - r0;
      const bool hit = u >= 0 && u < rows;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hits == 0) continue;
      if (hit) {
        const unsigned same = __match_any_sync(hits, (int)u);
        const int pos = pair<R>(base, (int)u, warp) + __popc(same & below_lane);
        perm[pos] = (int)(s0 + 32 * j + lane);
        srow[pos] = r0 + (int)u;
        __syncwarp(same);  // the group has read its start before its leader moves it
        if (lane == __ffs(same) - 1) pair<R>(base, (int)u, warp) += __popc(same);
      }
      __syncwarp();
    }
  }
  cluster_wait();  // no CTA leaves while another may read its memory
}

// Backward 2: one warp a window of S sorted positions sums each chunk
// that starts in it into part[2 window + (first chunk of its row)].
template <int V, int I>
__global__ void __launch_bounds__(kThreads) chunk_sums_kernel(
    const float* __restrict__ g,          // [P0, D]
    const int* __restrict__ perm,         // [P] slot of each sorted position
    const int* __restrict__ srow,         // [P] row of each sorted position
    const float* __restrict__ id_mask,    // [P] or null
    const int* __restrict__ row_start,    // [N + 1]
    float* __restrict__ part,             // [2 n_windows, D]
    int n_windows, int N, int F, int D) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int n_sorted = row_start[N];
  if (w >= n_windows || w * kS >= n_sorted) return;  // the whole warp
  const int pos = w * kS + lane;
  int rs = 0, re = 0;
  bool first = false;
  if (pos < n_sorted) {
    const int i = srow[pos];
    rs = row_start[i];
    re = row_start[i + 1];
    first = re - rs > kS && (pos - rs) % kS == 0;
  }
  unsigned starts = __ballot_sync(0xffffffffu, first);
  const int c = blockIdx.y * kGroupCols + V * lane;
  while (starts) {  // at most two
    const int b = __ffs(starts) - 1;
    starts &= starts - 1;
    const int s0 = w * kS + b;
    const int row_first = __shfl_sync(0xffffffffu, rs, b), row_end = __shfl_sync(0xffffffffu, re, b);
    float acc[V * I];
#pragma unroll
    for (int i = 0; i < V * I; ++i) acc[i] = 0.0f;
    sum_run<V, I>(g, perm, id_mask, s0, min(kS, row_end - s0), F, D, c, 32 * V, 5, acc);
    store_row<V, I>(part + (size_t)(2 * w + (s0 == row_first)) * D, c, 32 * V, D, acc);
  }
}

// Backward 3: the rows [first, first + kWarps (32 >> lanes_log2)) of the
// dense gradient, each written once: a row of at most S slots by its 1 <<
// lanes_log2 lanes (as the forward's positions), its slots in slot order
// (zeros for none); then each row of more slots, in row order, by the
// block's warps together over column groups of 512: warp j the partials
// of chunks j, j + kWarps, ..., then the kWarps sums in warp order.
template <int V, int I>
__global__ void __launch_bounds__(kThreads) dense_rows_kernel(
    const float* __restrict__ g,          // [P0, D]
    const int* __restrict__ perm,         // [P]
    const float* __restrict__ id_mask,    // [P] or null
    const int* __restrict__ row_start,    // [N + 1]
    const float* __restrict__ part,       // [2 n_windows, D]
    float* __restrict__ dtable,           // [N, D]
    int N, int F, int D, int lanes_log2) {
  __shared__ float warp_part[kWarps][kGroupCols];
  __shared__ bool chunked[kThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_block = kWarps * (32 >> lanes_log2);
  const int first = blockIdx.x * per_block;
  const int r = warp * (32 >> lanes_log2) + (lane >> lanes_log2), i = first + r;
  int s0 = 0, s1 = 0;
  if (i < N) {
    s0 = row_start[i];
    s1 = row_start[i + 1];
  }
  if ((lane & ((1 << lanes_log2) - 1)) == 0) chunked[r] = s1 - s0 > kS;
  if (i < N && s1 - s0 <= kS) {
    const int c = blockIdx.y * kGroupCols + V * (lane & ((1 << lanes_log2) - 1));
    float acc[V * I];
#pragma unroll
    for (int e = 0; e < V * I; ++e) acc[e] = 0.0f;
    sum_run<V, I>(g, perm, id_mask, s0, s1 - s0, F, D, c, V << lanes_log2, lanes_log2, acc);
    store_row<V, I>(dtable + (size_t)i * D, c, V << lanes_log2, D, acc);
  }
  __syncthreads();
  // a warp a row in this part: I loads cover D here too (lanes_log2 < 5 means D <= 16 V)
  const int c = blockIdx.y * kGroupCols + V * lane;
  for (int rr = 0; rr < per_block; ++rr) {
    if (!chunked[rr]) continue;  // the same for every thread
    const int row = first + rr, a = row_start[row], K = (row_start[row + 1] - a + kS - 1) / kS;
    float acc[V * I];
#pragma unroll
    for (int e = 0; e < V * I; ++e) acc[e] = 0.0f;
    // chunk k's partial is part[2 ((a + k S) / S) + (k == 0)]
    int k = warp;
    for (; k + (kUnroll - 1) * kWarps < K; k += kUnroll * kWarps) {
      float v[kUnroll][V * I];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int at = a + (k + u * kWarps) * kS;
        load_row<V, I>(part + (size_t)(2 * (at / kS) + (at == a)) * D, c, 32 * V, D, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_scaled<V * I>(acc, v[u], 1.0f);
    }
    for (; k < K; k += kWarps) {
      const int at = a + k * kS;
      float v[V * I];
      load_row<V, I>(part + (size_t)(2 * (at / kS) + (at == a)) * D, c, 32 * V, D, v);
      add_scaled<V * I>(acc, v, 1.0f);
    }
#pragma unroll
    for (int t = 0; t < I; ++t)
#pragma unroll
      for (int e = 0; e < V; ++e) warp_part[warp][V * lane + 32 * V * t + e] = acc[V * t + e];
    __syncthreads();
    for (int col = threadIdx.x; col < kGroupCols && blockIdx.y * kGroupCols + col < D; col += kThreads) {
      float x = 0.0f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) x = __fadd_rn(x, warp_part[j][col]);
      dtable[(size_t)row * D + blockIdx.y * kGroupCols + col] = x;
    }
    __syncthreads();
  }
}

inline bool aligned(const void* p, uintptr_t bytes) { return p == nullptr || ((uintptr_t)p & (bytes - 1)) == 0; }

// Loads of V floats where D and every pointer allow: 4, else 2, else 1.
inline int vector_width(int D, const void* a, const void* b, const void* c = nullptr) {
  if (D % 4 == 0 && aligned(a, 16) && aligned(b, 16) && aligned(c, 16)) return 4;
  if (D % 2 == 0 && aligned(a, 8) && aligned(b, 8) && aligned(c, 8)) return 2;
  return 1;
}

// lanes a row: log2 of the fewest (a power of two, up to 32) whose loads of
// V floats cover D
inline int lanes_log2(int D, int V) {
  int lg = 0;
  while (lg < 5 && (V << lg) < D) ++lg;
  return lg;
}

// f(std::integral_constant<int, I>) for I, the loads of V floats a lane
// makes of a row: 1 with fewer than 32 lanes a row, else the fewest (a power
// of two) that cover D, at most 16 / V (a 512-column group).
template <int V, typename Fn>
void with_loads(int D, int lg, Fn&& f) {
  int I = 1;
  while (lg == 5 && I < 16 / V && 32 * V * I < D) I *= 2;
  switch (I) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: if constexpr (V <= 2) f(std::integral_constant<int, 8>{}); break;
    default: if constexpr (V == 1) f(std::integral_constant<int, 16>{}); break;
  }
}

// A launch of a row kernel over n rows: lanes a row as lanes_log2, column
// groups of 512 on grid.y with a warp a row.
inline dim3 row_grid(long long n, int D, int lg) {
  const long long per_block = (long long)kWarps * (32 >> lg);
  return dim3((unsigned)((n + per_block - 1) / per_block), lg == 5 ? (unsigned)((D + kGroupCols - 1) / kGroupCols) : 1u);
}

template <int V, typename Id>
void launch_fwd_v(const float* table, const Id* ids, const float* id_mask, float* out, long long P0, int F,
                  int N, int D, cudaStream_t s) {
  const int lg = lanes_log2(D, V);
  with_loads<V>(D, lg, [&](auto I) {
    gather_sum_fwd_kernel<V, decltype(I)::value, Id><<<row_grid(P0, D, lg), kThreads, 0, s>>>(
        table, ids, id_mask, out, P0, F, N, D, lg);
  });
}

template <typename Id>
int launch_fwd(const float* table, const Id* ids, const float* id_mask, float* out, long long P0, int F,
               int N, int D, cudaStream_t s) {
  switch (vector_width(D, table, out)) {
    case 4: launch_fwd_v<4>(table, ids, id_mask, out, P0, F, N, D, s); break;
    case 2: launch_fwd_v<2>(table, ids, id_mask, out, P0, F, N, D, s); break;
    default: launch_fwd_v<1>(table, ids, id_mask, out, P0, F, N, D, s); break;
  }
  return (int)cudaGetLastError();
}

template <typename Id>
void launch_order(const Id* ids, long long P, int N, int* row_start, int* perm, int* srow, cudaStream_t s) {
  if (N <= kWideRows) {
    const unsigned clusters = (unsigned)((N + kOrderPairs / 32 - 1) / (kOrderPairs / 32));
    order_kernel<32, Id><<<clusters * kOrderCTAs, 32 * 32, 0, s>>>(ids, P, N, row_start, perm, srow);
  } else {
    const unsigned clusters = (unsigned)((N + kOrderPairs / 8 - 1) / (kOrderPairs / 8));
    order_kernel<8, Id><<<clusters * kOrderCTAs, 32 * 8, 0, s>>>(ids, P, N, row_start, perm, srow);
  }
}

template <int V>
void launch_sums_v(const float* g, const int* perm, const int* srow, const float* id_mask, const int* row_start,
                   float* part, float* dtable, int n_windows, int N, int F, int D, cudaStream_t s) {
  with_loads<V>(D, 5, [&](auto I) {
    if (n_windows > 0) {
      const dim3 grid((unsigned)((n_windows + kWarps - 1) / kWarps), (unsigned)((D + kGroupCols - 1) / kGroupCols));
      chunk_sums_kernel<V, decltype(I)::value><<<grid, kThreads, 0, s>>>(g, perm, srow, id_mask, row_start, part,
                                                                        n_windows, N, F, D);
    }
  });
  const int lg = lanes_log2(D, V);
  with_loads<V>(D, lg, [&](auto I) {
    dense_rows_kernel<V, decltype(I)::value><<<row_grid(N, D, lg), kThreads, 0, s>>>(
        g, perm, id_mask, row_start, part, dtable, N, F, D, lg);
  });
}

// Bytes of the backward's scratch for P slots, N rows of D columns: the
// chunk partials [2 ceil(P / S), D] f32, then row_start [N + 1], perm [P]
// and srow [P] int32 (ops/gather_sum.py:bwd_scratch_bytes computes the
// same for its allocation).
inline long long bwd_scratch_bytes(long long P, int N, int D) {
  return 4 * (2 * ((P + kS - 1) / kS) * D + N + 1 + 2 * P);
}

}  // namespace

// out [P0, D] = the gather-sum of table [N, D] over ids [P0, F] (of
// id_bytes 2, 4 or 8 bytes each) times id_mask [P0, F] (or null).
extern "C" int seqrec_gather_sum_fwd_f32(const float* table, const void* ids, int id_bytes,
                                         const float* id_mask, float* out, long long P0, int F,
                                         int N, int D, void* stream) {
  if (P0 <= 0 || F <= 0 || N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id_bytes) {
    case 2: return launch_fwd(table, (const int16_t*)ids, id_mask, out, P0, F, N, D, s);
    case 4: return launch_fwd(table, (const int32_t*)ids, id_mask, out, P0, F, N, D, s);
    case 8: return launch_fwd(table, (const int64_t*)ids, id_mask, out, P0, F, N, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtable [N, D] from the cotangent g [P0, D], ids [P0, F] (id_bytes 2, 4
// or 8 each) and id_mask [P0, F] (or null), with scratch of at least
// bwd_scratch_bytes(P0 F, N, D) bytes, 16-byte aligned. Three launches on
// the stream; no host sync.
extern "C" int seqrec_gather_sum_bwd_f32(const float* g, const void* ids, int id_bytes, const float* id_mask,
                                         void* scratch, long long scratch_bytes, float* dtable, long long P0,
                                         int F, int N, int D, void* stream) {
  const long long P = P0 * F;
  if (P0 < 0 || F <= 0 || N <= 0 || D <= 0 || P > INT_MAX - kS || (id_bytes != 2 && id_bytes != 4 && id_bytes != 8) ||
      !aligned(scratch, 16) || scratch_bytes < bwd_scratch_bytes(P, N, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_windows = (int)((P + kS - 1) / kS);
  float* part = (float*)scratch;
  int* row_start = (int*)(part + (size_t)2 * n_windows * D);
  int* perm = row_start + N + 1;
  int* srow = perm + P;
  switch (id_bytes) {
    case 2: launch_order((const int16_t*)ids, P, N, row_start, perm, srow, s); break;
    case 4: launch_order((const int32_t*)ids, P, N, row_start, perm, srow, s); break;
    default: launch_order((const int64_t*)ids, P, N, row_start, perm, srow, s); break;
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  switch (vector_width(D, g, part, dtable)) {
    case 4: launch_sums_v<4>(g, perm, srow, id_mask, row_start, part, dtable, n_windows, N, F, D, s); break;
    case 2: launch_sums_v<2>(g, perm, srow, id_mask, row_start, part, dtable, n_windows, N, F, D, s); break;
    default: launch_sums_v<1>(g, perm, srow, id_mask, row_start, part, dtable, n_windows, N, F, D, s); break;
  }
  return (int)cudaGetLastError();
}
