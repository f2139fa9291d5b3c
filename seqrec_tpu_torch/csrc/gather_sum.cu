// Multi-hot gather-sum of an input table, and its dense table gradient:
// the input layer of every recurrent tower (models/recurrent.py: the
// embedding and each first layer's W_in), forward and backward.
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
// 0 at every padded step.
//
// Design:
// - forward: one warp a position; lanes over a column group of up to 512
//   columns (16-byte loads where D and the pointers allow, else 4-byte),
//   the F slots added in slot order into registers, one store.
// - backward: the wrapper sorts the slots by id (stably, so each id's
//   slots stay in ascending order; pad slots sort last under the sentinel
//   N), and its segment_plan cuts each id's run of more than S slots into
//   chunks of S, the last one shorter (ops/gather_sum.py): row_start
//   [N + 1] bounds each id's run, row_chunk [N + 1] its chunks. Pass 1,
//   chunk_sums_kernel: one warp a chunk finds its id (a binary search of
//   row_chunk) and sums its slots' rows, times id_mask, in slot order into
//   a partial [D] in scratch. Pass 2, dense_rows_kernel: one warp a
//   row of the dense gradient writes it once: the sum of its chunk
//   partials in chunk order; for an id of at most S slots, the sum of its
//   rows in slot order (what its one chunk would hold); zeros for an id
//   with no slot. The zero fill is part of the one write of the gradient.
// Every sum is a fixed sequence of round-to-nearest adds (no contraction
// into FMAs), so ops/gather_sum.py's order is the whole story and two
// calls give the same bits. No atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupCols = 512;  // columns of one column group (grid.y)
constexpr int kPer = 16;         // floats a lane holds of a column group
constexpr int kUnroll = 4;       // rows loaded before they are added

// A lane's columns of a column group starting at c0: with kVec four
// float4s at c0 + 4 lane + 128 i, else sixteen floats at c0 + lane + 32 i.
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int c0, int D,
                                         float v[kPer]) {
  const int lane = threadIdx.x & 31;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const int c = c0 + 128 * i + 4 * lane;
      const float4 q = c < D ? __ldg(reinterpret_cast<const float4*>(row + c))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = c0 + 32 * i + lane;
      v[i] = c < D ? __ldg(row + c) : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ row, int c0, int D,
                                          const float v[kPer]) {
  const int lane = threadIdx.x & 31;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const int c = c0 + 128 * i + 4 * lane;
      if (c < D)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = c0 + 32 * i + lane;
      if (c < D) row[c] = v[i];
    }
  }
}

// acc += m v, as a round-to-nearest product and add (m = 1 without id_mask)
__device__ __forceinline__ void add_scaled(float acc[kPer], const float v[kPer], float m) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], m));
}

// acc += the rows of the sorted slots [s0, s1) of g, each times its
// id_mask, in slot order (kUnroll rows loaded, then added in order).
template <bool kVec>
__device__ __forceinline__ void sum_slots(const float* __restrict__ g,
                                          const int64_t* __restrict__ perm,
                                          const float* __restrict__ id_mask, int s0, int s1,
                                          int F, int D, int c0, float acc[kPer]) {
  int j = s0;
  for (; j + kUnroll <= s1; j += kUnroll) {
    float v[kUnroll][kPer], m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t slot = perm[j + u];
      m[u] = id_mask != nullptr ? id_mask[slot] : 1.0f;
      load_row<kVec>(g + (size_t)(slot / F) * D, c0, D, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_scaled(acc, v[u], m[u]);
  }
  for (; j < s1; ++j) {
    const int64_t slot = perm[j];
    float v[kPer];
    load_row<kVec>(g + (size_t)(slot / F) * D, c0, D, v);
    add_scaled(acc, v, id_mask != nullptr ? id_mask[slot] : 1.0f);
  }
}

template <bool kVec, typename Id>
__global__ void __launch_bounds__(kThreads) gather_sum_fwd_kernel(
    const float* __restrict__ table,    // [N, D]
    const Id* __restrict__ ids,         // [P0, F]
    const float* __restrict__ id_mask,  // [P0, F] or null
    float* __restrict__ out,            // [P0, D]
    long long P0, int F, int N, int D) {
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P0) return;
  const int c0 = blockIdx.y * kGroupCols;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  for (int f = 0; f < F; ++f) {
    const long long id = (long long)ids[p * F + f];
    if (id < 0) continue;  // a pad slot adds nothing
    if (id >= N) __trap();  // an id outside the table: fail loudly, as indexing does
    float v[kPer];
    load_row<kVec>(table + (size_t)id * D, c0, D, v);
    add_scaled(acc, v, id_mask != nullptr ? id_mask[p * F + f] : 1.0f);
  }
  store_row<kVec>(out + (size_t)p * D, c0, D, acc);
}

// Pass 1: part[c] = the rows of chunk c's slots in slot order. Chunk c
// belongs to the id i with row_chunk[i] <= c < row_chunk[i + 1] and covers
// the slots [row_start[i] + (c - row_chunk[i]) S, that + S), cut at the
// run's end; chunks past row_chunk[N] (the grid's bound is larger) do
// nothing.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) chunk_sums_kernel(
    const float* __restrict__ g,            // [P0, D]
    const int64_t* __restrict__ perm,       // [P0 F] slots in sorted order
    const float* __restrict__ id_mask,      // [P0 F] or null
    const int* __restrict__ row_start,      // [N + 1]
    const int* __restrict__ row_chunk,      // [N + 1]
    float* __restrict__ part,               // [n_chunks, D]
    int n_chunks, int N, int S, int F, int D) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks || c >= row_chunk[N]) return;
  int lo = 0, hi = N;  // row_chunk[lo] <= c < row_chunk[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (row_chunk[mid] <= c) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int s0 = row_start[lo] + (c - row_chunk[lo]) * S;
  const int s1 = min(s0 + S, row_start[lo + 1]);
  const int c0 = blockIdx.y * kGroupCols;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  sum_slots<kVec>(g, perm, id_mask, s0, s1, F, D, c0, acc);
  store_row<kVec>(part + (size_t)c * D, c0, D, acc);
}

// Pass 2: row i of the dense gradient, written once: its chunk partials
// [row_chunk[i], row_chunk[i + 1]) in chunk order, or, without chunks, its
// slots [row_start[i], row_start[i + 1]) in slot order (none: zeros).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) dense_rows_kernel(
    const float* __restrict__ g,          // [P0, D]
    const int64_t* __restrict__ perm,     // [P0 F]
    const float* __restrict__ id_mask,    // [P0 F] or null
    const int* __restrict__ row_start,    // [N + 1]
    const int* __restrict__ row_chunk,    // [N + 1]
    const float* __restrict__ part,       // [n_chunks, D]
    float* __restrict__ dtable,           // [N, D]
    int N, int F, int D) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N) return;
  const int c0 = blockIdx.y * kGroupCols;
  // the row's four plan entries in one round trip (most rows are zeros)
  const int k0 = row_chunk[i], k1 = row_chunk[i + 1];
  const int s0 = row_start[i], s1 = row_start[i + 1];
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.0f;
  if (k0 < k1) {
    int k = k0;
    for (; k + kUnroll <= k1; k += kUnroll) {
      float v[kUnroll][kPer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_row<kVec>(part + (size_t)(k + u) * D, c0, D, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_scaled(acc, v[u], 1.0f);
    }
    for (; k < k1; ++k) {
      float v[kPer];
      load_row<kVec>(part + (size_t)k * D, c0, D, v);
      add_scaled(acc, v, 1.0f);
    }
  } else {
    sum_slots<kVec>(g, perm, id_mask, s0, s1, F, D, c0, acc);
  }
  store_row<kVec>(dtable + (size_t)i * D, c0, D, acc);
}

inline bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

template <typename Id>
int launch_fwd(const float* table, const Id* ids, const float* id_mask, float* out, long long P0,
               int F, int N, int D, cudaStream_t stream) {
  const dim3 grid((unsigned)((P0 + kWarps - 1) / kWarps), (unsigned)((D + kGroupCols - 1) / kGroupCols));
  if (D % 4 == 0 && aligned16(table) && aligned16(out)) {
    gather_sum_fwd_kernel<true, Id><<<grid, kThreads, 0, stream>>>(table, ids, id_mask, out, P0, F, N, D);
  } else {
    gather_sum_fwd_kernel<false, Id><<<grid, kThreads, 0, stream>>>(table, ids, id_mask, out, P0, F, N, D);
  }
  return (int)cudaGetLastError();
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

// dtable [N, D] from the cotangent g [P0, D], the slots sorted by id (perm
// [P0 F]) and segment_plan's row_start, row_chunk [N + 1] for chunks of S
// slots; part [n_chunks, D] is scratch for at least row_chunk[N] chunks
// (the wrapper's bound; pass 1 runs a warp for each and is not launched
// where n_chunks = 0).
extern "C" int seqrec_gather_sum_bwd_f32(const float* g, const int64_t* perm, const float* id_mask,
                                         const int* row_start, const int* row_chunk, float* part,
                                         float* dtable, int n_chunks, int N, int S, int F, int D,
                                         void* stream) {
  if (N <= 0 || S <= 0 || F <= 0 || D <= 0 || n_chunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned groups = (unsigned)((D + kGroupCols - 1) / kGroupCols);
  const bool vec = D % 4 == 0 && aligned16(g) && aligned16(part) && aligned16(dtable);
  if (n_chunks > 0) {
    const dim3 grid((unsigned)((n_chunks + kWarps - 1) / kWarps), groups);
    if (vec) {
      chunk_sums_kernel<true><<<grid, kThreads, 0, s>>>(g, perm, id_mask, row_start, row_chunk, part,
                                                        n_chunks, N, S, F, D);
    } else {
      chunk_sums_kernel<false><<<grid, kThreads, 0, s>>>(g, perm, id_mask, row_start, row_chunk, part,
                                                         n_chunks, N, S, F, D);
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const dim3 grid((unsigned)((N + kWarps - 1) / kWarps), groups);
  if (vec) {
    dense_rows_kernel<true><<<grid, kThreads, 0, s>>>(g, perm, id_mask, row_start, row_chunk, part, dtable,
                                                      N, F, D);
  } else {
    dense_rows_kernel<false><<<grid, kThreads, 0, s>>>(g, perm, id_mask, row_start, row_chunk, part, dtable,
                                                       N, F, D);
  }
  return (int)cudaGetLastError();
}
