// Launchers of the training scans' redesigned paths, shared by K1
// (gru_scan_train.cu, kLstm = false) and K5 (lstm_scan_train.cu, kLstm =
// true); the eval scans K3 (gru_scan.cu, below H=256) and K6
// (lstm_scan.cu) launch the same forward kernels without their state
// stores (kStoreStates = false). The
// wrapper's plan (ops/rnn_scan_train.py:train_scan_plan) picks the path and
// passes it as an int:
//   kPathReg     W_hid in registers, one block per tile of R rows
//                (scan_train_reg.cuh; H <= 50);
//   kPathCluster W_hid split over clusters of C CTAs, R rows a cluster
//                (scan_train_cluster.cuh; R in 8, 16, 24, 32);
//   kPathL2      the first port's single-block kernels (W_hid in shared
//                memory if it fits, else read through L2), for the shapes
//                no cluster slice holds.
// The cluster and l2 paths' dW = hs^T dhid is a product over the L B rows
// on block_mma.cuh's 3xTF32 tensor-core tiles (about f32 accuracy, as
// K2's dW), split over K with the partials summed in split order. Each
// kernel's shared-memory limit is raised once (allow_smem_once), not at
// every launch; a refused launch returns its error.

#pragma once

#include "block_mma.cuh"
#include "scan_train_cluster.cuh"
#include "scan_train_reg.cuh"
#include "split_sum.cuh"

namespace {

constexpr int kPathReg = 0;
constexpr int kPathCluster = 1;
constexpr int kPathL2 = 2;

template <typename Kernel, typename... Args>
int reg_launch(Kernel kernel, int grid, size_t smem, cudaStream_t stream, Args... args) {
  const int err = allow_smem_once((const void*)kernel, smem);
  if (err) return err;
  kernel<<<grid, kRegThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

inline bool reg_shape_ok(int H, int R) { return H <= kRegMaxH && R >= 1 && R <= kRegMaxRows; }

inline bool cluster_shape_ok(int H, int C) {
  return C >= 2 && C <= kClusterMax && H >= C && (H + C - 1) / C <= kTrainClusterUnits;
}

// k-major operand slice S[k][x] = src[(k0 + k) ld + x0 + x], zero outside
// [x_end, k_end): block_mma.cuh's 16-byte copies where ld is a multiple of
// 4 (kVec), else one 4-byte copy a float
template <bool kVec>
__device__ __forceinline__ void stage_k_major_any(float* S, const float* __restrict__ src, size_t ld,
                                                  int x0, int x_end, int k0, int k_end) {
  if (kVec) {
    stage_k_major(S, src, ld, x0, x_end, k0, k_end);
    return;
  }
  for (int e = threadIdx.x; e < kBK * kBT; e += kBThreads) {
    const int k = e / kBT, x = e - k * kBT;
    if (k0 + k < k_end && x0 + x < x_end) {
      cp_async4(S + k * kKS + x, src + (size_t)(k0 + k) * ld + x0 + x);
    } else {
      S[k * kKS + x] = 0.0f;
    }
  }
}

// part[z, m, n] = sum over the rows k of split z of A[k, m] Bm[k, n]
// (A [K, M], Bm [K, N]): one 128 x 128 tile of dW = hs^T dhid a block.
template <bool kVec>
__global__ void __launch_bounds__(kBThreads) dw_partial_kernel(const float* __restrict__ A,
                                                               const float* __restrict__ Bm,
                                                               float* __restrict__ part, int K, int M,
                                                               int N, int k_per_split) {
  extern __shared__ float ring[];
  const int m0 = blockIdx.x * kBT, n0 = blockIdx.y * kBT;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(K, k_begin + k_per_split);
  float acc[4][4][4];
  zero_block(acc);
  pipeline(
      (k_end - k_begin + kBK - 1) / kBK, ring,
      [&](int s, float* slot) {
        stage_k_major_any<kVec>(slot, A, M, m0, M, k_begin + s * kBK, k_end);
        stage_k_major_any<kVec>(slot + kSlice, Bm, N, n0, N, k_begin + s * kBK, k_end);
      },
      [&](int, const float* slot) { mma_slice<false, kKS, false, kKS>(slot, slot + kSlice, acc); });
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + frag_row(mt, e), n = n0 + frag_col(nt, e);
        if (m < M && n < N) out[(size_t)m * N + n] = acc[mt][nt][e];
      }
    }
  }
}

// out [M, N] = A^T Bm for A [K, M], Bm [K, N], the K rows in n_splits
// ranges of k_per_split, one partial each in part [n_splits, M, N], summed
// in split order. No atomics: the same bits run after run.
inline int launch_dw(const float* A, const float* Bm, float* part, float* out, int K, int M, int N,
                     int n_splits, int k_per_split, cudaStream_t stream) {
  const bool vec = M % 4 == 0 && N % 4 == 0;
  const void* kernel = vec ? (const void*)dw_partial_kernel<true> : (const void*)dw_partial_kernel<false>;
  const size_t smem = sizeof(float) * kStages * kSlot;
  int err = allow_smem_once(kernel, smem);
  if (err) return err;
  const dim3 grid((M + kBT - 1) / kBT, (N + kBT - 1) / kBT, n_splits);
  if (vec) {
    dw_partial_kernel<true><<<grid, kBThreads, smem, stream>>>(A, Bm, part, K, M, N, k_per_split);
  } else {
    dw_partial_kernel<false><<<grid, kBThreads, smem, stream>>>(A, Bm, part, K, M, N, k_per_split);
  }
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_sum_splits(part, out, n_splits, (size_t)M * N, stream);
}

template <bool kLstm, bool kStoreStates = true>
auto cluster_forward_instance(int R) -> decltype(&cluster_forward_kernel<kLstm, 1, kStoreStates>) {
  switch (R) {
    case 8: return cluster_forward_kernel<kLstm, 1, kStoreStates>;
    case 16: return cluster_forward_kernel<kLstm, 2, kStoreStates>;
    case 24: return cluster_forward_kernel<kLstm, 3, kStoreStates>;
    case 32: return cluster_forward_kernel<kLstm, 4, kStoreStates>;
    default: return nullptr;
  }
}

template <bool kLstm>
auto cluster_backward_instance(int R) -> decltype(&cluster_backward_kernel<kLstm, 1>) {
  switch (R) {
    case 8: return cluster_backward_kernel<kLstm, 1>;
    case 16: return cluster_backward_kernel<kLstm, 2>;
    case 24: return cluster_backward_kernel<kLstm, 3>;
    case 32: return cluster_backward_kernel<kLstm, 4>;
    default: return nullptr;
  }
}

// The forward on the reg or cluster path (h0, c0 -> out, and with
// kStoreStates the training scan's hs, cs; without, the eval scan's final
// state alone, hs and cs unused).
template <bool kLstm, bool kStoreStates = true>
int train_forward(const float* x, const float* mask, const float* w, const float* peep,
                  const float* h0, const float* c0, float* out, float* hs, float* cs, int B, int L,
                  int H, int path, int C, int R, cudaStream_t stream) {
  constexpr int NG = kLstm ? 4 : 3;
  if (path == kPathReg) {
    if (!reg_shape_ok(H, R)) return (int)cudaErrorInvalidValue;
    return reg_launch(reg_forward_kernel<kLstm, kStoreStates>, (B + R - 1) / R,
                      sizeof(float) * reg_fwd_floats(NG, H, R), stream, x, mask, w, peep, h0, c0,
                      out, hs, cs, B, L, H, R);
  }
  if (path != kPathCluster || !cluster_shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  auto kernel = cluster_forward_instance<kLstm, kStoreStates>(R);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return cluster_launch(kernel, (B + R - 1) / R, C, sizeof(float) * cluster_fwd_floats(NG, H, C, R),
                        stream, x, mask, w, peep, h0, c0, out, hs, cs, B, L, H);
}

// The backward's scan on the reg path: dW (and dpeep) straight into dw
// (dpeep) where one block holds every row, else per-block partials in part
// (peep_part) summed in block order.
template <bool kLstm>
int train_backward_reg(const float* x, const float* mask, const float* w, const float* peep,
                       const float* hs, const float* cs, const float* dh, float* dx, float* dh0,
                       float* dc0, float* dw, float* dpeep, float* part, float* peep_part, int B,
                       int L, int H, int R, float clip, cudaStream_t stream) {
  constexpr int NG = kLstm ? 4 : 3;
  if (!reg_shape_ok(H, R)) return (int)cudaErrorInvalidValue;
  const int grid = (B + R - 1) / R;
  if (grid > 1 && (part == nullptr || (kLstm && peep_part == nullptr))) return (int)cudaErrorInvalidValue;
  int err = reg_launch(reg_backward_kernel<kLstm>, grid, sizeof(float) * reg_bwd_floats(NG, H, R),
                       stream, x, mask, w, peep, hs, cs, dh, dx, dh0, dc0, grid > 1 ? part : dw,
                       grid > 1 ? peep_part : dpeep, B, L, H, R, clip);
  if (err || grid == 1) return err;
  err = launch_sum_splits(part, dw, grid, (size_t)H * NG * H, stream);
  if (err || !kLstm) return err;
  return launch_sum_splits(peep_part, dpeep, grid, (size_t)3 * H, stream);
}

// The backward's scan on the cluster path: dx, dh0 (dc0), the dhid scratch
// [L, B, G] for the dW product, and (LSTM) dpeep from the per-cluster
// partials summed in cluster order, or straight from a single cluster.
template <bool kLstm>
int train_backward_cluster(const float* x, const float* mask, const float* w, const float* peep,
                           const float* hs, const float* cs, const float* dh, float* dx,
                           float* dh0, float* dc0, float* dhid, float* dpeep, float* peep_part,
                           int B, int L, int H, int C, int R, float clip, cudaStream_t stream) {
  constexpr int NG = kLstm ? 4 : 3;
  if (!cluster_shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  auto kernel = cluster_backward_instance<kLstm>(R);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int clusters = (B + R - 1) / R;
  if (kLstm && clusters > 1 && peep_part == nullptr) return (int)cudaErrorInvalidValue;
  int err = cluster_launch(kernel, clusters, C, sizeof(float) * cluster_bwd_floats(NG, H, C, R),
                           stream, x, mask, w, peep, hs, cs, dh, dx, dh0, dc0, dhid,
                           clusters > 1 ? peep_part : dpeep, B, L, H, clip);
  if (err || !kLstm || clusters == 1) return err;
  return launch_sum_splits(peep_part, dpeep, clusters, (size_t)3 * H, stream);
}

// floats of the l2 kernels' state, W_hid not counted (they stage it only
// where it fits beside this): the forward's h [R, H] (and c) and hid
// [R, nG H] (gru_forward.cuh, lstm_forward.cuh); the GRU backward's hp, dh,
// dd [R, H] and hid [R, 3H]; the LSTM backward's hp, cp, dh, dc [R, H], hid
// [R, 4H], dp [R, 3H], pacc [3H] and keep [R]
inline size_t l2_train_floats(int n_gates, int backward, int H, int R) {
  if (!backward) return (size_t)R * (n_gates == 4 ? 6 : 4) * H;
  return n_gates == 4 ? (size_t)R * 11 * H + 3 * H + R : (size_t)R * 6 * H;
}

// Shared-memory bytes of one block (CTA) of the path's forward (backward =
// 0) or backward kernel at (H, C, R), as its launcher asks for them; -1
// for a shape no kernel of that path takes. The wrapper's plan holds its
// own copy of these sizes against this on the card.
template <bool kLstm>
long long train_smem_bytes(int backward, int path, int H, int C, int R) {
  constexpr int NG = kLstm ? 4 : 3;
  if (H <= 0 || R <= 0) return -1;
  size_t floats;
  if (path == kPathReg && reg_shape_ok(H, R)) {
    floats = backward ? reg_bwd_floats(NG, H, R) : reg_fwd_floats(NG, H, R);
  } else if (path == kPathCluster && cluster_shape_ok(H, C) &&
             cluster_forward_instance<kLstm>(R) != nullptr) {
    floats = backward ? cluster_bwd_floats(NG, H, C, R) : cluster_fwd_floats(NG, H, C, R);
  } else if (path == kPathL2 && R <= kMaxRows) {
    floats = l2_train_floats(NG, backward, H, R);
  } else {
    return -1;
  }
  return (long long)(sizeof(float) * floats);
}

// How many clusters of the forward (backward = 0; the storing form, or
// without kStoreStates the eval form) or backward kernel at (H, C, R) the
// card holds at once.
template <bool kLstm, bool kStoreStates = true>
int train_cluster_capacity(int backward, int H, int C, int R, int* n_clusters) {
  constexpr int NG = kLstm ? 4 : 3;
  if (!cluster_shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  const void* kernel = backward ? (const void*)cluster_backward_instance<kLstm>(R)
                                : (const void*)cluster_forward_instance<kLstm, kStoreStates>(R);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (backward ? cluster_bwd_floats(NG, H, C, R) : cluster_fwd_floats(NG, H, C, R));
  const int err = allow_smem_once(kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, 1, C, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, kernel, &cfg);
}

}  // namespace
