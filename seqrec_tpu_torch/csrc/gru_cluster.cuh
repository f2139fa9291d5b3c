// K3's gru_cluster path: the forward GRU over time (final state only)
// with W_hid split over the 8 CTAs of a thread-block cluster, up to 64
// units a CTA and 64 rows a cluster, for H from 256 (GRU-256 serving,
// where it measured faster than the training forward's cluster kernel)
// to about 368 on an H100, past that kernel's 32 units a CTA (H=256:
// W_hid is 786 KB against the 227 KB a block may use).
//
// Replaces, with the training scan's forward kernels below H=256 and
// gru_forward.cuh's single-block kernel past this kernel's reach (all
// launched by gru_scan.cu), seqrec_tpu/ops/pallas_rnn.py:_gru_scan_kernel
// (reached through gru_scan). Same math, gate order reset|update|candidate:
//   hid = h . W_hid
//   r = sigmoid(x_r + hid_r), u = sigmoid(x_u + hid_u), c = tanh(x_c + r * hid_c)
//   h' = (1 - u) * h + u * c, kept only where mask > 0.
//
// What bounds it on an H100: f32 operations of the per-step product, and
// the L steps' dependence. At B=512, L=30, H=256 the work is 6.04 GFLOP
// (0.090 ms at 67 TFLOP/s) against 47 MB of x_pre. The single-block kernel
// streamed all of W_hid from L2 in every block and every step (3 GB of L2
// reads a launch) to feed 4 rows.
//
// Design: a cluster of C CTAs (C = 8, the portable maximum) owns a tile of
// R batch rows for all L steps. CTA q owns the hidden units
// [q H / C, (q + 1) H / C) (any H: the split may be uneven) and keeps their
// r|u|c columns of W_hid in its own shared memory, [H, 3U] with
// U = ceil(H / C), loaded once. Each CTA also holds the full h [R, H] of
// the tile, double-buffered by step parity. In a step, warp w owns rows
// w, w + 8, ... and lane l units l, l + 32 of the CTA's slice, and each
// thread keeps its rows' three gate sums of its units in registers
// (register tiling: a W_hid element feeds every row of the thread, an h
// float4, read as a broadcast, feeds all three gates), so the gate math
// follows the product with no barrier and no hid buffer. The new h of a
// unit is stored into the next-step buffer of every CTA of the cluster
// through distributed shared memory; one cluster barrier a step then
// orders those stores before the next step's reads, and the other buffer
// is not read until after the next barrier. The step's x_pre and mask are
// loaded into registers before the product, so their latency hides behind
// it. Rows past B compute on zeros and are never written out. The
// cell-independent pieces (the unit split, the barrier, the launch) are in
// cluster_common.cuh, shared with the training scans' cluster paths.

#pragma once

#include <cooperative_groups.h>

#include "cluster_common.cuh"
#include "scan_common.cuh"

namespace {

namespace cg = cooperative_groups;

inline size_t gru_cluster_smem(int H, int C, int R) {
  const size_t U = (size_t)(H + C - 1) / C;
  return sizeof(float) * ((size_t)h_stride(H) * 3 * U + 2 * (size_t)R * h_stride(H));
}

// x_pre's three gate inputs and the mask of step t for the thread's rows
// (warp + 8 i) and units (lane + 32 s); zeros outside the batch and slice
template <int kRPT, int kUPT>
__device__ __forceinline__ void load_step_inputs(const float* __restrict__ x,
                                                 const float* __restrict__ mask, int B, int L,
                                                 int H, int row0, int u0, int nu, int t,
                                                 float xg[kRPT][kUPT][3], float keep[kRPT]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int b = row0 + warp + kClusterWarps * i;
    keep[i] = b < B ? mask[(size_t)b * L + t] : 0.0f;
#pragma unroll
    for (int s = 0; s < kUPT; ++s) {
      const int j = lane + 32 * s;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xg[i][s][g] = (b < B && j < nu) ? x[((size_t)b * L + t) * 3 * H + g * H + u0 + j] : 0.0f;
    }
  }
}

template <int kRPT, int kUPT>
__global__ void __launch_bounds__(kClusterThreads, 1) gru_cluster_kernel(
    const float* __restrict__ x,     // [B, L, 3H]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, 3H]
    const float* __restrict__ h0,    // [B, H]
    float* __restrict__ out,         // [B, H]
    int B, int L, int H) {
  constexpr int R = kRPT * kClusterWarps;
  extern __shared__ float smem[];  // 16-byte aligned, as dynamic shared memory is
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * R;
  const int Hp = h_stride(H), G = 3 * H;
  const int U = (H + C - 1) / C, GU = 3 * U;
  const int u0 = unit_begin(q, H, C), nu = unit_begin(q + 1, H, C) - u0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ws = smem;                    // [Hp, 3U]: ws[k, g U + j] = w[k, g H + u0 + j]
  float* hbuf = ws + (size_t)Hp * GU;  // [2, R, Hp]

  for (int i = threadIdx.x; i < Hp * GU; i += kClusterThreads) {
    const int k = i / GU, c = i - k * GU, g = c / U, j = c - g * U;
    ws[i] = (k < H && j < nu) ? w[(size_t)k * G + g * H + u0 + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < R * Hp; i += kClusterThreads) {
    const int r = i / Hp, k = i - r * Hp;
    hbuf[i] = (row0 + r < B && k < H) ? h0[(size_t)(row0 + r) * H + k] : 0.0f;
    hbuf[R * Hp + i] = 0.0f;
  }
  float xg[kRPT][kUPT][3], keep[kRPT];
  if (L > 0) load_step_inputs<kRPT, kUPT>(x, mask, B, L, H, row0, u0, nu, 0, xg, keep);
  // every CTA of the cluster runs and is set up before any remote store
  cluster.sync();

  for (int t = 0; t < L; ++t) {
    const float* hc = hbuf + (t & 1) * R * Hp;
    float* hn = hbuf + ((t + 1) & 1) * R * Hp;
    float acc[kRPT][kUPT][3];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
#pragma unroll
      for (int s = 0; s < kUPT; ++s) {
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[i][s][g] = 0.0f;
      }
    }
    // hid of the thread's rows and units. Lanes past the CTA's units read
    // columns of the next gate or row (inside shared memory) and are
    // never stored.
    for (int k = 0; k < Hp; k += 4) {
      float4 hv[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
        hv[i] = *reinterpret_cast<const float4*>(hc + (warp + kClusterWarps * i) * Hp + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[kUPT][3];
#pragma unroll
        for (int s = 0; s < kUPT; ++s) {
#pragma unroll
          for (int g = 0; g < 3; ++g) wv[s][g] = ws[(k + kk) * GU + g * U + lane + 32 * s];
        }
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const float hk = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
#pragma unroll
          for (int s = 0; s < kUPT; ++s) {
#pragma unroll
            for (int g = 0; g < 3; ++g) acc[i][s][g] = fmaf(hk, wv[s][g], acc[i][s][g]);
          }
        }
      }
    }
    // gate math; masked rows carry h. Each new value goes to every CTA.
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = warp + kClusterWarps * i;
#pragma unroll
      for (int s = 0; s < kUPT; ++s) {
        const int j = lane + 32 * s;
        if (j < nu) {
          const int e = r * Hp + u0 + j;
          const float h_old = hc[e];
          float h_new = h_old;
          if (keep[i] > 0.0f) {
            const float rg = sigmoid_f(xg[i][s][0] + acc[i][s][0]);
            const float u = sigmoid_f(xg[i][s][1] + acc[i][s][1]);
            const float c = tanhf(xg[i][s][2] + rg * acc[i][s][2]);
            h_new = (1.0f - u) * h_old + u * c;
          }
          for (int p = 0; p < C; ++p) cluster.map_shared_rank(hn, p)[e] = h_new;
        }
      }
    }
    // the cluster barrier, split: the next step's inputs load while the
    // other CTAs finish this step
    cluster_arrive();
    if (t + 1 < L) load_step_inputs<kRPT, kUPT>(x, mask, B, L, H, row0, u0, nu, t + 1, xg, keep);
    cluster_wait();
  }
  const float* hf = hbuf + (L & 1) * R * Hp;
  for (int i = threadIdx.x; i < R * nu; i += kClusterThreads) {
    const int r = i / nu, j = i - r * nu;
    if (row0 + r < B) out[(size_t)(row0 + r) * H + u0 + j] = hf[r * Hp + u0 + j];
  }
}

// The kernel instance of R rows (R / 8 rows a thread) and ceil(U / 32)
// units a lane; nullptr where there is none.
template <int kUPT>
inline auto gru_cluster_rows(int R) -> decltype(&gru_cluster_kernel<1, kUPT>) {
  switch (R) {
    case 8: return gru_cluster_kernel<1, kUPT>;
    case 16: return gru_cluster_kernel<2, kUPT>;
    case 32: return gru_cluster_kernel<4, kUPT>;
    case 40: return gru_cluster_kernel<5, kUPT>;
    case 48: return gru_cluster_kernel<6, kUPT>;
    case 64: return gru_cluster_kernel<8, kUPT>;
    default: return nullptr;
  }
}

inline auto gru_cluster_instance(int R, int U) -> decltype(&gru_cluster_kernel<1, 1>) {
  const int upt = (U + 31) / 32;
  return upt == 1 ? gru_cluster_rows<1>(R) : upt == 2 ? gru_cluster_rows<2>(R) : nullptr;
}

int launch_gru_cluster(const float* x, const float* mask, const float* w, const float* h0,
                       float* out, int B, int L, int H, int C, int R, cudaStream_t stream) {
  if (B <= 0 || L < 0 || H <= 0 || C < 2 || C > kClusterMax || H < C)
    return (int)cudaErrorInvalidValue;
  auto kernel = gru_cluster_instance(R, (H + C - 1) / C);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return cluster_launch(kernel, (B + R - 1) / R, C, gru_cluster_smem(H, C, R), stream, x, mask,
                        w, h0, out, B, L, H);
}

// How many clusters of this plan the card holds at once (all CTAs resident).
int gru_cluster_capacity(int H, int C, int R, int* n_clusters) {
  if (H <= 0 || C < 2 || C > kClusterMax || H < C) return (int)cudaErrorInvalidValue;
  auto kernel = gru_cluster_instance(R, (H + C - 1) / C);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = gru_cluster_smem(H, C, R);
  const int err = allow_smem_once((const void*)kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, 1, C, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, (void*)kernel, &cfg);
}

}  // namespace
