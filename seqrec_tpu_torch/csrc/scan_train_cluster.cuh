// The training scans' "cluster" path (K1 and K5 at the large-catalog
// paths' B=1024, L=30, H=128): W_hid split over the CTAs of a thread-block
// cluster, forward and backward, GRU and LSTM.
//
// What bounds it on an H100: f32 FMAs of the per-step products and the L
// steps' dependence. K1's backward at B1024/L30/H128 is 9.1 GFLOP (0.135
// ms at 67 TFLOP/s), K5's 12.1. The kernels before this one read all of
// W_hid (and a transposed copy) through L2 in every block and every step
// to feed 8 rows: W and W^T are 393 KB (GRU) and 524 KB (LSTM), above the
// 227 KB a block may use.
//
// Design (gru_cluster.cuh's, K3's): a cluster of C CTAs owns a tile of R
// batch rows for all L steps; CTA q owns the units [u0, u0 + nu) (at most
// U = ceil(H / C) <= 32, one a lane), warp w the rows w, w + 8, ... Each
// thread keeps its rows' gate values of its unit in registers.
// - forward: CTA q holds W[:, cols(q)] (its units' gate columns), [Hp, nG
//   U]; it computes those gates from the tile's full h (double-buffered by
//   step parity), keeps c of its units in registers (LSTM), stores h_{t-1}
//   (and c_{t-1}) of its units for the backward, and stores each new h into
//   the next-step buffer of every CTA through distributed shared memory;
//   one split cluster barrier a step, the next step's x_pre and mask
//   loaded between its arrive and its wait.
// - backward: CTA q holds W[:, cols(q)] and, transposed, its units' rows
//   W[units(q), :] as [G, U]: two 1/C slices, no W^T copy. A step: the
//   tile's h_{t-1} arrives in shared memory by cp.async, issued a step
//   ahead; the CTA recomputes its units' gates, forms dx, the clipped
//   dhid (dpre) and, for the LSTM, dc and the dpeep terms, all for its own
//   units, in registers; it stores its slice of dhid into every CTA's
//   dhid buffer (double-buffered by step parity) and into the dW scratch;
//   one cluster barrier; then dh_{t-1} of its own units from the full dhid
//   and its rows of W. dh and dc never leave the thread that owns the
//   (row, unit). (Recomputing the next step's gates between the barrier's
//   arrive and wait, with a third h buffer, measured no faster: the
//   arrive waits for the remote stores.)
// The dW product over the L B rows of hs and the dhid scratch, and the
// ordered sums of the dpeep partials per cluster, are the launcher's.
// Rows past B compute on zeros and are never written out. No atomics.

#pragma once

#include <cooperative_groups.h>

#include "cluster_common.cuh"
#include "scan_cells.cuh"

namespace {

namespace cgt = cooperative_groups;

constexpr int kTrainClusterUnits = 32;  // units of one CTA: one a lane

// floats of shared memory of one CTA (the launchers' and the plan's)
__host__ __device__ inline int cluster_fwd_floats(int n_gates, int H, int C, int R) {
  const int U = (H + C - 1) / C;
  return h_stride(H) * n_gates * U + 2 * R * h_stride(H);  // W slice, h [2, R, Hp]
}
__host__ __device__ inline int cluster_bwd_floats(int n_gates, int H, int C, int R) {
  const int U = (H + C - 1) / C, Gp = h_stride(n_gates * H);
  // W[:, cols(q)] [Hp, nG U], W[units(q), :]^T [Gp, U], h [2, R, Hp], dhid [2, R, Gp]
  return h_stride(H) * n_gates * U + Gp * U + 2 * R * h_stride(H) + 2 * R * Gp;
}

// ws[k, g U + j] = w[k, g H + u0 + j] for k < Hp; zeros outside W and past
// the CTA's units
__device__ __forceinline__ void load_w_cols(const float* __restrict__ w, float* ws, int H,
                                            int n_gates, int U, int u0, int nu) {
  const int GU = n_gates * U, Hp = h_stride(H);
  for (int i = threadIdx.x; i < Hp * GU; i += kClusterThreads) {
    const int k = i / GU, c = i - k * GU, g = c / U, j = c - g * U;
    ws[i] = (k < H && j < nu) ? w[(size_t)k * n_gates * H + g * H + u0 + j] : 0.0f;
  }
}

// x_pre of the thread's unit's gates, the mask (and c_{t-1} of the unit,
// for the LSTM backward) of step t for its rows; zeros outside
template <int kRPT, int NG>
__device__ __forceinline__ void load_cluster_inputs(const float* __restrict__ x,
                                                    const float* __restrict__ mask,
                                                    const float* __restrict__ cs, int B, int L,
                                                    int H, int row0, int u0, int nu, int t,
                                                    float xg[kRPT][NG], float keep[kRPT],
                                                    float cprev[kRPT]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int b = row0 + warp + kClusterWarps * i;
    const bool in = b < B && lane < nu;
    keep[i] = b < B ? mask[(size_t)b * L + t] : 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g) xg[i][g] = in ? x[((size_t)b * L + t) * NG * H + g * H + u0 + lane] : 0.0f;
    if (cs != nullptr) cprev[i] = in ? cs[((size_t)t * B + b) * H + u0 + lane] : 0.0f;
  }
}

// acc[i][g] = h[row w + 8 i] . ws[:, g U + lane] over k < Hp (h rows of
// stride Hp, read as float4 broadcasts). Lanes past the CTA's units read
// inside shared memory and are never used.
template <int kRPT, int NG>
__device__ __forceinline__ void cluster_hid(const float* __restrict__ h, const float* __restrict__ ws,
                                            int Hp, int U, float acc[kRPT][NG]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, GU = NG * U;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[i][g] = 0.0f;
  }
  for (int k = 0; k < Hp; k += 4) {
    float4 hv[kRPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) hv[i] = *reinterpret_cast<const float4*>(h + (warp + kClusterWarps * i) * Hp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) wv[g] = ws[(k + kk) * GU + g * U + lane];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const float hk = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[i][g] = fmaf(hk, wv[g], acc[i][g]);
      }
    }
  }
}

// kStoreStates: store h_{t-1} (and c_{t-1}) of every step into hs (cs), the
// training scan's residuals; off for the eval scan (K6), which takes null
// hs, cs.
template <bool kLstm, int kRPT, bool kStoreStates = true>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_forward_kernel(
    const float* __restrict__ x,     // [B, L, G]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, G]
    const float* __restrict__ peep,  // [3, H] (LSTM)
    const float* __restrict__ h0,    // [B, H]
    const float* __restrict__ c0,    // [B, H] (LSTM)
    float* __restrict__ out,         // [B, H]
    float* __restrict__ hs,          // [L, B, H] (kStoreStates)
    float* __restrict__ cs,          // [L, B, H] (LSTM, kStoreStates)
    int B, int L, int H) {
  constexpr int NG = kLstm ? 4 : 3;
  constexpr int R = kRPT * kClusterWarps;
  extern __shared__ float smem[];
  cgt::cluster_group cluster = cgt::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * R;
  const int Hp = h_stride(H), U = (H + C - 1) / C;
  const int u0 = unit_begin(q, H, C), nu = unit_begin(q + 1, H, C) - u0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ws = smem;                        // [Hp, nG U]
  float* hbuf = ws + (size_t)Hp * NG * U;  // [2, R, Hp]
  load_w_cols(w, ws, H, NG, U, u0, nu);
  for (int i = threadIdx.x; i < R * Hp; i += kClusterThreads) {
    const int r = i / Hp, k = i - r * Hp;
    hbuf[i] = (row0 + r < B && k < H) ? h0[(size_t)(row0 + r) * H + k] : 0.0f;
    hbuf[R * Hp + i] = 0.0f;
  }
  const bool mine = lane < nu;
  float c[kRPT], p[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int b = row0 + warp + kClusterWarps * i;
    c[i] = (kLstm && mine && b < B) ? c0[(size_t)b * H + u0 + lane] : 0.0f;
  }
  if (kLstm && mine) {
#pragma unroll
    for (int g = 0; g < 3; ++g) p[g] = peep[g * H + u0 + lane];
  }
  float xg[kRPT][NG], keep[kRPT], unused[kRPT];
  if (L > 0) load_cluster_inputs<kRPT, NG>(x, mask, nullptr, B, L, H, row0, u0, nu, 0, xg, keep, unused);
  cluster.sync();  // every CTA runs and is set up before any remote store

  for (int t = 0; t < L; ++t) {
    const float* hc = hbuf + (t & 1) * R * Hp;
    float* hn = hbuf + ((t + 1) & 1) * R * Hp;
    float acc[kRPT][NG];
    cluster_hid<kRPT, NG>(hc, ws, Hp, U, acc);
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = warp + kClusterWarps * i, b = row0 + r;
      if (mine) {
        const int e = r * Hp + u0 + lane;
        float h = hc[e];
        if (kStoreStates && b < B) {
          const size_t o = ((size_t)t * B + b) * H + u0 + lane;
          hs[o] = h;
          if (kLstm) cs[o] = c[i];
        }
        if (keep[i] > 0.0f) {
          if constexpr (kLstm) {
            lstm_cell(xg[i], acc[i], p, h, c[i]);
          } else {
            h = gru_cell(xg[i], acc[i], h);
          }
        }
        for (int pr = 0; pr < C; ++pr) cluster.map_shared_rank(hn, pr)[e] = h;
      }
    }
    cluster_arrive();
    if (t + 1 < L) load_cluster_inputs<kRPT, NG>(x, mask, nullptr, B, L, H, row0, u0, nu, t + 1, xg, keep, unused);
    cluster_wait();
  }
  const float* hf = hbuf + (L & 1) * R * Hp;
  for (int i = threadIdx.x; i < R * nu; i += kClusterThreads) {
    const int r = i / nu, j = i - r * nu;
    if (row0 + r < B) out[(size_t)(row0 + r) * H + u0 + j] = hf[r * Hp + u0 + j];
  }
}

template <bool kLstm, int kRPT>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_backward_kernel(
    const float* __restrict__ x,       // [B, L, G]
    const float* __restrict__ mask,    // [B, L]
    const float* __restrict__ w,       // [H, G]
    const float* __restrict__ peep,    // [3, H] (LSTM)
    const float* __restrict__ hs,      // [L, B, H]
    const float* __restrict__ cs,      // [L, B, H] (LSTM)
    const float* __restrict__ dh_in,   // [B, H]
    float* __restrict__ dx,            // [B, L, G]
    float* __restrict__ dh0,           // [B, H]
    float* __restrict__ dc0,           // [B, H] (LSTM)
    float* __restrict__ dhid_out,      // [L, B, G]: the dW product's operand
    float* __restrict__ peep_part,     // [clusters, 3H] (LSTM)
    int B, int L, int H, float clip) {
  constexpr int NG = kLstm ? 4 : 3;
  constexpr int R = kRPT * kClusterWarps;
  extern __shared__ float smem[];
  cgt::cluster_group cluster = cgt::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * R;
  const int G = NG * H, Hp = h_stride(H), Gp = h_stride(G), U = (H + C - 1) / C;
  const int u0 = unit_begin(q, H, C), nu = unit_begin(q + 1, H, C) - u0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ws = smem;                        // [Hp, nG U]  W[:, cols(q)]
  float* wr = ws + (size_t)Hp * NG * U;    // [Gp, U]     wr[c, j] = W[u0 + j, c]
  float* hbuf = wr + (size_t)Gp * U;       // [2, R, Hp]  h_{t-1} by step parity
  float* dbuf = hbuf + 2 * R * Hp;         // [2, R, Gp]  dhid by step parity
  load_w_cols(w, ws, H, NG, U, u0, nu);
  for (int i = threadIdx.x; i < Gp * U; i += kClusterThreads) {
    const int c = i / U, j = i - c * U;
    wr[i] = (c < G && j < nu) ? w[(size_t)(u0 + j) * G + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * R * (Hp + Gp); i += kClusterThreads) hbuf[i] = 0.0f;
  const bool mine = lane < nu;
  float dh[kRPT], dc[kRPT], p[3] = {0.0f, 0.0f, 0.0f}, pacc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int b = row0 + warp + kClusterWarps * i;
    dh[i] = (mine && b < B) ? dh_in[(size_t)b * H + u0 + lane] : 0.0f;
    dc[i] = 0.0f;
  }
  if (kLstm && mine) {
#pragma unroll
    for (int g = 0; g < 3; ++g) p[g] = peep[g * H + u0 + lane];
  }
  __syncthreads();  // the zeros land before the copies into hbuf
  const int rows = min(R, B - row0);
  auto copy_h = [&](int t) {  // h_{t-1} of the tile's rows into hbuf[t & 1]
    float* dst = hbuf + (t & 1) * R * Hp;
    const float* src = hs + ((size_t)t * B + row0) * H;
    for (int e = threadIdx.x; e < rows * H; e += kClusterThreads) {
      const int r = e / H, k = e - r * H;
      cp_async4(dst + r * Hp + k, src + e);
    }
    cp_async_commit_group();
  };
  float xg[kRPT][NG], keep[kRPT], cprev[kRPT];
  copy_h(L - 1);
  load_cluster_inputs<kRPT, NG>(x, mask, kLstm ? cs : nullptr, B, L, H, row0, u0, nu, L - 1, xg, keep, cprev);
  cp_async_wait_all();
  cluster.sync();  // every CTA runs, its buffers zeroed and h_{L-2} landed

  for (int t = L - 1; t >= 0; --t) {
    const float* hp = hbuf + (t & 1) * R * Hp;
    float* dn = dbuf + (t & 1) * R * Gp;
    if (t >= 1) copy_h(t - 1);
    float acc[kRPT][NG], dd[kRPT];
    cluster_hid<kRPT, NG>(hp, ws, Hp, U, acc);
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = warp + kClusterWarps * i, b = row0 + r;
      dd[i] = dh[i];
      if (!mine) continue;
      float d[NG], xo[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) d[g] = xo[g] = 0.0f;
      if (keep[i] > 0.0f) {
        if constexpr (kLstm) {
          float terms[3];
          lstm_cell_bwd(xg[i], acc[i], cprev[i], p, dh[i], clip, d, dc[i], terms);
#pragma unroll
          for (int g = 0; g < 3; ++g) pacc[g] += terms[g];
#pragma unroll
          for (int g = 0; g < NG; ++g) xo[g] = d[g];
          dd[i] = 0.0f;
        } else {
          gru_cell_bwd(xg[i], acc[i], hp[r * Hp + u0 + lane], dh[i], clip, xo, d, dd[i]);
        }
      }
      if (b < B) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          dx[((size_t)b * L + t) * G + g * H + u0 + lane] = xo[g];
          dhid_out[((size_t)t * B + b) * G + g * H + u0 + lane] = d[g];
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int e = r * Gp + g * H + u0 + lane;
        for (int pr = 0; pr < C; ++pr) cluster.map_shared_rank(dn, pr)[e] = d[g];
      }
    }
    cp_async_wait_all();  // h_{t-2} of step t-1 (this thread's copies)
    cluster_arrive();
    if (t >= 1)
      load_cluster_inputs<kRPT, NG>(x, mask, kLstm ? cs : nullptr, B, L, H, row0, u0, nu, t - 1, xg, keep, cprev);
    cluster_wait();
    // dh_{t-1} of the thread's unit: dd + dhid[r, :] . W[u0 + lane, :]
    float s[kRPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) s[i] = 0.0f;
    for (int c = 0; c < Gp; c += 4) {
      const float w0 = wr[c * U + lane], w1 = wr[(c + 1) * U + lane];
      const float w2 = wr[(c + 2) * U + lane], w3 = wr[(c + 3) * U + lane];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const float4 dv = *reinterpret_cast<const float4*>(dn + (warp + kClusterWarps * i) * Gp + c);
        s[i] = fmaf(dv.x, w0, fmaf(dv.y, w1, fmaf(dv.z, w2, fmaf(dv.w, w3, s[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < kRPT; ++i) dh[i] = dd[i] + s[i];
  }
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int b = row0 + warp + kClusterWarps * i;
    if (mine && b < B) {
      dh0[(size_t)b * H + u0 + lane] = dh[i];
      if (kLstm) dc0[(size_t)b * H + u0 + lane] = dc[i];
    }
  }
  if (kLstm) {  // the cluster's dpeep: the warps' sums added in warp order
    __syncthreads();
    float* red = dbuf;  // [8 warps, 3, 32]
#pragma unroll
    for (int g = 0; g < 3; ++g) red[(warp * 3 + g) * 32 + lane] = pacc[g];
    __syncthreads();
    if (warp == 0 && mine) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float sum = 0.0f;
        for (int v = 0; v < kClusterWarps; ++v) sum += red[(v * 3 + g) * 32 + lane];
        peep_part[(size_t)(blockIdx.x / C) * 3 * H + g * H + u0 + lane] = sum;
      }
    }
  }
}

}  // namespace
