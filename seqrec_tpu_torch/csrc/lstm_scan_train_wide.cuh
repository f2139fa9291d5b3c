// The LSTM training scan's "wide" path (K5 at H <= 50 where at least 14
// rows land on each SM: the benchmark's B=4096, L=200, H=50): the step's
// products as register micro-tiles, in CTAs that fill the card in one wave,
// in the design of K1's wide path (scan_train_wide.cuh, whose helpers and
// thread layout it reuses; the math per cell is lstm_scan_train.cu's).
//
// What bounds it on an H100: as on K1, the issue of the per-step products'
// FMAs and the bytes shared memory delivers to registers. A 32-row step is
// three [32, 50] x [50, 200]-sized products in the backward (recompute hid,
// dh_{t-1} = dpre W^T, dW += h_{t-1}^T dpre) and one in the forward: 320k
// FMAs each, 4/3 of the GRU's. The reg path (scan_train_reg.cuh) runs 256
// blocks of 16 rows at B=4096, one block an SM: two waves walk the 200
// steps one after the other.
//
// Design: the backward in ceil(B / 32) CTAs of 256 threads (128 at
// B=4096: one wave on 132 SMs), the forward in CTAs of 16 rows and 128
// threads, two an SM. W_hid sits in shared memory; every product is
// float32 fmaf. Quads of lanes (WideThread: lane q, its bits kh and upb,
// row octet rq, unit quad uq, unit pair up = 2 uq + upb) own register
// tiles:
// - hid: the cell tile's 4 rows (8 rq + 4 kh ..) by the eight gate columns
//   (i, f, g, o of units 2 up, 2 up + 1) of unit pair up, over all k:
//   h_{t-1} transposed ([k][row]), W as [k][pair][8], which the pair's
//   eight columns fill exactly: per k one float4 of h and two of W for 32
//   FMAs.
// - dh_{t-1}: rows 8 rq .. + 7 by units 4 uq .. + 3 over the quarter q of
//   dpre's 4H columns, W^T as [c][quad][4]; two shuffle rounds leave each
//   lane the dh of its cell tile (as on K1).
// - dW: units 4 uq .. + 3 by the columns (q + 4 rq) + 16 i, i < 13 (4H <=
//   208), summed in registers over rows and steps (52 floats).
// A thread holds its eight cells' c (forward: h too) in registers; the
// backward loads c_{t-1} from cs straight into registers a step ahead, and
// carries dh and dc there. lstm_cell / lstm_cell_bwd (scan_cells.cuh) do
// each cell's math. Only h (forward) and the clipped dpre (backward,
// transposed, double-buffered by step parity) go through shared memory,
// and one barrier a step separates the cells from the products. The step's
// x_pre and mask (and in the backward h_{t-1}, transposed on the way) come
// by cp.async a step ahead; the backward keeps three h buffers. Every step
// is walked; masked steps carry (h, c) or (dh, dc), write dx = 0 and add
// nothing to dW or dpeep. The thread's unclipped dpeep terms are summed in
// registers over its rows and the steps, then over the 8 lanes of its unit
// pair by xor shuffles. Each backward CTA writes its dW and dpeep partials;
// the launcher sums them in block order (split_sum.cuh). Every sum has a
// fixed order and no atomics: two calls give the same bits.

#pragma once

#include <cstdint>

#include "scan_train_wide.cuh"

namespace {

constexpr int kLstmWideDwCols = 13;  // dW columns of a thread: c = cg + 16 i, 4 kWideMaxH <= 208

// Sizes at H: unit quads NQ, padded units HQ = 4 NQ (rows of the h
// buffers), unit pairs NUP = 2 NQ, dpre columns GP = 4H to 16s (rows of the
// dpre buffers), dpre columns a quarter CQ = H.
struct LstmWideDims {
  int G, NQ, HQ, NUP, GP, CQ;
  __host__ __device__ explicit LstmWideDims(int H)
      : G(4 * H), NQ((H + 3) / 4), HQ(4 * NQ), NUP(2 * NQ), GP(16 * ((4 * H + 15) / 16)), CQ(H) {}
};

// floats of shared memory of one CTA (the launchers' and the plan's)
__host__ __device__ inline int lstm_wide_fwd_floats(int H) {
  const LstmWideDims d(H);
  constexpr int R = kWideFwdRows, S = WideRows<R>::kS;
  // hT [2, HQ, S], Wf [HQ, NUP, 8], mask [2, R], x [2, R, 4H]
  return 2 * d.HQ * S + d.HQ * d.NUP * 8 + 2 * R + 2 * R * d.G;
}
__host__ __device__ inline int lstm_wide_bwd_floats(int H) {
  const LstmWideDims d(H);
  constexpr int R = kWideBwdRows, S = WideRows<R>::kS;
  // hpT [3, HQ, S], dT [2, GP, S], Wf [HQ, NUP, 8], Wq [GP, NQ, 4], mask [2, R], x [2, R, 4H]
  return 3 * d.HQ * S + 2 * d.GP * S + d.HQ * d.NUP * 8 + d.GP * d.NQ * 4 + 2 * R + 2 * R * d.G;
}

// Zero the block's shared memory, then W as Wf [HQ, NUP, 8] (Wf[k][p][2 g
// + u] = W[k, g H + 2 p + u], zeros past H) and, when Wq is given, W^T as
// Wq [GP, NQ, 4] (Wq[c][m][v] = W[4 m + v, c], zeros past H and 4H).
template <int kThreads>
__device__ __forceinline__ void lstm_wide_stage(float* smem, int n_floats, const float* __restrict__ w,
                                                float* Wf, float* Wq, int H) {
  const LstmWideDims d(H);
  for (int e = threadIdx.x; e < n_floats; e += kThreads) smem[e] = 0.0f;
  __syncthreads();
  for (int e = threadIdx.x; e < H * d.NUP * 8; e += kThreads) {
    const int k = e / (d.NUP * 8), s = e % 8, j = 2 * ((e / 8) % d.NUP) + (s & 1);
    if (j < H) Wf[e] = w[(size_t)k * d.G + (s >> 1) * H + j];
  }
  if (Wq != nullptr) {
    for (int e = threadIdx.x; e < d.G * d.HQ; e += kThreads) {
      const int c = e / d.HQ, j = e % d.HQ;
      if (j < H) Wq[e] = w[(size_t)j * d.G + c];
    }
  }
}

// hid[i][2 g + u] = the gate g pre-activation of unit 2 up + u from h_{t-1}
// at the cell tile's row i, over all k (hT [HQ][S], Wf [HQ, NUP, 8]).
template <int kRows>
__device__ __forceinline__ void lstm_wide_hid(const float* hT, const float* Wf, int H, const LstmWideDims& d,
                                              const WideThread<kRows>& th, float hid[4][8]) {
  constexpr int S = WideRows<kRows>::kS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) hid[i][c] = 0.0f;
  }
  const float* hp = hT + th.row(0);
  const float* wp = Wf + th.up * 8;
#pragma unroll 5
  for (int k = 0; k < H; ++k) {
    const float4 h = ld4(hp + k * S);
    const float4 w0 = ld4(wp + k * d.NUP * 8), w1 = ld4(wp + k * d.NUP * 8 + 4);
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) hid[i][c] = fmaf(lane4(h, i), wv[c], hid[i][c]);
    }
  }
}

// c_{t-1} of the thread's cells at step t, from cs [L, B, H] into registers
// (zeros outside the batch and H, and where ``on`` is false)
template <int kRows>
__device__ __forceinline__ void lstm_wide_load_c(const float* __restrict__ cs, const WideThread<kRows>& th, bool on,
                                                 int row0, int rows, int B, int H, int t, float c[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = th.row(i), j = 2 * th.up + u;
      c[i][u] = (on && r < rows && j < H) ? cs[((size_t)t * B + row0 + r) * H + j] : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(WideRows<kWideFwdRows>::kThreads) lstm_wide_forward_kernel(
    const float* __restrict__ x,     // [B, L, 4H]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, 4H]
    const float* __restrict__ peep,  // [3, H]
    const float* __restrict__ h0,    // [B, H]
    const float* __restrict__ c0,    // [B, H]
    float* __restrict__ out,         // [B, H]
    float* __restrict__ hs,          // [L, B, H]: h_{t-1} of step t
    float* __restrict__ cs,          // [L, B, H]: c_{t-1} of step t
    int B, int L, int H) {
  constexpr int R = kWideFwdRows, S = WideRows<R>::kS, kT = WideRows<R>::kThreads;
  extern __shared__ __align__(16) float lstm_wide_smem[];
  const LstmWideDims d(H);
  const int G = d.G;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* hT = lstm_wide_smem;         // [2, HQ, S] by step parity
  float* Wf = hT + 2 * d.HQ * S;      // [HQ, NUP, 8]
  float* mb = Wf + d.HQ * d.NUP * 8;  // [2, R]
  float* xb = mb + 2 * R;             // [2, R, G]
  const WideThread<R> th;
  const bool working = th.uq < d.NQ;
  lstm_wide_stage<kT>(lstm_wide_smem, lstm_wide_fwd_floats(H), w, Wf, nullptr, H);
  // the thread's cells (rows th.row(i), units 2 up + u): h, c and the peepholes in registers
  float hr[4][2], cr[4][2], pp[2][3];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = 2 * th.up + u;
#pragma unroll
    for (int g = 0; g < 3; ++g) pp[u][g] = (working && j < H) ? peep[g * H + j] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = th.row(i);
      const bool in = working && r < rows && j < H;
      hr[i][u] = in ? h0[(size_t)(row0 + r) * H + j] : 0.0f;
      cr[i][u] = in ? c0[(size_t)(row0 + r) * H + j] : 0.0f;
    }
    if (working && j < H) {
      *reinterpret_cast<float4*>(hT + j * S + th.row(0)) = make_float4(hr[0][u], hr[1][u], hr[2][u], hr[3][u]);
    }
  }
  wide_prefetch<kT>(x, mask, xb, mb, row0, rows, L, G, 0);
  cp_async_commit_group();
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const int p = t & 1;
    if (t + 1 < L) {
      wide_prefetch<kT>(x, mask, xb + (p ^ 1) * R * G, mb + (p ^ 1) * R, row0, rows, L, G, t + 1);
    }
    cp_async_commit_group();
    if (working) {
      float* hn = hT + (p ^ 1) * d.HQ * S;
      const float* xt = xb + p * R * G;
      float hid[4][8];
      lstm_wide_hid(hT + p * d.HQ * S, Wf, H, d, th, hid);
      const float4 mk = ld4(mb + p * R + th.row(0));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * th.up + u;
        if (j >= H) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = th.row(i);
          if (r < rows) {
            const size_t o = ((size_t)t * B + row0 + r) * H + j;
            hs[o] = hr[i][u];
            cs[o] = cr[i][u];
          }
          const float xv[4] = {xt[r * G + j], xt[r * G + H + j], xt[r * G + 2 * H + j], xt[r * G + 3 * H + j]};
          const float hv[4] = {hid[i][u], hid[i][2 + u], hid[i][4 + u], hid[i][6 + u]};
          float h = hr[i][u], c = cr[i][u];
          lstm_cell(xv, hv, pp[u], h, c);  // computed at every step, kept where the mask is on
          if (lane4(mk, i) > 0.0f) {
            hr[i][u] = h;
            cr[i][u] = c;
          }
        }
        *reinterpret_cast<float4*>(hn + j * S + th.row(0)) = make_float4(hr[0][u], hr[1][u], hr[2][u], hr[3][u]);
      }
    }
    cp_async_wait_all();  // step t+1's inputs
    __syncthreads();
  }
  if (working) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = th.row(i), j = 2 * th.up + u;
        if (r < rows && j < H) out[(size_t)(row0 + r) * H + j] = hr[i][u];
      }
    }
  }
}

__global__ void __launch_bounds__(WideRows<kWideBwdRows>::kThreads, 1) lstm_wide_backward_kernel(
    const float* __restrict__ x,      // [B, L, 4H]
    const float* __restrict__ mask,   // [B, L]
    const float* __restrict__ w,      // [H, 4H]
    const float* __restrict__ peep,   // [3, H]
    const float* __restrict__ hs,     // [L, B, H]
    const float* __restrict__ cs,     // [L, B, H]
    const float* __restrict__ dh_in,  // [B, H]
    float* __restrict__ dx,           // [B, L, 4H]
    float* __restrict__ dh0,          // [B, H]
    float* __restrict__ dc0,          // [B, H]
    float* __restrict__ dw_part,      // [gridDim.x, H, 4H]
    float* __restrict__ dpeep_part,   // [gridDim.x, 3H]
    int B, int L, int H, float clip) {
  constexpr int R = kWideBwdRows, S = WideRows<R>::kS, kT = WideRows<R>::kThreads;
  extern __shared__ __align__(16) float lstm_wide_smem[];
  const LstmWideDims d(H);
  const int G = d.G;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* hpT = lstm_wide_smem;        // [3, HQ, S]  h_{t-1} by step % 3
  float* dT = hpT + 3 * d.HQ * S;     // [2, GP, S]  dpre by step parity
  float* Wf = dT + 2 * d.GP * S;      // [HQ, NUP, 8]
  float* Wq = Wf + d.HQ * d.NUP * 8;  // [GP, NQ, 4]
  float* mb = Wq + d.GP * d.NQ * 4;   // [2, R]
  float* xb = mb + 2 * R;             // [2, R, G]
  const WideThread<R> th;
  const bool working = th.uq < d.NQ;
  const unsigned lanes = __ballot_sync(0xffffffffu, working);
  const int cg = th.q + 4 * th.rq;  // dW columns cg + 16 i
  lstm_wide_stage<kT>(lstm_wide_smem, lstm_wide_bwd_floats(H), w, Wf, Wq, H);
  float hid[4][8], dh[4][2], dc[4][2], cp[4][2], pp[2][3], dpp[2][3], dwr[4][kLstmWideDwCols];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = 2 * th.up + u;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      pp[u][g] = (working && j < H) ? peep[g * H + j] : 0.0f;
      dpp[u][g] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = th.row(i);
      dh[i][u] = (working && r < rows && j < H) ? dh_in[(size_t)(row0 + r) * H + j] : 0.0f;
      dc[i][u] = 0.0f;  // the final cell state is not an output
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
#pragma unroll
    for (int i = 0; i < kLstmWideDwCols; ++i) dwr[v][i] = 0.0f;
  }
  auto prefetch = [&](int t) {
    wide_prefetch<kT>(x, mask, xb + (t & 1) * R * G, mb + (t & 1) * R, row0, rows, L, G, t);
    wide_prefetch_t<R>(hs + ((size_t)t * B + row0) * H, hpT + (t % 3) * d.HQ * S, rows, H);
  };
  prefetch(L - 1);
  cp_async_commit_group();
  lstm_wide_load_c(cs, th, working, row0, rows, B, H, L - 1, cp);
  cp_async_wait_all();
  __syncthreads();
  if (working) lstm_wide_hid(hpT + ((L - 1) % 3) * d.HQ * S, Wf, H, d, th, hid);
  if (L > 1) prefetch(L - 2);
  cp_async_commit_group();

  for (int t = L - 1; t >= 0; --t) {
    const int p = t & 1;
    const float* hq = hpT + (t % 3) * d.HQ * S;
    float* dp = dT + p * d.GP * S;
    float cn[4][2];  // c_{t-2}, step t-1's, loaded while step t runs
    lstm_wide_load_c(cs, th, working && t >= 1, row0, rows, B, H, t - 1, cn);
    float dd[4][2];  // the part of dh_{t-1} outside W: dh itself at a masked step
    // gate cotangents of step t from the thread's hid tile: dx, dpre^T, dc_{t-1}, dpeep terms
    if (working) {
      const float* xt = xb + p * R * G;
      const float4 mk = ld4(mb + p * R + th.row(0));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * th.up + u;
        if (j >= H) {
#pragma unroll
          for (int i = 0; i < 4; ++i) dd[i][u] = 0.0f;
          continue;
        }
        float dv4[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = th.row(i);
          // computed at every step and kept where the mask is on: (dh, dc) pass through a masked step
          const float xv[4] = {xt[r * G + j], xt[r * G + H + j], xt[r * G + 2 * H + j], xt[r * G + 3 * H + j]};
          const float hv[4] = {hid[i][u], hid[i][2 + u], hid[i][4 + u], hid[i][6 + u]};
          float dpre[4], dcv = dc[i][u], terms[3];
          lstm_cell_bwd(xv, hv, cp[i][u], pp[u], dh[i][u], clip, dpre, dcv, terms);
          const bool on = lane4(mk, i) > 0.0f;
          dd[i][u] = on ? 0.0f : dh[i][u];
          dc[i][u] = on ? dcv : dc[i][u];
#pragma unroll
          for (int g = 0; g < 3; ++g) dpp[u][g] += on ? terms[g] : 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g) dv4[g][i] = on ? dpre[g] : 0.0f;
          if (r < rows) {
            float* dxt = dx + ((size_t)(row0 + r) * L + t) * G + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) dxt[g * H] = dv4[g][i];
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          *reinterpret_cast<float4*>(dp + (g * H + j) * S + th.row(0)) =
              make_float4(dv4[g][0], dv4[g][1], dv4[g][2], dv4[g][3]);
        }
      }
    }
    cp_async_wait_all();  // step t-1's inputs
    __syncthreads();
    if (t >= 2) prefetch(t - 2);
    cp_async_commit_group();
    if (working) {
      // dh_{t-1} = dd + dpre W^T: the octet's rows by the quad's units over the column quarter q
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      const float* dq = dp + th.q * d.CQ * S + 8 * th.rq;
      const float* wq = Wq + (th.q * d.CQ * d.NQ + th.uq) * 4;
#pragma unroll 5
      for (int c = 0; c < d.CQ; ++c) {
        const float4 d0 = ld4(dq + c * S), d1 = ld4(dq + c * S + 4);
        const float4 wv = ld4(wq + c * d.NQ * 4);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(dv[i], wv.x, acc[i][0]);
          acc[i][1] = fmaf(dv[i], wv.y, acc[i][1]);
          acc[i][2] = fmaf(dv[i], wv.z, acc[i][2]);
          acc[i][3] = fmaf(dv[i], wv.w, acc[i][3]);
        }
      }
      // the quarters summed: lanes upb = 0, 1 keep their unit pair, then lanes kh = 0, 1 their rows
      float half[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float send = th.upb ? acc[i][u] : acc[i][2 + u];
          const float keep = th.upb ? acc[i][2 + u] : acc[i][u];
          half[i][u] = keep + __shfl_xor_sync(lanes, send, 2);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float send = th.kh ? half[i][u] : half[4 + i][u];
          const float keep = th.kh ? half[4 + i][u] : half[i][u];
          dh[i][u] = dd[i][u] + (keep + __shfl_xor_sync(lanes, send, 1));
        }
      }
      // dW[4 uq + v, cg + 16 i] += sum over the 32 rows of h_{t-1} dpre
      const float* ha = hq + 4 * th.uq * S;
      const float* dcol = dp + cg * S;
#pragma unroll 1
      for (int rb = 0; rb < R; rb += 4) {
        float4 hv[4], dv[kLstmWideDwCols];
#pragma unroll
        for (int v = 0; v < 4; ++v) hv[v] = ld4(ha + v * S + rb);
#pragma unroll
        for (int i = 0; i < kLstmWideDwCols; ++i) {  // the columns' rows end at GP
          dv[i] = 16 * i < d.GP ? ld4(dcol + 16 * i * S + rb) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        // row by row over the block: 52 independent sums a row, not 4-long chains
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int i = 0; i < kLstmWideDwCols; ++i) {
#pragma unroll
            for (int v = 0; v < 4; ++v) dwr[v][i] = fmaf(lane4(hv[v], e), lane4(dv[i], e), dwr[v][i]);
          }
        }
      }
      // hid of step t-1 from h_{t-2}
      if (t >= 1) lstm_wide_hid(hpT + ((t - 1) % 3) * d.HQ * S, Wf, H, d, th, hid);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < 2; ++u) cp[i][u] = cn[i][u];
    }
  }
  if (working) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = th.row(i), j = 2 * th.up + u;
        if (r < rows && j < H) {
          dh0[(size_t)(row0 + r) * H + j] = dh[i][u];
          dc0[(size_t)(row0 + r) * H + j] = dc[i][u];
        }
      }
    }
    // dpeep of the unit pair: the 8 lanes that share it (bits kh and rq of the lane) summed by a fixed tree
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float s = dpp[u][g];
        s += __shfl_xor_sync(lanes, s, 1);
        s += __shfl_xor_sync(lanes, s, 8);
        s += __shfl_xor_sync(lanes, s, 16);
        dpp[u][g] = s;
      }
    }
    if (th.kh == 0 && th.rq == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * th.up + u;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          if (j < H) dpeep_part[(size_t)blockIdx.x * 3 * H + g * H + j] = dpp[u][g];
        }
      }
    }
    float* part = dw_part + (size_t)blockIdx.x * H * G;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int k = 4 * th.uq + v;
#pragma unroll
      for (int i = 0; i < kLstmWideDwCols; ++i) {
        const int c = cg + 16 * i;
        if (k < H && c < G) part[(size_t)k * G + c] = dwr[v][i];
      }
    }
  }
}

// The forward on the wide path: (h0, c0) -> out [B, H], hs, cs [L, B, H].
inline int lstm_wide_forward(const float* x, const float* mask, const float* w, const float* peep,
                             const float* h0, const float* c0, float* out, float* hs, float* cs, int B, int L,
                             int H, int R, cudaStream_t stream) {
  constexpr int kR = kWideFwdRows;
  if (!wide_shape_ok(H, R, 0) || reinterpret_cast<uintptr_t>(x) % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * lstm_wide_fwd_floats(H);
  const int err = allow_smem_once((const void*)lstm_wide_forward_kernel, smem);
  if (err) return err;
  lstm_wide_forward_kernel<<<(B + kR - 1) / kR, WideRows<kR>::kThreads, smem, stream>>>(x, mask, w, peep, h0, c0,
                                                                                        out, hs, cs, B, L, H);
  return (int)cudaGetLastError();
}

// The backward on the wide path: dx, dh0, dc0, and the per-CTA partials of
// dW and dpeep in part [ceil(B / R), H, 4H] and peep_part [ceil(B / R), 3H],
// summed in block order into dw and dpeep (the plan takes this path only
// where there are many CTAs).
inline int lstm_wide_backward(const float* x, const float* mask, const float* w, const float* peep,
                              const float* hs, const float* cs, const float* dh, float* dx, float* dh0,
                              float* dc0, float* dw, float* dpeep, float* part, float* peep_part, int B, int L,
                              int H, int R, float clip, cudaStream_t stream) {
  if (!wide_shape_ok(H, R, 1) || reinterpret_cast<uintptr_t>(x) % 8 || part == nullptr || peep_part == nullptr)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + R - 1) / R;
  const size_t smem = sizeof(float) * lstm_wide_bwd_floats(H);
  int err = allow_smem_once((const void*)lstm_wide_backward_kernel, smem);
  if (err) return err;
  lstm_wide_backward_kernel<<<grid, WideRows<kWideBwdRows>::kThreads, smem, stream>>>(
      x, mask, w, peep, hs, cs, dh, dx, dh0, dc0, part, peep_part, B, L, H, clip);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_sum_splits(part, dw, grid, (size_t)H * 4 * H, stream);
  if (err) return err;
  return launch_sum_splits(peep_part, dpeep, grid, (size_t)3 * H, stream);
}

}  // namespace
