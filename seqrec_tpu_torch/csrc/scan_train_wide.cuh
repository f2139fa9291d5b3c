// The training scans' "wide" path (K1 and K5, kLstm, at H <= 50 where the
// plan's WIDE_MIN_ROWS rows land on each SM: the benchmark's B=4096, L=200,
// H=50): the step's products as register micro-tiles, in CTAs that fill
// the card in one wave.
//
// What bounds it on an H100: the issue of the per-step products' FMAs and
// the bytes shared memory delivers to registers (128 a clock an SM, a
// float4 load costing 512 of them whatever its broadcast). A 32-row step
// is three [32, 50] x [50, G]-sized products in the backward (recompute
// hid, dh_{t-1} = dd + dhid W^T, dW += h_{t-1}^T dhid; G = 3H, or 4H for
// the LSTM, whose dhid is the clipped dpre) and one in the forward: 240k
// FMAs each for the GRU, about 1,900 clocks at 128 FMAs a clock, 320k for
// the LSTM. The reg path (scan_train_reg.cuh), built for latency at B=16,
// feeds each FMA a scalar shared load and runs 256 blocks of 16 rows at
// B=4096, one block an SM: two waves walk the 200 steps one after the
// other.
//
// Design: the backward in ceil(B / 32) CTAs of 256 threads (128 at
// B=4096: one wave on 132 SMs), the forward, which holds one copy of W, in
// CTAs of 16 rows and 128 threads, several an SM. W_hid sits in shared
// memory; every product is float32 fmaf. Quads of lanes (q = tid % 4, its
// bits kh and upb) in groups of row octet rq and unit quad uq (as many
// quads as the CTA has octets times 16) own register tiles:
// - hid: the cell tile's 4 rows (8 rq + 4 kh ..) by the gate columns of
//   unit pair up = 2 uq + upb (six for the GRU; the LSTM's eight, i, f, g,
//   o of units 2 up and 2 up + 1, fill them exactly), over all k: h_{t-1}
//   is kept transposed ([k][row], rows kRows + 4 floats apart), W as
//   [k][pair][8], so a k costs one float4 of h and the pair's columns for
//   24 (32) FMAs.
// - dh_{t-1}: rows 8 rq .. + 7 by units 4 uq .. 4 uq + 3 over the quarter
//   q of dhid's columns, W^T as [c][quad][4]: 48 bytes for 32 FMAs; two
//   shuffle rounds leave each lane the dh of its cell tile.
// - dW: units 4 uq .. + 3 by the columns (q + 4 rq) + 16 i, summed in
//   registers over rows and steps (40 floats, the LSTM's 52): 14 (17)
//   float4 loads per 160 (208) FMAs.
// The thread applies the cell's step (gru_cell / gru_cell_bwd, lstm_cell /
// lstm_cell_bwd; scan_cells.cuh) to the eight cells of its tile (rows 8 rq
// + 4 kh .., units 2 up, 2 up + 1) from registers. The GRU's forward reads
// h_{t-1} back from shared memory; the LSTM holds h and c in registers,
// and its backward loads c_{t-1} from cs a step ahead and carries dh and
// dc there. The cells' phase of each kernel is written out per cell under
// kLstm: a form shared by both cells compiles to other register counts
// (GRU backward 192 for 188, LSTM forward 145 for 128). Only h (forward)
// and the clipped dhid (backward, transposed, double-buffered by step
// parity) go through shared memory, and one barrier a step separates the
// cells from the products. The step's x_pre and mask (and in the backward
// h_{t-1}, transposed on the way) come by cp.async a step ahead; the
// backward keeps three h buffers. Every step is walked; masked steps
// carry the state (its cotangents), write hs (cs) and dx = 0 and add
// nothing to dW or dpeep. The LSTM's unclipped dpeep terms are summed in
// registers over the thread's rows and the steps, then over the 8 lanes of
// its unit pair by xor shuffles. Each backward CTA writes its dW (and
// dpeep) partial; the launcher sums them in block order (split_sum.cuh).
// Every sum has a fixed order and no atomics: two calls give the same bits.

#pragma once

#include <cstdint>

#include "cluster_common.cuh"
#include "scan_cells.cuh"
#include "split_sum.cuh"

namespace {

constexpr int kPathWide = 4;  // ops/rnn_scan.py PATHS["wide"]
constexpr int kWideMaxH = 50;  // 13 unit quads

// The cell's gates NG, a thread's dW columns (c = cg + 16 i < NG kWideMaxH)
// and the unroll of the dh loop (over 38 columns for the GRU at H 50, 50 for the LSTM).
template <bool kLstm>
struct WideCell {
  static constexpr int NG = kLstm ? 4 : 3;
  static constexpr int kDwCols = (NG * kWideMaxH + 15) / 16;
  static constexpr int kDhUnroll = kLstm ? 5 : 4;
};

// A CTA of kRows rows (the forward's 16 or the backward's 32): quads of
// lanes for kRows / 8 row octets by 16 unit quads.
template <int kRows>
struct WideRows {
  static constexpr int kThreads = 8 * kRows;
  static constexpr int kOctets = kRows / 8;
  static constexpr int kS = kRows + 4;  // row stride of the transposed buffers (float4 rows, few bank conflicts)
};

// Sizes at H: gate columns G = NG H, unit quads NQ, padded units HQ = 4 NQ
// (rows of the h buffers), unit pairs NUP = 2 NQ, dhid columns GP = G to
// 16s (rows of the dhid buffers), dhid columns a quarter CQ (H for the
// LSTM).
template <bool kLstm>
struct WideDims {
  int G, NQ, HQ, NUP, GP, CQ;
  __host__ __device__ explicit WideDims(int H)
      : G(WideCell<kLstm>::NG * H), NQ((H + 3) / 4), HQ(4 * NQ), NUP(2 * NQ),
        GP(16 * ((WideCell<kLstm>::NG * H + 15) / 16)), CQ(kLstm ? H : (3 * H + 3) / 4) {}
};

constexpr int kWideFwdRows = 16;  // rows of a forward CTA: several CTAs an SM
constexpr int kWideBwdRows = 32;  // rows of a backward CTA

// floats of shared memory of one CTA (the launchers' and the plan's)
template <bool kLstm>
__host__ __device__ inline int wide_fwd_floats(int H) {
  const WideDims<kLstm> d(H);
  constexpr int R = kWideFwdRows, S = WideRows<R>::kS;
  // hT [2, HQ, S], Wf [HQ, NUP, 8], mask [2, R], x [2, R, G]
  return 2 * d.HQ * S + d.HQ * d.NUP * 8 + 2 * R + 2 * R * d.G;
}
template <bool kLstm>
__host__ __device__ inline int wide_bwd_floats(int H) {
  const WideDims<kLstm> d(H);
  constexpr int R = kWideBwdRows, S = WideRows<R>::kS;
  // hpT [3, HQ, S], dT [2, GP, S], Wf [HQ, NUP, 8], Wq [GP, NQ, 4], mask [2, R], x [2, R, G]
  return 3 * d.HQ * S + 2 * d.GP * S + d.HQ * d.NUP * 8 + d.GP * d.NQ * 4 + 2 * R + 2 * R * d.G;
}

// Shared-memory bytes of one CTA of the forward (backward = 0) or backward
// kernel, as its launcher asks for them; -1 for a shape they do not take.
template <bool kLstm>
inline long long wide_smem_bytes(int backward, int H, int R) {
  if (H < 1 || H > kWideMaxH || R != (backward ? kWideBwdRows : kWideFwdRows)) return -1;
  return (long long)(sizeof(float) * (backward ? wide_bwd_floats<kLstm>(H) : wide_fwd_floats<kLstm>(H)));
}

// x_pre's rows come by 8-byte copies where G is even, which want x 8-byte aligned.
template <bool kLstm>
inline bool wide_x_ok(const float* x, int H) {
  return (WideCell<kLstm>::NG * H) % 2 != 0 || reinterpret_cast<uintptr_t>(x) % 8 == 0;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 8 bytes global -> shared, asynchronous (8-byte aligned addresses)
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// The thread's place: lane q of its quad (bits kh, upb), row octet rq,
// unit quad uq, unit pair up; working where uq < NQ (whole quads). The
// quads of 8 neighbouring lanes share rq and take uq, uq + 1, so that the
// dh product's dhid loads of a quarter warp fall in 4 distinct bank groups.
template <int kRows>
struct WideThread {
  int q, kh, upb, rq, uq, up;
  __device__ WideThread()
      : q(threadIdx.x & 3), kh(q & 1), upb(q >> 1), rq((threadIdx.x >> 3) % WideRows<kRows>::kOctets),
        uq((threadIdx.x >> 3) / WideRows<kRows>::kOctets * 2 + ((threadIdx.x >> 2) & 1)), up(2 * uq + upb) {}
  __device__ int row(int i) const { return 8 * rq + 4 * kh + i; }  // rows of the cell tile
};

// Zero the block's shared memory, then W as Wf [HQ, NUP, 8] (Wf[k][p][2 g
// + u] = W[k, g H + 2 p + u], zeros past H and, for the GRU, at 6, 7) and,
// when Wq is given, W^T as Wq [GP, NQ, 4] (Wq[c][m][v] = W[4 m + v, c],
// zeros past H and G).
template <bool kLstm, int kThreads>
__device__ __forceinline__ void wide_stage(float* smem, int n_floats, const float* __restrict__ w,
                                           float* Wf, float* Wq, int H) {
  const WideDims<kLstm> d(H);
  for (int e = threadIdx.x; e < n_floats; e += kThreads) smem[e] = 0.0f;
  __syncthreads();
  for (int e = threadIdx.x; e < H * d.NUP * 8; e += kThreads) {
    const int k = e / (d.NUP * 8), s = e % 8, j = 2 * ((e / 8) % d.NUP) + (s & 1);
    if (s < 2 * WideCell<kLstm>::NG && j < H) Wf[e] = w[(size_t)k * d.G + (s >> 1) * H + j];
  }
  if (Wq != nullptr) {
    for (int e = threadIdx.x; e < d.G * d.HQ; e += kThreads) {
      const int c = e / d.HQ, j = e % d.HQ;
      if (j < H) Wq[e] = w[(size_t)j * d.G + c];
    }
  }
}

// The step's x_pre rows [rows, G] into xb [kRows, G] and mask [rows] into
// mb, asynchronously (8-byte copies where G is even); the caller commits.
template <int kThreads>
__device__ __forceinline__ void wide_prefetch(const float* __restrict__ x, const float* __restrict__ mask,
                                              float* xb, float* mb, int row0, int rows, int L, int G, int t) {
  const float* src = x + ((size_t)row0 * L + t) * G;
  const size_t stride = (size_t)L * G;
  const int vec = (G & 1) ? 1 : 2, per = G / vec, total = rows * per;
  const int dr = kThreads / per, dc = kThreads % per;
  int r = threadIdx.x / per, c = threadIdx.x % per;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    if (vec == 2) {
      cp_async8(xb + r * G + 2 * c, src + r * stride + 2 * c);
    } else {
      cp_async4(xb + r * G + c, src + r * stride + c);
    }
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
  if (threadIdx.x < rows) cp_async4(mb + threadIdx.x, mask + (size_t)(row0 + threadIdx.x) * L + t);
}

// rows [rows, H] at src into the transposed buffer dT[j * S + r], asynchronously
template <int kRows>
__device__ __forceinline__ void wide_prefetch_t(const float* __restrict__ src, float* dT, int rows, int H) {
  constexpr int T = WideRows<kRows>::kThreads;
  const int dr = T / H, dj = T % H;
  int r = threadIdx.x / H, j = threadIdx.x % H;
  for (int e = threadIdx.x; e < rows * H; e += T) {
    cp_async4(dT + j * WideRows<kRows>::kS + r, src + e);
    r += dr;
    j += dj;
    if (j >= H) {
      j -= H;
      ++r;
    }
  }
}

// hid[i][2 g + u] = the gate g pre-activation of unit 2 up + u from h_{t-1}
// at the cell tile's row i, over all k (hT [HQ][S], Wf [HQ, NUP, 8]): per
// k one float4 of the tile's rows and the pair's gate columns (a float4
// and a float2 for the GRU's six, two float4 for the LSTM's eight).
template <bool kLstm, int kRows>
__device__ __forceinline__ void wide_hid(const float* hT, const float* Wf, int H, const WideDims<kLstm>& d,
                                         const WideThread<kRows>& th, float hid[4][2 * WideCell<kLstm>::NG]) {
  constexpr int S = WideRows<kRows>::kS, NC = 2 * WideCell<kLstm>::NG;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) hid[i][c] = 0.0f;
  }
  const float* hp = hT + th.row(0);
  const float* wp = Wf + th.up * 8;
#pragma unroll 5
  for (int k = 0; k < H; ++k) {
    const float4 h = ld4(hp + k * S);
    const float4 w0 = ld4(wp + k * d.NUP * 8);
    float wv[NC] = {w0.x, w0.y, w0.z, w0.w};
    if constexpr (kLstm) {
      const float4 w1 = ld4(wp + k * d.NUP * 8 + 4);
      wv[4] = w1.x;
      wv[5] = w1.y;
      wv[6] = w1.z;
      wv[7] = w1.w;
    } else {
      const float2 w1 = ld2(wp + k * d.NUP * 8 + 4);
      wv[4] = w1.x;
      wv[5] = w1.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) hid[i][c] = fmaf(lane4(h, i), wv[c], hid[i][c]);
    }
  }
}

// (LSTM) c_{t-1} of the thread's cells at step t, from cs [L, B, H] into
// registers (zeros outside the batch and H, and where ``on`` is false)
template <int kRows>
__device__ __forceinline__ void wide_load_c(const float* __restrict__ cs, const WideThread<kRows>& th, bool on,
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

template <bool kLstm, int kRows>
__global__ void __launch_bounds__(WideRows<kRows>::kThreads) wide_forward_kernel(
    const float* __restrict__ x,     // [B, L, G]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, G]
    const float* __restrict__ peep,  // [3, H] (LSTM)
    const float* __restrict__ h0,    // [B, H]
    const float* __restrict__ c0,    // [B, H] (LSTM)
    float* __restrict__ out,         // [B, H]
    float* __restrict__ hs,          // [L, B, H]: h_{t-1} of step t
    float* __restrict__ cs,          // [L, B, H]: c_{t-1} of step t (LSTM)
    int B, int L, int H) {
  constexpr int R = kRows, S = WideRows<R>::kS, kT = WideRows<R>::kThreads, NG = WideCell<kLstm>::NG;
  extern __shared__ __align__(16) float wide_smem[];
  const WideDims<kLstm> d(H);
  const int G = d.G;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* hT = wide_smem;              // [2, HQ, S] by step parity
  float* Wf = hT + 2 * d.HQ * S;      // [HQ, NUP, 8]
  float* mb = Wf + d.HQ * d.NUP * 8;  // [2, R]
  float* xb = mb + 2 * R;             // [2, R, G]
  const WideThread<R> th;
  const bool working = th.uq < d.NQ;
  wide_stage<kLstm, kT>(wide_smem, wide_fwd_floats<kLstm>(H), w, Wf, nullptr, H);
  // LSTM: the thread's cells (rows th.row(i), units 2 up + u): h, c and the peepholes in registers
  float hr[4][2], cr[4][2], pp[2][3];
  if constexpr (kLstm) {
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
  } else {
    for (int e = threadIdx.x; e < rows * H; e += kT) {
      const int r = e / H, j = e % H;
      hT[j * S + r] = h0[(size_t)row0 * H + e];
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
      const float* hc = hT + p * d.HQ * S;
      float* hn = hT + (p ^ 1) * d.HQ * S;
      const float* xt = xb + p * R * G;
      float hid[4][2 * NG];
      wide_hid(hc, Wf, H, d, th, hid);
      const float4 mk = ld4(mb + p * R + th.row(0));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * th.up + u;
        if (j >= H) continue;
        if constexpr (kLstm) {
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
        } else {
          const float4 hold = ld4(hc + j * S + th.row(0));
          float hnew[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = th.row(i);
            const float h = lane4(hold, i);
            if (r < rows) hs[((size_t)t * B + row0 + r) * H + j] = h;
            const float xv[3] = {xt[r * G + j], xt[r * G + H + j], xt[r * G + 2 * H + j]};
            const float hv[3] = {hid[i][u], hid[i][2 + u], hid[i][4 + u]};
            const float cell = gru_cell(xv, hv, h);  // computed at every step, kept where the mask is on
            hnew[i] = lane4(mk, i) > 0.0f ? cell : h;
          }
          *reinterpret_cast<float4*>(hn + j * S + th.row(0)) = make_float4(hnew[0], hnew[1], hnew[2], hnew[3]);
        }
      }
    }
    cp_async_wait_all();  // step t+1's inputs
    __syncthreads();
  }
  if constexpr (kLstm) {
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
  } else {
    const float* hf = hT + (L & 1) * d.HQ * S;
    for (int e = threadIdx.x; e < rows * H; e += kT) {
      const int r = e / H, j = e % H;
      out[(size_t)row0 * H + e] = hf[j * S + r];
    }
  }
}

template <bool kLstm>
__global__ void __launch_bounds__(WideRows<kWideBwdRows>::kThreads, 1) wide_backward_kernel(
    const float* __restrict__ x,      // [B, L, G]
    const float* __restrict__ mask,   // [B, L]
    const float* __restrict__ w,      // [H, G]
    const float* __restrict__ peep,   // [3, H] (LSTM)
    const float* __restrict__ hs,     // [L, B, H]
    const float* __restrict__ cs,     // [L, B, H] (LSTM)
    const float* __restrict__ dh_in,  // [B, H]
    float* __restrict__ dx,           // [B, L, G]
    float* __restrict__ dh0,          // [B, H]
    float* __restrict__ dc0,          // [B, H] (LSTM)
    float* __restrict__ dw_part,      // [gridDim.x, H, G]
    float* __restrict__ dpeep_part,   // [gridDim.x, 3H] (LSTM)
    int B, int L, int H, float clip) {
  constexpr int R = kWideBwdRows, S = WideRows<R>::kS, kT = WideRows<R>::kThreads, NG = WideCell<kLstm>::NG;
  constexpr int kDwCols = WideCell<kLstm>::kDwCols;
  extern __shared__ __align__(16) float wide_smem[];
  const WideDims<kLstm> d(H);
  const int G = d.G;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* hpT = wide_smem;             // [3, HQ, S]  h_{t-1} by step % 3
  float* dT = hpT + 3 * d.HQ * S;     // [2, GP, S]  dhid by step parity
  float* Wf = dT + 2 * d.GP * S;      // [HQ, NUP, 8]
  float* Wq = Wf + d.HQ * d.NUP * 8;  // [GP, NQ, 4]
  float* mb = Wq + d.GP * d.NQ * 4;   // [2, R]
  float* xb = mb + 2 * R;             // [2, R, G]
  const WideThread<R> th;
  const bool working = th.uq < d.NQ;
  const unsigned lanes = __ballot_sync(0xffffffffu, working);
  const int cg = th.q + 4 * th.rq;  // dW columns cg + 16 i
  wide_stage<kLstm, kT>(wide_smem, wide_bwd_floats<kLstm>(H), w, Wf, Wq, H);
  // the LSTM's dc, c_{t-1}, peepholes and dpeep sums ride beside dh
  float hid[4][2 * NG], dh[4][2], dc[4][2], cp[4][2], pp[2][3], dpp[2][3], dwr[4][kDwCols];
  if constexpr (kLstm) {
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
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = th.row(i), j = 2 * th.up + u;
        dh[i][u] = (working && r < rows && j < H) ? dh_in[(size_t)(row0 + r) * H + j] : 0.0f;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
#pragma unroll
    for (int i = 0; i < kDwCols; ++i) dwr[v][i] = 0.0f;
  }
  auto prefetch = [&](int t) {
    wide_prefetch<kT>(x, mask, xb + (t & 1) * R * G, mb + (t & 1) * R, row0, rows, L, G, t);
    wide_prefetch_t<R>(hs + ((size_t)t * B + row0) * H, hpT + (t % 3) * d.HQ * S, rows, H);
  };
  prefetch(L - 1);
  cp_async_commit_group();
  if constexpr (kLstm) wide_load_c(cs, th, working, row0, rows, B, H, L - 1, cp);
  cp_async_wait_all();
  __syncthreads();
  if (working) wide_hid(hpT + ((L - 1) % 3) * d.HQ * S, Wf, H, d, th, hid);
  if (L > 1) prefetch(L - 2);
  cp_async_commit_group();

  for (int t = L - 1; t >= 0; --t) {
    const int p = t & 1;
    const float* hq = hpT + (t % 3) * d.HQ * S;
    float* dp = dT + p * d.GP * S;
    float cn[4][2];  // LSTM: c_{t-2}, step t-1's, loaded while step t runs
    if constexpr (kLstm) wide_load_c(cs, th, working && t >= 1, row0, rows, B, H, t - 1, cn);
    float dd[4][2];  // the part of dh_{t-1} outside W: dh itself at a masked step
    // gate cotangents of step t from the thread's hid tile: dx, dhid^T, dd (LSTM: dc_{t-1}, dpeep terms)
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
        float4 hold;  // GRU: h_{t-1} of the unit at the tile's rows
        if constexpr (!kLstm) hold = ld4(hq + j * S + th.row(0));
        float dv4[NG][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = th.row(i);
          if constexpr (kLstm) {
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
          } else {
            const float xv[3] = {xt[r * G + j], xt[r * G + H + j], xt[r * G + 2 * H + j]};
            const float hv[3] = {hid[i][u], hid[i][2 + u], hid[i][4 + u]};
            float xo[3], dv[3], ddv;
            gru_cell_bwd(xv, hv, lane4(hold, i), dh[i][u], clip, xo, dv, ddv);
            const bool on = lane4(mk, i) > 0.0f;
            dd[i][u] = on ? ddv : dh[i][u];
            if (r < rows) {
              float* dxt = dx + ((size_t)(row0 + r) * L + t) * G + j;
              dxt[0] = on ? xo[0] : 0.0f;
              dxt[H] = on ? xo[1] : 0.0f;
              dxt[2 * H] = on ? xo[2] : 0.0f;
            }
#pragma unroll
            for (int g = 0; g < 3; ++g) dv4[g][i] = on ? dv[g] : 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < NG; ++g) {
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
      // dh_{t-1} = dd + dhid W^T: the octet's rows by the quad's units over the column quarter q
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      const float* dq = dp + th.q * d.CQ * S + 8 * th.rq;
      const float* wq = Wq + (th.q * d.CQ * d.NQ + th.uq) * 4;
#pragma unroll (WideCell<kLstm>::kDhUnroll)
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
      // dW[4 uq + v, cg + 16 i] += sum over the 32 rows of h_{t-1} dhid
      const float* ha = hq + 4 * th.uq * S;
      const float* dcol = dp + cg * S;
#pragma unroll 1
      for (int rb = 0; rb < R; rb += 4) {
        float4 hv[4], dv[kDwCols];
#pragma unroll
        for (int v = 0; v < 4; ++v) hv[v] = ld4(ha + v * S + rb);
#pragma unroll
        for (int i = 0; i < kDwCols; ++i) {  // the columns' rows end at GP
          dv[i] = 16 * i < d.GP ? ld4(dcol + 16 * i * S + rb) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        // row by row over the block: 4 kDwCols independent sums a row, not 4-long chains
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int i = 0; i < kDwCols; ++i) {
#pragma unroll
            for (int v = 0; v < 4; ++v) dwr[v][i] = fmaf(lane4(hv[v], e), lane4(dv[i], e), dwr[v][i]);
          }
        }
      }
      // hid of step t-1 from h_{t-2}
      if (t >= 1) wide_hid(hpT + ((t - 1) % 3) * d.HQ * S, Wf, H, d, th, hid);
    }
    if constexpr (kLstm) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int u = 0; u < 2; ++u) cp[i][u] = cn[i][u];
      }
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
          if constexpr (kLstm) dc0[(size_t)(row0 + r) * H + j] = dc[i][u];
        }
      }
    }
    if constexpr (kLstm) {
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
    }
    float* part = dw_part + (size_t)blockIdx.x * H * G;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int k = 4 * th.uq + v;
#pragma unroll
      for (int i = 0; i < kDwCols; ++i) {
        const int c = cg + 16 * i;
        if (k < H && c < G) part[(size_t)k * G + c] = dwr[v][i];
      }
    }
  }
}

// The forward on the wide path: h0 (c0) -> out [B, H], hs (cs) [L, B, H].
template <bool kLstm>
inline int wide_forward(const float* x, const float* mask, const float* w, const float* peep, const float* h0,
                        const float* c0, float* out, float* hs, float* cs, int B, int L, int H, int R,
                        cudaStream_t stream) {
  constexpr int kR = kWideFwdRows;
  const long long smem = wide_smem_bytes<kLstm>(0, H, R);
  if (smem < 0 || !wide_x_ok<kLstm>(x, H)) return (int)cudaErrorInvalidValue;
  const int err = allow_smem_once((const void*)wide_forward_kernel<kLstm, kR>, (size_t)smem);
  if (err) return err;
  wide_forward_kernel<kLstm, kR><<<(B + kR - 1) / kR, WideRows<kR>::kThreads, (size_t)smem, stream>>>(
      x, mask, w, peep, h0, c0, out, hs, cs, B, L, H);
  return (int)cudaGetLastError();
}

// The backward on the wide path: dx, dh0 (dc0), and dW (dpeep) straight
// into dw (dpeep) where one CTA holds every row, else per-CTA partials in
// part [ceil(B / R), H, G] (peep_part [ceil(B / R), 3H]) summed in block
// order.
template <bool kLstm>
inline int wide_backward(const float* x, const float* mask, const float* w, const float* peep, const float* hs,
                         const float* cs, const float* dh, float* dx, float* dh0, float* dc0, float* dw,
                         float* dpeep, float* part, float* peep_part, int B, int L, int H, int R, float clip,
                         cudaStream_t stream) {
  const long long smem = wide_smem_bytes<kLstm>(1, H, R);
  if (smem < 0 || !wide_x_ok<kLstm>(x, H)) return (int)cudaErrorInvalidValue;
  const int grid = (B + R - 1) / R;
  if (grid > 1 && (part == nullptr || (kLstm && peep_part == nullptr))) return (int)cudaErrorInvalidValue;
  int err = allow_smem_once((const void*)wide_backward_kernel<kLstm>, (size_t)smem);
  if (err) return err;
  wide_backward_kernel<kLstm><<<grid, WideRows<kWideBwdRows>::kThreads, (size_t)smem, stream>>>(
      x, mask, w, peep, hs, cs, dh, dx, dh0, dc0, grid > 1 ? part : dw, grid > 1 ? peep_part : dpeep, B, L, H,
      clip);
  err = (int)cudaGetLastError();
  if (err || grid == 1) return err;
  err = launch_sum_splits(part, dw, grid, (size_t)H * WideCell<kLstm>::NG * H, stream);
  if (err || !kLstm) return err;
  return launch_sum_splits(peep_part, dpeep, grid, (size_t)3 * H, stream);
}

}  // namespace
