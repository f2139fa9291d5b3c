// The training scans' "reg" path (K1 and K5 at H <= 50, the flagship's
// B=16, L=30, H=50): W_hid held in registers for all L steps, in the
// manner of persistent RNNs, forward and backward, GRU and LSTM.
//
// What bounds it on an H100: the L dependent steps. At B=16, H=50 the
// work is tiny (K1's backward: 3 x 2 B L H 3H = 21.6 MFLOP), so a step
// costs its critical path: the longest chain of dependent FMAs, the
// barriers, and the global loads on the way.
//
// Design: one block of kRegThreads threads per tile of R rows (R from
// the wrapper's plan) holds W [H, G] (G = 3H or 4H) twice in registers:
// - layout A: thread a = 4 c + s holds column c, rows s KC .. s KC + KC - 1
//   (KC = ceil(H / 4)). It gives a partial of hid[r, c] = sum_k h[r, k]
//   W[k, c]; the 4 partials of a column sit in 4 neighbouring lanes and
//   are summed by two xor shuffles (a fixed tree: every lane gets the same
//   bits). The same thread sums dW[k, c] over its k's, rows and steps in
//   registers (a fixed order), so no dhid scratch leaves the kernel.
// - layout B: thread b = 16 k + s holds row k, columns s CC .. s CC + CC
//   - 1 (CC = ceil(G / 16)). It gives a partial of dh_{t-1}[r, k] =
//   sum_c dhid[r, c] W[k, c], summed over 16 lanes by four xor shuffles.
// Chains are at most 13 FMAs (H=50) plus the shuffles, where the kernels
// before this one ran chains of 50 and 150. Every phase uses every
// thread. The step's x_pre, mask (and for the backward h_{t-1}, c_{t-1})
// are copied into shared memory by cp.async a step ahead (two buffers for
// the forward, three for the backward, whose next-but-one copy starts
// while the current buffer is still read), so no global load is on the
// critical path (copies two steps ahead measured no faster). Barriers: two a step. The backward folds step t's dh
// and dW products and step t-1's hid recompute into one phase (hid is
// double-buffered by step parity). Blocks write their dW (and LSTM
// dpeep) partials, which the launcher sums in block order (split_sum.cuh),
// or straight into dW where one block holds every row. No atomics.

#pragma once

#include "scan_cells.cuh"

namespace {

constexpr int kRegThreads = 800;  // 4 x 200 columns (LSTM, H=50) and 16 x 50 rows
constexpr int kRegKS = 4;         // k slices of a column (layout A)
constexpr int kRegCS = 16;        // column slices of a row (layout B)
constexpr int kRegKC = 13;        // most k a thread holds: ceil(50 / 4)
constexpr int kRegCC = 13;        // most columns a thread holds: ceil(200 / 16)
constexpr int kRegHs = kRegKS * kRegKC;  // row stride of the h buffers (52)
constexpr int kRegGs = kRegCS * kRegCC;  // row stride of the hid buffers (208)
constexpr int kRegMaxH = 50;
constexpr int kRegMaxRows = 16;

// floats of shared memory of one block (the launchers' and the plan's)
__host__ __device__ inline int reg_fwd_floats(int n_gates, int H, int R) {
  // h, c [R, 52], hid [R, 208], x [2, R, G], mask [2, R]
  return R * (2 * kRegHs + kRegGs + 2 * n_gates * H + 2);
}
__host__ __device__ inline int reg_bwd_floats(int n_gates, int H, int R) {
  // hp, cp [3, R, 52], dh, dc, dd [R, 52], hid [2, R, 208], x [3, R, G],
  // mask [3, R], dpeep terms [R, 3H]
  return R * (9 * kRegHs + 2 * kRegGs + 3 * n_gates * H + 3 + 3 * H);
}

// Columns of W held in layout A: wa[i] = W[s KC + i, c]; and in layout B:
// wb[j] = W[k, s CC + j]; zeros outside W.
__device__ __forceinline__ void load_w_regs(const float* __restrict__ w, int H, int G,
                                            float wa[kRegKC], float wb[kRegCC]) {
  const int KC = (H + kRegKS - 1) / kRegKS, CC = (G + kRegCS - 1) / kRegCS;
  const int ca = threadIdx.x / kRegKS, sa = threadIdx.x % kRegKS;
  const int kb = threadIdx.x / kRegCS, sb = threadIdx.x % kRegCS;
#pragma unroll
  for (int i = 0; i < kRegKC; ++i) {
    const int k = sa * KC + i;
    wa[i] = (ca < G && i < KC && k < H) ? w[(size_t)k * G + ca] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kRegCC; ++j) {
    const int c = sb * CC + j;
    wb[j] = (kb < H && j < CC && c < G) ? w[(size_t)kb * G + c] : 0.0f;
  }
}

// hid[r, c] = h[r] . W[:, c] for r < rows (h [rows, 52], hid [rows, 208]);
// the first lane of each column's four stores it.
__device__ __forceinline__ void reg_hid(const float* __restrict__ h, float* __restrict__ hid,
                                        const float wa[kRegKC], int rows, int H, int G) {
  const int KC = (H + kRegKS - 1) / kRegKS;
  const int ca = threadIdx.x / kRegKS, sa = threadIdx.x % kRegKS;
  for (int r = 0; r < rows; ++r) {
    const float* hr = h + r * kRegHs + sa * KC;
    float p = 0.0f;
#pragma unroll
    for (int i = 0; i < kRegKC; ++i) p = fmaf(hr[i], wa[i], p);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (sa == 0 && ca < G) hid[r * kRegGs + ca] = p;
  }
}

// The step's x_pre rows [rows, G] and mask [rows] into shared memory,
// asynchronously (the caller commits and waits).
__device__ __forceinline__ void reg_prefetch(const float* __restrict__ x,
                                             const float* __restrict__ mask, float* xb, float* mb,
                                             int row0, int rows, int L, int G, int t) {
  for (int e = threadIdx.x; e < rows * G; e += kRegThreads) {
    const int r = e / G, c = e - r * G;
    cp_async4(xb + e, x + ((size_t)(row0 + r) * L + t) * G + c);
  }
  for (int r = threadIdx.x; r < rows; r += kRegThreads) cp_async4(mb + r, mask + (size_t)(row0 + r) * L + t);
}

// rows [rows, H] of a [*, H] state at row0 into a [rows, 52] buffer
__device__ __forceinline__ void reg_prefetch_state(const float* __restrict__ src, float* dst,
                                                   int rows, int H) {
  for (int e = threadIdx.x; e < rows * H; e += kRegThreads) {
    const int r = e / H, j = e - r * H;
    cp_async4(dst + r * kRegHs + j, src + e);
  }
}

// kStoreStates: store h_{t-1} (and c_{t-1}) of every step into hs (cs), the
// training scan's residuals; off for the eval scan (K6), which takes null
// hs, cs.
template <bool kLstm, bool kStoreStates = true>
__global__ void __launch_bounds__(kRegThreads, 1) reg_forward_kernel(
    const float* __restrict__ x,     // [B, L, G]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, G]
    const float* __restrict__ peep,  // [3, H] (LSTM)
    const float* __restrict__ h0,    // [B, H]
    const float* __restrict__ c0,    // [B, H] (LSTM)
    float* __restrict__ out,         // [B, H]
    float* __restrict__ hs,          // [L, B, H]: h_{t-1} of step t (kStoreStates)
    float* __restrict__ cs,          // [L, B, H]: c_{t-1} of step t (LSTM, kStoreStates)
    int B, int L, int H, int R) {
  constexpr int NG = kLstm ? 4 : 3;
  extern __shared__ float smem[];
  const int G = NG * H;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* h = smem;                 // [R, 52]
  float* c = h + R * kRegHs;       // [R, 52] (LSTM)
  float* hid = c + R * kRegHs;     // [R, 208]
  float* xb = hid + R * kRegGs;    // [2, R, G] by step parity
  float* mb = xb + 2 * R * G;      // [2, R]
  float wa[kRegKC], wb[kRegCC];
  load_w_regs(w, H, G, wa, wb);
  for (int e = threadIdx.x; e < R * kRegHs; e += kRegThreads) {
    const int r = e / kRegHs, j = e - r * kRegHs;
    const bool in = r < rows && j < H;
    h[e] = in ? h0[(size_t)(row0 + r) * H + j] : 0.0f;
    if (kLstm) c[e] = in ? c0[(size_t)(row0 + r) * H + j] : 0.0f;
  }
  if (L > 0) reg_prefetch(x, mask, xb, mb, row0, rows, L, G, 0);
  cp_async_commit_group();
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const float* xt = xb + (t & 1) * R * G;
    const float* mt = mb + (t & 1) * R;
    if (t + 1 < L) reg_prefetch(x, mask, xb + ((t + 1) & 1) * R * G, mb + ((t + 1) & 1) * R, row0, rows, L, G, t + 1);
    cp_async_commit_group();
    reg_hid(h, hid, wa, rows, H, G);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * H; e += kRegThreads) {
      const int r = e / H, j = e - r * H;
      float* hr = h + r * kRegHs + j;
      if (kStoreStates) {
        const size_t o = ((size_t)t * B + row0 + r) * H + j;
        hs[o] = *hr;
        if (kLstm) cs[o] = c[r * kRegHs + j];
      }
      if (mt[r] > 0.0f) {
        float xv[NG], hv[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          xv[g] = xt[r * G + g * H + j];
          hv[g] = hid[r * kRegGs + g * H + j];
        }
        if constexpr (kLstm) {
          const float p[3] = {peep[j], peep[H + j], peep[2 * H + j]};
          lstm_cell(xv, hv, p, *hr, c[r * kRegHs + j]);
        } else {
          *hr = gru_cell(xv, hv, *hr);
        }
      }
    }
    cp_async_wait_all();  // step t+1's inputs
    __syncthreads();
  }
  for (int e = threadIdx.x; e < rows * H; e += kRegThreads) {
    const int r = e / H, j = e - r * H;
    out[(size_t)(row0 + r) * H + j] = h[r * kRegHs + j];
  }
}

template <bool kLstm>
__global__ void __launch_bounds__(kRegThreads, 1) reg_backward_kernel(
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
    int B, int L, int H, int R, float clip) {
  constexpr int NG = kLstm ? 4 : 3;
  extern __shared__ float smem[];
  const int G = NG * H, P = 3 * H;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* hp = smem;                 // [3, R, 52]  h_{t-1} by step % 3
  float* cp = hp + 3 * R * kRegHs;  // [3, R, 52]  c_{t-1} (LSTM)
  float* dh = cp + 3 * R * kRegHs;  // [R, 52]
  float* dc = dh + R * kRegHs;      // [R, 52]     (LSTM)
  float* dd = dc + R * kRegHs;      // [R, 52]     the part of dh_{t-1} outside W
  float* hid = dd + R * kRegHs;     // [2, R, 208] hid by step parity, then dhid
  float* xb = hid + 2 * R * kRegGs; // [3, R, G]
  float* mb = xb + 3 * R * G;       // [3, R]
  float* dp = mb + 3 * R;           // [R, 3H]     the step's dpeep terms (LSTM)
  const int KC = (H + kRegKS - 1) / kRegKS, CC = (G + kRegCS - 1) / kRegCS;
  const int ca = threadIdx.x / kRegKS, sa = threadIdx.x % kRegKS;
  const int kb = threadIdx.x / kRegCS, sb = threadIdx.x % kRegCS;
  float wa[kRegKC], wb[kRegCC], dwa[kRegKC];
  load_w_regs(w, H, G, wa, wb);
#pragma unroll
  for (int i = 0; i < kRegKC; ++i) dwa[i] = 0.0f;
  float pacc = 0.0f;  // dpeep column threadIdx.x (LSTM)
  for (int e = threadIdx.x; e < reg_bwd_floats(NG, H, R); e += kRegThreads) smem[e] = 0.0f;
  __syncthreads();
  for (int e = threadIdx.x; e < rows * H; e += kRegThreads) {
    const int r = e / H, j = e - r * H;
    dh[r * kRegHs + j] = dh_in[(size_t)(row0 + r) * H + j];
  }
  auto prefetch = [&](int t) {
    const int q = t % 3;
    reg_prefetch(x, mask, xb + q * R * G, mb + q * R, row0, rows, L, G, t);
    reg_prefetch_state(hs + ((size_t)t * B + row0) * H, hp + q * R * kRegHs, rows, H);
    if (kLstm) reg_prefetch_state(cs + ((size_t)t * B + row0) * H, cp + q * R * kRegHs, rows, H);
  };
  prefetch(L - 1);
  cp_async_commit_group();
  cp_async_wait_all();
  __syncthreads();
  reg_hid(hp + ((L - 1) % 3) * R * kRegHs, hid + ((L - 1) & 1) * R * kRegGs, wa, rows, H, G);
  if (L > 1) prefetch(L - 2);
  cp_async_commit_group();
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    const int q = t % 3;
    float* hd = hid + (t & 1) * R * kRegGs;
    const float* hpt = hp + q * R * kRegHs;
    // gate cotangents of step t: hid becomes dhid (dpre) in place
    for (int e = threadIdx.x; e < rows * H; e += kRegThreads) {
      const int r = e / H, j = e - r * H;
      float* dxt = dx + ((size_t)(row0 + r) * L + t) * G;
      const float g_h = dh[r * kRegHs + j];
      float d[NG], xo[NG];
      if (mb[q * R + r] > 0.0f) {
        float xv[NG], hv[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          xv[g] = xb[q * R * G + r * G + g * H + j];
          hv[g] = hd[r * kRegGs + g * H + j];
        }
        if constexpr (kLstm) {
          const float p[3] = {peep[j], peep[H + j], peep[2 * H + j]};
          float terms[3];
          lstm_cell_bwd(xv, hv, cp[q * R * kRegHs + r * kRegHs + j], p, g_h, clip, d,
                        dc[r * kRegHs + j], terms);
#pragma unroll
          for (int g = 0; g < NG; ++g) xo[g] = d[g];
#pragma unroll
          for (int g = 0; g < 3; ++g) dp[r * P + g * H + j] = terms[g];
          dd[r * kRegHs + j] = 0.0f;
        } else {
          gru_cell_bwd(xv, hv, hpt[r * kRegHs + j], g_h, clip, xo, d, dd[r * kRegHs + j]);
        }
      } else {  // dh (and dc) pass through a masked step
#pragma unroll
        for (int g = 0; g < NG; ++g) d[g] = xo[g] = 0.0f;
        if (kLstm) {
#pragma unroll
          for (int g = 0; g < 3; ++g) dp[r * P + g * H + j] = 0.0f;
        }
        dd[r * kRegHs + j] = g_h;
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        dxt[g * H + j] = xo[g];
        hd[r * kRegGs + g * H + j] = d[g];
      }
    }
    cp_async_wait_all();  // step t-1's inputs
    __syncthreads();
    // dh_{t-1} = dd + dhid . W^T (layout B); dW += h_{t-1}^T dhid (layout A)
    for (int r = 0; r < rows; ++r) {
      const float* dr = hd + r * kRegGs + sb * CC;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kRegCC; ++j) s = fmaf(dr[j], wb[j], s);
#pragma unroll
      for (int m = 1; m < kRegCS; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (sb == 0 && kb < H) dh[r * kRegHs + kb] = dd[r * kRegHs + kb] + s;
      const float dv = ca < G ? hd[r * kRegGs + ca] : 0.0f;
      const float* hr = hpt + r * kRegHs + sa * KC;
#pragma unroll
      for (int i = 0; i < kRegKC; ++i) dwa[i] = fmaf(hr[i], dv, dwa[i]);
    }
    if (kLstm && threadIdx.x < P) {
      for (int r = 0; r < rows; ++r) pacc += dp[r * P + threadIdx.x];
    }
    // hid of step t-1, and the copies of step t-2
    if (t >= 1) reg_hid(hp + ((t - 1) % 3) * R * kRegHs, hid + ((t - 1) & 1) * R * kRegGs, wa, rows, H, G);
    if (t >= 2) prefetch(t - 2);
    cp_async_commit_group();
    __syncthreads();
  }
  for (int e = threadIdx.x; e < rows * H; e += kRegThreads) {
    const int r = e / H, j = e - r * H;
    dh0[(size_t)(row0 + r) * H + j] = dh[r * kRegHs + j];
    if (kLstm) dc0[(size_t)(row0 + r) * H + j] = dc[r * kRegHs + j];
  }
  float* part = dw_part + (size_t)blockIdx.x * H * G;
  if (ca < G) {
#pragma unroll
    for (int i = 0; i < kRegKC; ++i) {
      const int k = sa * KC + i;
      if (i < KC && k < H) part[(size_t)k * G + ca] = dwa[i];
    }
  }
  if (kLstm && threadIdx.x < P) dpeep_part[(size_t)blockIdx.x * P + threadIdx.x] = pacc;
}

}  // namespace
