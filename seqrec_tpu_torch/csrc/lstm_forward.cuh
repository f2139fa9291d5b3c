// Forward LSTM over time, shared by the eval scan (lstm_scan.cu, K6) and the
// training scan (lstm_scan_train.cu, K5). Lasagne's cell with peepholes,
// gate order in|forget|cell|out, peep [3, H] = (w_ci, w_cf, w_co):
//   hid = h . W_hid                                   [rows, 4H]
//   i = sigmoid(x_i + hid_i + c w_ci), f = sigmoid(x_f + hid_f + c w_cf)
//   g = tanh(x_g + hid_g), c' = f c + i g
//   o = sigmoid(x_o + hid_o + c' w_co), h' = o tanh(c')
// (h, c) become (h', c') only where mask > 0.
//
// What bounds it on an H100: the L steps depend on each other. At the
// LSTM path's shape (B=1024, L=30, H=128) the work is 2 B L H 4H = 4.0
// GFLOP of f32 FMAs (0.06 ms at 67 TFLOP/s), while W_hid [128, 512] is
// 256 KB, more than a block's 227 KB of shared memory, so each block reads
// it through L2 every step.
//
// Design (gru_forward.cuh's): one block per tile of `rows` batch rows runs
// the whole L-step loop, so h and c never leave shared memory between
// steps. The tile is chosen so the grid has about one block per SM (rows =
// ceil(B / SMs), at most 8). Each step has two phases with a barrier
// between them: threads own gate columns of the [rows, H] x [H, 4H]
// product (one W_hid element feeds all rows of the tile from a register),
// then (row, unit) pairs for the gate math. W_hid is staged in shared
// memory when it fits beside the state (H=50: 40 KB) and read through L2
// otherwise. Any H is taken as is: no padding to a lane multiple. With
// kStoreStates the training scan also writes h_{t-1} and c_{t-1} of every
// step to hs, cs [L, B, H], the residuals its backward needs.

#pragma once

#include "scan_common.cuh"

namespace {

// The gates of unit j from x_pre[t] of one row (xt), its hid row (hr) and
// the previous cell state cp.
struct LstmGates {
  float i, f, g, c, o;
};

__device__ __forceinline__ LstmGates lstm_gates(const float* __restrict__ xt,
                                                const float* __restrict__ hr,
                                                const float* __restrict__ peep, float cp, int j,
                                                int H) {
  LstmGates z;
  z.i = sigmoid_f(xt[j] + hr[j] + cp * peep[j]);
  z.f = sigmoid_f(xt[H + j] + hr[H + j] + cp * peep[H + j]);
  z.g = tanhf(xt[2 * H + j] + hr[2 * H + j]);
  z.c = z.f * cp + z.i * z.g;
  z.o = sigmoid_f(xt[3 * H + j] + hr[3 * H + j] + z.c * peep[2 * H + j]);
  return z;
}

template <bool kWShared, bool kStoreStates>
__global__ void __launch_bounds__(kThreads) lstm_forward_kernel(
    const float* __restrict__ x,     // [B, L, 4H]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, 4H]
    const float* __restrict__ peep,  // [3, H]
    const float* __restrict__ h0,    // [B, H]
    const float* __restrict__ c0,    // [B, H]
    float* __restrict__ out,         // [B, H]
    float* __restrict__ hs,          // [L, B, H] when kStoreStates
    float* __restrict__ cs,          // [L, B, H] when kStoreStates
    int B, int L, int H, int rows_per_block) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, B - row0);
  float* h = smem;                       // [rows_per_block, H]
  float* c = h + rows_per_block * H;     // [rows_per_block, H]
  float* hid = c + rows_per_block * H;   // [rows_per_block, 4H]
  float* ws = hid + rows_per_block * G;  // [H, 4H] when kWShared
  const float* wr = kWShared ? ws : w;

  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    h[i] = h0[(size_t)row0 * H + i];
    c[i] = c0[(size_t)row0 * H + i];
  }
  if (kWShared) {
    for (int i = threadIdx.x; i < H * G; i += kThreads) ws[i] = w[i];
  }
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    // phase 1: hid = h . W_hid
    rows_product(h, wr, hid, nullptr, rows, H, G);
    __syncthreads();
    // phase 2: gate math; masked steps carry (h, c) through
    for (int i = threadIdx.x; i < rows * H; i += kThreads) {
      const int r = i / H;
      const int j = i - r * H;
      const size_t b = (size_t)row0 + r;
      if (kStoreStates) {
        hs[((size_t)t * B + b) * H + j] = h[i];
        cs[((size_t)t * B + b) * H + j] = c[i];
      }
      if (mask[b * L + t] > 0.0f) {
        const LstmGates z = lstm_gates(x + (b * L + t) * G, hid + r * G, peep, c[i], j, H);
        h[i] = z.o * tanhf(z.c);
        c[i] = z.c;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * H; i += kThreads) out[(size_t)row0 * H + i] = h[i];
}

template <bool kStoreStates>
int launch_lstm_forward(const float* x, const float* mask, const float* w, const float* peep,
                        const float* h0, const float* c0, float* out, float* hs, float* cs, int B,
                        int L, int H, void* stream) {
  if (B <= 0 || L < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int rows = scan_rows_per_block(B);
  const size_t base = (size_t)rows * 6 * H * sizeof(float);  // h, c [rows, H] + hid [rows, 4H]
  const size_t w_bytes = (size_t)4 * H * H * sizeof(float);
  return launch_scan(lstm_forward_kernel<true, kStoreStates>,
                     lstm_forward_kernel<false, kStoreStates>, base, w_bytes,
                     (B + rows - 1) / rows, (cudaStream_t)stream, x, mask, w, peep, h0, c0, out,
                     hs, cs, B, L, H, rows);
}

}  // namespace
