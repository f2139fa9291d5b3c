// Forward GRU over time, the first port's single-block kernel, shared by
// the training scan (gru_scan_train.cu, K1) and the eval scan (gru_scan.cu,
// K3) on their "l2" paths: the shapes no cluster slice of theirs holds
// (H above 256 for K1's forward, above about 368 for K3 on an H100). Gate order
// reset|update|candidate:
//   hid = h . W_hid
//   r = sigmoid(x_r + hid_r), u = sigmoid(x_u + hid_u), c = tanh(x_c + r * hid_c)
//   h' = (1 - u) * h + u * c, kept only where mask > 0.
//
// What bounds it on an H100: the L steps depend on each other, and at the
// sizes that reach it the per-step [rows, H] x [H, 3H] product, whose
// W_hid (over 786 KB) is read from L2 in every block and every step.
//
// Design: one block per tile of `rows` batch rows runs the whole L-step
// loop, so h never leaves shared memory between steps. The tile is chosen
// so the grid has about one block per SM (rows = ceil(B / SMs), at most
// 8). Each step has two phases with a barrier between them: threads own
// gate columns of the product (one W_hid element feeds all rows of the
// tile from a register), then (row, unit) pairs for the gate math. K1's
// form stages W_hid in shared memory where it fits beside h and hid and
// reads it through L2 otherwise; K3's form (kStoreHs = false) is launched
// only where W_hid never fits a block, and reads it through L2 alone.
// Any H is taken as is: no padding to a lane multiple. x_pre is read in
// the caller's [B, L, 3H] layout. With kStoreHs the training scan also
// writes h_{t-1} of every step to hs [L, B, H], the one residual its
// backward needs.

#pragma once

#include "scan_common.cuh"

namespace {

template <bool kWShared, bool kStoreHs>
__global__ void __launch_bounds__(kThreads) gru_forward_kernel(
    const float* __restrict__ x,     // [B, L, 3H]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, 3H]
    const float* __restrict__ h0,    // [B, H]
    float* __restrict__ out,         // [B, H]
    float* __restrict__ hs,          // [L, B, H] when kStoreHs
    int B, int L, int H, int rows_per_block) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, B - row0);
  float* h = smem;                       // [rows_per_block, H]
  float* hid = h + rows_per_block * H;   // [rows_per_block, 3H]
  float* ws = hid + rows_per_block * G;  // [H, 3H] when kWShared
  const float* wr = kWShared ? ws : w;

  for (int i = threadIdx.x; i < rows * H; i += kThreads) h[i] = h0[(size_t)row0 * H + i];
  if (kWShared) {
    for (int i = threadIdx.x; i < H * G; i += kThreads) ws[i] = w[i];
  }
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    // phase 1: hid = h . W_hid
    rows_product(h, wr, hid, nullptr, rows, H, G);
    __syncthreads();
    // phase 2: gate math; masked steps carry h through
    for (int i = threadIdx.x; i < rows * H; i += kThreads) {
      const int r = i / H;
      const int j = i - r * H;
      const size_t b = (size_t)row0 + r;
      if (kStoreHs) hs[((size_t)t * B + b) * H + j] = h[i];
      if (mask[b * L + t] > 0.0f) {
        const float* xt = x + (b * L + t) * G;
        const float* hr = hid + r * G;
        const float rg = sigmoid_f(xt[j] + hr[j]);
        const float u = sigmoid_f(xt[H + j] + hr[H + j]);
        const float c = tanhf(xt[2 * H + j] + rg * hr[2 * H + j]);
        h[i] = (1.0f - u) * h[i] + u * c;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * H; i += kThreads) out[(size_t)row0 * H + i] = h[i];
}

template <bool kStoreHs>
int launch_gru_forward(const float* x, const float* mask, const float* w, const float* h0,
                       float* out, float* hs, int B, int L, int H, void* stream) {
  if (B <= 0 || L < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int rows = scan_rows_per_block(B);
  const size_t base = (size_t)rows * 4 * H * sizeof(float);  // h [rows, H] + hid [rows, 3H]
  // K3's form has no shared-W_hid instance: asking for 0 bytes of W_hid,
  // it always launches the L2 one
  const size_t w_bytes = kStoreHs ? (size_t)3 * H * H * sizeof(float) : 0;
  return launch_scan(gru_forward_kernel<kStoreHs, kStoreHs>, gru_forward_kernel<false, kStoreHs>,
                     base, w_bytes, (B + rows - 1) / rows, (cudaStream_t)stream, x, mask, w, h0, out,
                     hs, B, L, H, rows);
}

}  // namespace
