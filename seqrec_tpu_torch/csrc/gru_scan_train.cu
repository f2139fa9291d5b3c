// GRU training scan: the forward that keeps h_{t-1} of every step, and its
// backward (kernel K1).
//
// Replaces seqrec_tpu/ops/pallas_rnn_train.py:_fwd_kernel and _bwd_kernel
// (reached through gru_scan_train, a custom VJP). Backward math per
// unmasked step, gate order reset|update|candidate, with the gates
// recomputed from x_pre[t] and h_{t-1}:
//   du = dh (c - h_{t-1});  dc = dh u;  dcpre = dc (1 - c^2)
//   dr = dcpre hid_c;  drpre = dr r (1 - r);  dupre = du u (1 - u)
//   dhid = clip([drpre, dupre, dcpre r], +-grad_clip), 0 on masked steps
//   dx[t] = [drpre, dupre, dcpre] (unclipped; the caller clips x_pre), 0 when masked
//   dh_{t-1} = dh (1 - u) + dhid . W_hid^T, or dh itself on masked steps
//   dW_hid = sum over steps and rows of h_{t-1}^T dhid.
//
// What bounds it on an H100: the walk is L dependent steps, latency-bound
// at the flagship shape (B=16, L=30, H=50: 21.6 MFLOP for the backward);
// at B=1024, H=128 the three per-step products (recompute hid, dhid . W^T,
// and dW) dominate: 3 x 2 B L H 3H = 9.1 GFLOP of f32 FMAs.
//
// Design: four paths, chosen by the wrapper's plan (scan_train.cuh):
// - reg (H <= 50): W_hid in registers, forward and backward, dW summed in
//   registers inside the scan (scan_train_reg.cuh);
// - wide (H <= 50 with more than 16 rows an SM): backward CTAs of 32 rows
//   in one wave, forward CTAs of 16 rows several an SM, the per-step
//   products as register micro-tiles from W_hid in shared memory, dW
//   summed in registers (scan_train_wide.cuh, K5's kernels too);
// - cluster (H up to 32 units a CTA of 8): W_hid split over a thread-block
//   cluster (scan_train_cluster.cuh); the backward writes each step's dhid
//   to scratch [L, B, 3H], and dW = hs^T dhid is a split-K 3xTF32 product
//   (scan_train.cuh launch_dw) whose partials are summed in split order;
// - l2 (larger H): the kernels below, the first port: one block per tile
//   of rows walks t = L-1 .. 0 with dh in shared memory. Per step: load
//   h_{t-1}; threads over gate columns recompute hid = h_{t-1} W; threads
//   over (row, unit) form dx and dhid; threads over units form dh_{t-1}
//   from a transposed copy W^T [3H, H], read through L2 with W; dW as on
//   the cluster path.
// No atomics: the result is the same run after run. Any H and L are taken
// as they are (no lane padding, no time chunks).

#include "gru_forward.cuh"
#include "scan_train.cuh"
#include "scan_train_wide.cuh"

namespace {

template <bool kWShared>
__global__ void __launch_bounds__(kThreads) gru_backward_kernel(
    const float* __restrict__ x,     // [B, L, 3H]
    const float* __restrict__ mask,  // [B, L]
    const float* __restrict__ w,     // [H, 3H]
    const float* __restrict__ wt,    // [3H, H]
    const float* __restrict__ hs,    // [L, B, H], h_{t-1} of step t
    const float* __restrict__ dh_in, // [B, H]
    float* __restrict__ dx,          // [B, L, 3H]
    float* __restrict__ dh0,         // [B, H]
    float* __restrict__ dhid_out,    // [L, B, 3H]
    int B, int L, int H, int rows_per_block, float clip) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, B - row0);
  float* hp = smem;                      // [rows_per_block, H]   h_{t-1}
  float* dh = hp + rows_per_block * H;   // [rows_per_block, H]
  float* dd = dh + rows_per_block * H;   // [rows_per_block, H]   direct part of dh_{t-1}
  float* hid = dd + rows_per_block * H;  // [rows_per_block, 3H] hid, then dhid
  float* ws = hid + rows_per_block * G;  // [H, 3H] when kWShared
  float* wts = ws + H * G;               // [3H, H] when kWShared
  const float* wr = kWShared ? ws : w;
  const float* wtr = kWShared ? wts : wt;

  for (int i = threadIdx.x; i < rows * H; i += kThreads) dh[i] = dh_in[(size_t)row0 * H + i];
  if (kWShared) {
    for (int i = threadIdx.x; i < H * G; i += kThreads) {
      ws[i] = w[i];
      wts[i] = wt[i];
    }
  }

  for (int t = L - 1; t >= 0; --t) {
    // rows of one step are contiguous in hs [L, B, H]
    const float* hs_t = hs + ((size_t)t * B + row0) * H;
    for (int i = threadIdx.x; i < rows * H; i += kThreads) hp[i] = hs_t[i];
    __syncthreads();
    // phase 1: recompute hid = h_{t-1} W
    rows_product(hp, wr, hid, nullptr, rows, H, G);
    __syncthreads();
    // phase 2: gate cotangents; each thread reads and then overwrites only
    // its own three hid columns, so hid becomes dhid in place
    for (int i = threadIdx.x; i < rows * H; i += kThreads) {
      const int r = i / H;
      const int j = i - r * H;
      const size_t b = (size_t)row0 + r;
      float* hr = hid + r * G;
      float* dxt = dx + (b * L + t) * G;
      float* dht = dhid_out + ((size_t)t * B + b) * G;
      const float g = dh[i];
      if (mask[b * L + t] > 0.0f) {
        const float* xt = x + (b * L + t) * G;
        const float rg = sigmoid_f(xt[j] + hr[j]);
        const float u = sigmoid_f(xt[H + j] + hr[H + j]);
        const float hidc = hr[2 * H + j];
        const float c = tanhf(xt[2 * H + j] + rg * hidc);
        const float du = g * (c - hp[i]);
        const float dcpre = g * u * (1.0f - c * c);
        const float drpre = dcpre * hidc * rg * (1.0f - rg);
        const float dupre = du * u * (1.0f - u);
        float d0 = drpre, d1 = dupre, d2 = dcpre * rg;
        if (clip > 0.0f) {
          d0 = fminf(fmaxf(d0, -clip), clip);
          d1 = fminf(fmaxf(d1, -clip), clip);
          d2 = fminf(fmaxf(d2, -clip), clip);
        }
        dxt[j] = drpre;
        dxt[H + j] = dupre;
        dxt[2 * H + j] = dcpre;
        hr[j] = d0;
        hr[H + j] = d1;
        hr[2 * H + j] = d2;
        dd[i] = g * (1.0f - u);
      } else {
        dxt[j] = dxt[H + j] = dxt[2 * H + j] = 0.0f;
        hr[j] = hr[H + j] = hr[2 * H + j] = 0.0f;
        dd[i] = g;  // dh passes through a masked step
      }
      dht[j] = hr[j];
      dht[H + j] = hr[H + j];
      dht[2 * H + j] = hr[2 * H + j];
    }
    __syncthreads();
    // phase 3: dh_{t-1}[r, k] = dd[r, k] + sum_c dhid[r, c] W^T[c, k]
    for (int k = threadIdx.x; k < H; k += kThreads) {
      float acc[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.0f;
      for (int c = 0; c < G; ++c) {
        const float wk = wtr[c * H + k];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) acc[r] = fmaf(hid[r * G + c], wk, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) dh[r * H + k] = dd[r * H + k] + acc[r];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * H; i += kThreads) dh0[(size_t)row0 * H + i] = dh[i];
}

}  // namespace

extern "C" int seqrec_gru_train_fwd_f32(const float* x, const float* mask, const float* w,
                                        const float* h0, float* out, float* hs, int B, int L,
                                        int H, int path, int C, int R, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (path == kPathL2) return launch_gru_forward<true>(x, mask, w, h0, out, hs, B, L, H, stream);
  if (path == kPathWide)
    return wide_forward<false>(x, mask, w, nullptr, h0, nullptr, out, hs, nullptr, B, L, H, R, (cudaStream_t)stream);
  return train_forward<false>(x, mask, w, nullptr, h0, nullptr, out, hs, nullptr, B, L, H, path, C,
                              R, (cudaStream_t)stream);
}

// dh [B, H] -> dx [B, L, 3H], dh0 [B, H], dw [H, 3H]. Scratch from the
// caller, by path: reg and wide: part [ceil(B / R), H, 3H] where that is
// over 1 block; cluster and l2: dhid [L, B, 3H] and part [n_splits, H, 3H] (the
// K = L * B rows of the dW product in n_splits ranges of k_per_split
// rows); l2 also wt = W^T [3H, H].
extern "C" int seqrec_gru_train_bwd_f32(const float* x, const float* mask, const float* w,
                                        const float* wt, const float* hs, const float* dh,
                                        float* dx, float* dh0, float* dw, float* dhid,
                                        float* part, int B, int L, int H, int path, int C, int R,
                                        int n_splits, int k_per_split, float clip, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == kPathReg)
    return train_backward_reg<false>(x, mask, w, nullptr, hs, nullptr, dh, dx, dh0, nullptr, dw,
                                     nullptr, part, nullptr, B, L, H, R, clip, s);
  if (path == kPathWide)
    return wide_backward<false>(x, mask, w, nullptr, hs, nullptr, dh, dx, dh0, nullptr, dw, nullptr, part, nullptr, B,
                                L, H, R, clip, s);
  if (n_splits <= 0 || k_per_split <= 0 || (long long)n_splits * k_per_split < (long long)L * B)
    return (int)cudaErrorInvalidValue;
  int err;
  if (path == kPathCluster) {
    err = train_backward_cluster<false>(x, mask, w, nullptr, hs, nullptr, dh, dx, dh0, nullptr, dhid,
                                        nullptr, nullptr, B, L, H, C, R, clip, s);
  } else if (path == kPathL2 && R <= kMaxRows && wt != nullptr) {
    const size_t base = l2_train_floats(3, 1, H, R) * sizeof(float);
    const size_t w_bytes = (size_t)2 * 3 * H * H * sizeof(float);  // W and W^T
    err = launch_scan(gru_backward_kernel<true>, gru_backward_kernel<false>, base, w_bytes,
                      (B + R - 1) / R, s, x, mask, w, wt, hs, dh, dx, dh0, dhid, B, L, H, R, clip);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return launch_dw(hs, dhid, part, dw, L * B, H, 3 * H, n_splits, k_per_split, s);
}

// Clusters of the forward (backward = 0) or backward cluster kernel at
// (H, C, R) that the card holds at once.
extern "C" int seqrec_gru_train_capacity(int backward, int H, int C, int R, int* n_clusters) {
  return train_cluster_capacity<false>(backward, H, C, R, n_clusters);
}

// Shared-memory bytes of one block of the path's kernel (-1: none takes it).
extern "C" long long seqrec_gru_train_smem(int backward, int path, int H, int C, int R) {
  if (path == kPathWide) return wide_smem_bytes<false>(backward, H, R);
  return train_smem_bytes<false>(backward, path, H, C, R);
}

// Blocks of the reg or wide path's forward (backward = 0) or backward
// kernel at (H, R) that one SM holds at once, with the shared memory its
// launcher asks for (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int seqrec_gru_train_blocks_per_sm(int backward, int path, int H, int R, int* n_blocks) {
  const long long smem = seqrec_gru_train_smem(backward, path, H, 1, R);
  if (smem < 0 || (path != kPathReg && path != kPathWide)) return (int)cudaErrorInvalidValue;
  const void* kernel;
  int threads;
  if (path == kPathReg) {
    kernel = backward ? (const void*)reg_backward_kernel<false> : (const void*)reg_forward_kernel<false, true>;
    threads = kRegThreads;
  } else {
    kernel = backward ? (const void*)wide_backward_kernel<false>
                      : (const void*)wide_forward_kernel<false, kWideFwdRows>;
    threads = backward ? WideRows<kWideBwdRows>::kThreads : WideRows<kWideFwdRows>::kThreads;
  }
  const int err = allow_smem_once(kernel, (size_t)smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n_blocks, kernel, threads, (size_t)smem);
}
