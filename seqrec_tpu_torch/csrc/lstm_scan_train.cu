// LSTM training scan: the forward that keeps h_{t-1} and c_{t-1} of every
// step, and its backward (kernel K5).
//
// Replaces seqrec_tpu/ops/pallas_lstm_train.py:_fwd_kernel and _bwd_kernel
// (reached through lstm_scan_train, a custom VJP). Backward math per
// unmasked step, gate order in|forget|cell|out, the gates recomputed from
// x_pre[t], h_{t-1} and c_{t-1} (lstm_forward.cuh), dh and dc the running
// cotangents (dc starts at 0: the final cell state is not an output):
//   do = dh tanh(c);          dc += dh o (1 - tanh^2(c))
//   dpre_o = do o (1 - o);    dc += dpre_o w_co
//   di = dc g;  df = dc c_{t-1};  dg = dc i;  dc_{t-1} = dc f
//   dpre_i = di i (1 - i);    dc_{t-1} += dpre_i w_ci
//   dpre_f = df f (1 - f);    dc_{t-1} += dpre_f w_cf
//   dpre_g = dg (1 - g^2)
//   dpeep += (dpre_i c_{t-1}, dpre_f c_{t-1}, dpre_o c), unclipped
//   dpre = clip([dpre_i, dpre_f, dpre_g, dpre_o], +-grad_clip)
//   dx[t] = dpre;  dh_{t-1} = dpre . W_hid^T;  dW_hid += h_{t-1}^T dpre
// Lasagne clips the cotangent of the summed pre-activation x + h W_hid, so
// the clipped dpre feeds dx, dh_{t-1} and dW alike, while the peephole
// terms (of dpeep and dc_{t-1}) branch off before the clip. Masked steps
// pass (dh, dc) through untouched and add nothing to dx, dW or dpeep.
//
// What bounds it on an H100: the reverse walk is L dependent steps; at
// B=1024, L=30, H=128 its three products (recompute hid, dpre . W^T, and
// dW) are 3 x 2 B L H 4H = 12.1 GFLOP of f32 FMAs (0.18 ms at 67 TFLOP/s).
//
// Design: four paths, chosen by the wrapper's plan (scan_train.cuh):
// - wide (H <= 50 with at least 14 rows an SM: the benchmark's B=4096):
//   one wave of register-tiled CTAs, W_hid in shared memory, dW and dpeep
//   summed inside the scan (scan_train_wide.cuh, K1's kernels too);
// - reg (H <= 50): W_hid in registers, forward and backward, dW and dpeep
//   summed inside the scan (scan_train_reg.cuh);
// - cluster (H up to 32 units a CTA of 8): W_hid split over a thread-block
//   cluster (scan_train_cluster.cuh); the backward writes each step's
//   clipped, masked dpre to scratch [L, B, 4H], dW = hs^T dpre is a
//   split-K 3xTF32 product (scan_train.cuh launch_dw) with the partials
//   added in split order, and the per-cluster dpeep sums in cluster order;
// - l2 (larger H): the kernels below, the first port. Forward: the eval
//   scan of lstm_forward.cuh with the h_{t-1}, c_{t-1} stores. Backward:
//   one block per tile of rows walks t = L-1 .. 0 with dh and dc in shared
//   memory. Per step: load h_{t-1}, c_{t-1}; threads over gate columns
//   recompute hid = h_{t-1} W; threads over (row, unit) form the gate
//   cotangents, dx, dc_{t-1} and the row's dpeep terms; threads over units
//   form dh_{t-1} from a transposed copy W^T [4H, H] (read through L2 with
//   W), and threads over the 3H peephole columns add the tile's dpeep
//   terms, in row order, to a per-block sum, the blocks' sums then added
//   in block order; dW as on the cluster path.
// No atomics: the result is the same run after run. Any H and L are taken
// as they are (no lane padding, no time chunks).

#include "lstm_forward.cuh"
#include "scan_train.cuh"
#include "scan_train_wide.cuh"

namespace {

template <bool kWShared>
__global__ void __launch_bounds__(kThreads) lstm_backward_kernel(
    const float* __restrict__ x,       // [B, L, 4H]
    const float* __restrict__ mask,    // [B, L]
    const float* __restrict__ w,       // [H, 4H]
    const float* __restrict__ wt,      // [4H, H]
    const float* __restrict__ peep,    // [3, H]
    const float* __restrict__ hs,      // [L, B, H], h_{t-1} of step t
    const float* __restrict__ cs,      // [L, B, H], c_{t-1} of step t
    const float* __restrict__ dh_in,   // [B, H]
    float* __restrict__ dx,            // [B, L, 4H]
    float* __restrict__ dh0,           // [B, H]
    float* __restrict__ dc0,           // [B, H]
    float* __restrict__ dpre_out,      // [L, B, 4H]
    float* __restrict__ peep_part,     // [gridDim.x, 3H]
    int B, int L, int H, int rows_per_block, float clip) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int P = 3 * H;
  const int R = rows_per_block;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  float* hp = smem;          // [R, H]  h_{t-1}
  float* cp = hp + R * H;    // [R, H]  c_{t-1}
  float* dh = cp + R * H;    // [R, H]
  float* dc = dh + R * H;    // [R, H]
  float* hid = dc + R * H;   // [R, 4H] hid, then dpre
  float* dp = hid + R * G;   // [R, 3H] this step's dpeep terms
  float* pacc = dp + R * P;  // [3H]    the block's dpeep sum
  float* keep = pacc + P;    // [R]     mask of this step
  float* ws = keep + R;      // [H, 4H] when kWShared
  float* wts = ws + H * G;   // [4H, H] when kWShared
  const float* wr = kWShared ? ws : w;
  const float* wtr = kWShared ? wts : wt;

  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    dh[i] = dh_in[(size_t)row0 * H + i];
    dc[i] = 0.0f;
  }
  for (int j = threadIdx.x; j < P; j += kThreads) pacc[j] = 0.0f;
  if (kWShared) {
    for (int i = threadIdx.x; i < H * G; i += kThreads) {
      ws[i] = w[i];
      wts[i] = wt[i];
    }
  }

  for (int t = L - 1; t >= 0; --t) {
    // rows of one step are contiguous in hs and cs [L, B, H]
    const size_t st = ((size_t)t * B + row0) * H;
    for (int i = threadIdx.x; i < rows * H; i += kThreads) {
      hp[i] = hs[st + i];
      cp[i] = cs[st + i];
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) keep[r] = mask[(size_t)(row0 + r) * L + t];
    __syncthreads();
    // phase 1: recompute hid = h_{t-1} W
    rows_product(hp, wr, hid, nullptr, rows, H, G);
    __syncthreads();
    // phase 2: gate cotangents; each thread reads and then overwrites only
    // its own four hid columns, so hid becomes dpre in place
    for (int i = threadIdx.x; i < rows * H; i += kThreads) {
      const int r = i / H;
      const int j = i - r * H;
      const size_t b = (size_t)row0 + r;
      float* hr = hid + r * G;
      float* dxt = dx + (b * L + t) * G;
      float* dpt = dpre_out + ((size_t)t * B + b) * G;
      float* dpr = dp + r * P;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (keep[r] > 0.0f) {
        const float c_prev = cp[i];
        const LstmGates z = lstm_gates(x + (b * L + t) * G, hr, peep, c_prev, j, H);
        const float g_h = dh[i];
        const float tanh_c = tanhf(z.c);
        const float d_o = g_h * tanh_c;
        float dct = dc[i] + g_h * z.o * (1.0f - tanh_c * tanh_c);
        const float dpre_o = d_o * z.o * (1.0f - z.o);
        dct += dpre_o * peep[2 * H + j];
        const float dpre_i = dct * z.g * z.i * (1.0f - z.i);
        const float dpre_f = dct * c_prev * z.f * (1.0f - z.f);
        const float dpre_g = dct * z.i * (1.0f - z.g * z.g);
        dc[i] = dct * z.f + dpre_i * peep[j] + dpre_f * peep[H + j];
        dpr[j] = dpre_i * c_prev;
        dpr[H + j] = dpre_f * c_prev;
        dpr[2 * H + j] = dpre_o * z.c;
        d[0] = dpre_i;
        d[1] = dpre_f;
        d[2] = dpre_g;
        d[3] = dpre_o;
        if (clip > 0.0f) {
#pragma unroll
          for (int q = 0; q < 4; ++q) d[q] = fminf(fmaxf(d[q], -clip), clip);
        }
      } else {
        dpr[j] = dpr[H + j] = dpr[2 * H + j] = 0.0f;  // dc passes through a masked step
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dxt[q * H + j] = d[q];
        dpt[q * H + j] = d[q];
        hr[q * H + j] = d[q];
      }
    }
    __syncthreads();
    // phase 3: dh_{t-1} = dpre . W^T on unmasked rows (masked rows keep dh),
    // and the tile's dpeep terms added to the block's sum in row order
    rows_product(hid, wtr, dh, keep, rows, G, H);
    for (int j = threadIdx.x; j < P; j += kThreads) {
      float s = pacc[j];
      for (int r = 0; r < rows; ++r) s += dp[r * P + j];
      pacc[j] = s;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    dh0[(size_t)row0 * H + i] = dh[i];
    dc0[(size_t)row0 * H + i] = dc[i];
  }
  for (int j = threadIdx.x; j < P; j += kThreads) peep_part[(size_t)blockIdx.x * P + j] = pacc[j];
}

}  // namespace

extern "C" int seqrec_lstm_train_fwd_f32(const float* x, const float* mask, const float* w,
                                         const float* peep, const float* h0, const float* c0,
                                         float* out, float* hs, float* cs, int B, int L, int H,
                                         int path, int C, int R, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (path == kPathL2)
    return launch_lstm_forward<true>(x, mask, w, peep, h0, c0, out, hs, cs, B, L, H, stream);
  if (path == kPathWide)
    return wide_forward<true>(x, mask, w, peep, h0, c0, out, hs, cs, B, L, H, R, (cudaStream_t)stream);
  return train_forward<true>(x, mask, w, peep, h0, c0, out, hs, cs, B, L, H, path, C, R,
                             (cudaStream_t)stream);
}

// dh [B, H] -> dx [B, L, 4H], dh0, dc0 [B, H], dw [H, 4H], dpeep [3, H].
// Scratch from the caller, by path: reg and wide: part [ceil(B / R), H, 4H]
// and peep_part [ceil(B / R), 3H] where that is over 1 block; cluster: dpre
// [L, B, 4H], part [n_splits, H, 4H] (the K = L * B rows of the dW product
// in n_splits ranges of k_per_split rows) and peep_part [ceil(B / R), 3H]
// where that is over 1 cluster; l2: the same (peep_part over 1 block) and
// wt = W^T [4H, H].
extern "C" int seqrec_lstm_train_bwd_f32(const float* x, const float* mask, const float* w,
                                         const float* wt, const float* peep, const float* hs,
                                         const float* cs, const float* dh, float* dx, float* dh0,
                                         float* dc0, float* dw, float* dpeep, float* dpre,
                                         float* part, float* peep_part, int B, int L, int H,
                                         int path, int C, int R, int n_splits, int k_per_split,
                                         float clip, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == kPathReg)
    return train_backward_reg<true>(x, mask, w, peep, hs, cs, dh, dx, dh0, dc0, dw, dpeep, part,
                                    peep_part, B, L, H, R, clip, s);
  if (path == kPathWide)
    return wide_backward<true>(x, mask, w, peep, hs, cs, dh, dx, dh0, dc0, dw, dpeep, part, peep_part, B, L, H, R,
                               clip, s);
  if (n_splits <= 0 || k_per_split <= 0 || (long long)n_splits * k_per_split < (long long)L * B)
    return (int)cudaErrorInvalidValue;
  int err;
  if (path == kPathCluster) {
    err = train_backward_cluster<true>(x, mask, w, peep, hs, cs, dh, dx, dh0, dc0, dpre, dpeep,
                                       peep_part, B, L, H, C, R, clip, s);
  } else if (path == kPathL2 && R <= kMaxRows && wt != nullptr) {
    const int blocks = (B + R - 1) / R;
    if (blocks > 1 && peep_part == nullptr) return (int)cudaErrorInvalidValue;
    const size_t base = l2_train_floats(4, 1, H, R) * sizeof(float);
    const size_t w_bytes = (size_t)2 * 4 * H * H * sizeof(float);  // W and W^T
    err = launch_scan(lstm_backward_kernel<true>, lstm_backward_kernel<false>, base, w_bytes,
                      blocks, s, x, mask, w, wt, peep, hs, cs, dh, dx, dh0, dc0, dpre,
                      blocks > 1 ? peep_part : dpeep, B, L, H, R, clip);
    if (!err && blocks > 1) err = launch_sum_splits(peep_part, dpeep, blocks, (size_t)3 * H, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return launch_dw(hs, dpre, part, dw, L * B, H, 4 * H, n_splits, k_per_split, s);
}

// Clusters of the forward (backward = 0) or backward cluster kernel at
// (H, C, R) that the card holds at once.
extern "C" int seqrec_lstm_train_capacity(int backward, int H, int C, int R, int* n_clusters) {
  return train_cluster_capacity<true>(backward, H, C, R, n_clusters);
}

// Shared-memory bytes of one block of the path's kernel (-1: none takes it).
extern "C" long long seqrec_lstm_train_smem(int backward, int path, int H, int C, int R) {
  if (path == kPathWide) return wide_smem_bytes<true>(backward, H, R);
  return train_smem_bytes<true>(backward, path, H, C, R);
}
