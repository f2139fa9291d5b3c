// Forward LSTM over time, final hidden state only: the eval/serving tower
// scan (kernel K6).
//
// Replaces seqrec_tpu/ops/pallas_rnn.py:_lstm_scan_kernel (reached through
// lstm_scan). Lasagne's cell with peepholes (lstm_forward.cuh gives the
// math); masked steps carry (h, c).
//
// What bounds it on an H100: the L dependent steps and their f32 FMAs. At
// the LSTM path's B=1024, L=30, H=128 the work is 2 B L H 4H = 4.0 GFLOP
// (0.06 ms at 67 TFLOP/s); W_hid [128, 512] is 256 KB, more than a block's
// 227 KB of shared memory.
//
// Design: the training scan's forward kernels (K5, scan_train.cuh), built
// here without their per-step h_{t-1}/c_{t-1} stores (kStoreStates =
// false), on the path of the wrapper's plan
// (ops/rnn_scan_train.py:train_scan_plan, forward):
// - reg (H <= 50): W_hid in registers, one block per tile of R rows
//   (scan_train_reg.cuh);
// - cluster: W_hid split over the CTAs of a C-CTA cluster, R rows a
//   cluster, h broadcast through distributed shared memory
//   (scan_train_cluster.cuh);
// - l2 (no cluster slice fits, H above 256): lstm_forward.cuh's
//   single-block kernel, W_hid read through L2.
// The same fixed order of sums on every call; no atomics.

#include "lstm_forward.cuh"
#include "scan_train.cuh"

extern "C" int seqrec_lstm_scan_f32(const float* x, const float* mask, const float* w,
                                    const float* peep, const float* h0, const float* c0,
                                    float* out, int B, int L, int H, int path, int C, int R,
                                    void* stream) {
  if (B <= 0 || L < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (path == kPathL2) {
    // the l2 kernel tiles the rows itself: the plan's R must be its tile
    if (R != scan_rows_per_block(B)) return (int)cudaErrorInvalidValue;
    return launch_lstm_forward<false>(x, mask, w, peep, h0, c0, out, nullptr, nullptr, B, L, H,
                                      stream);
  }
  return train_forward<true, false>(x, mask, w, peep, h0, c0, out, nullptr, nullptr, B, L, H,
                                    path, C, R, (cudaStream_t)stream);
}

// Clusters of the eval form of the cluster kernel at (H, C, R) that the
// card holds at once (backward must be 0: the plan's signature).
extern "C" int seqrec_lstm_scan_capacity(int backward, int H, int C, int R, int* n_clusters) {
  if (backward) return (int)cudaErrorInvalidValue;
  return train_cluster_capacity<true, false>(0, H, C, R, n_clusters);
}

// Shared-memory bytes of one block of the path's kernel (-1: none takes
// it): the training forward's, whose buffers the eval form keeps.
extern "C" long long seqrec_lstm_scan_smem(int backward, int path, int H, int C, int R) {
  return backward ? -1 : train_smem_bytes<true>(0, path, H, C, R);
}
