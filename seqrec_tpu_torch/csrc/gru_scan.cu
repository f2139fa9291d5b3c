// Forward GRU over time, final state only: the eval/serving tower scan.
//
// Replaces seqrec_tpu/ops/pallas_rnn.py:_gru_scan_kernel (reached through
// gru_scan). The kernel, what bounds it and its design are in
// gru_forward.cuh, which the training scan (gru_scan_train.cu) shares; this
// file launches it without the per-step residual store.

#include "gru_forward.cuh"

extern "C" int seqrec_gru_scan_f32(const float* x, const float* mask, const float* w,
                                   const float* h0, float* out, int B, int L, int H,
                                   void* stream) {
  return launch_gru_forward<false>(x, mask, w, h0, out, nullptr, B, L, H, stream);
}
