// Forward LSTM over time, final hidden state only: the eval/serving tower
// scan (kernel K6).
//
// Replaces seqrec_tpu/ops/pallas_rnn.py:_lstm_scan_kernel (reached through
// lstm_scan). The kernel, what bounds it and its design are in
// lstm_forward.cuh, which the training scan (lstm_scan_train.cu) shares;
// this file launches it without the per-step residual stores.

#include "lstm_forward.cuh"

extern "C" int seqrec_lstm_scan_f32(const float* x, const float* mask, const float* w,
                                    const float* peep, const float* h0, const float* c0,
                                    float* out, int B, int L, int H, void* stream) {
  return launch_lstm_forward<false>(x, mask, w, peep, h0, c0, out, nullptr, nullptr, B, L, H,
                                    stream);
}
