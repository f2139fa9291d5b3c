// The per-unit math of the training scans' redesigned kernels
// (scan_train_reg.cuh, scan_train_cluster.cuh), on values a thread holds:
// the forward step and the backward step of one (row, unit) for the GRU
// (gates reset|update|candidate) and the LSTM with peepholes (gates
// in|forget|cell|out, peep = (w_ci, w_cf, w_co)). The math is that of
// gru_forward.cuh / lstm_forward.cuh and of the backward kernels of
// gru_scan_train.cu / lstm_scan_train.cu (their header comments give it).

#pragma once

#include "scan_common.cuh"

namespace {

// Clip to +-clip; clip <= 0 is no clip.
__device__ __forceinline__ float clip_to(float v, float clip) {
  return clip > 0.0f ? fminf(fmaxf(v, -clip), clip) : v;
}

// GRU forward of one unit: x and hid of its three gates, the old h.
__device__ __forceinline__ float gru_cell(const float x[3], const float hid[3], float h) {
  const float r = sigmoid_f(x[0] + hid[0]);
  const float u = sigmoid_f(x[1] + hid[1]);
  const float c = tanhf(x[2] + r * hid[2]);
  return (1.0f - u) * h + u * c;
}

// LSTM forward of one unit: x and hid of its four gates, the old c, the
// unit's peepholes; h and c become the new state.
__device__ __forceinline__ void lstm_cell(const float x[4], const float hid[4], const float p[3],
                                          float& h, float& c) {
  const float i = sigmoid_f(x[0] + hid[0] + c * p[0]);
  const float f = sigmoid_f(x[1] + hid[1] + c * p[1]);
  const float g = tanhf(x[2] + hid[2]);
  c = f * c + i * g;
  const float o = sigmoid_f(x[3] + hid[3] + c * p[2]);
  h = o * tanhf(c);
}

// GRU backward of one unmasked unit: from x, the recomputed hid, h_{t-1}
// and dh, the unclipped dx, the clipped dhid and dd, the part of dh_{t-1}
// that does not pass through W_hid.
__device__ __forceinline__ void gru_cell_bwd(const float x[3], const float hid[3], float hp,
                                             float dh, float clip, float dx[3], float dhid[3],
                                             float& dd) {
  const float rg = sigmoid_f(x[0] + hid[0]);
  const float u = sigmoid_f(x[1] + hid[1]);
  const float c = tanhf(x[2] + rg * hid[2]);
  const float du = dh * (c - hp);
  const float dcpre = dh * u * (1.0f - c * c);
  dx[0] = dcpre * hid[2] * rg * (1.0f - rg);
  dx[1] = du * u * (1.0f - u);
  dx[2] = dcpre;
  dhid[0] = clip_to(dx[0], clip);
  dhid[1] = clip_to(dx[1], clip);
  dhid[2] = clip_to(dcpre * rg, clip);
  dd = dh * (1.0f - u);
}

// LSTM backward of one unmasked unit: from x, the recomputed hid, c_{t-1},
// the peepholes, dh and the running dc, the clipped dpre (which is dx and
// feeds dW and dh_{t-1}), dc becoming dc_{t-1}, and the unit's three
// unclipped dpeep terms.
__device__ __forceinline__ void lstm_cell_bwd(const float x[4], const float hid[4], float cp,
                                              const float p[3], float dh, float clip,
                                              float dpre[4], float& dc, float dpeep[3]) {
  const float i = sigmoid_f(x[0] + hid[0] + cp * p[0]);
  const float f = sigmoid_f(x[1] + hid[1] + cp * p[1]);
  const float g = tanhf(x[2] + hid[2]);
  const float c = f * cp + i * g;
  const float o = sigmoid_f(x[3] + hid[3] + c * p[2]);
  const float tanh_c = tanhf(c);
  float dct = dc + dh * o * (1.0f - tanh_c * tanh_c);
  const float dpre_o = dh * tanh_c * o * (1.0f - o);
  dct += dpre_o * p[2];
  const float dpre_i = dct * g * i * (1.0f - i);
  const float dpre_f = dct * cp * f * (1.0f - f);
  const float dpre_g = dct * i * (1.0f - g * g);
  dc = dct * f + dpre_i * p[0] + dpre_f * p[1];
  dpeep[0] = dpre_i * cp;
  dpeep[1] = dpre_f * cp;
  dpeep[2] = dpre_o * c;
  dpre[0] = clip_to(dpre_i, clip);
  dpre[1] = clip_to(dpre_f, clip);
  dpre[2] = clip_to(dpre_g, clip);
  dpre[3] = clip_to(dpre_o, clip);
}

// 4 bytes global -> shared, asynchronous (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
