// Forward GRU over time, final state only: the eval/serving tower scan.
//
// Replaces seqrec_tpu/ops/pallas_rnn.py:_gru_scan_kernel (reached through
// gru_scan). Two kernels, chosen by the caller's plan
// (ops/rnn_scan.py:gru_scan_plan): where W_hid fits in one block's shared
// memory beside the state, gru_forward.cuh's single-block kernel, which the
// training scan (gru_scan_train.cu) shares, launched here without the
// per-step residual store (it reads W_hid through L2 past that size);
// where it does not, gru_cluster.cuh's kernel, which splits W_hid over a
// thread-block cluster. Each header has its design and bounds.

#include "gru_cluster.cuh"
#include "gru_forward.cuh"

extern "C" int seqrec_gru_scan_f32(const float* x, const float* mask, const float* w,
                                   const float* h0, float* out, int B, int L, int H,
                                   void* stream) {
  return launch_gru_forward<false>(x, mask, w, h0, out, nullptr, B, L, H, stream);
}

// The cluster path: clusters of C CTAs, each cluster owning R batch rows.
extern "C" int seqrec_gru_scan_cluster_f32(const float* x, const float* mask, const float* w,
                                           const float* h0, float* out, int B, int L, int H,
                                           int C, int R, void* stream) {
  return launch_gru_cluster(x, mask, w, h0, out, B, L, H, C, R, (cudaStream_t)stream);
}

// Clusters of that plan the card holds at once, in *n_clusters.
extern "C" int seqrec_gru_cluster_capacity(int H, int C, int R, int* n_clusters) {
  return gru_cluster_capacity(H, C, R, n_clusters);
}

// The current device's SM count and the shared memory a block may opt in
// to: the inputs of the caller's plan.
extern "C" int seqrec_gru_device_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}
