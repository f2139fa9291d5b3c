// Forward GRU over time, final state only: the eval/serving tower scan
// (kernel K3).
//
// Replaces seqrec_tpu/ops/pallas_rnn.py:_gru_scan_kernel (reached through
// gru_scan). Gate order reset|update|candidate (scan_cells.cuh gru_cell
// gives the math); masked steps carry h.
//
// What bounds it on an H100: the L dependent steps. At the serving chunk
// (B=64, L=30, H=50) the work is 29 MFLOP and 1.2 MB, so a step costs its
// critical path (the product's FMA chain, the barriers); at B=1024, L=30,
// H=128 it is 3.0 GFLOP of f32 FMAs (0.045 ms at 67 TFLOP/s) and W_hid
// [128, 384] is 196 KB, most of a block's 227 KB of shared memory.
//
// Design: the training scan's forward kernels (K1, scan_train.cuh), built
// here without their per-step h_{t-1} store (kStoreStates = false), as K6
// (lstm_scan.cu) runs K5's, on the path of the wrapper's plan
// (ops/rnn_scan.py:gru_scan_plan):
// - reg (H <= 50): W_hid in registers, one block per tile of R rows
//   (scan_train_reg.cuh);
// - cluster (51 <= H < 256): W_hid split over the CTAs of a C-CTA
//   cluster of at most 32 units a CTA, R rows a cluster, h broadcast
//   through distributed shared memory (scan_train_cluster.cuh);
// - gru_cluster (H from 256, where it measured faster, up to 64 units a
//   CTA of 8: about 368 on an H100): gru_cluster.cuh's kernel, 8 CTAs, up
//   to 64 rows a cluster;
// - l2 (no cluster slice fits): gru_forward.cuh's single-block kernel,
//   W_hid read through L2.
// The same fixed order of sums on every call; no atomics.

#include "gru_cluster.cuh"
#include "gru_forward.cuh"
#include "scan_train.cuh"

namespace {

constexpr int kPathGruCluster = 3;  // K3's own path beside scan_train.cuh's kPath*

}  // namespace

extern "C" int seqrec_gru_scan_f32(const float* x, const float* mask, const float* w,
                                   const float* h0, float* out, int B, int L, int H, int path,
                                   int C, int R, void* stream) {
  if (B <= 0 || L < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == kPathGruCluster) return launch_gru_cluster(x, mask, w, h0, out, B, L, H, C, R, s);
  if (path == kPathL2) {
    // the l2 kernel tiles the rows itself: the plan's R must be its tile
    if (R != scan_rows_per_block(B)) return (int)cudaErrorInvalidValue;
    return launch_gru_forward<false>(x, mask, w, h0, out, nullptr, B, L, H, stream);
  }
  return train_forward<false, false>(x, mask, w, nullptr, h0, nullptr, out, nullptr, nullptr, B, L,
                                     H, path, C, R, s);
}

// Clusters of the eval form of the cluster kernel at (H, C, R) that the
// card holds at once (backward must be 0: the plan's signature).
extern "C" int seqrec_gru_scan_capacity(int backward, int H, int C, int R, int* n_clusters) {
  if (backward) return (int)cudaErrorInvalidValue;
  return train_cluster_capacity<false, false>(0, H, C, R, n_clusters);
}

// Shared-memory bytes of one block of the path's kernel (-1: none takes
// it): gru_cluster.cuh's, or the training forward's, whose buffers the
// eval form keeps.
extern "C" long long seqrec_gru_scan_smem(int backward, int path, int H, int C, int R) {
  if (backward) return -1;
  if (path != kPathGruCluster) return train_smem_bytes<false>(0, path, H, C, R);
  if (H <= 0 || C < 2 || C > kClusterMax || H < C) return -1;
  return gru_cluster_instance(R, (H + C - 1) / C) == nullptr ? -1 : (long long)gru_cluster_smem(H, C, R);
}

// Clusters of gru_cluster.cuh's kernel at (H, C, R) the card holds at once.
extern "C" int seqrec_gru_cluster_capacity(int H, int C, int R, int* n_clusters) {
  return gru_cluster_capacity(H, C, R, n_clusters);
}

// The current device's SM count and the shared memory a block may opt in
// to: the inputs of the callers' plans.
extern "C" int seqrec_gru_device_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}
