// A 128 x 128 block product with f32 accuracy on the tensor cores (3xTF32),
// its streamed operands brought in by a ring of three cp.async stages:
// K2's stats and gradients (streaming_cce.cu) and K4 (score_topk.cu) all
// take their logits tiles (h W) from logits_block below.
//
// 3xTF32: each f32 operand x splits into a TF32 head big (x's top 11
// significant bits) and a tail small = x - big (of which the tensor cores
// read the top 11 bits), and a*b is taken as small_a*big_b +
// big_a*small_b + big_a*big_b (the small*small term is below f32
// rounding), each an mma.sync m16n8k8 TF32 product summed in f32. That is
// about 22 bits of each operand, close to f32 FMA, at up to a third of
// the 495 TFLOP/s TF32 rate against 67 TFLOP/s for f32 FMA. The split is
// two ALU instructions an operand value.
//
// A block of kBThreads threads (8 warps, 2 x 4) owns one 128 x 128 output
// tile; warp (wm, wn) owns the 64 x 32 at (64 wm, 32 wn) as 4 x 4 m16n8
// tiles, 64 f32 sums a thread (frag_row/frag_col give their positions).
// An operand slice is kBK = 32 values of k by 128 of x (m or n), staged in
// the layout its source has, so no copy transposes:
// - x-major, S[x][k] with a row stride of kXS = 36 (source contiguous
//   along k; a fragment read hits banks 4 g + t, all 32 distinct);
// - k-major, S[k][x] with a row stride of kKS = 136 (source contiguous
//   along x; banks 8 t + g, all distinct).
// The resident dz tile is either (row stride 136 or 132 by its role).
// Copies: 16-byte cp.async chunks, zero-filled past the operand's edge,
// so any ragged size is taken; rows of the source must start 16-byte
// aligned (the caller pads an operand whose row length is not a multiple
// of 4). pipeline() keeps two slices in flight while the third
// multiplies, with one barrier per slice.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 128;      // rows and columns of a block tile
constexpr int kBK = 32;       // depth of one operand slice
constexpr int kXS = kBK + 4;  // row stride of an x-major slice
constexpr int kKS = kBT + 8;  // row stride of a k-major slice
constexpr int kBThreads = 256;
constexpr int kStages = 3;
constexpr int kSlice = kBT * kXS;  // floats of one operand slice (>= kBK * kKS)
constexpr int kSlot = 2 * kSlice;  // one ring stage: an A and a B slice

// position in the block tile of sum e of m16n8 tile (mt, nt) of this thread
__device__ __forceinline__ int frag_row(int mt, int e) {
  return 64 * ((threadIdx.x >> 5) >> 2) + 16 * mt + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return 32 * ((threadIdx.x >> 5) & 3) + 8 * nt + 2 * (threadIdx.x & 3) + (e & 1);
}

__device__ __forceinline__ void zero_block(float acc[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
}

// 16 bytes global -> shared, asynchronous; the first `bytes` (0, 4, 8,
// 12 or 16) come from src, the rest are zeros (src must be a valid,
// 16-byte aligned address even when bytes is 0)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// bytes of the 4-float chunk at i0 that lie before end (0 to 16)
__device__ __forceinline__ int chunk_bytes(int i0, int end) {
  return 4 * max(0, min(4, end - i0));
}

// x-major: S[x][k] = src[(x0 + x) * ld + k0 + k], zero where
// x0 + x >= x_end or k0 + k >= k_end; ld and k0 multiples of 4
__device__ __forceinline__ void stage_x_major(float* S, const float* __restrict__ src, size_t ld,
                                              int x0, int x_end, int k0, int k_end) {
#pragma unroll
  for (int p = 0; p < kBK * kBT / 4 / kBThreads; ++p) {
    const int e = threadIdx.x + p * kBThreads;
    const int x = e / (kBK / 4), k = 4 * (e % (kBK / 4));
    const int bytes = x0 + x < x_end ? chunk_bytes(k0 + k, k_end) : 0;
    cp_async16(S + x * kXS + k, bytes ? src + (size_t)(x0 + x) * ld + k0 + k : src, bytes);
  }
}

// k-major: S[k][x] = src[(k0 + k) * ld + x0 + x], same bounds; ld and x0
// multiples of 4
__device__ __forceinline__ void stage_k_major(float* S, const float* __restrict__ src, size_t ld,
                                              int x0, int x_end, int k0, int k_end) {
#pragma unroll
  for (int p = 0; p < kBK * kBT / 4 / kBThreads; ++p) {
    const int e = threadIdx.x + p * kBThreads;
    const int k = e / (kBT / 4), x = 4 * (e % (kBT / 4));
    const int bytes = k0 + k < k_end ? chunk_bytes(x0 + x, x_end) : 0;
    cp_async16(S + k * kKS + x, bytes ? src + (size_t)(k0 + k) * ld + x0 + x : src, bytes);
  }
}

// an operand's element (x, k) in shared memory, x-major or k-major
template <bool kXMajor, int kLd>
__device__ __forceinline__ float operand_at(const float* S, int x, int k) {
  return kXMajor ? S[x * kLd + k] : S[k * kLd + x];
}

// v = big + small exactly: big keeps v's top 11 significant bits (a TF32
// value), small the rest; the tensor cores read small's top 11 bits (the
// TF32 part of an f32 register), so the pair carries about 22 bits of v
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over kBK values of k: A's element (m, k) and B's (n, k) in
// shared memory in the given layouts (A at its slice's m = 0, B at n = 0)
template <bool kAX, int kALd, bool kBX, int kBLd>
__device__ __forceinline__ void mma_slice(const float* A, const float* B, float acc[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 64 * (warp >> 2), n0 = 32 * (warp & 3);
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 8) {
    uint32_t bb[4][2], bs[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + g;
      split_tf32(operand_at<kBX, kBLd>(B, n, k0 + t), bb[nt][0], bs[nt][0]);
      split_tf32(operand_at<kBX, kBLd>(B, n, k0 + t + 4), bb[nt][1], bs[nt][1]);
    }
    // two m16 tiles at a time; the small terms first, with 8 independent
    // sums between two products into the same sum
#pragma unroll
    for (int mp = 0; mp < 4; mp += 2) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + 16 * (mp + i) + g;
        split_tf32(operand_at<kAX, kALd>(A, m, k0 + t), ab[i][0], as[i][0]);
        split_tf32(operand_at<kAX, kALd>(A, m + 8, k0 + t), ab[i][1], as[i][1]);
        split_tf32(operand_at<kAX, kALd>(A, m, k0 + t + 4), ab[i][2], as[i][2]);
        split_tf32(operand_at<kAX, kALd>(A, m + 8, k0 + t + 4), ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + i][nt], as[i], bb[nt]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + i][nt], ab[i], bs[nt]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + i][nt], ab[i], bb[nt]);
      }
    }
  }
}

// Run n_slices slices through the ring (kStages slots of kSlot floats):
// stage(s, slot) starts the copies of slice s into a slot, mma(s, slot)
// multiplies it once it has landed. Starts with a barrier, so the ring and
// anything the caller wrote to shared memory before are safe to use.
template <typename Stage, typename Mma>
__device__ __forceinline__ void pipeline(int n_slices, float* ring, Stage stage, Mma mma) {
  __syncthreads();
  stage(0, ring);
  cp_async_commit();
  if (n_slices > 1) stage(1, ring + kSlot);
  cp_async_commit();
  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<1>();  // slice s has landed (this thread's copies)
    __syncthreads();     // ... everyone's; and slice s - 1's slot is read
    if (s + 2 < n_slices) stage(s + 2, ring + ((s + 2) % kStages) * kSlot);
    cp_async_commit();
    mma(s, ring + (s % kStages) * kSlot);
  }
}

// acc = (h W)[row0 + frag_row, col0 + frag_col] for one 128 x 128 tile
// (no bias); rows past B and columns past N hold 0. h [B, H] and W [H, N]
// are read with row strides ldh and ldw (multiples of 4, rows 16-byte
// aligned). On return every warp may still be reading the ring.
__device__ __forceinline__ void logits_block(const float* __restrict__ h, size_t ldh,
                                             const float* __restrict__ W, size_t ldw, int B, int H,
                                             int N, int row0, int col0, float* ring,
                                             float acc[4][4][4]) {
  zero_block(acc);
  pipeline(
      (H + kBK - 1) / kBK, ring,
      [&](int s, float* slot) {
        stage_x_major(slot, h, ldh, row0, B, s * kBK, H);           // A (row, k) = h[row0 + row, k]
        stage_k_major(slot + kSlice, W, ldw, col0, N, s * kBK, H);  // B (col, k) = W[k, col0 + col]
      },
      [&](int, const float* slot) { mma_slice<true, kXS, false, kKS>(slot, slot + kSlice, acc); });
}

}  // namespace
