// HSTU's pointwise attention, forward and backward, fused: S and A never
// leave shared memory and registers.
//
// Replaces no TPU kernel: the JAX package has no attention model. It is
// the sequence mixer of the HSTU tower (models/hstu.py; Zhai et al.,
// arXiv:2402.17152). For one row b of B and one head h, with m = lengths[b]
// valid (left-aligned) positions of the L padded ones:
//   S[i, j] = Q[i] . K[j] + bias[i - j],
//   A[i, j] = SiLU(S[i, j]) * scale   for j <= i < m, else 0,
//   O[i]    = sum_j A[i, j] V[j],
// and the backward, from dO:
//   dV[j] = sum_i A[i, j] dO[i],   dA[i, j] = dO[i] . V[j],
//   dS[i, j] = dA[i, j] SiLU'(S[i, j]) scale (0 off the causal, valid pairs),
//   dQ[i] = sum_j dS[i, j] K[j],   dK[j] = sum_i dS[i, j] Q[i],
//   dbias[r] = sum over b, h and the pairs with i - j = r of dS[i, j].
// bias [L] is the relative attention bias as a function of i - j (the
// wrapper folds the position and time-bucket tables into it). Q, K, V are
// [B, L, heads * d] with head h at columns h d .. h d + d - 1 and a row
// stride ld (a multiple of 4; they may be views of one projection's
// output), O, dO, dQ, dK, dV [B, L, heads * d] contiguous.
//
// What bounds it on an H100: latency and the tensor cores' instruction rate,
// not bytes. At B 512, L 200, 4 heads of 64 and about 100 valid positions
// a row, a block's attention is about 0.9 GFLOP of products forward and
// backward over 4 heads' Q, K, V, O and gradients of about 50 MB: 1.9 ms of
// f32 FMA at 67 TFLOP/s or 0.005 ms of TF32 at 495 TFLOP/s, against 15 us
// of HBM. Products are 3xTF32 (block_mma.cuh's split_tf32 and mma_tf32:
// about f32 accuracy).
//
// Design. A block of 4 warps owns a 64-row tile of one (b, h) and walks
// the 64-wide tiles of the other side that its causal, valid pairs reach;
// warp w owns 16 rows of every 64 x 64 product (acc[8][4]: m16n8 tiles
// across 64 columns, depth 64 in steps of 8). Operands are staged in
// shared memory with a row stride of 68 floats, each read in the layout
// its source has: row-major reads are free of bank conflicts, the
// transposed reads of V, K, Q and dO in the second product of a tile have
// two-way conflicts. Tiles past m are zero-filled, so no NaN can come from
// padding; a head width d < 64 is zero-padded to 64.
// - forward, block (query tile, h, b): S = Q K^T in registers, A written to
//   the warp's rows of a shared tile, O += A V.
// - dQ, block (query tile, h, b): S and dA = dO V^T, dS to shared memory,
//   dQ += dS K; the 127 diagonals of each dS tile summed one a thread, in
//   row order, into the block's dbias partial [L] (each tile's diagonals
//   land on distinct r), written to part[(b, h, query tile)].
// - dK and dV, block (key tile, h, b): S^T = K Q^T and dA^T = V dO^T, A^T
//   and dS^T to the warp's rows of shared tiles, dV += A^T dO, dK += dS^T Q.
// S is computed in both backward kernels (7 products a tile pair instead
// of flash attention's 5) so that each output row is written once by one
// block: no atomics, the same bits run after run. The wrapper sums the
// dbias partials over blocks in a fixed order.

#include <math.h>

#include "block_mma.cuh"

namespace {

constexpr int kT = 64;            // rows of a tile, columns of a tile, and the padded head width
constexpr int kLd = kT + 4;       // row stride of a staged tile (floats)
constexpr int kTileF = kT * kLd;  // floats of one staged tile
constexpr int kThreads = 128;     // 4 warps x 16 rows
constexpr size_t kFwdSmem = 4 * kTileF * sizeof(float);
constexpr size_t kDqSmem = 5 * kTileF * sizeof(float);  // + L floats of dbias partial
constexpr size_t kDkvSmem = 6 * kTileF * sizeof(float);

// rows [r0, r0 + 64) of src (row stride ld floats, width w <= 64, both
// multiples of 4) into S[row][col] with row stride kLd; zeros at rows
// >= r_end and columns >= w
__device__ __forceinline__ void load_tile(float* S, const float* __restrict__ src, size_t ld, int r0,
                                          int r_end, int w) {
  for (int e = threadIdx.x; e < kT * kT / 4; e += kThreads) {
    const int r = e / (kT / 4), c = 4 * (e % (kT / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < r_end && c < w) v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * ld + c);
    *reinterpret_cast<float4*>(S + r * kLd + c) = v;
  }
}

template <bool kRowMajor>
__device__ __forceinline__ float at(const float* S, int x, int k) {
  return kRowMajor ? S[x * kLd + k] : S[k * kLd + x];
}

// the warp's 16 x 64 block of acc += A B^T over depth 64: A's element
// (m, k) is at(A, m, k) and B's element (n, k) is at(B, n, k), m the tile
// row (the warp's rows 16 w ..), n the tile column
template <bool kARow, bool kBRow>
__device__ __forceinline__ void warp_mma(const float* A, const float* B, float acc[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m = 16 * (threadIdx.x >> 5) + g;
#pragma unroll
  for (int k0 = 0; k0 < kT; k0 += 8) {
    uint32_t ab[4], as[4];
    split_tf32(at<kARow>(A, m, k0 + t), ab[0], as[0]);
    split_tf32(at<kARow>(A, m + 8, k0 + t), ab[1], as[1]);
    split_tf32(at<kARow>(A, m, k0 + t + 4), ab[2], as[2]);
    split_tf32(at<kARow>(A, m + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bb[2], bs[2];
      split_tf32(at<kBRow>(B, 8 * nt + g, k0 + t), bb[0], bs[0]);
      split_tf32(at<kBRow>(B, 8 * nt + g, k0 + t + 4), bb[1], bs[1]);
      mma_tf32(acc[nt], as, bb);
      mma_tf32(acc[nt], ab, bs);
      mma_tf32(acc[nt], ab, bb);
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
}

// tile row and column of element e of m16n8 tile nt of this thread
__device__ __forceinline__ int acc_row(int e) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int nt, int e) { return 8 * nt + 2 * (threadIdx.x & 3) + (e & 1); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// the block's acc into rows [r0, r0 + 64) of dst (a head's first column
// of a row-major output with row stride ld): rows below `rows`, columns
// below w
__device__ __forceinline__ void store_acc(float* __restrict__ dst, size_t ld, int r0, int rows, int w,
                                          const float acc[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + acc_row(e), c = acc_col(nt, e);
      if (r < rows && c < w) dst[(size_t)r * ld + c] = acc[nt][e];
    }
  }
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  int ld_in;  // row stride of q, k, v
  const float* bias;
  const int* lengths;
  const float* dout;  // [B, L, heads * dv] (backward)
  float* out;         // forward: O; dQ kernel: dQ; dK/dV kernel: dK
  float* out2;        // dK/dV kernel: dV
  float* part;        // dQ kernel: [B * heads * query tiles, L] dbias partials
  int L, heads, dqk, dv;
  float scale;
};

__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float *Qs = smem, *Ks = Qs + kTileF, *Vs = Ks + kTileF, *Ps = Vs + kTileF;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int m = min(max(a.lengths[b], 0), a.L);
  const size_t row0 = (size_t)b * a.L;
  const int ldo = a.heads * a.dv;
  float* o = a.out + row0 * ldo + h * a.dv;
  float acc[8][4];
  zero_acc(acc);
  if (q0 < m) {
    load_tile(Qs, a.q + row0 * a.ld_in + h * a.dqk, a.ld_in, q0, m, a.dqk);
    const int n_tiles = (min(q0 + kT, m) - 1) / kT + 1;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kT;
      __syncthreads();  // the previous tile's K, V and A are read
      load_tile(Ks, a.k + row0 * a.ld_in + h * a.dqk, a.ld_in, k0, m, a.dqk);
      load_tile(Vs, a.v + row0 * a.ld_in + h * a.dv, a.ld_in, k0, m, a.dv);
      __syncthreads();
      float s[8][4];
      zero_acc(s);
      warp_mma<true, true>(Qs, Ks, s);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + acc_row(e), j = k0 + acc_col(nt, e);
          float p = 0.f;
          if (j <= i && i < m) {
            const float x = s[nt][e] + a.bias[i - j];
            p = x * sigmoid(x) * a.scale;
          }
          Ps[acc_row(e) * kLd + acc_col(nt, e)] = p;
        }
      }
      __syncwarp();  // a warp reads back only its own rows of A
      warp_mma<true, false>(Ps, Vs, acc);
    }
  }
  store_acc(o, ldo, q0, a.L, a.dv, acc);
}

__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float *Qs = smem, *Gs = Qs + kTileF, *Ks = Gs + kTileF, *Vs = Ks + kTileF, *Ds = Vs + kTileF;
  float* db = Ds + kTileF;  // [L]
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int m = min(max(a.lengths[b], 0), a.L);
  const size_t row0 = (size_t)b * a.L;
  const int ldo = a.heads * a.dv, ldq = a.heads * a.dqk;
  for (int r = threadIdx.x; r < a.L; r += kThreads) db[r] = 0.f;
  float acc[8][4];
  zero_acc(acc);
  if (q0 < m) {
    load_tile(Qs, a.q + row0 * a.ld_in + h * a.dqk, a.ld_in, q0, m, a.dqk);
    load_tile(Gs, a.dout + row0 * ldo + h * a.dv, ldo, q0, m, a.dv);
    const int n_tiles = (min(q0 + kT, m) - 1) / kT + 1;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kT;
      __syncthreads();  // the previous tile's K, V and dS are read, its dbias added
      load_tile(Ks, a.k + row0 * a.ld_in + h * a.dqk, a.ld_in, k0, m, a.dqk);
      load_tile(Vs, a.v + row0 * a.ld_in + h * a.dv, a.ld_in, k0, m, a.dv);
      __syncthreads();
      float s[8][4], dp[8][4];
      zero_acc(s);
      zero_acc(dp);
      warp_mma<true, true>(Qs, Ks, s);
      warp_mma<true, true>(Gs, Vs, dp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + acc_row(e), j = k0 + acc_col(nt, e);
          float ds = 0.f;
          if (j <= i && i < m) {
            const float x = s[nt][e] + a.bias[i - j], sg = sigmoid(x);
            ds = dp[nt][e] * sg * (1.f + x * (1.f - sg)) * a.scale;
          }
          Ds[acc_row(e) * kLd + acc_col(nt, e)] = ds;
        }
      }
      __syncthreads();  // every warp's dS rows, for the diagonals
      // diagonal d = row - col of the tile (-63 .. 63) is r = q0 - k0 + d
      const int d = (int)threadIdx.x - (kT - 1), r = q0 - k0 + d;
      if (d < kT && r >= 0 && r < a.L) {
        float sum = 0.f;
        for (int row = max(d, 0); row < min(kT, kT + d); ++row) sum += Ds[row * kLd + row - d];
        db[r] += sum;
      }
      warp_mma<true, false>(Ds, Ks, acc);
    }
  }
  __syncthreads();
  float* part = a.part + ((size_t)(b * a.heads + h) * gridDim.x + blockIdx.x) * a.L;
  for (int r = threadIdx.x; r < a.L; r += kThreads) part[r] = db[r];
  store_acc(a.out + row0 * ldq + h * a.dqk, ldq, q0, a.L, a.dqk, acc);
}

__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float *Ks = smem, *Vs = Ks + kTileF, *Qs = Vs + kTileF, *Gs = Qs + kTileF, *Ps = Gs + kTileF,
        *Ds = Ps + kTileF;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int m = min(max(a.lengths[b], 0), a.L);
  const size_t row0 = (size_t)b * a.L;
  const int ldo = a.heads * a.dv, ldq = a.heads * a.dqk;
  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  if (k0 < m) {
    load_tile(Ks, a.k + row0 * a.ld_in + h * a.dqk, a.ld_in, k0, m, a.dqk);
    load_tile(Vs, a.v + row0 * a.ld_in + h * a.dv, a.ld_in, k0, m, a.dv);
    for (int q0 = k0; q0 < m; q0 += kT) {
      __syncthreads();  // the previous tile's Q and dO are read
      load_tile(Qs, a.q + row0 * a.ld_in + h * a.dqk, a.ld_in, q0, m, a.dqk);
      load_tile(Gs, a.dout + row0 * ldo + h * a.dv, ldo, q0, m, a.dv);
      __syncthreads();
      float s[8][4], dp[8][4];
      zero_acc(s);
      zero_acc(dp);
      warp_mma<true, true>(Ks, Qs, s);   // S^T: row j (key), column i (query)
      warp_mma<true, true>(Vs, Gs, dp);  // dA^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + acc_row(e), i = q0 + acc_col(nt, e);
          float p = 0.f, ds = 0.f;
          if (j <= i && i < m) {
            const float x = s[nt][e] + a.bias[i - j], sg = sigmoid(x);
            p = x * sg * a.scale;
            ds = dp[nt][e] * sg * (1.f + x * (1.f - sg)) * a.scale;
          }
          Ps[acc_row(e) * kLd + acc_col(nt, e)] = p;
          Ds[acc_row(e) * kLd + acc_col(nt, e)] = ds;
        }
      }
      __syncwarp();  // a warp reads back only its own rows of A^T and dS^T
      warp_mma<true, false>(Ps, Gs, dv);
      warp_mma<true, false>(Ds, Qs, dk);
    }
  }
  store_acc(a.out + row0 * ldq + h * a.dqk, ldq, k0, a.L, a.dqk, dk);
  store_acc(a.out2 + row0 * ldo + h * a.dv, ldo, k0, a.L, a.dv, dv);
}

bool valid_call(const Args& a, int B) {
  const bool aligned = (uintptr_t)a.q % 16 == 0 && (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0;
  return B > 0 && a.L > 0 && a.heads > 0 && a.dqk > 0 && a.dv > 0 && a.dqk <= kT && a.dv <= kT &&
         a.dqk % 4 == 0 && a.dv % 4 == 0 && a.ld_in % 4 == 0 && aligned &&
         a.L <= 8192 && B <= 65535 && a.heads <= 65535;
}

dim3 grid(const Args& a, int B) { return dim3((a.L + kT - 1) / kT, a.heads, B); }

}  // namespace

// O [B, L, heads dv] from q, k, v (row stride ld_in, 16-byte aligned),
// bias [L] and lengths int32 [B]
extern "C" int seqrec_hstu_attention_fwd_f32(const float* q, const float* k, const float* v, int ld_in,
                                             const float* bias, const int* lengths, float* out, int B,
                                             int L, int heads, int dqk, int dv, float scale,
                                             void* stream) {
  Args a{q, k, v, ld_in, bias, lengths, nullptr, out, nullptr, nullptr, L, heads, dqk, dv, scale};
  if (!valid_call(a, B)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err) return err;
  fwd_kernel<<<grid(a, B), kThreads, kFwdSmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// dQ, dK [B, L, heads dqk], dV [B, L, heads dv] and the dbias partials
// part [B * heads * ceil(L / 64), L] from q, k, v, bias, lengths and dO
// [B, L, heads dv] (16-byte aligned)
extern "C" int seqrec_hstu_attention_bwd_f32(const float* q, const float* k, const float* v, int ld_in,
                                             const float* bias, const int* lengths, const float* dout,
                                             float* dq, float* dk, float* dv, float* part, int B, int L,
                                             int heads, int dqk, int dv_width, float scale,
                                             void* stream) {
  Args a{q, k, v, ld_in, bias, lengths, dout, dq, nullptr, part, L, heads, dqk, dv_width, scale};
  if (!valid_call(a, B) || (uintptr_t)dout % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t dq_smem = kDqSmem + (size_t)L * sizeof(float);
  int err = (int)cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmem);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  dq_kernel<<<grid(a, B), kThreads, dq_smem, s>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  a.out = dk;
  a.out2 = dv;
  dkv_kernel<<<grid(a, B), kThreads, kDkvSmem, s>>>(a);
  return (int)cudaGetLastError();
}
