// Dequantize -> matmul with a uint8 or K-packed uint4 weight, built into the
// same plain-C library as entropy_decode.cu and fused_decode_matmul.cu.
//
// dequant_matmul replaces the TPU kernel
// src/repro/kernels/dequant_matmul.py:_mm_kernel (launched by
// dequant_matmul there and reached through kernels/ops.py:dequant_matmul).
// A launch computes
//
//   out[m, n] = bf16( sum_k x[m, k] * w[k, n] ),
//   w[k, n]   = bf16( f32(q[k, n]) * scale[n] + zero[n] )
//
// with the product and the sum each rounded in float32 (two roundings, as
// the JAX package's oracle ref.dequant_matmul_ref and the plain version
// do: __fmul_rn / __fadd_rn keep nvcc from contracting them into one fma),
// the bf16 products accumulated in float32 over K in order, and the sum
// cast to bf16 once.  q is uint8 (K, N), or uint4 packed two to a byte
// ALONG K: byte wq[k / 2, n] holds even k in its low nibble and odd k in
// its high one (ops.pack_nibbles).
// scale and zero are float32, read at n * stride (stride 0: one scalar).
//
// What bounds it on an H100: at decode (M = 4) the weight bytes, K*N (or
// K*N/2) read once against 3.35 TB/s; at prefill (M = 128) on a 4-bit
// weight the 2*M*K*N tensor-core FLOPs.  The TPU kernel walks a (M/bm,
// N/bn, K/bk) grid with K innermost into a VMEM f32 scratch; Hopper blocks
// run in no order, so here the K axis is a loop inside the block.
//
// Design (simple first; see PERF.md for its times):
//  - grid (N tile, M tile); a block owns one BM x BN output tile and walks
//    K in steps of BK = 64;
//  - each step loads the x tile (bf16) and the weight tile (raw bytes)
//    into registers, every load of the step in flight at once, and stores
//    them to shared memory, x row-major and the weight dequantized to bf16
//    and n-major (a thread's two k values of one column are one 32-bit
//    word); the next step's loads are issued before this step's MMAs.
//    Loads are bounds-checked element by element, so any M, K and N is
//    taken and the ragged edge reads as zero;
//  - warps run mma.sync m16n8k16 (bf16 operands, float32 accumulators in
//    registers); each output element is written once, by one thread: no
//    atomics, no second pass, and the result is deterministic;
//  - BM = 16 with two warps for M <= 16 (decode: the MMA's 16 rows hold
//    the whole batch and twice as many blocks read the weight), BM = 64
//    with four warps otherwise (prefill).
// Only one step's loads are in flight ahead and no split of K across
// blocks is made, so at the layer shapes, where the output has few tiles,
// a step still waits for its loads: the bytes and the FLOPs are both far
// from the card's rates.  cp.async or TMA rings, wgmma and a deterministic
// split of K are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBK = 64;           // K per step
constexpr int kLds = kBK + 8;     // shared row, bf16: 36 words, conflict-free
                                  // fragment loads

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// bf16(q * s + z), rounding the product and the sum separately.
__device__ __forceinline__ __nv_bfloat16 dequant(uint32_t q, float s,
                                                 float z) {
  return __float2bfloat16_rn(__fadd_rn(__fmul_rn(float(q), s), z));
}

// BM x BN output tile, WARPS_M x WARPS_N warps, each a (BM / WARPS_M) x
// (BN / WARPS_N) slab of 16 x 8 MMA tiles.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool kInt4>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
dequant_matmul_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                      int N, const uint8_t* __restrict__ wq,
                      const float* __restrict__ scale, int64_t ssn,
                      const float* __restrict__ zero, int64_t szn,
                      __nv_bfloat16* __restrict__ out) {
  constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  constexpr int MT = BM / WARPS_M / 16;   // MMA tiles per warp along M
  constexpr int NT = BN / WARPS_N / 8;    // and along N
  constexpr int kXPairs = BM * kBK / 2 / kThreads;   // per thread, a step
  constexpr int kWPairs = kBK / 2 / (kThreads / BN);
  static_assert(kThreads % BN == 0, "a thread keeps one column");
  static_assert((BM * kBK / 2) % kThreads == 0, "x pairs per thread");
  static_assert((kBK / 2) % (kThreads / BN) == 0, "weight pairs per thread");

  __shared__ __align__(16) __nv_bfloat16 xs[BM * kLds];   // [m][k]
  __shared__ __align__(16) __nv_bfloat16 ws[BN * kLds];   // [n][k]
  uint32_t* xs32 = reinterpret_cast<uint32_t*>(xs);
  uint32_t* ws32 = reinterpret_cast<uint32_t*>(ws);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;       // MMA group and thread in it
  const int wm = (warp / WARPS_N) * MT * 16;  // warp's slab in the tile
  const int wn = (warp % WARPS_N) * NT * 8;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const unsigned short* __restrict__ xu =
      reinterpret_cast<const unsigned short*>(x);

  // the weight column this thread dequantizes, and its affine
  const int cn = tid % BN;
  const int n = n0 + cn;
  const bool n_ok = n < N;
  const float s = n_ok ? scale[n * ssn] : 0.f;
  const float z = n_ok ? zero[n * szn] : 0.f;

  // A step's tiles pass through registers: x pairs (k, k + 1) of one row,
  // neighbouring threads on neighbouring pairs; weight pairs of this
  // thread's column, neighbouring threads on neighbouring bytes of a row
  // (q0 | q1 << 8).  All the step's loads are issued before any is used,
  // and the next step's are issued before this step's MMAs.
  uint32_t xv[kXPairs], wv[kWPairs];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kXPairs; ++j) {
      const int i = tid + j * kThreads;
      const int m = m0 + i / (kBK / 2), k = k0 + 2 * (i % (kBK / 2));
      const int64_t at = int64_t(m) * K + k;
      const uint32_t lo = m < M && k < K ? xu[at] : 0u;
      const uint32_t hi = m < M && k + 1 < K ? xu[at + 1] : 0u;
      xv[j] = lo | (hi << 16);
    }
#pragma unroll
    for (int j = 0; j < kWPairs; ++j) {
      const int k = k0 + 2 * (tid / BN + j * (kThreads / BN));
      if (kInt4) {                                // K is even
        wv[j] = n_ok && k < K ? wq[int64_t(k / 2) * N + n] : 0u;
      } else {
        const uint32_t q0 = n_ok && k < K ? wq[int64_t(k) * N + n] : 0u;
        const uint32_t q1 =
            n_ok && k + 1 < K ? wq[int64_t(k + 1) * N + n] : 0u;
        wv[j] = q0 | (q1 << 8);
      }
    }
  };
  // registers -> shared memory, the weight dequantized on the way; a k
  // past K stores zero
  auto stage = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kXPairs; ++j) {
      const int i = tid + j * kThreads;
      xs32[(i / (kBK / 2)) * (kLds / 2) + i % (kBK / 2)] = xv[j];
    }
#pragma unroll
    for (int j = 0; j < kWPairs; ++j) {
      const int kp = tid / BN + j * (kThreads / BN);
      const int k = k0 + 2 * kp;
      const uint32_t q0 = kInt4 ? wv[j] & 0xFu : wv[j] & 0xFFu;
      const uint32_t q1 = kInt4 ? wv[j] >> 4 : wv[j] >> 8;
      const __nv_bfloat16 zero_bf = __float2bfloat16_rn(0.f);
      const __nv_bfloat16 w0 = n_ok && k < K ? dequant(q0, s, z) : zero_bf;
      const __nv_bfloat16 w1 =
          n_ok && k + 1 < K ? dequant(q1, s, z) : zero_bf;
      ws32[cn * (kLds / 2) + kp] = pack_bf16(w0, w1);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    stage(k0);
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + i * 16 + g;
        const int c = (kk + 2 * t) / 2;
        a[i][0] = xs32[r * (kLds / 2) + c];
        a[i][1] = xs32[(r + 8) * (kLds / 2) + c];
        a[i][2] = xs32[r * (kLds / 2) + c + 4];
        a[i][3] = xs32[(r + 8) * (kLds / 2) + c + 4];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn + j * 8 + g;
        const int c = (kk + 2 * t) / 2;
        b[j][0] = ws32[col * (kLds / 2) + c];
        b[j][1] = ws32[col * (kLds / 2) + c + 4];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // accumulator (r, c) pairs: rows g and g + 8, columns 2t and 2t + 1
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = n0 + wn + j * 8 + 2 * t + e;
          if (nn < N) {
            out[int64_t(m) * N + nn] = __float2bfloat16_rn(acc[i][j][2 * h + e]);
          }
        }
      }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool kInt4>
int launch(const void* x, int M, int K, int N, const void* wq,
           const void* scale, long long ssn, const void* zero,
           long long szn, void* out, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_matmul_kernel<BM, BN, WARPS_M, WARPS_N, kInt4>
      <<<grid, 32 * WARPS_M * WARPS_N, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), M, K, N,
          static_cast<const uint8_t*>(wq), static_cast<const float*>(scale),
          int64_t(ssn), static_cast<const float*>(zero), int64_t(szn),
          static_cast<__nv_bfloat16*>(out));
  return int(cudaGetLastError());
}

template <bool kInt4>
int dispatch(const void* x, int M, int K, int N, const void* wq,
             const void* scale, long long ssn, const void* zero,
             long long szn, void* out, cudaStream_t stream) {
  if (M <= 16) {
    return launch<16, 32, 1, 2, kInt4>(x, M, K, N, wq, scale, ssn, zero, szn,
                                       out, stream);
  }
  return launch<64, 64, 2, 2, kInt4>(x, M, K, N, wq, scale, ssn, zero, szn,
                                     out, stream);
}

}  // namespace

extern "C" {

// x (M, K) bf16 row-major; wq (K, N) uint8, or (K / 2, N) uint8 with int4
// != 0 (K even, nibbles packed along K); scale / zero float32 read at
// n * ssn / n * szn (0: a scalar); out (M, N) bf16; M <= 65535 * 64.
int dequant_matmul(const void* x, int M, int K, int N, const void* wq,
                   int int4, const void* scale, long long ssn,
                   const void* zero, long long szn, void* out,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int4 ? dispatch<true>(x, M, K, N, wq, scale, ssn, zero, szn, out, st)
              : dispatch<false>(x, M, K, N, wq, scale, ssn, zero, szn, out,
                                st);
}

}  // extern "C"
