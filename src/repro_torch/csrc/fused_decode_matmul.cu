// Fused entropy decode -> bf16 dequantize -> matmul, prefix and tANS
// families, built into the same plain-C library as entropy_decode.cu.
//
// fused_prefix_matmul and fused_tans_matmul replace the TPU kernels
// src/repro/kernels/fused_decode_matmul.py:_fused_prefix_kernel and
// _fused_tans_kernel (shared tail _deq_accumulate, launched by
// _fused_pallas).  A launch computes
//
//   out[m, n] = sum_k x[m, k] * w[k, n],
//   w = bf16(bf16(bf16(q) * bf16(scale)) + bf16(zero))
//
// rounded to bf16 after each operation exactly as models.layers.deq does,
// with q[k, n] symbol k*N + n of the layer slice: lane j holds the whole
// rows j*R .. (j+1)*R - 1, R = seg / N.  Products accumulate in float32 and
// the sum is cast to bf16 once.  Every lane holds exactly seg symbols (the
// tile-alignment contract), so there is no count mask.
//
// What bounds it on an H100: the decode chain, not bytes or FLOPs.  A launch
// reads the lane matrix (about 2.6 MB for a 2048 x 2048 Huffman-8 slice),
// x, and writes the output, microseconds at 3.35 TB/s; its 2*M*K*N FLOPs are
// microseconds on the tensor cores.  But each lane is a chain of seg
// dependent steps (window load -> table load -> add), the same chain as the
// decode kernels, so a launch takes about one chain whatever the lane count.
//
// Design (simple first; see PERF.md for its times):
//  - grid (lane, column tile), 256 threads a block.  The block copies its
//    decode tables into shared memory (global memory when they do not fit);
//  - thread 0 walks the lane's chain and drops each symbol of the block's
//    columns into shared memory as uint8 (R x tile bytes, at most 64 KiB;
//    one tile covers all N at seg 65,536, so the chain is walked once per
//    lane); it stops after the last symbol the tile needs;
//  - then every thread takes columns n of the tile and, for each row m of x,
//    sums x[m, k] * w[k, n] over the lane's R rows, dequantizing on the fly,
//    and writes the float32 partial to partial[lane, m, n];
//  - a second kernel sums the partials of all lanes in lane order and casts
//    to bf16: the result is deterministic and needs no atomics.
// The TPU kernel keeps a (Mp, N) f32 accumulator in VMEM and walks the
// K-tiles in sequence; blocks on Hopper run in no order, so the reduction
// across lanes is the second pass.  The partial buffer is S x M x N float32
// (201 MB for qwen3-1.7b's w_down at M = 128).  Tensor cores are not used:
// the matmul work is small next to the chain.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "entropy_common.cuh"

namespace {

using entropy::PrefixCursor;
using entropy::TansCursor;
using entropy::stage_tables;

constexpr int kThreads = 256;
constexpr int kSumThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Walks a lane and keeps the symbols of columns [n0, n0 + width) of its R
// rows in sym_s (row-major, R x width).
template <class Cursor>
__device__ void stage_lane(Cursor& cur, int R, int N, int n0, int width,
                           uint8_t* sym_s) {
  const int64_t last = int64_t(R - 1) * N + n0 + width;
  int col = 0, r = 0;
  for (int64_t i = 0; i < last; ++i) {
    const int32_t v = cur.next();
    const int c = col - n0;
    if (unsigned(c) < unsigned(width)) sym_s[r * width + c] = uint8_t(v);
    if (++col == N) {
      col = 0;
      ++r;
    }
  }
}

struct Affine {
  const float* scale;
  int64_t ssk, ssn;
  const float* zero;
  int64_t szk, szn;
};

// The block's partial product: partial[lane, m, n] = sum over the lane's
// rows k of x[m, k] * deq(q[k, n]) for the block's columns n.
__device__ void deq_accumulate(const __nv_bfloat16* __restrict__ x, int M,
                               int K, int N, int lane, int R, int n0,
                               int width, const uint8_t* sym_s, Affine a,
                               float* __restrict__ partial) {
  const int k0 = lane * R;
  const bool per_row = a.ssk != 0 || a.szk != 0;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    const int n = n0 + c;
    float s = round_bf16(a.scale[n * a.ssn]);
    float z = round_bf16(a.zero[n * a.szn]);
    for (int m = 0; m < M; ++m) {
      const __nv_bfloat16* xm = x + int64_t(m) * K + k0;
      float acc = 0.f;
      for (int r = 0; r < R; ++r) {
        if (per_row) {
          s = round_bf16(a.scale[int64_t(k0 + r) * a.ssk + n * a.ssn]);
          z = round_bf16(a.zero[int64_t(k0 + r) * a.szk + n * a.szn]);
        }
        const float w =
            round_bf16(round_bf16(float(sym_s[r * width + c]) * s) + z);
        acc += __bfloat162float(xm[r]) * w;
      }
      partial[(int64_t(lane) * M + m) * N + n] = acc;
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fused_prefix_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, int N,
                    const uint8_t* __restrict__ mat, int64_t B, int R,
                    const int32_t* __restrict__ lut_sym_g,
                    const int32_t* __restrict__ lut_len_g, int lut_size,
                    int max_len, Affine a, int tile,
                    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int32_t* lut_sym = lut_sym_g;
  const int32_t* lut_len = lut_len_g;
  uint8_t* sym_s = fused_smem;
  if (kShared) {
    const int32_t* tabs[2] = {lut_sym_g, lut_len_g};
    lut_sym = stage_tables(reinterpret_cast<int32_t*>(fused_smem), tabs, 2,
                           lut_size);
    lut_len = lut_sym + lut_size;
    sym_s += size_t(2) * lut_size * sizeof(int32_t);
  }
  const int lane = blockIdx.x;
  const int n0 = blockIdx.y * tile;
  const int width = min(tile, N - n0);
  if (threadIdx.x == 0) {
    PrefixCursor cur(mat + int64_t(lane) * B, B, lut_sym, lut_len, max_len);
    stage_lane(cur, R, N, n0, width, sym_s);
  }
  __syncthreads();
  deq_accumulate(x, M, K, N, lane, R, n0, width, sym_s, a, partial);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fused_tans_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, int N,
                  const uint8_t* __restrict__ mat, int64_t B, int R,
                  const int32_t* __restrict__ sym_g,
                  const int32_t* __restrict__ bits_g,
                  const int32_t* __restrict__ base_g, int table_log,
                  Affine a, int tile, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int L = 1 << table_log;
  const int32_t* tab_sym = sym_g;
  const int32_t* tab_bits = bits_g;
  const int32_t* tab_base = base_g;
  uint8_t* sym_s = fused_smem;
  if (kShared) {
    const int32_t* tabs[3] = {sym_g, bits_g, base_g};
    tab_sym = stage_tables(reinterpret_cast<int32_t*>(fused_smem), tabs, 3,
                           L);
    tab_bits = tab_sym + L;
    tab_base = tab_sym + 2 * L;
    sym_s += size_t(3) * L * sizeof(int32_t);
  }
  const int lane = blockIdx.x;
  const int n0 = blockIdx.y * tile;
  const int width = min(tile, N - n0);
  if (threadIdx.x == 0) {
    TansCursor cur(mat + int64_t(lane) * B, B, tab_sym, tab_bits, tab_base,
                   table_log);
    stage_lane(cur, R, N, n0, width, sym_s);
  }
  __syncthreads();
  deq_accumulate(x, M, K, N, lane, R, n0, width, sym_s, a, partial);
}

// out[i] = bf16(sum over lanes s, in order, of partial[s, i]).
__global__ void lane_sum_kernel(const float* __restrict__ partial, int S,
                                int64_t MN, __nv_bfloat16* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[int64_t(s) * MN + i];
  out[i] = __float2bfloat16_rn(acc);
}

int sum_lanes(const float* partial, int S, int64_t MN, __nv_bfloat16* out,
              cudaStream_t stream) {
  const int64_t blocks = (MN + kSumThreads - 1) / kSumThreads;
  lane_sum_kernel<<<dim3(unsigned(blocks)), kSumThreads, 0, stream>>>(
      partial, S, MN, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (M, K) bf16 row-major; mat (S, B) uint8, S * seg == K * N and
// seg % N == 0; lut_sym / lut_len (lut_size,) int32, lut_size >= 2^max_len;
// scale / zero float32 read at k * s?k + n * s?n (0 along a broadcast axis);
// tile columns per block (tile * seg / N <= 64 KiB); partial (S, M, N)
// float32 scratch; out (M, N) bf16.
int fused_prefix_matmul(const void* x, int M, int K, int N, const void* mat,
                        long long B, int S, int seg, const void* lut_sym,
                        const void* lut_len, int lut_size, int max_len,
                        const void* scale, long long ssk, long long ssn,
                        const void* zero, long long szk, long long szn,
                        int tile, void* partial, void* out, void* stream) {
  const int R = seg / N;
  const size_t sym_bytes = size_t(R) * tile;
  const size_t tab_bytes = size_t(2) * lut_size * sizeof(int32_t);
  const Affine a{static_cast<const float*>(scale), ssk, ssn,
                 static_cast<const float*>(zero), szk, szn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = entropy::launch(
      fused_prefix_kernel<true>, fused_prefix_kernel<false>,
      tab_bytes + sym_bytes, sym_bytes, dim3(S, (N + tile - 1) / tile),
      dim3(kThreads), st, static_cast<const __nv_bfloat16*>(x), M, K, N,
      static_cast<const uint8_t*>(mat), int64_t(B), R,
      static_cast<const int32_t*>(lut_sym),
      static_cast<const int32_t*>(lut_len), lut_size, max_len, a, tile,
      static_cast<float*>(partial));
  if (err != 0) return err;
  return sum_lanes(static_cast<const float*>(partial), S, int64_t(M) * N,
                   static_cast<__nv_bfloat16*>(out), st);
}

// As fused_prefix_matmul, with tab_sym / tab_bits / tab_base
// (2^table_log,) int32.
int fused_tans_matmul(const void* x, int M, int K, int N, const void* mat,
                      long long B, int S, int seg, const void* tab_sym,
                      const void* tab_bits, const void* tab_base,
                      int table_log, const void* scale, long long ssk,
                      long long ssn, const void* zero, long long szk,
                      long long szn, int tile, void* partial, void* out,
                      void* stream) {
  const int R = seg / N;
  const size_t sym_bytes = size_t(R) * tile;
  const size_t tab_bytes =
      size_t(3) * (size_t(1) << table_log) * sizeof(int32_t);
  const Affine a{static_cast<const float*>(scale), ssk, ssn,
                 static_cast<const float*>(zero), szk, szn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = entropy::launch(
      fused_tans_kernel<true>, fused_tans_kernel<false>,
      tab_bytes + sym_bytes, sym_bytes, dim3(S, (N + tile - 1) / tile),
      dim3(kThreads), st, static_cast<const __nv_bfloat16*>(x), M, K, N,
      static_cast<const uint8_t*>(mat), int64_t(B), R,
      static_cast<const int32_t*>(tab_sym),
      static_cast<const int32_t*>(tab_bits),
      static_cast<const int32_t*>(tab_base), table_log, a, tile,
      static_cast<float*>(partial));
  if (err != 0) return err;
  return sum_lanes(static_cast<const float*>(partial), S, int64_t(M) * N,
                   static_cast<__nv_bfloat16*>(out), st);
}

}  // extern "C"
