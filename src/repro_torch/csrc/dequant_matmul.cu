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
// the bf16 products accumulated in float32, and the sum cast to bf16 once.
// q is uint8 (K, N), or uint4 packed two to a byte ALONG K: byte
// wq[k / 2, n] holds even k in its low nibble and odd k in its high one
// (ops.pack_nibbles).  scale and zero are float32, read at n * stride
// (stride 0: one scalar).
//
// What bounds it on an H100 80GB HBM3 at 700 W (132 SMs, 3.35 TB/s,
// 989 TFLOP/s bf16 dense; times from scripts/time_decode_kernels.py):
//  - decode (M <= 16): the weight's bytes, K*N (or K*N/2) read once.  At
//    the layer matrices (1-6 MB) that is 0.3-1.9 us, so what is left is
//    latency and launch: a memory round trip a K step, and too few blocks
//    to cover it.  At lm_head (2048 x 152064 uint8, 311 MB) it is
//    0.093 ms; the ring streams it at 65-66% of that (0.142-0.143 ms cold).
//  - prefill (M = 128): lm_head's 2*M*K*N = 79.7 GFLOP (0.081 ms at the
//    tensor-core peak).  The ring takes 0.266 ms there against the dense
//    bf16 floor's 0.236, held by two parts of its stage together: the
//    mma.sync issue and the copies of x, whose 128 x 64 bf16 tile (16 KiB
//    a stage, from L2) is twice the weight's 8 KiB and is read again by
//    each of the 1,188 column tiles.  scripts/ablate_dequant_ring.py takes
//    one part out at a time: without the MMAs, or without x's copies, it
//    runs 15% faster, under the floor; cutting the A fragment loads to one
//    in eight gains 4%; without the dequant it is slower (the schedule
//    changes).  wgmma versions (the stage dequantized into a bf16 B tile,
//    one block an SM) were no faster and are not kept.
//
// Design.  The host plans each launch (kernels/dequant_matmul.py:plan):
// the variant, the rows of a tile, the split of K and the workspace.
//  - ring variant, for every shape whose rows are 16-byte multiples
//    (N % 16 == 0, K % 8 == 0) at 16-byte-aligned x, wq and out:
//    - a block of 4 warps owns a BM x 128 output tile; each warp 32
//      columns as 4 MMA n8 tiles and all BM rows.  BM = 16 at decode (one
//      mma.sync m16n8k16 row tile holds the batch).  Above, each BM-row
//      tile dequantizes the weight again: BM = 128 for lm_head (each
//      weight dequantized once a block and multiplied by all 128 rows),
//      16 or 64 for the layer matrices, where more blocks beat fewer
//      dequants (the plan's rule);
//    - a ring of kStages = 4 stages in shared memory, each the x tile
//      (BM x 64 bf16) and the weight tile (64 x 128 bytes, or 32 x 128
//      for uint4), filled by cp.async.cg copies of 16 bytes (zero-filled
//      past M, K and N): three stages in flight while one is multiplied,
//      24-32 KiB of weight a block, several blocks an SM at decode;
//    - the weight is dequantized straight from the byte tile into B
//      fragments, with no bf16 staging tile: a warp's MMA column g of n8
//      tile j is the tile's column 4g + j, so one 32-bit shared load gives
//      a thread the bytes of four n8 tiles.  For uint4 the byte at k-pair
//      row kk/2 + t holds exactly b[0]'s two k values and the byte 4 rows
//      down b[1]; uint8 takes rows 2t, 2t + 1, 2t + 8, 2t + 9.  The rows
//      are padded (160 / 144 bytes) so a warp's 32 loads hit 32 banks.
//      Bytes become floats exactly under 2^23's exponent (a byte permute
//      and a subtraction, not the slower integer convert);
//    - a split of K across blocks (grid z) when the output has few tiles
//      (every layer matrix): each split is whole 64-deep stages, the last
//      ragged.  A split writes its float32 partial tile to a workspace,
//      then takes an integer ticket for its output tile; the block that
//      draws the last ticket adds the partials in split order (not arrival
//      order), casts once and resets the ticket.  No float atomics: two
//      launches are bitwise equal, and a one-hot row sums one exact
//      product and zeros in any split;
//    - in the epilogue a thread holds 8 neighbouring columns of a row
//      (MMA columns 2t, 2t + 1 of the 4 n8 tiles), written as one 16-byte
//      store (or two of float32 partials).
//  - edge variant, for any other shape or address: the same arithmetic in
//    a plain loop (registers -> shared memory, loads bounds-checked element
//    by element, one K step ahead), BM = 16 with two warps for M <= 16,
//    BM = 64 with four warps above, no split.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBK = 64;           // K per step (both variants)
constexpr int kLds = kBK + 8;     // shared x row, bf16: 144 bytes, conflict-
                                  // free fragment loads and ldmatrix rows

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

// ------------------------------------------------------------ edge variant
// Any M, K, N and address: a BM x BN output tile, WARPS_M x WARPS_N warps,
// each a (BM / WARPS_M) x (BN / WARPS_N) slab of 16 x 8 MMA tiles; K walked
// in steps of kBK staged through registers, every load bounds-checked.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool kInt4>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
edge_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
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
            out[int64_t(m) * N + nn] =
                __float2bfloat16_rn(acc[i][j][2 * h + e]);
          }
        }
      }
}

// ------------------------------------------------------------ ring variant
namespace ring {

constexpr int kThreads = 128;     // 4 warps, 32 columns each
constexpr int kBN = 128;
constexpr int kStages = 4;

template <bool kInt4>
__host__ __device__ constexpr int w_rows() {
  return kInt4 ? kBK / 2 : kBK;
}
// a weight row in shared memory, bytes: a warp's B loads (rows t, or 2t
// and 2t + 1, at 8 neighbouring words) then touch 32 distinct banks
template <bool kInt4>
__host__ __device__ constexpr int w_ld() {
  return kInt4 ? kBN + 32 : kBN + 16;
}

template <int MT, bool kInt4>
constexpr size_t smem_bytes() {
  return size_t(kStages) * (size_t(16 * MT) * kLds * 2 +
                            size_t(w_rows<kInt4>()) * w_ld<kInt4>());
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (src is
// then not read)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the A fragment of a 16 x 16 tile of x in shared memory: lane l passes
// the address of row l % 16, column 8 * (l / 16) of the tile
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p))
      : "memory");
}

// f32 of byte `sel` of v, exactly: the byte as the low mantissa bits under
// 2^23's exponent, minus 2^23
__device__ __forceinline__ float byte_f32(uint32_t v, int sel) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u | sel)) -
         8388608.f;
}

// two dequantized weights as one bf16x2 B register, lower k low
__device__ __forceinline__ uint32_t deq_pair(float q0, float q1, float s,
                                             float z) {
  const __nv_bfloat162 p =
      __floats2bfloat162_rn(__fadd_rn(__fmul_rn(q0, s), z),
                            __fadd_rn(__fmul_rn(q1, s), z));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The ring kernel's epilogue.  A thread owns runs of 8 neighbouring
// output columns; rows(f) calls f(m, nc, v) for each (row m, first column
// nc, 8 float32 sums).  Unsplit, the runs are cast and stored.  Split, they
// go to this split's partial tile; then a ticket for the output tile, and
// the block that draws the last one adds the partials in split order (its
// own from registers, the others' from L2), casts once, and resets the
// ticket.
template <typename Rows>
__device__ __forceinline__ void write_tile(Rows rows, int M, int N,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ partial,
                                           int* __restrict__ tickets,
                                           int split, int splits, int tile) {
  __shared__ int last;
  auto store = [&](int m, int nc, const float* v) {
    uint4 o;
    o.x = pack_bf16(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
    o.y = pack_bf16(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
    o.z = pack_bf16(__float2bfloat16_rn(v[4]), __float2bfloat16_rn(v[5]));
    o.w = pack_bf16(__float2bfloat16_rn(v[6]), __float2bfloat16_rn(v[7]));
    *reinterpret_cast<uint4*>(out + int64_t(m) * N + nc) = o;
  };
  // N % 16 == 0: a run's 8 columns are all inside N or all outside
  if (splits == 1) {
    rows([&](int m, int nc, const float* v) {
      if (m < M && nc < N) store(m, nc, v);
    });
    return;
  }
  rows([&](int m, int nc, const float* v) {
    if (m < M && nc < N) {
      float4* p = reinterpret_cast<float4*>(
          partial + (int64_t(split) * M + m) * N + nc);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  rows([&](int m, int nc, const float* own) {
    if (!(m < M && nc < N)) return;
    float sum[8];
    for (int q = 0; q < splits; ++q) {
      float v[8];
      if (q == split) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = own[e];
      } else {
        const float4* p = reinterpret_cast<const float4*>(
            partial + (int64_t(q) * M + m) * N + nc);
        const float4 a = __ldcg(p), b = __ldcg(p + 1);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = q == 0 ? v[e] : sum[e] + v[e];
    }
    store(m, nc, sum);
  });
  if (threadIdx.x == 0) tickets[tile] = 0;   // ready for the next launch
}

// a (16 MT) x 128 output tile, a warp's 32 columns as 4 n8 tiles
template <int MT, bool kInt4>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, int N,
            const uint8_t* __restrict__ wq, const float* __restrict__ scale,
            int64_t ssn, const float* __restrict__ zero, int64_t szn,
            __nv_bfloat16* __restrict__ out, int k_per_split,
            float* __restrict__ partial, int* __restrict__ tickets) {
  constexpr int BM = 16 * MT;
  constexpr int kWRows = w_rows<kInt4>(), kWLd = w_ld<kInt4>();
  constexpr int kXStage = BM * kLds;          // bf16 elements
  constexpr int kWStage = kWRows * kWLd;      // bytes
  constexpr int kXCopies = BM * (kBK / 8) / kThreads;      // per thread
  constexpr int kWCopies = kWRows * (kBN / 16) / kThreads;
  static_assert(BM * (kBK / 8) % kThreads == 0, "x copies per thread");
  static_assert(kWRows * (kBN / 16) % kThreads == 0, "w copies per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ws = smem + size_t(kStages) * kXStage * 2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // MMA group and thread in it
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int wc = warp * 32;               // the warp's columns in the tile

  // this thread's B column of n8 tile j is the tile's column wc + 4g + j
  float s[4], z[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wc + 4 * g + j;
    s[j] = n < N ? scale[n * ssn] : 0.f;
    z[j] = n < N ? zero[n * szn] : 0.f;
  }

  // copies of stage `step` into its slot of the ring
  auto issue = [&](int step) {
    const int slot = step % kStages;
    const int k0 = k_begin + step * kBK;
    __nv_bfloat16* xd = xs + slot * kXStage;
#pragma unroll
    for (int i = 0; i < kXCopies; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), kc = 8 * (c % (kBK / 8));
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < M && k < k_end;
      copy16(xd + r * kLds + kc, ok ? x + int64_t(m) * K + k : x, ok);
    }
    uint8_t* wd = ws + slot * kWStage;
    const int r0 = kInt4 ? k0 / 2 : k0;
    const int r_end = kInt4 ? k_end / 2 : k_end;
#pragma unroll
    for (int i = 0; i < kWCopies; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBN / 16), nc = 16 * (c % (kBN / 16));
      const int kr = r0 + r, n = n0 + nc;
      const bool ok = kr < r_end && n < N;
      copy16(wd + r * kWLd + nc, ok ? wq + int64_t(kr) * N + n : wq, ok);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue(st);
    commit();
  }
  for (int step = 0; step < steps; ++step) {
    wait_copies<kStages - 2>();   // this step's group has landed
    __syncthreads();              // for every thread, and the slot refilled
                                  // below is no longer read
    if (step + kStages - 1 < steps) issue(step + kStages - 1);
    commit();
    const int slot = step % kStages;
    const __nv_bfloat16* xsl = xs + slot * kXStage;
    const uint8_t* wsl = ws + slot * kWStage + wc + 4 * g;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[4][2];
      if constexpr (kInt4) {
        // k-pair rows 8kk + t (b[0]) and 8kk + t + 4 (b[1])
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              wsl + (8 * kk + t + 4 * h) * kWLd);
          const uint32_t lo = v & 0x0F0F0F0Fu, hi = (v >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j][h] = deq_pair(byte_f32(lo, j), byte_f32(hi, j), s[j], z[j]);
          }
        }
      } else {
        // k rows 16kk + 2t, + 1 (b[0]) and those + 8 (b[1])
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* p = wsl + (16 * kk + 2 * t + 8 * h) * kWLd;
          const uint32_t v0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t v1 = *reinterpret_cast<const uint32_t*>(p + kWLd);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j][h] = deq_pair(byte_f32(v0, j), byte_f32(v1, j), s[j], z[j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        load_a(a, xsl + (16 * i + lane % 16) * kLds + 16 * kk +
                      8 * (lane / 16));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j]);
      }
    }
  }
  wait_copies<0>();

  // MMA column c of n8 tile j is the tile's column wc + 4c + j, so this
  // thread's columns 2t and 2t + 1 of the four tiles are the 8 neighbours
  // nc .. nc + 7: element 4e + j is acc[.][j][2h + e] for row g + 8h
  const int nc = n0 + wc + 8 * t;
  write_tile(
      [&](auto f) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v[8];
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int j = 0; j < 4; ++j) v[4 * e + j] = acc[i][j][2 * h + e];
            f(m0 + 16 * i + g + 8 * h, nc, v);
          }
      },
      M, N, out, partial, tickets, split, splits,
      blockIdx.y * gridDim.x + blockIdx.x);
}

template <int MT, bool kInt4>
int launch(const void* x, int M, int K, int N, const void* wq,
           const void* scale, long long ssn, const void* zero,
           long long szn, void* out, int splits, int k_per_split,
           void* partial, void* tickets, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<MT, kInt4>();
  auto kernel = ring_kernel<MT, kInt4>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           int(cudaSharedmemCarveoutMaxShared));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * MT - 1) / (16 * MT), splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), M, K, N,
      static_cast<const uint8_t*>(wq), static_cast<const float*>(scale),
      int64_t(ssn), static_cast<const float*>(zero), int64_t(szn),
      static_cast<__nv_bfloat16*>(out), k_per_split,
      static_cast<float*>(partial), static_cast<int*>(tickets));
  return int(cudaGetLastError());
}

}  // namespace ring

template <int BM, int BN, int WARPS_M, int WARPS_N, bool kInt4>
int launch_edge(const void* x, int M, int K, int N, const void* wq,
                const void* scale, long long ssn, const void* zero,
                long long szn, void* out, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  edge_kernel<BM, BN, WARPS_M, WARPS_N, kInt4>
      <<<grid, 32 * WARPS_M * WARPS_N, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), M, K, N,
          static_cast<const uint8_t*>(wq), static_cast<const float*>(scale),
          int64_t(ssn), static_cast<const float*>(zero), int64_t(szn),
          static_cast<__nv_bfloat16*>(out));
  return int(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kInt4>
int dispatch(const void* x, int M, int K, int N, const void* wq,
             const void* scale, long long ssn, const void* zero,
             long long szn, void* out, int variant, int bm, int splits,
             int k_per_split, void* partial, void* tickets,
             cudaStream_t stream) {
  if ((M + bm - 1) / bm > 65535) return int(cudaErrorInvalidValue);
  if (variant == 0) {   // edge
    if (splits != 1) return int(cudaErrorInvalidValue);
    if (bm == 16) {
      return launch_edge<16, 32, 1, 2, kInt4>(x, M, K, N, wq, scale, ssn,
                                              zero, szn, out, stream);
    }
    if (bm == 64) {
      return launch_edge<64, 64, 2, 2, kInt4>(x, M, K, N, wq, scale, ssn,
                                              zero, szn, out, stream);
    }
    return int(cudaErrorInvalidValue);
  }
  // ring: 16-byte rows and addresses, whole stages a split, no empty split
  const bool shape_ok = N % 16 == 0 && K % 8 == 0 && aligned16(x) &&
                        aligned16(wq) && aligned16(out);
  const bool split_ok =
      splits >= 1 && splits <= 65535 && k_per_split > 0 &&
      k_per_split % kBK == 0 && int64_t(splits) * k_per_split >= K &&
      (splits == 1 || (int64_t(splits - 1) * k_per_split < K &&
                       partial != nullptr && aligned16(partial) &&
                       tickets != nullptr));
  if (variant != 1 || !shape_ok || !split_ok) {
    return int(cudaErrorInvalidValue);
  }
  if (bm == 16) {
    return ring::launch<1, kInt4>(x, M, K, N, wq, scale, ssn, zero, szn, out,
                                  splits, k_per_split, partial, tickets,
                                  stream);
  }
  if (bm == 64) {
    return ring::launch<4, kInt4>(x, M, K, N, wq, scale, ssn, zero, szn, out,
                                  splits, k_per_split, partial, tickets,
                                  stream);
  }
  if (bm == 128) {
    return ring::launch<8, kInt4>(x, M, K, N, wq, scale, ssn, zero, szn, out,
                                  splits, k_per_split, partial, tickets,
                                  stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x (M, K) bf16 row-major; wq (K, N) uint8, or (K / 2, N) uint8 with int4
// != 0 (K even, nibbles packed along K); scale / zero float32 read at
// n * ssn / n * szn (0: a scalar); out (M, N) bf16.  The launch plan
// (kernels/dequant_matmul.py:plan): variant 0 edge (any shape and address,
// bm 16 or 64, splits 1) or 1 ring (N % 16 == 0, K % 8 == 0, x, wq and out
// 16-byte aligned; bm 16 or 128); K cut into `splits` splits of
// k_per_split (a multiple of 64, none empty); with splits > 1, partial
// (splits, M, N) float32, 16-byte aligned, and tickets, one int32 a
// (M tile, N tile), zero before the launch and zero after it.  A plan the
// kernel does not take returns cudaErrorInvalidValue and launches nothing.
int dequant_matmul(const void* x, int M, int K, int N, const void* wq,
                   int int4, const void* scale, long long ssn,
                   const void* zero, long long szn, void* out, int variant,
                   int bm, int splits, int k_per_split, void* partial,
                   void* tickets, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int4 ? dispatch<true>(x, M, K, N, wq, scale, ssn, zero, szn, out,
                               variant, bm, splits, k_per_split, partial,
                               tickets, st)
              : dispatch<false>(x, M, K, N, wq, scale, ssn, zero, szn, out,
                                variant, bm, splits, k_per_split, partial,
                                tickets, st);
}

}  // extern "C"
