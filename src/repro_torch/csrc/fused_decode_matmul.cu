// Fused entropy decode -> bf16 dequantize -> matmul, prefix and tANS
// families, built into the same plain-C library as entropy_decode.cu.
//
// fused_prefix_matmul and fused_tans_matmul replace the TPU kernels
// src/repro/kernels/fused_decode_matmul.py:_fused_prefix_kernel and
// _fused_tans_kernel (shared tail _deq_accumulate, launched by
// _fused_pallas).  A launch computes
//
//   out[m, n] = bf16( sum_k x[m, k] * w[k, n] )   (float32 sums),
//   w = bf16(bf16(bf16(q) * bf16(scale)) + bf16(zero))
//
// rounded to bf16 after each operation exactly as models.layers.deq does,
// with q[k, n] symbol k*N + n of the layer slice: lane j holds the whole
// rows j*R .. (j+1)*R - 1, R = seg / N.  Every lane holds exactly seg
// symbols (the tile-alignment contract), so the count of every lane is seg.
//
// What bounds them on an H100: neither bytes nor FLOPs.  A launch reads the
// lane matrix (2.6 MB for a 2048 x 2048 Huffman-8 slice), x, and writes the
// output: about a microsecond at 3.35 TB/s; its 2*M*K*N FLOPs are
// microseconds on the tensor cores.
// - fused_tans_matmul is bound by one lane's chain: each tANS step's table
//   index is the state the step before computed, so a lane's seg steps run
//   one after another (a speculative split costs about 40 times the steps;
//   PERF.md).  The design makes the step as short as tans_decode's: one
//   block a lane, whose thread 0 runs the chain with the state kept as the
//   byte offset of its interleaved 8-byte table entry, the bits in
//   registers (entropy::BitReader), and the symbols leaving four at a time
//   as one 32-bit shared-memory store.  The block's other warps stage the
//   table and wait.  A block of 256 threads needs 72 KiB of shared memory
//   at table_log 10 (8 KiB table, 64 KiB symbols) and at most 128
//   registers a thread, so two blocks share an SM and the 192 lanes of a
//   2048 x 6144 w_down run at once on 132 SMs: two chains on one SM take
//   about one chain's time, as both wait on latency.  At table_log 13-14 a
//   block takes more than half an SM's shared memory, so one block runs on
//   an SM and 192 lanes take two chains' time.
// - fused_prefix_matmul breaks the chain: a canonical prefix code
//   resynchronises, so a block of up to 1024 threads decodes a lane with
//   the split-and-sync decode of prefix_decode (entropy::split_sync, phases
//   1 and 2; see entropy_decode.cu), its count seg.  Lanes are packed to
//   one power-of-two width across layers, so most end in zero padding;
//   the passes end once the exact prefix holds seg symbols, not when every
//   subsequence agrees.  Phase 3 decodes each exact subsequence again and
//   writes symbol i to the tile at row i / N, column i % N - n0.  What
//   bounds it is the sync passes (each a decode of L bits by every thread
//   behind, plus a block scan) and, on the main path, the host's launch
//   path: the wrapper's ctypes call and the lane-sum launch.
//
// The tail, both families: once a barrier has passed, the block's warps
// compute partial[lane] (M x width) = x[:, k0 : k0 + R] . deq(symbols) with
// mma.sync m16n8k16 (bf16 operands, float32 sums).  A warp takes 8
// columns (prefix: a 1,024-thread block leaves 64 registers a thread) or
// 16 (tANS) at a time and dequantizes their weights once, into B fragments
// in registers, with the three bf16 roundings done before the fragment
// (a one-hot row of x then sums one exact product and zeros: the weight,
// bitwise); then it runs every 16-row tile of x through them.  x's lane
// rows are staged as bf16 in shared memory, 128 rows at a time, in the
// bytes the table used (the table is dead by then); M is padded to
// 16-row tiles, whose rows past M are neither read nor stored.  A lane of
// more than 64 rows is taken 64 rows at a time, each block of rows adding
// to the partial the thread stored before; M above 128 dequantizes again
// for each further 128 rows.  A second kernel sums the partials of all
// lanes in lane order and casts to bf16: deterministic, no atomics.  The
// partial buffer is S x M x N float32 (201 MB for w_down at M = 128,
// about 0.12 ms of writes and reads at 3.35 TB/s).
//
// Lanes too long for one block's 64 KiB symbol tile are cut into column
// tiles, one block each (grid (lane, column tile)); each tile decodes the
// lane again (the tANS chain stops after the tile's last symbol).
//
// Tables: interleaved 8-byte entries as in entropy_decode.cu, staged into
// dynamic shared memory beside the symbol tile when fused_table_fits_shared
// says so (prefix max_len and tANS table_log up to 14 beside a 64 KiB
// tile), else interleaved by the entry point into the caller's `scratch`
// and read from global memory.  The wrapper asks that function before it
// allocates `scratch`.
//
// Stats, as the decode kernels: each launch sets stats[0] to the largest
// sync-pass count of a lane (0 for tANS) and stats[1] to the most SM
// cycles a block took, thread 0's clock64() from its first instruction to
// the end of the block's work, tail included.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "entropy_common.cuh"
#include "mma_bf16.cuh"

namespace {

using entropy::BitReader;

constexpr int kTansBlock = 256;   // tANS: threads a block, two blocks an SM
constexpr int kSumThreads = 256;
constexpr int kKB = 64;           // tail: lane rows held in B fragments
constexpr int kXRows = 128;       // tail: rows of x staged at once
constexpr int kXLds = kKB + 8;    // bf16 row stride of the staged x: the
                                  // A-fragment loads hit 32 banks
constexpr size_t kXTileBytes = size_t(kXRows) * kXLds * 2;

struct Affine {
  const float* scale;
  int64_t ssk, ssn;
  const float* zero;
  int64_t szk, szn;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 bits of bf16(bf16(q * s) + z), s and z bf16 values: the product
// of two bf16 values is exact in float32, so this is layers.deq's three
// roundings (bf16(q) is exact for q < 256).
__device__ __forceinline__ uint32_t deq_bits(uint32_t q, float s, float z) {
  return __bfloat16_as_ushort(
      __float2bfloat16_rn(round_bf16(float(q) * s) + z));
}

// The block's partial product on the tensor cores:
//   partial[lane, m, n0 + c] = sum over k < R of x[m, k0 + k] * w[k, c]
// for c < width, w[k, c] the dequantized sym_s[k * width + c].  xs is the
// staging region for x (kXTileBytes, or as many as M's 16-row tiles up to
// kXRows need).  A warp holds NT 8-column tiles of B at a time: 16 * NT
// registers of fragments.  Begins with a barrier; every thread of the block
// calls it.
template <int NT>
__device__ void mma_tail(const __nv_bfloat16* __restrict__ x, int M, int K,
                         int N, int lane, int R, int n0, int width,
                         const uint8_t* sym_s, Affine a, uint32_t* xs,
                         float* __restrict__ partial) {
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int64_t k0 = int64_t(lane) * R;
  const bool per_row = a.ssk != 0 || a.szk != 0;
  const int chunks = (width + 8 * NT - 1) / (8 * NT);
  const unsigned short* __restrict__ xu =
      reinterpret_cast<const unsigned short*>(x);
  unsigned short* xh = reinterpret_cast<unsigned short*>(xs);
  float* __restrict__ out = partial + int64_t(lane) * M * N + n0;
  for (int kb = 0; kb < R; kb += kKB) {
    const int kr = min(kKB, R - kb);               // rows of this block
    for (int mc = 0; mc < M; mc += kXRows) {
      const int tiles = (min(kXRows, M - mc) + 15) / 16;
      __syncthreads();                             // the region is free
      for (int i = threadIdx.x; i < tiles * 16 * kKB; i += blockDim.x) {
        const int r = i / kKB, c = i % kKB;
        xh[r * kXLds + c] =
            mc + r < M && c < kr ? xu[int64_t(mc + r) * K + k0 + kb + c]
                                 : (unsigned short)0;
      }
      __syncthreads();                             // x staged
      for (int ch = warp; ch < chunks; ch += warps) {
        // B fragments: columns 8 * (ch * NT + j) + g, lane rows
        // kb + 16ks + 2t + {0, 1} (h = 0) and {8, 9} (h = 1)
        uint32_t b[kKB / 16][NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = 8 * (ch * NT + j) + g;
          const bool c_ok = c < width;
          const int64_t n = n0 + c;
          float s = 0.f, z = 0.f;
          if (c_ok && !per_row) {
            s = round_bf16(a.scale[n * a.ssn]);
            z = round_bf16(a.zero[n * a.szn]);
          }
#pragma unroll
          for (int ks = 0; ks < kKB / 16; ++ks) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t v = 0;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = 16 * ks + 2 * t + 8 * h + e;
                if (c_ok && r < kr) {
                  if (per_row) {
                    s = round_bf16(a.scale[(k0 + kb + r) * a.ssk + n * a.ssn]);
                    z = round_bf16(a.zero[(k0 + kb + r) * a.szk + n * a.szn]);
                  }
                  v |= deq_bits(sym_s[(kb + r) * width + c], s, z)
                       << (16 * e);
                }
              }
              b[ks][j][h] = v;
            }
          }
        }
        for (int mt = 0; mt < tiles; ++mt) {
          const int r0 = 16 * mt + g;              // staged row of a[0]
          float acc[NT][4];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = mc + r0 + 8 * (q >> 1);
              const int c = 8 * (ch * NT + j) + 2 * t + (q & 1);
              acc[j][q] = kb > 0 && m < M && c < width
                              ? out[int64_t(m) * N + c] : 0.f;
            }
          }
#pragma unroll
          for (int ks = 0; ks < kKB / 16; ++ks) {
            if (16 * ks < kr) {
              const int cc = 8 * ks + t;           // word of k pair 16ks + 2t
              const uint32_t af[4] = {xs[r0 * (kXLds / 2) + cc],
                                      xs[(r0 + 8) * (kXLds / 2) + cc],
                                      xs[r0 * (kXLds / 2) + cc + 4],
                                      xs[(r0 + 8) * (kXLds / 2) + cc + 4]};
#pragma unroll
              for (int j = 0; j < NT; ++j) mma_bf16(acc[j], af, b[ks][j]);
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = mc + r0 + 8 * (q >> 1);
              const int c = 8 * (ch * NT + j) + 2 * t + (q & 1);
              if (m < M && c < width) out[int64_t(m) * N + c] = acc[j][q];
            }
          }
        }
      }
    }
  }
}

// One block per (lane, column tile), blockDim.x >= n_sub threads (a
// multiple of 32).  Dynamic shared memory: `region` bytes for the table
// (kShared) and later the staged x, then the R x width symbol tile.
template <bool kShared>
__global__ void __launch_bounds__(entropy::kSplitThreads, 1)
    fused_prefix_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                        int N, const uint8_t* __restrict__ mat, int B, int R,
                        const int32_t* __restrict__ lut_sym,
                        const int32_t* __restrict__ lut_len,
                        const int2* __restrict__ tab_g, int max_len, int L,
                        int n_sub, Affine a, int tile, int region,
                        float* __restrict__ partial,
                        long long* __restrict__ stats) {
  const long long t0 = clock64();
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int lane = blockIdx.x;
  const int j = threadIdx.x;
  const int n0 = blockIdx.y * tile;
  const int width = min(tile, N - n0);
  const int seg = R * N;
  uint8_t* sym_s = fused_smem + region;
  const int2* tab = tab_g;
  if (kShared) {
    int2* dyn = reinterpret_cast<int2*>(fused_smem);
    for (int i = j; i < (1 << max_len); i += blockDim.x) {
      dyn[i] = entropy::prefix_entry(lut_sym, lut_len, i, max_len);
    }
    tab = dyn;
  }
  BitReader br(mat + int64_t(lane) * B, B);
  __syncthreads();                                  // table staged
  const entropy::Split sp =                         // phases 1 and 2
      entropy::split_sync(br, tab, max_len, L, n_sub, seg);
  // phase 3: symbol i = excl + k goes to row i / N, column i % N - n0
  if (j < n_sub && sp.excl < seg) {
    const int m = min(sp.n, seg - sp.excl);
    int r = sp.excl / N;
    int c = sp.excl - r * N - n0;
    br.seek(sp.start);
    for (int k = 0; k < m; ++k) {
      const int2 e = tab[br.peek(max_len)];
      br.skip(e.y);
      if (unsigned(c) < unsigned(width)) sym_s[r * width + c] = uint8_t(e.x);
      if (++c == N - n0) {
        c = -n0;
        ++r;
      }
    }
  }
  // at 1,024 threads a thread has 64 registers: one 8-column tile at a time
  mma_tail<1>(x, M, K, N, lane, R, n0, width, sym_s, a,
              reinterpret_cast<uint32_t*>(fused_smem), partial);
  __syncthreads();                                  // the block's work done
  if (j == 0) {
    atomicMax(&stats[0], (long long)sp.passes);
    atomicMax(&stats[1], clock64() - t0);
  }
}

// One block per (lane, column tile), kTansBlock threads: all stage the
// table, thread 0 runs the lane's chain into the symbol tile, then all run
// the tail.  Shared memory as fused_prefix_kernel's.
template <bool kShared>
__global__ void __launch_bounds__(kTansBlock, 2)
    fused_tans_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                      int N, const uint8_t* __restrict__ mat, int B, int R,
                      const int32_t* __restrict__ tab_sym,
                      const int32_t* __restrict__ tab_bits,
                      const int32_t* __restrict__ tab_base,
                      const int2* __restrict__ tab_g, int table_log,
                      Affine a, int tile, int region,
                      float* __restrict__ partial,
                      long long* __restrict__ stats) {
  const long long t0 = clock64();
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int lane = blockIdx.x;
  const int n0 = blockIdx.y * tile;
  const int width = min(tile, N - n0);
  uint8_t* sym_s = fused_smem + region;
  const int2* tab = tab_g;
  if (kShared) {
    int2* dyn = reinterpret_cast<int2*>(fused_smem);
    for (int i = threadIdx.x; i < (1 << table_log); i += blockDim.x) {
      dyn[i] = entropy::tans_entry(tab_sym, tab_bits, tab_base, i, table_log);
    }
    tab = dyn;
  }
  __syncthreads();                                  // table staged
  if (threadIdx.x == 0) {
    BitReader br(mat + int64_t(lane) * B, B);
    br.seek(0);
    // the state as the byte offset of its entry
    const char* base = reinterpret_cast<const char*>(tab);
    uint32_t off = (br.peek(entropy::kTansHeaderBits) &
                    ((1u << table_log) - 1u)) << 3;
    br.skip(entropy::kTansHeaderBits);
    uint32_t window = br.peek(table_log);
    // on the chain: the entry's load, a funnel shift, a shift and an add;
    // the window for the next step is cut beside it
    auto step = [&]() -> uint32_t {
      const int2 e = *reinterpret_cast<const int2*>(base + off);
      const uint32_t y = uint32_t(e.y);
      off = (y >> 5) + (__funnelshift_r(window, 0u, y) << 3);
      br.skip(table_log - int(y & 31u));
      window = br.peek(table_log);
      return uint32_t(e.x);
    };
    if (width == N) {
      // whole rows: symbol i is byte i of the tile, four to a store
      const int seg = R * N;
      int i = 0;
      for (; i + 4 <= seg; i += 4) {
        const uint32_t s0 = step();
        const uint32_t s1 = step();
        const uint32_t s2 = step();
        const uint32_t s3 = step();
        *reinterpret_cast<uint32_t*>(sym_s + i) =
            __byte_perm(__byte_perm(s0, s1, 0x0040),
                        __byte_perm(s2, s3, 0x0040), 0x5410);
      }
      for (; i < seg; ++i) sym_s[i] = uint8_t(step());
    } else {
      // a column tile: stop after its last symbol
      const int last = (R - 1) * N + n0 + width;
      int r = 0, c = -n0;
      for (int i = 0; i < last; ++i) {
        const uint32_t v = step();
        if (unsigned(c) < unsigned(width)) sym_s[r * width + c] = uint8_t(v);
        if (++c == N - n0) {
          c = -n0;
          ++r;
        }
      }
    }
  }
  mma_tail<2>(x, M, K, N, lane, R, n0, width, sym_s, a,
              reinterpret_cast<uint32_t*>(fused_smem), partial);
  __syncthreads();                                  // the block's work done
  if (threadIdx.x == 0) atomicMax(&stats[1], clock64() - t0);
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

// The placement test of both fused kernels: the table's 2^log 8-byte
// entries (or the staged x, whichever is larger: they share the bytes), the
// symbol tile and the prefix kernel's static shared memory in one block.
bool fits_shared(int log, size_t sym_bytes) {
  return std::max(size_t(8) << log, kXTileBytes) + sym_bytes +
             entropy::kSplitStaticSmem <= entropy::kMaxSmem;
}

// The dynamic shared memory before the symbol tile: the table when it is
// staged, and the x rows the tail stages (as many 16-row tiles of M as fit
// kXRows), in the same bytes.  A multiple of 16.
size_t region_bytes(bool shared, int log, int M) {
  const size_t x_bytes =
      size_t(std::min((M + 15) / 16 * 16, kXRows)) * kXLds * 2;
  return shared ? std::max(size_t(8) << log, x_bytes) : x_bytes;
}

bool bad_geometry(int M, int K, int N, long long B, int S, int seg,
                  int tile) {
  return M < 1 || N < 1 || S < 1 || seg < N || seg % N != 0 ||
         int64_t(S) * seg != int64_t(K) * N || tile < 1 || B < 1 ||
         B >= entropy::kMaxRowBytes;
}

}  // namespace

extern "C" {

// 1 when a fused kernel stages a table of 2^log 8-byte entries in shared
// memory beside a symbol tile of sym_bytes, 0 when the entry point needs
// `scratch` for it.
int fused_table_fits_shared(int log, long long sym_bytes) {
  return sym_bytes >= 0 && fits_shared(log, size_t(sym_bytes)) ? 1 : 0;
}

// x (M, K) bf16 row-major; mat (S, B) uint8 at any address, S * seg ==
// K * N and seg % N == 0; lut_sym / lut_len int32 with at least 2^max_len
// entries; scale / zero float32 read at k * s?k + n * s?n (0 along a
// broadcast axis); tile columns per block; partial (S, M, N) float32
// scratch; out (M, N) bf16; scratch 2^max_len int2 unless
// fused_table_fits_shared(max_len, seg / N * tile), else unused; stats
// two int64 (see Stats above).
int fused_prefix_matmul(const void* x, int M, int K, int N, const void* mat,
                        long long B, int S, int seg, const void* lut_sym,
                        const void* lut_len, int max_len, const void* scale,
                        long long ssk, long long ssn, const void* zero,
                        long long szk, long long szn, int tile, void* partial,
                        void* out, void* scratch, void* stats, void* stream) {
  if (bad_geometry(M, K, N, B, S, seg, tile) || max_len < 1 ||
      max_len > 24) {
    return int(cudaErrorInvalidValue);
  }
  const int R = seg / N;
  const size_t sym_bytes = size_t(R) * tile;
  const bool shared = fits_shared(max_len, sym_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shared) {
    if (scratch == nullptr) return int(cudaErrorInvalidValue);
    entropy::interleave_prefix<<<entropy::grid_for(1LL << max_len), 256, 0,
                                 st>>>(
        static_cast<const int32_t*>(lut_sym),
        static_cast<const int32_t*>(lut_len), 1 << max_len, max_len,
        static_cast<int2*>(scratch));
  }
  cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(long long), st);
  if (e != cudaSuccess) return int(e);
  int n_sub;
  const long long L = entropy::split_length(B, max_len, n_sub);
  const int threads = (n_sub + 31) / 32 * 32;
  const size_t region = region_bytes(shared, max_len, M);
  const Affine a{static_cast<const float*>(scale), ssk, ssn,
                 static_cast<const float*>(zero), szk, szn};
  int err = entropy::launch(
      shared ? fused_prefix_kernel<true> : fused_prefix_kernel<false>,
      region + sym_bytes, dim3(S, (N + tile - 1) / tile), dim3(threads), st,
      static_cast<const __nv_bfloat16*>(x), M, K, N,
      static_cast<const uint8_t*>(mat), int(B), R,
      static_cast<const int32_t*>(lut_sym),
      static_cast<const int32_t*>(lut_len),
      static_cast<const int2*>(scratch), max_len, int(L), n_sub, a, tile,
      int(region), static_cast<float*>(partial),
      static_cast<long long*>(stats));
  if (err != 0) return err;
  return sum_lanes(static_cast<const float*>(partial), S, int64_t(M) * N,
                   static_cast<__nv_bfloat16*>(out), st);
}

// As fused_prefix_matmul, with tab_sym / tab_bits / tab_base
// (2^table_log,) int32 and scratch 2^table_log int2 unless
// fused_table_fits_shared(table_log, seg / N * tile).
int fused_tans_matmul(const void* x, int M, int K, int N, const void* mat,
                      long long B, int S, int seg, const void* tab_sym,
                      const void* tab_bits, const void* tab_base,
                      int table_log, const void* scale, long long ssk,
                      long long ssn, const void* zero, long long szk,
                      long long szn, int tile, void* partial, void* out,
                      void* scratch, void* stats, void* stream) {
  if (bad_geometry(M, K, N, B, S, seg, tile) || table_log < 1 ||
      table_log > entropy::kTansHeaderBits) {
    return int(cudaErrorInvalidValue);
  }
  const int R = seg / N;
  const size_t sym_bytes = size_t(R) * tile;
  const bool shared = fits_shared(table_log, sym_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shared) {
    if (scratch == nullptr) return int(cudaErrorInvalidValue);
    entropy::interleave_tans<<<entropy::grid_for(1LL << table_log), 256, 0,
                               st>>>(
        static_cast<const int32_t*>(tab_sym),
        static_cast<const int32_t*>(tab_bits),
        static_cast<const int32_t*>(tab_base), 1 << table_log, table_log,
        static_cast<int2*>(scratch));
  }
  cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(long long), st);
  if (e != cudaSuccess) return int(e);
  const size_t region = region_bytes(shared, table_log, M);
  const Affine a{static_cast<const float*>(scale), ssk, ssn,
                 static_cast<const float*>(zero), szk, szn};
  int err = entropy::launch(
      shared ? fused_tans_kernel<true> : fused_tans_kernel<false>,
      region + sym_bytes, dim3(S, (N + tile - 1) / tile), dim3(kTansBlock),
      st, static_cast<const __nv_bfloat16*>(x), M, K, N,
      static_cast<const uint8_t*>(mat), int(B), R,
      static_cast<const int32_t*>(tab_sym),
      static_cast<const int32_t*>(tab_bits),
      static_cast<const int32_t*>(tab_base),
      static_cast<const int2*>(scratch), table_log, a, tile, int(region),
      static_cast<float*>(partial), static_cast<long long*>(stats));
  if (err != 0) return err;
  return sum_lanes(static_cast<const float*>(partial), S, int64_t(M) * N,
                   static_cast<__nv_bfloat16*>(out), st);
}

}  // extern "C"
