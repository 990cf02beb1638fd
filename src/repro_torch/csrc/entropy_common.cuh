// Shared pieces of the entropy-decode kernels (entropy_decode.cu) and the
// fused decode -> dequant -> matmul kernels (fused_decode_matmul.cu): the
// register bit reader, the interleaved 8-byte table entries and the kernels
// that build them in global memory, the split decode's phases 1 and 2 with
// their block scan, the placement test for tables, and the launch helper.
//
// Everything here is inline or in an unnamed namespace: each source that
// includes it gets its own copy, and the library links without clashes.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace entropy {

constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kTansHeaderBits = 16;
constexpr int kSplitThreads = 1024;  // split decode: subsequences (threads)
constexpr int kMaxRowBytes = 1 << 28;
// the static shared memory of a kernel that runs split_sync: the exits,
// the covered count and block_scan's sums
constexpr size_t kSplitStaticSmem =
    sizeof(uint32_t) * kSplitThreads + sizeof(int) * (1 + 2 * 32);

// BitReader: a row of B bytes at any address, read as a big-endian bit
// stream from registers.  The 64 bits from the start of 4-byte-aligned word
// wi are held as two byte-swapped words (hi, lo) with the bit offset o < 32
// of the next bit in hi, and the word after them (n1) beside them; the word
// after that waits as loaded (pend).  When a step leaves fewer than 32 bits
// in hi:lo, the words move down and the load of the word three ahead is
// issued, so every word is loaded a word's worth of steps before it is used
// and no load sits on the dependent chain.  Words that hold no byte of the
// row read as 0, and so do the bytes past the row in its last word: the
// zero guard of the numpy decoder.  The bytes before the row in its first
// word are loaded but never consumed.  Bit positions are 32-bit: the
// callers keep B below 2^28.
struct BitReader {
  const uint32_t* words;  // the aligned word holding the row's first byte
  uint32_t lead;          // bits of that word before the row: 0, 8, 16, 24
  int wlim;               // words [0, wlim) hold a byte of the row
  uint32_t tail_mask;     // keeps the row's bytes of word wlim - 1
  uint32_t hi, lo, n1;    // words wi, wi + 1, wi + 2, byte-swapped
  uint32_t pend;          // word wi + 3 as loaded
  int wi;
  int o;

  __device__ BitReader(const uint8_t* row, int B) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
    const int a = int(addr & 3);
    words = reinterpret_cast<const uint32_t*>(addr - a);
    lead = uint32_t(8 * a);
    wlim = (B + a + 3) >> 2;
    const int k = B + a - 4 * (wlim - 1);     // row bytes in the last word
    tail_mask = 0xFFFFFFFFu << (8 * (4 - k));
  }

  __device__ __forceinline__ uint32_t raw(int w) const {
    uint32_t v = 0;
    if (w < wlim) v = __ldg(words + w);
    return v;
  }

  __device__ __forceinline__ uint32_t swap(uint32_t v, int w) const {
    v = __byte_perm(v, 0, 0x0123);
    return w == wlim - 1 ? v & tail_mask : v;
  }

  // Moves to bit `pos` of the row.
  __device__ __forceinline__ void seek(uint32_t pos) {
    const uint32_t q = pos + lead;
    wi = int(q >> 5);
    o = int(q & 31);
    hi = swap(raw(wi), wi);
    lo = swap(raw(wi + 1), wi + 1);
    n1 = swap(raw(wi + 2), wi + 2);
    pend = raw(wi + 3);
  }

  // The next n bits (1 <= n <= 32) as an integer.
  __device__ __forceinline__ uint32_t peek(int n) const {
    return __funnelshift_l(lo, hi, o) >> (32 - n);
  }

  // Consumes n <= 32 bits.
  __device__ __forceinline__ void skip(int n) {
    o += n;
    if (__builtin_expect(o >= 32, 0)) {
      o -= 32;
      hi = lo;
      lo = n1;
      n1 = swap(pend, wi + 3);
      ++wi;
      pend = raw(wi + 3);
    }
  }
};

// Writes m int32 symbols, the results of m calls of step(), to o[0..m):
// one at a time up to a 16-byte boundary, then four at a time, held in
// registers and stored as one 16-byte store, then the tail one at a time.
template <typename Step>
__device__ __forceinline__ void emit_run(int32_t* o, int m, Step step) {
  int k = 0;
  for (; k < m && (reinterpret_cast<uintptr_t>(o + k) & 15); ++k) {
    o[k] = step();
  }
  for (; k + 4 <= m; k += 4) {
    const int32_t a = step();
    const int32_t b = step();
    const int32_t c = step();
    const int32_t d = step();
    *reinterpret_cast<int4*>(o + k) = make_int4(a, b, c, d);
  }
  for (; k < m; ++k) o[k] = step();
}

__device__ __forceinline__ int2 prefix_entry(const int32_t* sym,
                                             const int32_t* len, int i,
                                             int max_len) {
  return make_int2(sym[i], min(max(len[i], 1), max_len));
}

// (sym, base << 8 | (table_log - nb)): base << 8 >> 5 is the byte offset
// of entry `base`, and a funnel shift by the whole word shifts by its low 5
// bits, table_log - nb.  nb is clamped to [0, table_log] and base to
// [0, 2^table_log - 2^nb], so base + fresh (fresh < 2^nb) indexes the table
// whatever the stream holds; a well-formed table has no other values.
__device__ __forceinline__ int2 tans_entry(const int32_t* sym,
                                           const int32_t* bits,
                                           const int32_t* base, int i,
                                           int table_log) {
  const int nb = min(max(bits[i], 0), table_log);
  const int b = min(max(base[i], 0), (1 << table_log) - (1 << nb));
  return make_int2(sym[i], (b << 8) | (table_log - nb));
}

namespace {

__global__ void interleave_prefix(const int32_t* __restrict__ sym,
                                  const int32_t* __restrict__ len, int n,
                                  int max_len, int2* __restrict__ dst) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    dst[i] = prefix_entry(sym, len, i, max_len);
  }
}

__global__ void interleave_tans(const int32_t* __restrict__ sym,
                                const int32_t* __restrict__ bits,
                                const int32_t* __restrict__ base, int n,
                                int table_log, int2* __restrict__ dst) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    dst[i] = tans_entry(sym, bits, base, i, table_log);
  }
}

}  // namespace

inline int grid_for(long long n) {
  return int(n < 1024 * 256 ? (n + 255) / 256 : 1024);
}

// Decodes from bit `pos` until the position reaches `end`; returns the
// position reached and sets n to the symbols decoded.
__device__ __forceinline__ uint32_t decode_span(BitReader& br,
                                                const int2* tab, int max_len,
                                                uint32_t pos, uint32_t end,
                                                int& n) {
  br.seek(pos);
  int k = 0;
  while (pos < end) {
    const int len = tab[br.peek(max_len)].y;
    br.skip(len);
    pos += uint32_t(len);
    ++k;
  }
  n = k;
  return pos;
}

// One pass's block-wide sums: the exclusive scan of v over the threads, its
// total, and the lowest thread index whose flag is set (blockDim.x if
// none).  Two calls need a barrier between them: a call writes the shared
// sums that the one before read.
__device__ __forceinline__ void block_scan(int v, bool flag, int& excl,
                                           int& total, int& first) {
  __shared__ int s_sum[32];
  __shared__ int s_min[32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
  }
  const unsigned b = __ballot_sync(0xFFFFFFFFu, flag);
  if (lane == 31) s_sum[w] = incl;
  if (lane == 0) s_min[w] = b ? w * 32 + __ffs(int(b)) - 1 : INT_MAX;
  __syncthreads();
  if (w == 0) {
    int x = lane < nw ? s_sum[lane] : 0;
    const int m = __reduce_min_sync(0xFFFFFFFFu,
                                    lane < nw ? s_min[lane] : INT_MAX);
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += t;
    }
    s_sum[lane] = x;
    if (lane == 0) s_min[0] = min(m, int(blockDim.x));
  }
  __syncthreads();
  excl = (w > 0 ? s_sum[w - 1] : 0) + incl - v;
  total = s_sum[nw - 1];
  first = s_min[0];
}

// What split_sync leaves each thread: where its subsequence starts and the
// symbols decoded from there, the symbols of the subsequences before it,
// the symbols of the exact prefix, and the sync passes the block took.
struct Split {
  uint32_t start;
  int n, excl, covered, passes;
};

// Phases 1 and 2 of the split decode of one row of `cnt` symbols (see
// entropy_decode.cu's header), by a block of blockDim.x >= n_sub threads
// (a multiple of 32): thread j owns subsequence j, bits [j*L, (j+1)*L).
// Phase 1 decodes every subsequence from its guessed start; each sync pass
// decodes again every subsequence whose start differs from its left
// neighbour's exit, from that exit.  The passes end once the exact prefix
// holds cnt symbols (or every subsequence agrees).  Every thread of the
// block calls it, after a barrier that follows the table's staging.
__device__ __forceinline__ Split split_sync(BitReader& br, const int2* tab,
                                            int max_len, int L, int n_sub,
                                            int cnt) {
  __shared__ uint32_t s_exit[kSplitThreads];
  __shared__ int s_covered;
  const int j = threadIdx.x;
  const bool live = j < n_sub && cnt > 0;
  Split sp;
  sp.start = uint32_t(j) * uint32_t(L);
  const uint32_t end = sp.start + uint32_t(L);
  sp.n = 0;
  // phase 1
  s_exit[j] = live ? decode_span(br, tab, max_len, sp.start, end, sp.n)
                   : end;
  // phase 2
  sp.passes = 0;
  int total, first;
  for (;;) {
    __syncthreads();                                // exits written
    const uint32_t from = j > 0 ? s_exit[j - 1] : 0u;
    const bool behind = live && j > 0 && sp.start != from;
    block_scan(sp.n, behind, sp.excl, total, first);
    if (j == first) s_covered = sp.excl;
    __syncthreads();
    sp.covered = first >= n_sub ? total : s_covered;
    if (sp.covered >= cnt || first >= n_sub) break;
    if (behind) {
      sp.start = from;
      s_exit[j] = decode_span(br, tab, max_len, sp.start, end, sp.n);
    }
    ++sp.passes;
  }
  return sp;
}

// The subsequence length of the split decode of a row of B bytes: the least
// multiple of max_len that cuts its bits into at most kSplitThreads
// subsequences; sets n_sub to their number.
inline long long split_length(long long B, int max_len, int& n_sub) {
  const long long bits = 8 * B;
  const long long per = (bits + kSplitThreads - 1) / kSplitThreads;
  const long long L = max_len * ((per + max_len - 1) / max_len + (per == 0));
  n_sub = int((bits + L - 1) / L) + (bits == 0);
  return L;
}

// The placement test: whether a table of 2^log interleaved 8-byte entries
// fits a block's shared memory beside `other` bytes the kernel needs there
// as well.  When it does not, the entry point interleaves the table into
// the caller's global scratch buffer and the kernel reads it there.
inline bool table_fits_shared(int log, size_t other) {
  return (size_t(8) << log) + other <= kMaxSmem;
}

// Launches `kernel` with `smem` bytes of dynamic shared memory.  Above the
// 48 KiB default the kernel's limit is raised and the SM's carve-out set to
// shared memory first.  Returns cudaGetLastError().
template <typename... P, typename... A>
int launch(void (*kernel)(P...), size_t smem, dim3 grid, dim3 block,
           cudaStream_t stream, A... args) {
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace entropy
