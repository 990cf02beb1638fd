// Multi-stream entropy decode: the two kernel families of the load path,
// built into one shared library with a plain C interface.
//
// prefix_decode (canonical Huffman / raw) replaces the TPU kernel
// src/repro/kernels/huffman_decode.py:_decode_kernel (launched by
// decode_streams_pallas).  Same result as
// repro_torch.core.bitstream.decode_streams: peek max_len bits at bitpos
// (big-endian, bytes past the row read as 0), sym = lut_sym[peek],
// bitpos += lut_len[peek].
//
// tans_decode replaces the TPU kernel
// src/repro/kernels/ans_decode.py:_tans_kernel (launched by
// decode_streams_tans_pallas).  Same result as
// repro_torch.core.bitstream.decode_streams_tans: the initial state is the
// 16-bit header (b0 << 8) | b1 with bitpos = 16; each step emits
// sym = tab_sym[st], reads nb = tab_bits[st] fresh bits as the top nb bits
// of the table_log-bit window at bitpos, and moves to
// st = tab_base[st] + fresh, bitpos += nb.
//
// Both write int32 symbols and 0 past a stream's count, from rows (S, B) at
// any address and any width B below 2^28 bytes.  Both read a stream through
// BitReader and write symbols through emit_run; these, the table entries,
// the split decode's phases 1 and 2 and the placement test live in
// entropy_common.cuh, which the fused kernels share.
//
// What bounds them on an H100: not bytes.  A load-path call (8 streams of
// 65,536 symbols) moves about 2.5 MB, under a microsecond at 3.35 TB/s.
// - tans_decode is bound by the latency of one step.  A tANS state is one
//   chain per stream: each step's table index is the state the step before
//   computed, so a stream's max_count steps run one after another.  The
//   design makes the step short: the state is kept as the byte offset of
//   its table entry, and the chain is one 64-bit shared-memory load of the
//   interleaved entry (sym, base << 8 | (table_log - nb)), one funnel shift
//   of the window and one shift-and-add to the next offset.  The bits come
//   from BitReader's words in registers, whose loads are issued a word
//   ahead, so none waits on the chain; the reader's own few ops (the next
//   window, the move to the next word) are what the step costs beyond the
//   chain, as one warp issues in order.  Symbols leave four at a time as
//   16-byte stores (emit_run).  Each stream gets its own block, so the
//   streams of a call do not share an SM's shared memory and L1; the
//   block's other threads stage the table and write the zeros past the
//   count.
// - prefix_decode breaks the chain: canonical prefix codes resynchronise,
//   so one block of up to 1024 threads decodes each stream with the
//   self-synchronizing decode of Weissenberger & Schmidt ("Massively
//   Parallel Huffman Decoding on GPUs", ICPP 2018).  The row's 8B bits are
//   cut into n_sub <= 1024 subsequences of L bits, L a multiple of max_len
//   (so a raw code's fixed-length codewords start where a subsequence
//   starts).  Phase 1: thread j decodes from bit j*L until its position
//   reaches (j+1)*L, and keeps where it left off (its exit) and how many
//   symbols it decoded.  Phase 2, the sync passes: every thread whose start
//   differs from its left neighbour's exit decodes again from that exit.
//   Subsequence 0 starts exact; subsequence j is exact once every start up
//   to j equals its left neighbour's exit, so the exact prefix grows by at
//   least one subsequence a pass.  The passes stop when the exact prefix
//   holds the stream's count symbols: the rows are zero-padded to a
//   power-of-two width, and there an all-zero codeword can keep exits
//   apart a subsequence a pass, so waiting for every subsequence to agree
//   could take up to n_sub passes.  Phase 3: an exclusive block scan of the
//   counts gives each exact subsequence its output offset, and its thread
//   decodes it a third time, writing the symbols below the count.  What
//   bounds it is the sync passes: a launch takes about (2 + passes) times L
//   over the mean code length steps, plus the table staging and one block
//   scan a pass.  Stream bytes are read from global memory, not staged in shared
//   memory with a TMA bulk copy: a bulk copy needs 16-byte-aligned rows,
//   and rows here start anywhere; a block's row (64 KiB at the load shape)
//   stays in L1 and L2 after phase 1, so the passes that follow hit cache.
//   Table lengths are clamped to [1, max_len] as they are staged, so a
//   thread that starts out of step, and meets a window that is no codeword,
//   still moves on; a well-formed stream decoded from its start never meets
//   one, so its symbols do not change.
//
// Stats: each launch sets stats[0] to the largest sync-pass count of a
// stream (prefix_decode; 0 for tANS) and stats[1] to the most SM cycles a
// block took, thread 0's clock64() from its first instruction to the end
// of the block's work.  The wrapper keeps the two int64s on the card;
// nothing on the main path reads them.
//
// Tables: both kernels interleave their tables into 8-byte entries, one
// shared-memory load a step: 8 << max_len bytes for prefix (32 KiB at
// max_len 12), 8 << table_log for tANS (32 KiB at table_log 12).  Up to
// 2^14 entries (128 KiB) they are staged into dynamic shared memory by the
// decoding block; larger ones (tANS at table_log 15-16, prefix above
// max_len 14) do not fit a block, so the entry point first interleaves
// them into the caller's `scratch` in global memory and the kernel reads
// them there.  The staging clamps the tANS entries (see tans_entry) and
// the initial state is masked to the table, so a malformed stream cannot
// read out of bounds; for a well-formed table that changes nothing.
// decode_table_fits_shared() is the one test of which placement a table
// gets; the wrappers ask it whether to allocate `scratch`.
#include <cstdint>
#include <cuda_runtime.h>

#include "entropy_common.cuh"

namespace {

using entropy::BitReader;
using entropy::emit_run;
using entropy::kSplitThreads;

constexpr int kTansThreads = 256;    // tANS: table staging and zero fill

// One block per stream, blockDim.x >= n_sub threads (a multiple of 32).
template <bool kShared>
__global__ void __launch_bounds__(kSplitThreads, 1)
    prefix_decode_kernel(const uint8_t* __restrict__ mat, int B,
                         const int32_t* __restrict__ counts,
                         const int32_t* __restrict__ lut_sym,
                         const int32_t* __restrict__ lut_len,
                         const int2* __restrict__ tab_g, int max_len, int L,
                         int n_sub, int max_count, int32_t* __restrict__ out,
                         long long* __restrict__ stats) {
  const long long t0 = clock64();
  extern __shared__ int2 dyn_tab[];
  const int s = blockIdx.x;
  const int j = threadIdx.x;
  const int2* tab = tab_g;
  if (kShared) {
    for (int i = j; i < (1 << max_len); i += blockDim.x) {
      dyn_tab[i] = entropy::prefix_entry(lut_sym, lut_len, i, max_len);
    }
    tab = dyn_tab;
  }
  const int cnt = max(0, min(counts[s], max_count));
  int32_t* o = out + int64_t(s) * max_count;
  BitReader br(mat + int64_t(s) * B, B);
  __syncthreads();                                  // table staged
  const entropy::Split sp =                         // phases 1 and 2
      entropy::split_sync(br, tab, max_len, L, n_sub, cnt);
  // phase 3
  if (j < n_sub && sp.excl < cnt) {
    const int m = min(sp.n, cnt - sp.excl);
    br.seek(sp.start);
    emit_run(o + sp.excl, m, [&] {
      const int2 e = tab[br.peek(max_len)];
      br.skip(e.y);
      return e.x;
    });
  }
  for (int i = min(cnt, sp.covered) + j; i < max_count; i += blockDim.x) {
    o[i] = 0;
  }
  __syncthreads();                                  // the block's work done
  if (j == 0) {
    atomicMax(&stats[0], (long long)sp.passes);
    atomicMax(&stats[1], clock64() - t0);
  }
}

// One block per stream: every thread stages the table and writes the zeros
// past the count, then thread 0 decodes the stream.
template <bool kShared>
__global__ void __launch_bounds__(kTansThreads)
    tans_decode_kernel(const uint8_t* __restrict__ mat, int B,
                       const int32_t* __restrict__ counts,
                       const int32_t* __restrict__ tab_sym,
                       const int32_t* __restrict__ tab_bits,
                       const int32_t* __restrict__ tab_base,
                       const int2* __restrict__ tab_g, int table_log,
                       int max_count, int32_t* __restrict__ out,
                       long long* __restrict__ stats) {
  const long long t0 = clock64();
  extern __shared__ int2 dyn_tab[];
  const int s = blockIdx.x;
  const int2* tab = tab_g;
  if (kShared) {
    for (int i = threadIdx.x; i < (1 << table_log); i += blockDim.x) {
      dyn_tab[i] =
          entropy::tans_entry(tab_sym, tab_bits, tab_base, i, table_log);
    }
    tab = dyn_tab;
  }
  const int cnt = max(0, min(counts[s], max_count));
  int32_t* o = out + int64_t(s) * max_count;
  for (int i = cnt + threadIdx.x; i < max_count; i += blockDim.x) o[i] = 0;
  __syncthreads();                                  // table staged
  if (threadIdx.x != 0 || cnt == 0) return;
  BitReader br(mat + int64_t(s) * B, B);
  br.seek(0);
  // the state as the byte offset of its entry
  const char* base = reinterpret_cast<const char*>(tab);
  uint32_t off = (br.peek(entropy::kTansHeaderBits) &
                  ((1u << table_log) - 1u)) << 3;
  br.skip(entropy::kTansHeaderBits);
  uint32_t window = br.peek(table_log);
  // on the chain: the entry's load, a funnel shift, a shift and an add;
  // the window for the next step is cut beside it
  emit_run(o, cnt, [&] {
    const int2 e = *reinterpret_cast<const int2*>(base + off);
    const uint32_t y = uint32_t(e.y);
    off = (y >> 5) + (__funnelshift_r(window, 0u, y) << 3);
    br.skip(table_log - int(y & 31u));
    window = br.peek(table_log);
    return e.x;
  });
  atomicMax(&stats[1], clock64() - t0);
}

// The table placement of both decode kernels (the prefix kernel's static
// shared memory counted for both).
bool fits_shared(int log) {
  return entropy::table_fits_shared(log, entropy::kSplitStaticSmem);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when a table of 2^log interleaved 8-byte entries is staged into a
// block's shared memory, 0 when the entry point needs `scratch` for it.
int decode_table_fits_shared(int log) { return fits_shared(log) ? 1 : 0; }

// mat (S, B) uint8 row-major at any address; counts (S,) int32; lut_sym /
// lut_len int32 with at least 2^max_len entries; out (S, max_count) int32;
// scratch 2^max_len int2 unless decode_table_fits_shared(max_len), else
// unused; stats two int64 (see Stats above).
int prefix_decode(const void* mat, long long B, const void* counts,
                  const void* lut_sym, const void* lut_len, int max_len,
                  int S, int max_count, void* out, void* scratch,
                  void* stats, void* stream) {
  if (B < 0 || B >= entropy::kMaxRowBytes || max_len < 1 || max_len > 24) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = fits_shared(max_len);
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
  return entropy::launch(
      shared ? prefix_decode_kernel<true> : prefix_decode_kernel<false>,
      shared ? size_t(8) << max_len : 0, dim3(S), dim3(threads), st,
      static_cast<const uint8_t*>(mat), int(B),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(lut_sym),
      static_cast<const int32_t*>(lut_len),
      static_cast<const int2*>(scratch), max_len, int(L), n_sub, max_count,
      static_cast<int32_t*>(out), static_cast<long long*>(stats));
}

// mat (S, B) uint8 row-major at any address; counts (S,) int32; tab_sym /
// tab_bits / tab_base (2^table_log,) int32; out (S, max_count) int32;
// scratch 2^table_log int2 unless decode_table_fits_shared(table_log), else
// unused; stats two int64 (see Stats above).
int tans_decode(const void* mat, long long B, const void* counts,
                const void* tab_sym, const void* tab_bits,
                const void* tab_base, int table_log, int S, int max_count,
                void* out, void* scratch, void* stats, void* stream) {
  if (B < 0 || B >= entropy::kMaxRowBytes || table_log < 1 ||
      table_log > entropy::kTansHeaderBits) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = fits_shared(table_log);
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
  return entropy::launch(
      shared ? tans_decode_kernel<true> : tans_decode_kernel<false>,
      shared ? size_t(8) << table_log : 0, dim3(S), dim3(kTansThreads), st,
      static_cast<const uint8_t*>(mat), int(B),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(tab_sym),
      static_cast<const int32_t*>(tab_bits),
      static_cast<const int32_t*>(tab_base),
      static_cast<const int2*>(scratch), table_log, max_count,
      static_cast<int32_t*>(out), static_cast<long long*>(stats));
}

}  // extern "C"
