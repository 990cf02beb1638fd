// Multi-stream lock-step entropy decode: the two kernel families of the
// load path, built into one shared library with a plain C interface.
//
// prefix_decode (canonical Huffman / raw) replaces the TPU kernel
// src/repro/kernels/huffman_decode.py:_decode_kernel (launched by
// decode_streams_pallas).  Same arithmetic as
// repro_torch.core.bitstream.decode_streams: a 32-bit big-endian window from
// bytes bitpos>>3 .. +3, shifted right by 32-max_len-(bitpos&7), masked to
// max_len bits, then sym = lut_sym[peek], bitpos += lut_len[peek].
//
// tans_decode replaces the TPU kernel
// src/repro/kernels/ans_decode.py:_tans_kernel (launched by
// decode_streams_tans_pallas).  Same arithmetic as
// repro_torch.core.bitstream.decode_streams_tans: the initial state is the
// 16-bit header (b0 << 8) | b1 with bitpos = 16; each step emits
// sym = tab_sym[st], reads nb = tab_bits[st] fresh bits as the top nb bits
// of the table_log-bit window at bitpos, and moves to
// st = tab_base[st] + fresh, bitpos += nb.
//
// Both write int32 symbols and 0 past a stream's count.  The window, the
// two cursors, the table staging and the launch helper live in
// entropy_common.cuh, shared with the fused kernels of
// fused_decode_matmul.cu.
//
// What bounds them on an H100: not bytes.  A load-path call moves about
// 2.5 MB (8 streams of 65,536 symbols: stream bytes in, int32 symbols out),
// about a microsecond at 3.35 TB/s, but each stream is a chain of max_count
// dependent steps (window load -> table load -> add), so the time is
// max_count times the latency of one step, and only S threads of the card's
// 132 SMs have work.
//
// Design: one thread per stream (the paper's thread-per-segment decode), 128
// threads a block.  The block first copies its int32 tables into shared
// memory (prefix: 2 * 4 * 2^max_len bytes, 32 KiB at max_len 12; tANS:
// 3 * 4 * 2^table_log bytes, 12 KiB at the 4-bit default table_log 10, 48 KiB
// at 12).  Above 48 KiB the dynamic-shared-memory limit is raised; tables
// larger than a block's shared memory (tANS at table_log 15-16) are read from
// global memory.  A thread's window bytes come from its own row, so after the
// first touch they hit L1.  Reads past the row width return 0, like the zero
// guard the numpy decoder appends, and the tANS state is masked to the table,
// so a malformed stream cannot read out of bounds; for a well-formed stream
// neither changes a value.  Rows lie B bytes apart, so neighbouring threads'
// loads and stores are not coalesced; that and the few lanes per call are
// what a faster design would change.
#include <cstdint>
#include <cuda_runtime.h>

#include "entropy_common.cuh"

namespace {

using entropy::PrefixCursor;
using entropy::TansCursor;
using entropy::stage_tables;

constexpr int kThreads = 128;

template <bool kShared>
__global__ void prefix_decode_kernel(const uint8_t* __restrict__ mat,
                                     int64_t B,
                                     const int32_t* __restrict__ counts,
                                     const int32_t* __restrict__ lut_sym_g,
                                     const int32_t* __restrict__ lut_len_g,
                                     int lut_size, int max_len, int S,
                                     int max_count,
                                     int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int32_t* lut_sym = lut_sym_g;
  const int32_t* lut_len = lut_len_g;
  if (kShared) {
    const int32_t* tabs[2] = {lut_sym_g, lut_len_g};
    lut_sym = stage_tables(smem, tabs, 2, lut_size);
    lut_len = lut_sym + lut_size;
  }
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  int32_t* o = out + int64_t(s) * max_count;
  const int n = min(counts[s], max_count);
  PrefixCursor cur(mat + int64_t(s) * B, B, lut_sym, lut_len, max_len);
  int k = 0;
  for (; k < n; ++k) o[k] = cur.next();
  for (; k < max_count; ++k) o[k] = 0;
}

template <bool kShared>
__global__ void tans_decode_kernel(const uint8_t* __restrict__ mat, int64_t B,
                                   const int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ sym_g,
                                   const int32_t* __restrict__ bits_g,
                                   const int32_t* __restrict__ base_g,
                                   int table_log, int S, int max_count,
                                   int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int L = 1 << table_log;
  const int32_t* tab_sym = sym_g;
  const int32_t* tab_bits = bits_g;
  const int32_t* tab_base = base_g;
  if (kShared) {
    const int32_t* tabs[3] = {sym_g, bits_g, base_g};
    tab_sym = stage_tables(smem, tabs, 3, L);
    tab_bits = tab_sym + L;
    tab_base = tab_sym + 2 * L;
  }
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  int32_t* o = out + int64_t(s) * max_count;
  const int n = min(counts[s], max_count);
  TansCursor cur(mat + int64_t(s) * B, B, tab_sym, tab_bits, tab_base,
                 table_log);
  int k = 0;
  for (; k < n; ++k) o[k] = cur.next();
  for (; k < max_count; ++k) o[k] = 0;
}

// One thread per stream, kThreads a block; the tables in dynamic shared
// memory when they fit a block, else read from global memory.
template <typename... P, typename... A>
int launch_decode(void (*shared_kernel)(P...), void (*global_kernel)(P...),
                  size_t table_bytes, int S, cudaStream_t stream, A... args) {
  return entropy::launch(shared_kernel, global_kernel, table_bytes, 0,
                         dim3((S + kThreads - 1) / kThreads), dim3(kThreads),
                         stream, args...);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// mat (S, B) uint8 row-major; counts (S,) int32; lut_sym / lut_len
// (lut_size,) int32 with lut_size >= 2^max_len; out (S, max_count) int32.
int prefix_decode(const void* mat, long long B, const void* counts,
                  const void* lut_sym, const void* lut_len, int lut_size,
                  int max_len, int S, int max_count, void* out,
                  void* stream) {
  return launch_decode(prefix_decode_kernel<true>, prefix_decode_kernel<false>,
                       size_t(2) * lut_size * sizeof(int32_t), S,
                       static_cast<cudaStream_t>(stream),
                       static_cast<const uint8_t*>(mat), int64_t(B),
                       static_cast<const int32_t*>(counts),
                       static_cast<const int32_t*>(lut_sym),
                       static_cast<const int32_t*>(lut_len), lut_size, max_len, S,
                       max_count, static_cast<int32_t*>(out));
}

// mat (S, B) uint8 row-major; counts (S,) int32; tab_sym / tab_bits /
// tab_base (2^table_log,) int32; out (S, max_count) int32.
int tans_decode(const void* mat, long long B, const void* counts,
                const void* tab_sym, const void* tab_bits,
                const void* tab_base, int table_log, int S, int max_count,
                void* out, void* stream) {
  return launch_decode(tans_decode_kernel<true>, tans_decode_kernel<false>,
                       size_t(3) * (size_t(1) << table_log) * sizeof(int32_t), S,
                       static_cast<cudaStream_t>(stream),
                       static_cast<const uint8_t*>(mat), int64_t(B),
                       static_cast<const int32_t*>(counts),
                       static_cast<const int32_t*>(tab_sym),
                       static_cast<const int32_t*>(tab_bits),
                       static_cast<const int32_t*>(tab_base), table_log, S,
                       max_count, static_cast<int32_t*>(out));
}

}  // extern "C"
