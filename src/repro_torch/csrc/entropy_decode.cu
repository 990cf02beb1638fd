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
// Both write int32 symbols and 0 past a stream's count.
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

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kTansHeaderBits = 16;

// The big-endian 32-bit window starting at `byte` of a row of width B.
__device__ __forceinline__ uint32_t window32(const uint8_t* row, int64_t B,
                                             int64_t byte) {
  if (byte + 3 < B) {
    return (uint32_t(row[byte]) << 24) | (uint32_t(row[byte + 1]) << 16) |
           (uint32_t(row[byte + 2]) << 8) | uint32_t(row[byte + 3]);
  }
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i) {
    w = (w << 8) | (byte + i < B ? uint32_t(row[byte + i]) : 0u);
  }
  return w;
}

// Copies n_tabs tables of L int32 entries each into shared memory, one
// after another, and returns where they start.
__device__ __forceinline__ const int32_t* stage_tables(
    int32_t* smem, const int32_t* const* tabs, int n_tabs, int L) {
  for (int t = 0; t < n_tabs; ++t) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      smem[t * L + i] = tabs[t][i];
    }
  }
  __syncthreads();
  return smem;
}

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
  const uint8_t* row = mat + int64_t(s) * B;
  int32_t* o = out + int64_t(s) * max_count;
  const int n = min(counts[s], max_count);
  const uint32_t mask = (1u << max_len) - 1u;
  const int top = 32 - max_len;
  int64_t bitpos = 0;
  int k = 0;
  for (; k < n; ++k) {
    const uint32_t w = window32(row, B, bitpos >> 3);
    const uint32_t peek = (w >> (top - int(bitpos & 7))) & mask;
    o[k] = lut_sym[peek];
    bitpos += lut_len[peek];
  }
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
  const uint8_t* row = mat + int64_t(s) * B;
  int32_t* o = out + int64_t(s) * max_count;
  const int n = min(counts[s], max_count);
  const uint32_t mask = uint32_t(L - 1);
  const int top = 32 - table_log;
  uint32_t st = (window32(row, B, 0) >> 16) & mask;
  int64_t bitpos = kTansHeaderBits;
  int k = 0;
  for (; k < n; ++k) {
    const int32_t nb = tab_bits[st];
    o[k] = tab_sym[st];
    const uint32_t w = window32(row, B, bitpos >> 3);
    const uint32_t peek = (w >> (top - int(bitpos & 7))) & mask;
    const uint32_t fresh = peek >> (table_log - nb);
    st = uint32_t(tab_base[st] + int32_t(fresh)) & mask;
    bitpos += nb;
  }
  for (; k < max_count; ++k) o[k] = 0;
}

// Launches one thread per stream on `stream`: `shared_kernel` with `smem`
// bytes of tables in dynamic shared memory when they fit a block (raising
// the kernel's limit above the 48 KiB default), else `global_kernel`.
// Returns cudaGetLastError().
template <typename... P, typename... A>
int launch(void (*shared_kernel)(P...), void (*global_kernel)(P...),
           size_t smem, int S, cudaStream_t stream, A... args) {
  const dim3 grid((S + kThreads - 1) / kThreads);
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      cudaError_t e = cudaFuncSetAttribute(
          shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          int(smem));
      if (e != cudaSuccess) return int(e);
    }
    shared_kernel<<<grid, kThreads, smem, stream>>>(args...);
  } else {
    global_kernel<<<grid, kThreads, 0, stream>>>(args...);
  }
  return int(cudaGetLastError());
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
  return launch(prefix_decode_kernel<true>, prefix_decode_kernel<false>,
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
  return launch(tans_decode_kernel<true>, tans_decode_kernel<false>,
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
