// Shared pieces of the entropy-decode kernels (entropy_decode.cu) and the
// fused decode -> dequant -> matmul kernels (fused_decode_matmul.cu): the
// stream window, the two decode cursors, the copy of the decode tables into
// shared memory, and the launch helper that places them.
//
// A cursor walks one encoded stream (one segment, one "lane") a symbol at a
// time; every step depends on the one before, so a lane is a dependent chain
// of window load -> table load -> add.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace entropy {

constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kTansHeaderBits = 16;

// The big-endian 32-bit window starting at `byte` of a row of width B; bytes
// past the row read as 0, like the zero guard the numpy decoder appends.
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
// after another, and returns where they start.  Every thread of the block
// must call it (it ends with a barrier).
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

// Canonical prefix code (Huffman / raw): peek max_len bits at bitpos, then
// sym = lut_sym[peek], bitpos += lut_len[peek].
struct PrefixCursor {
  const uint8_t* row;
  int64_t B;
  const int32_t* lut_sym;
  const int32_t* lut_len;
  uint32_t mask;
  int top;
  int64_t bitpos;

  __device__ PrefixCursor(const uint8_t* row_, int64_t B_,
                          const int32_t* lut_sym_, const int32_t* lut_len_,
                          int max_len)
      : row(row_), B(B_), lut_sym(lut_sym_), lut_len(lut_len_),
        mask((1u << max_len) - 1u), top(32 - max_len), bitpos(0) {}

  __device__ __forceinline__ int32_t next() {
    const uint32_t w = window32(row, B, bitpos >> 3);
    const uint32_t peek = (w >> (top - int(bitpos & 7))) & mask;
    bitpos += lut_len[peek];
    return lut_sym[peek];
  }
};

// tANS: the initial state is the 16-bit header (b0 << 8) | b1 (masked to the
// table) with bitpos = 16; each step emits sym = tab_sym[st], reads
// nb = tab_bits[st] fresh bits as the top nb bits of the table_log-bit
// window at bitpos, and moves to st = tab_base[st] + fresh, bitpos += nb.
struct TansCursor {
  const uint8_t* row;
  int64_t B;
  const int32_t* tab_sym;
  const int32_t* tab_bits;
  const int32_t* tab_base;
  uint32_t mask;
  int top;
  int table_log;
  uint32_t st;
  int64_t bitpos;

  __device__ TansCursor(const uint8_t* row_, int64_t B_,
                        const int32_t* tab_sym_, const int32_t* tab_bits_,
                        const int32_t* tab_base_, int table_log_)
      : row(row_), B(B_), tab_sym(tab_sym_), tab_bits(tab_bits_),
        tab_base(tab_base_), mask((1u << table_log_) - 1u),
        top(32 - table_log_), table_log(table_log_),
        st((window32(row_, B_, 0) >> 16) & ((1u << table_log_) - 1u)),
        bitpos(kTansHeaderBits) {}

  __device__ __forceinline__ int32_t next() {
    const int32_t nb = tab_bits[st];
    const int32_t sym = tab_sym[st];
    const uint32_t w = window32(row, B, bitpos >> 3);
    const uint32_t peek = (w >> (top - int(bitpos & 7))) & mask;
    const uint32_t fresh = peek >> (table_log - nb);
    st = uint32_t(tab_base[st] + int32_t(fresh)) & mask;
    bitpos += nb;
    return sym;
  }
};

// Launches `shared_kernel` with `smem_shared` bytes of dynamic shared memory
// when that fits a block, else `global_kernel` (decode tables read from
// global memory) with `smem_global` bytes.  Above the 48 KiB default the
// kernel's limit is raised and the SM's carve-out set to shared memory
// first.  Returns cudaGetLastError().
template <typename... P, typename... A>
int launch(void (*shared_kernel)(P...), void (*global_kernel)(P...),
           size_t smem_shared, size_t smem_global, dim3 grid, dim3 block,
           cudaStream_t stream, A... args) {
  const bool fits = smem_shared <= kMaxSmem;
  void (*kernel)(P...) = fits ? shared_kernel : global_kernel;
  const size_t smem = fits ? smem_shared : smem_global;
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
