// The warp-level tensor-core product shared by dequant_matmul.cu and
// fused_decode_matmul.cu: mma.sync m16n8k16, bf16 operands, float32
// accumulators.
#pragma once

#include <cstdint>

// d += a * b for one 16 x 8 tile of depth 16.  Fragments (PTX ISA,
// m16n8k16 .bf16), with g = lane / 4 and t = lane % 4, two bf16 a register
// and the lower index in the low half:
//   a[0] row g, k 2t and 2t + 1;   a[1] row g + 8, the same k;
//   a[2] row g, k 2t + 8 and 2t + 9;   a[3] row g + 8, those k;
//   b[0] k 2t and 2t + 1, column g;   b[1] k 2t + 8 and 2t + 9, column g;
//   d[0], d[1] row g, columns 2t and 2t + 1;   d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
