// The int8 pieces that F6's attention (flash_attn_int8.cu, mma.sync) and
// the int8 wgmma core of F1-F5 (int8_wgmma.cuh, int8_tail.cuh) share: the
// mma.sync m16n8k32 s8 product, vdn's dequantization order, and the load
// of eight consecutive row values as fp32.
#pragma once

#include "common.cuh"

namespace vdn {

// D += A B for A 16x32 (row), B 32x8 (col) int8, D 16x8 int32.  Fragments
// (PTX ISA, "mma.m16n8k32" for .s8), g = lane / 4, t = lane % 4, each
// register four int8 of consecutive k:
//   a0 = A[g][4t..4t+3]     a1 = A[g+8][4t..4t+3]
//   a2 = A[g][4t+16..+19]   a3 = A[g+8][4t+16..+19]
//   b0 = B[4t..4t+3][g]     b1 = B[4t+16..4t+19][g]
//   d0,d1 = D[g][2t..2t+1]  d2,d3 = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (float(acc) * rs) * cs, each product rounded on its own (no FMA): vdn's
// order, (acc * sx) * sw
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), rs), cs);
}

// Eight consecutive elements of a bf16 or fp32 row, as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

}  // namespace vdn
