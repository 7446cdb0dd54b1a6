// The int8 pieces of the int8 wgmma core of F1-F5 (int8_wgmma.cuh,
// int8_tail.cuh): vdn's dequantization order, and the load of eight
// consecutive row values as fp32.
#pragma once

#include "common.cuh"

namespace vdn {

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
