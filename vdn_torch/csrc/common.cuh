// Shared device helpers for the vdn_torch kernels (sm_90a, bf16).
//
// Tensor-core products use the warp-level mma.sync m16n8k16 bf16 -> fp32
// instruction.  Fragment layouts (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major):  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                          a2 = A[g][2t+8..2t+9]  a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"):       b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C/D (16x8, fp32):      c0,c1 = C[g][2t..2t+1] c2,c3 = C[g+8][2t..2t+1]
// A B operand stored as W[n][k] (a torch Linear weight, K contiguous) is
// exactly the "col" layout, so b0/b1 are single 32-bit shared loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdn {

__device__ __forceinline__ float bf16r(float x) {
  // round to bf16 and back: the rounding points of the TPU kernels
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices, transposed on the way to registers: lane l gives
// the row address of matrix l / 8; register i holds matrix i with thread
// (g, t) receiving M[2t][g] and M[2t+1][g] -- the "col" B fragment of a
// row-major [k][n] operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination
// (the ragged tail of a tile).  The source address must stay valid.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// bf16 / fp32 element <-> fp32, and VEC consecutive elements at once: one
// 16-byte access where VEC * sizeof(T) == 16 (address 16-byte aligned),
// else element by element.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* src, float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f(src[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* dst, const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = from_f<T>(f[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tanh-form GELU in fp32, the bf16 flavour of vdn/ops/pallas/mlp.py
// (_gelu_fast_f32): tanh(u) = 1 - 2 / (exp2(2u log2 e) + 1).  2 / d is
// taken as 2 * rcp_rn(d), the same bits as the correctly rounded quotient
// (a power of two commutes with rounding; d >= 1) in fewer instructions.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kA = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kB = 0.044715f;
  float u = kA * (x + kB * x * x * x);
  float e = exp2f(u * (2.0f * 1.4426950408889634f));
  return 0.5f * x * (1.0f + (1.0f - 2.0f * __frcp_rn(e + 1.0f)));
}

}  // namespace vdn
