// Shared pieces of C2's fp32 forward (flash_attn_bthd_f32.cu) and its
// backward D2 (flash_attn_bthd_bwd.cu): attention over [B, T, H, D],
// templated on the head width D.
//
// D2 runs every product and sum in fp32 FMA on 32-row shared tiles (the
// first half of this file).  Thread (r, sub) with r = tid / 4 and sub =
// tid % 4 owns row r of a 32 x 32 product tile at the columns sub + 4 j
// (j < 8), and of a 32 x D accumulator the float4 columns sub + 4 i (i < D
// / 16): the four threads of a row are neighbouring lanes (their row sums
// are two shuffles), and in every phase of a 16-byte shared load they read
// consecutive or broadcast addresses.  Shared rows are D + 4 floats:
// 16-byte aligned, and rows r and r + 1 start four banks apart.
//
// C2's forward runs its products on the tensor cores in 3xTF32 (the second
// half): each fp32 operand x splits into big = x rounded to TF32 and
// small = x - big, and a product a b is summed as small_a big_b + big_a
// small_b + big_a big_b in fp32, which keeps about 22 of fp32's 24
// mantissa bits (1xTF32, 10 bits, would miss the 1e-5 checks against the
// fp32 plain versions by 40-fold; tests/test_torch_tf32x3.py).
//
// Operands are read in place through their strides (batch, row; the head
// at h * D, elements contiguous): q, k and v may be slices of one fused
// qkv projection [B, T, 3, H, D].  Each row and base must be 16-byte
// aligned (the wrapper checks).
#pragma once

#include <math.h>

#include "common.cuh"

namespace vdn {
namespace attn_f32 {

constexpr int kRows = 32;      // q rows or keys per tile
constexpr int kThreads = 128;  // 32 rows x 4 threads
constexpr int kPld = kRows + 1;  // 32 x 32 tiles of p or dS: conflict-free

template <int D>
struct Dims {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  static constexpr int kLd = D + 4;              // floats per shared row
  static constexpr int kTile = kRows * kLd;      // floats per 32 x D tile
  static constexpr int kVec = D / 16;            // float4 columns per thread
};

// A strided [B, T, H, D] operand of one (batch, head).
struct Operand {
  const float* base;
  long long row;  // elements between rows t and t + 1
};

__device__ __forceinline__ Operand operand(const float* p, long long sb,
                                           long long st, int b, int h,
                                           int D) {
  return {p + (size_t)b * sb + (size_t)h * D, st};
}

// rows [t0, t0 + 32) of x into a shared tile (rows >= T zero-filled), each
// element times mul (1 leaves it as it is, rounded as the plain version's
// elementwise product).  Synchronous: the caller syncs before use.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, Operand x, int t0,
                                          int T, float mul) {
  constexpr int kChunks = kRows * D / 4;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 4), d = (c % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) {
      v = __ldg(reinterpret_cast<const float4*>(x.base + (t0 + r) * x.row +
                                                d));
      if (mul != 1.f) {
        v.x = __fmul_rn(v.x, mul);
        v.y = __fmul_rn(v.y, mul);
        v.z = __fmul_rn(v.z, mul);
        v.w = __fmul_rn(v.w, mul);
      }
    }
    *reinterpret_cast<float4*>(tile + r * Dims<D>::kLd + d) = v;
  }
}

// 32 values of a [B, H, T] fp32 row statistic (lse, delta) into shared
// memory; rows >= T read 0.
__device__ __forceinline__ void load_rowstat(float* dst, const float* src,
                                             int t0, int T) {
  if (threadIdx.x < kRows)
    dst[threadIdx.x] = t0 + threadIdx.x < T ? src[t0 + threadIdx.x] : 0.f;
}

// sum_d a[d] * b[d] over two shared rows, in fp32 FMA
template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// acc[i] += w * row[float4 column sub + 4 i], over the thread's columns
template <int D>
__device__ __forceinline__ void axpy_row(float4 (&acc)[Dims<D>::kVec],
                                         float w, const float* row, int sub) {
#pragma unroll
  for (int i = 0; i < Dims<D>::kVec; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * (sub + 4 * i));
    acc[i].x = fmaf(w, v.x, acc[i].x);
    acc[i].y = fmaf(w, v.y, acc[i].y);
    acc[i].z = fmaf(w, v.z, acc[i].z);
    acc[i].w = fmaf(w, v.w, acc[i].w);
  }
}

// the thread's columns of one output row, times mul, to dst (contiguous
// [.., D] row)
template <int D>
__device__ __forceinline__ void store_row(float* dst,
                                          const float4 (&acc)[Dims<D>::kVec],
                                          float mul, int sub) {
#pragma unroll
  for (int i = 0; i < Dims<D>::kVec; ++i) {
    float4 v = acc[i];
    v.x *= mul;
    v.y *= mul;
    v.z *= mul;
    v.w *= mul;
    *reinterpret_cast<float4*>(dst + 4 * (sub + 4 * i)) = v;
  }
}

// a kernel that takes more than the 48 KB of static shared memory: opt in
// once per process (the attribute is per function)
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// ------------------------------------------------ 3xTF32 tensor-core tiles
// x = big + small with big x rounded to TF32's 11 significant bits
// (Veltkamp's split: t = x (2^13 + 1), big = t - (t - x), each step
// rounded on its own, four fp32 operations at the full rate where two
// cvt.rna.tf32 would take the slow conversion unit) and small = x - big,
// exact.  The tensor cores read the top 11 significant bits of each
// operand register and drop the rest, so small enters its products
// truncated: an error below 2^-23 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  const float t = __fmul_rn(x, 8193.f);
  const float b = __fsub_rn(t, __fsub_rn(t, x));
  big = __float_as_uint(b);
  small = __float_as_uint(__fsub_rn(x, b));
}

// D += A B for A 16x8 (row), B 8x8 (col) TF32, D 16x8 fp32.  Fragments
// (PTX ISA, "mma.m16n8k8" for .tf32), g = lane / 4, t = lane % 4:
//   a0 = A[g][t]  a1 = A[g+8][t]  a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   b0 = B[t][g]  b1 = B[t+4][g]
//   d0,d1 = D[g][2t..2t+1]  d2,d3 = D[g+8][2t..2t+1]
// (not volatile: it has no effect but its outputs, so the compiler may
// interleave independent products)
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D[off + j] += A B[j] in 3xTF32 for kJ products sharing A, from split
// operands (a big / small, b big / small).  The tensor cores truncate
// their fp32 sums toward zero, which over a chain of products into one
// accumulator (36 per logits tile, 24 a key tile into O) drifts by tens of
// ulps (the measured errors on the card, 3-6e-6, match that emulation in
// tests/test_torch_tf32x3.py); so each 8-wide step sums its three products
// into a zeroed temporary (small * big, big * small, then big * big; over
// the kJ products in turn, so that no product waits on the one before
// it), which one rounded fp32 add takes into D.  off must be a constant
// after unrolling (registers); products j >= valid are skipped (the
// ragged key tile).
template <int kJ, int kD>
__device__ __forceinline__ void mma_3xtf32(float (&d)[kD][4], int off,
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[kJ][2],
                                           const uint32_t (&bs)[kJ][2],
                                           int valid = kJ) {
  float t[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) t[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    if (j < valid) mma_tf32_1688(t[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    if (j < valid) mma_tf32_1688(t[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    if (j < valid) mma_tf32_1688(t[j], ab, bb[j]);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[off + j][i] = __fadd_rn(d[off + j][i], t[j][i]);
}

}  // namespace attn_f32
}  // namespace vdn
