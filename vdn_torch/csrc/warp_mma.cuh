// Warp-level pieces of the mma.sync cores that several kernels share: the
// T x T cores of A3 and D4 (temporal_attn.cuh) and E1, the ring-attention
// step (ring_step.cu).  bf16 fragments are read out of row-major shared
// tiles by ldmatrix (row stride ``ld`` elements, rows 16-byte aligned; a
// stride of 16 bytes more than an odd number of 16-byte groups, as D + 8
// for D % 16 == 0, puts the 8 rows of one ldmatrix on 8 different bank
// groups), multiplied on mma.sync m16n8k16 with fp32 sums, and fp32
// accumulators are repacked into A fragments for a product over the keys.
// Fragment layouts: common.cuh.
#pragma once

#include "common.cuh"

namespace vdn {
namespace msync {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix x4 (as stored / transposed), ordered against the warp's other
// shared-memory accesses ("memory"): lane l gives the row address of
// matrix l / 8; register i holds matrix i, thread (g, t) receiving M[g][2t
// .. 2t + 1] (as stored) or M[2t][g], M[2t + 1][g] (transposed)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  mma_bf16_16816(d, a, b);
}

// The A fragment of rows [16 mi, 16 mi + 16) and columns [c0, c0 + 16) of
// a row-major tile (lane: row mi * 16 + l % 16, column c0 + 8 (l / 16))
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int mi, int c0, int lane) {
  ldsm(a, s + (16 * mi + (lane & 15)) * ld + c0 + ((lane >> 4) << 3));
}

// The A fragment of the transpose of a row-major tile: A[m][k] = s[k][m]
// for m in [16 mi, + 16), k in [16 kk, + 16)
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4],
                                         const __nv_bfloat16* s, int ld,
                                         int mi, int kk, int lane) {
  ldsm_t(a, s + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * mi +
                (((lane >> 3) & 1) << 3));
}

// B fragments of n8 tiles 2p and 2p + 1 over k in [c0, c0 + 16) of an
// operand stored [n][k] (keys as rows: S = q k^T): b[0], b[1] of tile 2p,
// b[2], b[3] of tile 2p + 1
__device__ __forceinline__ void frag_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* s, int ld, int p,
                                       int c0, int lane) {
  ldsm(b, s + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
              (((lane >> 3) & 1) << 3));
}

// B fragments of n8 tiles nd and nd + 1 (columns 8 nd ..) over k in [16
// kk, 16 kk + 16) of an operand stored [k][n] (P V: keys as rows)
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4],
                                         const __nv_bfloat16* s, int ld,
                                         int kk, int nd, int lane) {
  ldsm_t(b, s + (16 * kk + (lane & 15)) * ld + 8 * nd + ((lane >> 4) << 3));
}

template <int A, int B>
__device__ __forceinline__ void zero(float (&acc)[A][B][4]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The A fragment of a 16-key step, the bf16-rounded accumulators of its
// two n8 key tiles p0 (keys 16 kk ..) and p1 (16 kk + 8 ..)
__device__ __forceinline__ void pack_p(uint32_t (&a)[4], const float (&p0)[4],
                                       const float (&p1)[4]) {
  a[0] = pack_bf16(p0[0], p0[1]);
  a[1] = pack_bf16(p0[2], p0[3]);
  a[2] = pack_bf16(p1[0], p1[1]);
  a[3] = pack_bf16(p1[2], p1[3]);
}

}  // namespace msync
}  // namespace vdn
