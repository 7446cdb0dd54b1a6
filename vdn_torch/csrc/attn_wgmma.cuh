// The wgmma pieces of A1's forward (flash_attn_qkv.cu), D1's backward
// (flash_attn_qkv_bwd.cu) and F6 (flash_attn_int8.cu): bf16 products of
// 64-row tiles from shared memory or register A fragments, the conversion
// of an fp32 accumulator into A fragments, the MUFU's exp2, a consumer
// thread's row, and the 3-D tensor map of a [B, T, width] bf16 tensor.  Internal linkage: each
// source that includes it gets its own copy.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace vdn::wg;

#define VDN_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define VDN_D32_HI(d)                                                       \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),      \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),      \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),      \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),      \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),      \
      "+f"(d[62]), "+f"(d[63])
#define VDN_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define VDN_R64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// D (+)= A B, 64 x 64 x 16 bf16 -> fp32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VDN_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VDN_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B, 64 x 128 x 16 bf16 -> fp32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VDN_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : VDN_D32(d), VDN_D32_HI(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B, A from registers (the A fragment layout of a 64 x 16 slice:
// that of mma.sync m16n8k16 for warp w's rows 16 w .. 16 w + 15, which the
// m64nN accumulator layout is, rounded to bf16 pairs), B in shared memory,
// K-major or (kTransB) MN-major
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VDN_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : VDN_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

// D += A B, 64 x 72 x 16 bf16 -> fp32, A from registers (wgmma_rs's
// fragments), B MN-major in shared memory: its columns 64-71 one swizzle
// atom on, at the descriptor's leading byte offset (A1's and F6's P V
// beside a tile of ones: columns 64-71 sum P's rows)
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, "
      "p, 1, 1, 1;\n}\n"
      : VDN_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The A fragments (16 rows x 64 columns a warp, four 16-wide K slices) of
// a 64-row bf16 tile in the 128-byte swizzle (TMA's layout: 16-byte chunk
// c of row r at r * 128 + ((c ^ (r % 8)) * 16)), by ldmatrix: lane l
// gives the row of matrix l / 8 (rows +8 for matrices 1 and 3, the second
// 8 columns of the slice for 2 and 3)
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4],
                                             uint32_t tile, int warp,
                                             int lane) {
  const int r = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 2 * kk + (lane >> 4);
    const uint32_t addr = tile + r * 128 + ((c ^ (r & 7)) << 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(addr));
  }
}

// 2^x, flushing results below 2^-126 to zero (p's smallest contributions)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of the 64 x 64 product x (accumulator layout) in bf16,
// one per 16-wide K slice kk: columns 16 kk + 2 (l % 4) (+1) and + 8
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = vdn::pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = vdn::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = vdn::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = vdn::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// x / l rounded to nearest, from r = 1 / l rounded to nearest (one
// reciprocal per row): q = x r, e = x - l q exactly (FMA), q + e r is the
// correctly rounded quotient (Markstein's theorem; x, l finite and normal
// or x zero), three instructions in place of a division's subroutine
__device__ __forceinline__ float div_rn(float x, float l, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-l, q, x), r, q);
}

// this consumer thread's row (key or q row) within its warpgroup's 64
__device__ __forceinline__ int wg_row(int t) {
  return ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
}

// [B, T, width] bf16 moved as boxes of 64 columns (one head, 128 bytes)
// by box_rows rows of one frame in the 128-byte swizzle: rows >= T load
// as zeros and are not stored
cudaError_t encode_rows_bf16(CUtensorMap* map, const void* ptr, int B, int T,
                             int width, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)width * 2 * T};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A [B, T, H, D] bf16 operand read through its strides (elements between
// rows t and t + 1, and between batches; a head D elements on, elements
// contiguous; every stride 16-byte aligned), moved as boxes of 64 of one
// head's columns by box_rows rows of one batch in the 128-byte swizzle,
// coordinates (column, head, row, batch).  Columns >= D and rows >= T
// load as zeros and are not stored: a 56-wide head fills a 64-wide box.
cudaError_t encode_heads_bf16(CUtensorMap* map, const void* ptr, int B,
                              int T, int H, int D, long long row_stride,
                              long long batch_stride, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)row_stride * 2,
                                 (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
