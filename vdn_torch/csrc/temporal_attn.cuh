// What A3 (temporal_attn.cu) and D4 (temporal_attn_bwd.cu) share: the
// + pe row kernel, the plain store epilogue of their products on the bf16
// wgmma + TMA core (bf16_wgmma.cuh), and the warp-level pieces of their
// T x T cores on the tensor cores.
//
// The core: one warp takes one (token, head) item, the T <= 32 frames of
// one token and one head.  Its q, k, v (D4: and doh) rows, dh bf16 each,
// lie in shared memory at a row stride of dh + 8 (16 bytes more than the
// row: the 8 rows an ldmatrix reads fall on 8 different 16-byte bank
// groups at every head width, 32 / 48 / 64 / 128 / 192).  S = q k^T runs
// on mma.sync m16n8k16 bf16 with fp32 sums: KT = ceil(T / 16) m16 tiles of
// query rows by 2 KT n8 tiles of keys, over dh / 16 steps (dh 48 and 192
// are multiples of 16, so every width runs this code).  Rows past T are
// zero in shared memory, and the columns past T are -inf before the
// softmax, so their probabilities are exactly 0.  The softmax is fp32
// across the quad that holds a row (shuffles), exp by expf and a correctly
// rounded division, as vdn's kernel (temporal_attention.py:75-78).
//
// Each warp keeps its own ring of kStages item slots and fills the next
// slot by cp.async (16 bytes a lane) while it computes the current one, so
// no block-level barrier exists; persistent blocks of kWarps warps walk
// the items (warp w of the grid takes items w, w + grid kWarps, ...; items
// numbered token * heads + head, so neighbouring warps read neighbouring
// columns of the same rows).  The result rows are staged in shared memory
// (a consumed operand's region) and stored 16 bytes a lane.
#pragma once

#include <math.h>

#include "bf16_wgmma.cuh"

namespace vdn {
namespace tattn {

constexpr int kMaxT = 32;
constexpr int kSmemMax = 232448;  // an H100 block's dynamic shared memory

// One warp's shared memory for a core of head width DH over KT m16 tiles
// of frames (16 KT >= T): kStages slots of kTensors tensors [16 KT, DH +
// 8] bf16, plus kExtra bytes (D4's probability and ds tiles).  A block
// holds as many warps as fit in an H100 block's shared memory, up to 8
// (16 at T <= 16, where an item is half the size: more items in flight).
template <int DH, int KT, int kTensors, int kExtra>
struct Core {
  static_assert(DH % 16 == 0 && DH <= 256, "head width");
  static constexpr int kRows = 16 * KT;
  static constexpr int LD = DH + 8;
  static constexpr int kTensor = kRows * LD;  // elements
  static constexpr int kSlot = kTensors * kTensor;
  static constexpr int kStages = 2;
  static constexpr int kWarpBytes = kStages * kSlot * 2 + kExtra;
  static constexpr int kCap = KT == 1 ? 16 : 8;
  static constexpr int kFit = kSmemMax / kWarpBytes;
  static constexpr int kWarps = kFit < kCap ? kFit : kCap;
  static_assert(kWarps >= 1, "a warp's slots fit a block");
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSmem = kWarps * kWarpBytes;
  // output columns a pass: 64 (8 n8 tiles) or the whole head
  static constexpr int kCT = DH >= 64 ? 8 : DH / 8;
  static_assert((DH / 8) % kCT == 0 && kCT % 2 == 0, "column passes");
};

// ldmatrix x4 (as stored / transposed), ordered against the warp's other
// shared-memory accesses ("memory"): lane l gives the row address of
// matrix l / 8; register i holds matrix i, thread (g, t) receiving M[g][2t
// .. 2t + 1] (as stored) or M[2t][g], M[2t + 1][g] (transposed)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(row))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(row))
      : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  mma_bf16_16816(d, a, b);
}

// The A fragment of rows [16 mi, 16 mi + 16) and columns [c0, c0 + 16) of
// a row-major [rows, LD] tile (lane: row mi * 16 + l % 16, column c0 + 8
// (l / 16))
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int mi,
                                       int c0, int lane) {
  ldsm(a, s + (16 * mi + (lane & 15)) * LD + c0 + ((lane >> 4) << 3));
}

// The A fragment of the transpose of a row-major tile: A[m][k] = s[k][m]
// for m in [16 mi, + 16), k in [16 kk, + 16)
template <int LD>
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4],
                                         const __nv_bfloat16* s, int mi,
                                         int kk, int lane) {
  ldsm_t(a, s + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * mi +
                (((lane >> 3) & 1) << 3));
}

// B fragments of n8 tiles 2p and 2p + 1 over k in [c0, c0 + 16) of an
// operand stored [n][k] (keys as rows: S = q k^T): b[0], b[1] of tile 2p,
// b[2], b[3] of tile 2p + 1
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* s, int p, int c0,
                                       int lane) {
  ldsm(b, s + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
              (((lane >> 3) & 1) << 3));
}

// B fragments of n8 tiles nd and nd + 1 (columns 8 nd ..) over k in [16
// kk, 16 kk + 16) of an operand stored [k][n] (P V: keys as rows)
template <int LD>
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4],
                                         const __nv_bfloat16* s, int kk,
                                         int nd, int lane) {
  ldsm_t(b, s + (16 * kk + (lane & 15)) * LD + 8 * nd + ((lane >> 4) << 3));
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

// acc[mi][nj] = A B^T over dh: A rows from a, B rows (keys) from b, both
// [16 KT, LD] (S = q k^T; D4: dP = doh v^T)
template <int DH, int KT, int LD>
__device__ __forceinline__ void rows_by_keys(float (&acc)[KT][2 * KT][4],
                                             const __nv_bfloat16* a,
                                             const __nv_bfloat16* b,
                                             int lane) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t af[KT][4];
#pragma unroll
    for (int mi = 0; mi < KT; ++mi) frag_a<LD>(af[mi], a, mi, 16 * kk, lane);
#pragma unroll
    for (int p = 0; p < KT; ++p) {
      uint32_t bf[4];
      frag_b<LD>(bf, b, p, 16 * kk, lane);
#pragma unroll
      for (int mi = 0; mi < KT; ++mi) {
        mma(acc[mi][2 * p], af[mi], bf[0], bf[1]);
        mma(acc[mi][2 * p + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// s (the fp32 q k^T sums) -> softmax(s * scale) over the keys < T, in
// place: thread (g, t) holds rows 16 mi + g (e 0, 1) and + 8 (e 2, 3),
// columns 8 nj + 2t + e % 2; the max and the sum across the quad
template <int KT>
__device__ __forceinline__ void softmax_rows(float (&s)[KT][2 * KT][4],
                                             int T, float scale, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < KT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nj = 0; nj < 2 * KT; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[mi][nj][2 * h + e];
          v = 8 * nj + 2 * t + e < T ? v * scale : -INFINITY;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int nj = 0; nj < 2 * KT; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[mi][nj][2 * h + e];
          v = expf(v - mx);
          sum += v;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
      for (int nj = 0; nj < 2 * KT; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[mi][nj][2 * h + e] = __fdiv_rn(s[mi][nj][2 * h + e], sum);
    }
}

// A fragments of the bf16-rounded p (rows x keys) for the products over
// the keys: a[mi][kk] from n8 tiles 2 kk and 2 kk + 1 of row tile mi
template <int KT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KT][KT][4],
                                       const float (&p)[KT][2 * KT][4]) {
#pragma unroll
  for (int mi = 0; mi < KT; ++mi)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      a[mi][kk][0] = pack_bf16(p[mi][2 * kk][0], p[mi][2 * kk][1]);
      a[mi][kk][1] = pack_bf16(p[mi][2 * kk][2], p[mi][2 * kk][3]);
      a[mi][kk][2] = pack_bf16(p[mi][2 * kk + 1][0], p[mi][2 * kk + 1][1]);
      a[mi][kk][3] = pack_bf16(p[mi][2 * kk + 1][2], p[mi][2 * kk + 1][3]);
    }
}

// Zero rows [T, 16 KT) of ``n`` tensors of a warp's slots: no load writes
// them, so they stay zero for the launch (T is fixed): the keys past T
// then give finite scores and zero values, and 0 * 0 adds nothing.
template <int LD>
__device__ __forceinline__ void zero_tail(__nv_bfloat16* s, int n,
                                          int tensor, int rows, int T,
                                          int lane) {
  constexpr int CH = LD / 8;
  for (int i = 0; i < n; ++i)
    for (int j = lane; j < (rows - T) * CH; j += 32)
      reinterpret_cast<uint4*>(s + i * tensor + T * LD)[j] =
          make_uint4(0, 0, 0, 0);
}

// cp.async of rows [0, T) of DH values at src (row stride ld) into dst
// (row stride LD), 16 bytes a lane
template <int DH, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t ld,
                                          int T, int lane) {
  constexpr int CH = DH / 8;
  for (int i = lane; i < T * CH; i += 32) {
    const int r = i / CH, c = (i - r * CH) * 8;
    cp_async_16(dst + r * LD + c, src + r * ld + c, 16);
  }
}

// rows [0, T) of DH values from src (row stride LD, shared) to dst (row
// stride ld), 16 bytes a lane
template <int DH, int LD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t ld, int T, int lane) {
  constexpr int CH = DH / 8;
  for (int i = lane; i < T * CH; i += 32) {
    const int r = i / CH, c = (i - r * CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * LD + c);
  }
}

// acc [KT][kCT][4] (rows 16 mi + g (+ 8), columns c0 + 8 nd + 2t) rounded
// to bf16 pairs into a [rows, LD] tile
template <int KT, int CT, int LD>
__device__ __forceinline__ void stage_pairs(__nv_bfloat16* s,
                                            const float (&acc)[KT][CT][4],
                                            int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < KT; ++mi)
#pragma unroll
    for (int nd = 0; nd < CT; ++nd)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(s + (16 * mi + g + 8 * h) * LD + c0 +
                                     8 * nd + 2 * t) =
            pack_bf16(acc[mi][nd][2 * h], acc[mi][nd][2 * h + 1]);
}

// f(std::integral_constant<int, KT>{}) with KT = ceil(T / 16)
template <class Fn>
inline cudaError_t with_kt(int T, Fn&& f) {
  return T <= 16 ? f(std::integral_constant<int, 1>{})
                 : f(std::integral_constant<int, 2>{});
}

}  // namespace tattn

namespace {

// xp = bf16(x + pe[row % T]) over x [M, C] (C % 8 == 0), the A operand of
// the qkv product (TMA applies no prologue), 8 values a thread.  Internal
// linkage, a copy in each source; Caller, an empty tag type of that source
// (A3Rows, D4Rows), names each caller's rows apart in a profiler's trace.
template <class Caller>
__global__ void __launch_bounds__(256)
pe_rows_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ pe, int M, int T, int C,
               __nv_bfloat16* __restrict__ xp) {
  const int per_row = C / 8;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)M * per_row) return;
  const size_t row = i / per_row;
  const int c = (int)(i - row * per_row) * 8;
  float a[8], p[8];
  vdn::load_vec<__nv_bfloat16, 8>(x + row * C + c, a);
  vdn::load_vec<__nv_bfloat16, 8>(pe + (row % T) * C + c, p);
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] += p[j];
  vdn::store_vec<__nv_bfloat16, 8>(xp + row * C + c, a);
}

template <class Caller>
inline cudaError_t launch_pe_rows(const __nv_bfloat16* x,
                                  const __nv_bfloat16* pe, int M, int T,
                                  int C, __nv_bfloat16* xp, cudaStream_t s) {
  const size_t n = (size_t)M * (C / 8);
  pe_rows_kernel<Caller><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      x, pe, M, T, C, xp);
  return cudaGetLastError();
}

// The products' plain epilogue: out = bf16(acc).  Tag, an empty type,
// names each product apart in a profiler's trace (one instance each).
template <class Tag>
struct EpiStore {
  static constexpr int kOuts = 1;
  static constexpr bool kResidual = false;
  static constexpr int kColSumOut = -1;
  static constexpr bool kEdge = false;
  struct None {};
  __device__ __forceinline__ None col(int) const { return {}; }
  __device__ __forceinline__ void operator()(None, float v0, float v1,
                                             float2, uint32_t (&o)[1]) const {
    o[0] = vdn::pack_bf16(v0, v1);
  }
};

}  // namespace
}  // namespace vdn
