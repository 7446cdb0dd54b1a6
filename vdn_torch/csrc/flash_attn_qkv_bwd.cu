// D1: the backward of A1, ViT self-attention off the fused qkv projection.
//
// Replaces vdn/ops/pallas/flash_attention.py _flash_bwd_cols
// (_flash_bwd_cols_kernel), the vjp of flash_attention_fused_qkv: qkv
// [B, T, 3, H, D], the forward's out [B, T, H, D] and row log-sum-exp lse
// [B, H, T] (base 2, from the training variant of A1), dO [B, T, H, D] ->
// dqkv [B, T, 3, H, D], at vitl's B = 16 frames, T = 1370, H = 16, D = 64,
// bf16.
//
// Bound on the H100 by five tensor-core products per (q tile, key tile)
// (10 * B * H * T^2 * D FLOP; this design recomputes S and dP once more,
// 14 * B * H * T^2 * D issued, so that no atomics change the sums' order
// from run to run: dqkv is bit-identical between launches).  The TPU
// kernel walked the q blocks of one head in order and carried dK / dV in
// VMEM across the grid; Hopper blocks run in no order, so the work runs as
// three launches, the last two warp-specialised on wgmma and TMA
// (sm90.cuh):
//   1. a pre-pass, 8 threads per (frame, token, head) row: qs = bf16(q *
//      qscale) [B, T, H, 64] once, so no block rescales q; delta = sum_d
//      dO * O in fp32 and a copy of lse, both [B, H, Tp] (Tp = T up to a
//      multiple of 128) with the padded rows at delta 0, lse +inf;
//   2. dK / dV: one block per (frame, head, 128-key tile).  A producer
//      warp keeps TMA loads of 64-row qs, q and dO tiles and their lse /
//      delta in flight through a ring of kStages; warpgroups 0 and 1 own
//      64 keys each, K and V resident in shared memory.  S^T = K qs^T and
//      dP^T = V dO^T run as wgmma m64n64k16 from shared memory; P^T and
//      dS^T go to bf16 in registers and feed dV += P^T dO and dK += dS^T q
//      as register-A wgmma, dO and q read MN-major through the
//      descriptor's transpose bit;
//   3. dQ: one block per (frame, head, 128-row q tile), the same core with
//      each warpgroup's qs and dO rows held as A fragments (ldmatrix from
//      the swizzled tiles, so S and dP read only K and V from shared
//      memory), K and V streamed as 64-key tiles in key order, dQ += dS K
//      summed over them in that order in registers.  Each product is a
//      wgmma group of its own, so exp2 of P runs while dP is computed.
// The tensor maps keep the frame as a dimension of its own ([B, T, C]), so
// TMA zero-fills rows >= T of the ragged tail (1370 = 21 * 64 + 26) and
// never reads the next frame's; nothing past T is stored.
//
// vdn's math (flash_attention.py:578-663): q * bf16(scale * log2 e) in
// bf16, S in fp32; p = exp2(S - lse), already normalized; dV takes p
// rounded to bf16; dS = p * (dP - delta) rounded to bf16; dQ = dS K * scale
// and dK = dS^T q * scale with the unscaled q and scale (not scale * log2
// e: d exp2(c x) / dx carries the ln 2 that log2 e cancels).  exp2 is the
// MUFU's ex2.approx.ftz (p below 2^-126 flushes to 0).  Padded q rows give
// p = exp2(0 - inf) = 0; keys >= T are masked to p = 0 in the dQ kernel
// (its last tile) and give rows of dK / dV that are not stored.
//
// On an H100 80GB HBM3 at 700 W the 14 issued products run at ~45% of the
// bf16 peak; taking the q tile's stream or the exp2 out of a copy of the
// kernel moved it by 0 and ~7%, so the m64n64 products of two warpgroups,
// not bytes or the MUFU, set its pace (PERF.md, section 6).
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace vdn::wg;

constexpr int kD = 64;         // head width: one 128-byte swizzle row
constexpr int kRows = 64;      // rows of one TMA box (q rows or keys)
constexpr int kBlockRows = 128;  // keys (dK / dV) or q rows (dQ) a block
constexpr int kTileBytes = kRows * kD * 2;  // 8 KB, 1024-aligned
// consumers: warpgroups 0 and 1; producer: one warp.  ptxas gives each
// thread the launch bound's share rounded to whole warpgroups, 168
// registers (setmaxnreg moves registers at run time but does not raise
// that allocation): dK / dV fits with S^T and dP^T from shared memory (its
// four 64 x 64 fp32 tiles and P^T, dS^T in bf16), dQ with its qs and dO
// tiles held as A fragments
constexpr int kThreads = 288;
constexpr int kConsumers = 256;

// dK / dV: ring stages of {qs, q, dO} tiles, then their lse / delta rows
constexpr int kStages = 4;
constexpr int kKvBytes = 2 * kBlockRows * kD * 2;            // K, V
constexpr int kStageTiles = 3 * kTileBytes;
constexpr int kStatBytes = 2 * kRows * 4;                    // lse, delta
constexpr int kSmemKv = 1024 + kKvBytes + kStages * (kStageTiles + kStatBytes)
                        + 8 * (2 * kStages + 1);
static_assert(kSmemKv <= 232448, "an H100 block's dynamic shared memory");
// dQ: qs and dO resident (128 rows each), ring stages of {K, V} tiles
constexpr int kStagesQ = 6;
constexpr int kSmemQ = 1024 + 2 * kBlockRows * kD * 2
                       + kStagesQ * 2 * kTileBytes + 8 * (2 * kStagesQ + 1);
static_assert(kSmemQ <= 232448, "an H100 block's dynamic shared memory");

#define VDN_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define VDN_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

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

// D (+)= A B, A from registers (the A fragment layout of a 64 x 16 slice:
// that of mma.sync m16n8k16 for warp w's rows 16 w .. 16 w + 15, which the
// m64n64 accumulator layout is, rounded to bf16 pairs), B in shared memory,
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

// qs, delta and the padded lse: 8 threads per (b, t, h) row, d [8 j, 8 j +
// 8) each; rows t in [T, Tp) write the pads only
__global__ void d1_prepass_kernel(const __nv_bfloat16* __restrict__ qkv,
                                  const __nv_bfloat16* __restrict__ out,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse, int B,
                                  int T, int Tp, int H, float qscale,
                                  __nv_bfloat16* __restrict__ qs,
                                  float* __restrict__ lse2,
                                  float* __restrict__ delta) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int j = idx & 7;
  const size_t row = idx >> 3;
  if (row >= (size_t)B * Tp * H) return;
  const int h = row % H;
  const int t = (row / H) % Tp;
  const int b = row / ((size_t)H * Tp);
  const size_t st = ((size_t)b * H + h) * Tp + t;
  if (t >= T) {
    if (j == 0) {
      lse2[st] = INFINITY;
      delta[st] = 0.f;
    }
    return;
  }
  const size_t tok = (size_t)b * T + t;
  const size_t off = (tok * H + h) * kD + 8 * j;
  uint4 qv = *reinterpret_cast<const uint4*>(qkv + (tok * 3 * H + h) * kD +
                                             8 * j);
  const uint4 gv = *reinterpret_cast<const uint4*>(dout + off);
  const uint4 ov = *reinterpret_cast<const uint4*>(out + off);
  __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(&qv);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(q2[i]);
    q2[i] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
    const float2 a = __bfloat1622float2(g2[i]);
    const float2 o = __bfloat1622float2(o2[i]);
    acc += a.x * o.x + a.y * o.y;
  }
  *reinterpret_cast<uint4*>(qs + off) = qv;
  // the row's 8 lanes (a warp holds 4 rows, which return or not together)
  const unsigned group = 0xffu << (threadIdx.x & 24);
  acc += __shfl_xor_sync(group, acc, 1);
  acc += __shfl_xor_sync(group, acc, 2);
  acc += __shfl_xor_sync(group, acc, 4);
  if (j == 0) {
    delta[st] = acc;
    lse2[st] = lse[((size_t)b * H + h) * T + t];
  }
}

// this consumer thread's row (key or q row) within its warpgroup's 64 and
// its first column
__device__ __forceinline__ int wg_row(int t) {
  return ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
}

__global__ void __launch_bounds__(kThreads, 1)
d1_dkdv_kernel(const __grid_constant__ CUtensorMap map_qkv,
               const __grid_constant__ CUtensorMap map_qs,
               const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_lse,
               const __grid_constant__ CUtensorMap map_delta, int T, int H,
               float scale, __nv_bfloat16* __restrict__ dqkv) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t kv = base;                       // K [128 keys], then V
  const uint32_t ring = base + kKvBytes;          // stage s: qs, q, dO
  const int stat_off = kKvBytes + kStages * kStageTiles;
  const float* stats = reinterpret_cast<const float*>(gbase + stat_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gbase + stat_off + kStages * kStatBytes);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  const int k0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int C = H * kD;
  const int bh = b * H + h;
  const int n_q = (T + kRows - 1) / kRows;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_init(smem_u32(kv_bar), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    if (threadIdx.x == 256) {
      const uint32_t kb = smem_u32(kv_bar);
      mbar_expect_tx(kb, kKvBytes);
      for (int r = 0; r < 2; ++r) {
        tma_load_3d(kv + r * kTileBytes, &map_qkv, kb, C + h * kD,
                    k0 + r * kRows, b);
        tma_load_3d(kv + kKvBytes / 2 + r * kTileBytes, &map_qkv, kb,
                    2 * C + h * kD, k0 + r * kRows, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_q; ++i) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t bar = smem_u32(&full[stage]);
        const uint32_t dst = ring + stage * kStageTiles;
        const uint32_t st = base + stat_off + stage * kStatBytes;
        mbar_expect_tx(bar, kStageTiles + kStatBytes);
        tma_load_3d(dst, &map_qs, bar, h * kD, i * kRows, b);
        tma_load_3d(dst + kTileBytes, &map_qkv, bar, h * kD, i * kRows, b);
        tma_load_3d(dst + 2 * kTileBytes, &map_do, bar, h * kD, i * kRows,
                    b);
        tma_load_2d(st, &map_lse, bar, i * kRows, bh);
        tma_load_2d(st + kRows * 4, &map_delta, bar, i * kRows, bh);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns keys k0 + [64 wgi, 64 wgi + 64)
  const int t = threadIdx.x;
  const int c2 = 2 * (t & 3);
  const uint32_t kw = kv + wgi * kTileBytes;
  const uint32_t vw = kv + kKvBytes / 2 + wgi * kTileBytes;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(smem_u32(kv_bar), 0);
  int stage = 0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int i = 0; i < n_q; ++i) {
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint32_t qs_s = ring + stage * kStageTiles;
    const uint32_t q_s = qs_s + kTileBytes, do_s = qs_s + 2 * kTileBytes;
    const float* ls = stats + stage * (kStatBytes / 4);
    const float* ds = ls + kRows;
    // S^T = K qs^T and dP^T = V dO^T: rows keys, columns this tile's q rows
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, desc_sw128(kw + 32 * kk), desc_sw128(qs_s + 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(dp, desc_sw128(vw + 32 * kk), desc_sw128(do_s + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // P^T = exp2(S^T - lse), dS^T = P^T (dP^T - delta), per q column
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n8 + c2);
      const float2 dl = *reinterpret_cast<const float2*>(ds + 8 * n8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * n8 + e] - (e & 1 ? l.y : l.x));
        dp[4 * n8 + e] = p * (dp[4 * n8 + e] - (e & 1 ? dl.y : dl.x));
        s[4 * n8 + e] = p;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(pa, s);
    to_a_frags(dsa, dp);
    // dV += bf16(P^T) dO and dK += bf16(dS^T) q, 16 q rows a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dv, pa[kk], desc_sw128(do_s + 2048 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dk, dsa[kk], desc_sw128(q_s + 2048 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int ld = 3 * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wgi * 64 + wg_row(t) + 8 * r;
    if (key >= T) continue;
    __nv_bfloat16* dst = dqkv + ((size_t)b * T + key) * ld + h * kD + c2;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      *reinterpret_cast<uint32_t*>(dst + C + 8 * n8) = vdn::pack_bf16(
          dk[4 * n8 + 2 * r] * scale, dk[4 * n8 + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dst + 2 * C + 8 * n8) =
          vdn::pack_bf16(dv[4 * n8 + 2 * r], dv[4 * n8 + 2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
d1_dq_kernel(const __grid_constant__ CUtensorMap map_qkv,
             const __grid_constant__ CUtensorMap map_qs,
             const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse2,
             const float* __restrict__ delta, int T, int Tp, int H,
             float scale, __nv_bfloat16* __restrict__ dqkv) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t qd = base;                      // qs [128 rows], then dO
  const uint32_t ring = base + 2 * kBlockRows * kD * 2;  // stage s: K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gbase + 2 * kBlockRows * kD * 2 + kStagesQ * 2 * kTileBytes);
  uint64_t* empty = full + kStagesQ;
  uint64_t* q_bar = empty + kStagesQ;

  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int C = H * kD;
  const int n_k = (T + kRows - 1) / kRows;
  const int wgi = threadIdx.x >> 7;
  constexpr int kHalf = kBlockRows * kD * 2;     // qs, then dO

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesQ; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_init(smem_u32(q_bar), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    if (threadIdx.x == 256) {
      const uint32_t qb = smem_u32(q_bar);
      mbar_expect_tx(qb, 2 * kHalf);
      for (int r = 0; r < 2; ++r) {
        tma_load_3d(qd + r * kTileBytes, &map_qs, qb, h * kD, q0 + r * kRows,
                    b);
        tma_load_3d(qd + kHalf + r * kTileBytes, &map_do, qb, h * kD,
                    q0 + r * kRows, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_k; ++j) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t bar = smem_u32(&full[stage]);
        const uint32_t dst = ring + stage * 2 * kTileBytes;
        mbar_expect_tx(bar, 2 * kTileBytes);
        tma_load_3d(dst, &map_qkv, bar, C + h * kD, j * kRows, b);
        tma_load_3d(dst + kTileBytes, &map_qkv, bar, 2 * C + h * kD,
                    j * kRows, b);
        if (++stage == kStagesQ) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns q rows q0 + [64 wgi, 64 wgi + 64),
  // their qs and dO tiles held as A fragments.  One wgmma group per
  // product: exp2 of P runs under dP.
  const int t = threadIdx.x;
  const int c2 = 2 * (t & 3);
  const int row0 = q0 + wgi * 64 + wg_row(t);    // and row0 + 8
  const size_t st = ((size_t)b * H + h) * Tp;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // padded rows: lse +inf, delta 0
    lse_r[r] = lse2[st + row0 + 8 * r];
    delta_r[r] = delta[st + row0 + 8 * r];
  }
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(smem_u32(q_bar), 0);
  uint32_t qa[4][4], oa[4][4];
  load_a_frags(qa, qd + wgi * kTileBytes, (t >> 5) & 3, t & 31);
  load_a_frags(oa, qd + kHalf + wgi * kTileBytes, (t >> 5) & 3, t & 31);
  int stage = 0;
  uint32_t phase = 0;
  // keys >= T (the last tile of a ragged T) take p = 0
  auto tile = [&](uint32_t k_s, int kbase, auto masked) {
    // S = qs K^T and dP = dO V^T: rows q, columns this tile's keys
    float s[32], dp[32];
    uint32_t dsa[4][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<0>(s, qa[kk], desc_sw128(k_s + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<0>(dp, oa[kk], desc_sw128(k_s + kTileBytes + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S
    fence_regs(s);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * n8 + e] - lse_r[e >> 1]);
        s[4 * n8 + e] =
            decltype(masked)::value && kbase + 8 * n8 + (e & 1) >= T ? 0.f : p;
      }
    fence_regs(s);    // P before the wait for dP
    wgmma_wait<0>();  // dP
    fence_regs(dp);
    // dS = P (dP - delta); dQ += bf16(dS) K, 16 keys a step
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n8 + e] = s[4 * n8 + e] * (dp[4 * n8 + e] - delta_r[e >> 1]);
    to_a_frags(dsa, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dq, dsa[kk], desc_sw128(k_s + 2048 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  };
#pragma unroll 1
  for (int j = 0; j < n_k; ++j) {
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint32_t k_s = ring + stage * 2 * kTileBytes;
    if ((j + 1) * kRows > T)
      tile(k_s, j * kRows + c2, std::true_type{});
    else
      tile(k_s, j * kRows + c2, std::false_type{});
    mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == kStagesQ) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int ld = 3 * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* dst = dqkv + ((size_t)b * T + row) * ld + h * kD + c2;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
      *reinterpret_cast<uint32_t*>(dst + 8 * n8) = vdn::pack_bf16(
          dq[4 * n8 + 2 * r] * scale, dq[4 * n8 + 2 * r + 1] * scale);
  }
}

// [B, T, width] bf16 loaded as 64 x 64 boxes (one frame, 64 rows of the
// head's 64 columns) in the 128-byte swizzle
cudaError_t encode_rows_bf16(CUtensorMap* map, const void* ptr, int B, int T,
                             int width) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)width * 2 * T};
  const cuuint32_t box[3] = {kD, kRows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// [B * H, Tp] fp32 loaded as 64-value rows
cudaError_t encode_stats(CUtensorMap* map, const float* ptr, int rows,
                         int Tp) {
  const cuuint64_t dims[2] = {(cuuint64_t)Tp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Tp * 4};
  const cuuint32_t box[2] = {kRows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

// qkv [B, T, 3 * H * 64], out and dout [B, T, H * 64] bf16; lse [B, H, T]
// fp32 (the training forward's); scratch qs [B, T, H * 64] bf16 and stats
// [2, B, H, Tp] fp32 (the padded lse, then delta; Tp = T up to a multiple
// of 128) -> dqkv [B, T, 3 * H * 64] bf16.  qscale is bf16(scale * log2
// e), as the forward took it.  Head width 64 only.
extern "C" int vdn_flash_attention_qkv_bwd(const void* qkv, const void* out,
                                           const void* dout, const void* lse,
                                           int B, int T, int H, float qscale,
                                           float scale, void* qs, void* stats,
                                           void* dqkv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Tp = (T + kBlockRows - 1) / kBlockRows * kBlockRows;
  const int C = H * kD;
  auto* lse2 = static_cast<float*>(stats);
  float* delta = lse2 + (size_t)B * H * Tp;
  auto* dq = static_cast<__nv_bfloat16*>(dqkv);
  const size_t threads = (size_t)B * Tp * H * 8;
  d1_prepass_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), B, T, Tp, H, qscale,
      static_cast<__nv_bfloat16*>(qs), lse2, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map_qkv, map_qs, map_do, map_lse, map_delta;
  if ((err = encode_rows_bf16(&map_qkv, qkv, B, T, 3 * C)) != cudaSuccess ||
      (err = encode_rows_bf16(&map_qs, qs, B, T, C)) != cudaSuccess ||
      (err = encode_rows_bf16(&map_do, dout, B, T, C)) != cudaSuccess ||
      (err = encode_stats(&map_lse, lse2, B * H, Tp)) != cudaSuccess ||
      (err = encode_stats(&map_delta, delta, B * H, Tp)) != cudaSuccess)
    return err;
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      d1_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKv);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      d1_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const dim3 grid(Tp / kBlockRows, H, B);
  d1_dkdv_kernel<<<grid, kThreads, kSmemKv, s>>>(
      map_qkv, map_qs, map_do, map_lse, map_delta, T, H, scale, dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  d1_dq_kernel<<<grid, kThreads, kSmemQ, s>>>(map_qkv, map_qs, map_do, lse2,
                                              delta, T, Tp, H, scale, dq);
  return cudaGetLastError();
}
