// D2: the backward of C2 (attention over [B, T, H, D]) in fp32, for
// hieradet's global blocks on the v1 training path: q, k, v [b * s, T, H,
// D] fp32 with D 96 (hiera_tiny / small / base, H 4 or 8), 56
// (hiera_base_plus, H 8) or 72 (hiera_large, H 8) (T 256 at 256 px, 324 at
// 288; read in place as slices of the fused qkv projection), the forward's
// out and dO [B, Tq, H, D], its base-2 row log-sum-exp lse [B, H, Tq] -> dq
// [B, Tq, H, D], dk and dv [B, Tk, H, D], fp32.
//
// Replaces vdn/ops/pallas/flash_attention.py _flash_bwd_bhtd
// (_flash_bwd_kernel), the VJP of flash_attention: P recomputed, delta =
// rowsum(dO * O), dV = P^T dO, dS = P * (dP - delta) with dP = dO V^T, dQ =
// dS K * scale, dK = dS^T q * scale.
//
// Bound on the H100 by its tensor-core products: 14 * B * H * Tq * Tk * D
// FLOP with the recompute of S and dP in both kernels below, issued three
// times over (3xTF32, attn_f32.cuh: each fp32 operand split into a TF32
// big part and the small rest, a b summed as small_a big_b + big_a small_b
// + big_a big_b, about 22 of fp32's 24 bits) at the card's 495 TF32
// TFLOP/s.  The TPU kernel walked one head's q blocks in order and carried
// dK / dV in VMEM across that sequential grid axis; Hopper blocks run in no
// order, so the work splits as D1's (flash_attn_qkv_bwd.cu), with no
// atomics, into three launches:
//   1. d2_delta: delta = sum_d dO * O per (b, h, row), one warp per row,
//      written beside a copy of lse into stats [2, B, H, Tp] (Tp = Tq up
//      to 64; padded rows: lse +inf, so p = 0 there, and delta 0);
//   2. d2_dkdv: one block per (64-key tile, head, batch); each of four
//      consumer warps owns 16 keys and keeps their dK and dV in registers
//      while the q rows stream past in 32-row stages;
//   3. d2_dq: one block per (64-row q tile, head, batch); each warp owns
//      16 q rows and keeps their dQ while the keys stream past.
// In place of vdn's full-row recompute (rowmax, rowsum, 1 / l folded into
// the [bq, d] operands) p = exp2(S - lse) comes out normalized from the
// forward's statistic; S is recomputed from q * fp32(scale * log2 e) as the
// forward took it, so dK = dS^T (q * qscale) * (scale / qscale).
//
// Every product runs on the tensor cores as mma.sync m16n8k8 in 3xTF32,
// each 8-deep step into a zeroed temporary that one rounded fp32 add takes
// into the accumulator (mma_3xtf32: the tensor cores truncate their fp32
// sums, and the chains here are 12 steps for S and dP and 32-41 for dK, dV
// and dQ).  The products are arranged so that nothing is transposed: the
// dK / dV kernel computes S^T = K (q qscale)^T and dP^T = V dO^T with the
// keys as rows, whose accumulators are the A fragments of dV += P^T dO and
// dK += dS^T (q qscale), with the q rows of each 8-deep step in the order
// 2t, 2t + 1 (as the forward's P V, flash_attn_bthd_f32.cu); the dQ kernel
// computes S and dP with the q rows as rows and dS is the A fragment of dQ
// += dS K.  P and dS never leave registers.  Every operand is split into
// big and small in registers as its fragment is loaded from shared memory
// (a tile's values are read by all four warps; splitting them once into
// shared memory would double its size and halve the blocks an SM holds).
//
// Loads: a producer warp keeps TMA loads in flight behind full / empty
// mbarriers (sm90.cuh: a stuck wait traps, never hangs).  The dK / dV
// kernel loads its K and V tiles once and streams q, dO and their stats
// rows through a ring of two 32-row stages; the dQ kernel loads q, dO and
// the stats once and streams 32-key K / V stages.  Every tile is fp32 in
// TMA's 128-byte swizzle, a row as ceil(D / 32) 32-float atoms (chunk c of
// row r at c ^ (r % 8)), which keeps the fragment reads (rows g and columns
// t, or rows 2t / 2t + 1 and columns g) free of bank conflicts as the
// forward's padded rows do.  The maps are 4-D over [B, T, H, D] with q, k
// and v's own row strides (4,608 bytes off hiera_base's fused qkv): no
// copy, rows past T load as zeros, and so do the columns past D of a
// narrow head's last atom (D 56: columns 56-63, D 72: 72-95): a 3-D map
// over H * D would read the next head's columns there.  Zero columns add
// nothing to S = q K^T or dP = dO V^T; the products over the head take
// D / 8 steps, the accumulators' 8-wide tiles past D are skipped, and only
// D columns of dq, dk and dv are stored.  At D 96 about 98 KB of shared
// memory and
// 168 registers a thread (ptxas's cap for two blocks of five warps: the dK
// / dV kernel spills 548 bytes) a block, two blocks an SM, two consumer
// warps on each of its four sub-partitions.  The kernels are bound by the
// sub-partitions' mma.sync issue: five consumer warps (80-row blocks, T 324
// in four full blocks of a head in place of five) left 3, 2, 3, 2 warps on
// them and ran 1.3-1.7x slower; one block an SM (no spills) and a second
// stream for dQ did not pay either (tools/d2_variants.py, PERF.md).  Tails
// (T 324 = 5 * 64 + 4): q rows >= Tq take p = 0 (lse +inf) and keys >= Tk
// take p = 0 in the dQ kernel (masked) and zero K / V in the dK / dV
// kernel; whole 8-row steps past the end are skipped, a warp whose rows all
// lie past the end only waits and arrives, and nothing past either end is
// stored.
#include <math.h>

#include "attn_f32.cuh"
#include "sm90.cuh"

namespace {

using namespace vdn::attn_f32;
using namespace vdn::wg;

constexpr int kBlockRows = 64;         // keys (dK / dV) or q rows (dQ)
constexpr int kStage = 32;             // rows of a streamed stage
constexpr int kStages = 2;
constexpr int kConsumers = 128;        // four warps of 16 block rows
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kBox = 32;               // a TMA box: 32 floats x 32 rows
constexpr int kStatBytes = 2 * kStage * 4;       // lse, then delta
constexpr int kG = 4;                  // n8 tiles of a head-wide product at once
constexpr int kPad = 64;               // stats rows: Tq up to a multiple

// The layout at head width D (56, 72 or 96): the dK / dV kernel holds K,
// V, then the ring's q / dO tiles, their stats, the barriers; the dQ
// kernel q, dO, then the ring's K / V tiles, the q tile's stats, the
// barriers (both with 1024 bytes of alignment)
template <int kD>
struct Cfg {
  static_assert(kD % 8 == 0 && kD <= 96, "D a multiple of 8 up to 96");
  static constexpr int kAtoms = (kD + kBox - 1) / kBox;  // 32-float atoms
  static constexpr int kDP = kAtoms * kBox;   // the row's padded width
  static constexpr int kSteps = kD / 8;       // 8-deep steps along the head
  static constexpr int kN8 = kD / 8;          // 8-wide output tiles
  static constexpr int kNP = (kN8 + kG - 1) / kG * kG;  // in groups of kG
  static constexpr int kBlockTile = kBlockRows * kDP * 4;  // 24 KB at D 96
  static constexpr int kStageTile = kStage * kDP * 4;      // 12 KB
  static constexpr int kRingOff = 2 * kBlockTile;
  static constexpr int kStatOff = kRingOff + kStages * 2 * kStageTile;
  static constexpr int kBarOff = kStatOff + kStages * kStatBytes;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (2 * kStages + 1);
  static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");
  static_assert(kStages * kStatBytes >= 2 * kBlockRows * 4,
                "the dQ tile's stats fit the stats area");
};

// a tile of kR rows x kDP fp32 in TMA's 128-byte swizzle: atom a (columns
// 32a .. 32a + 31) at a * kR * 128, row r at r * 128 within it, 16-byte
// chunk c of the row at (c ^ (r % 8)) * 16.  Two lane offsets address a
// warp's fragments (g = lane / 4, t = lane % 4): offA the element (g, t)
// of an 8 x 8 block (A fragments, and B fragments read as X[g][t]);
// offB[e] the element (2t + e, g) (B fragments read as X[2t + e][g]);
// XOR with chunk * 16 moves either to another 8 x 4 block of the atom.
__device__ __forceinline__ float lds(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// x, times mul where kMul (rounded as the plain version's product)
template <bool kMul>
__device__ __forceinline__ float scaled(float x, float mul) {
  return kMul ? __fmul_rn(x, mul) : x;
}

// the A fragment of rows r0 .. r0 + 15 (r0 % 8 == 0), head columns 8kk ..
// 8kk + 7, split: {X[g][t], X[g+8][t], X[g][t+4], X[g+8][t+4]}, times mul
// where kMul
template <int kR, bool kMul = false>
__device__ __forceinline__ void frag_a(const uint8_t* tile, int r0, int kk,
                                       uint32_t offA, float mul,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const uint8_t* p = tile + (kk >> 2) * (kR * 128) + r0 * 128;
  const uint32_t c = (2 * (kk & 3)) << 4;
  const float x[4] = {lds(p + (offA ^ c)), lds(p + 1024 + (offA ^ c)),
                      lds(p + (offA ^ (c + 16))),
                      lds(p + 1024 + (offA ^ (c + 16)))};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(scaled<kMul>(x[i], mul), ab[i], as[i]);
}

// the B fragment {X[r0+g][8kk+t], X[r0+g][8kk+t+4]} (keys or q rows as
// the product's N), split
template <int kR, bool kMul = false>
__device__ __forceinline__ void frag_b_rows(const uint8_t* tile, int r0,
                                            int kk, uint32_t offA, float mul,
                                            uint32_t (&bb)[2],
                                            uint32_t (&bs)[2]) {
  const uint8_t* p = tile + (kk >> 2) * (kR * 128) + r0 * 128;
  const uint32_t c = (2 * (kk & 3)) << 4;
  const float x0 = lds(p + (offA ^ c)), x1 = lds(p + (offA ^ (c + 16)));
  split_tf32(scaled<kMul>(x0, mul), bb[0], bs[0]);
  split_tf32(scaled<kMul>(x1, mul), bb[1], bs[1]);
}

// the B fragment {X[r0+2t][8n+g], X[r0+2t+1][8n+g]} (rows r0 .. r0 + 7 as
// the 8-deep step, in the order of the accumulators' columns), split
template <int kR, bool kMul>
__device__ __forceinline__ void frag_b_cols(const uint8_t* tile, int r0,
                                            int n, uint32_t offB0,
                                            uint32_t offB1, float mul,
                                            uint32_t (&bb)[2],
                                            uint32_t (&bs)[2]) {
  const uint8_t* p = tile + (n >> 2) * (kR * 128) + r0 * 128;
  const uint32_t c = (2 * (n & 3)) << 4;
  const float x0 = lds(p + (offB0 ^ c)), x1 = lds(p + (offB1 ^ c));
  split_tf32(scaled<kMul>(x0, mul), bb[0], bs[0]);
  split_tf32(scaled<kMul>(x1, mul), bb[1], bs[1]);
}

// an accumulator tile (the C layout of m16n8k8: {Y[g][2t], Y[g][2t+1],
// Y[g+8][2t], Y[g+8][2t+1]}) as the A fragment of the next product, its 8
// columns the 8-deep step in the order 2t, 2t + 1 (logical t, t + 4)
__device__ __forceinline__ void acc_to_a(const float (&y)[4],
                                         uint32_t (&ab)[4],
                                         uint32_t (&as)[4]) {
  split_tf32(y[0], ab[0], as[0]);
  split_tf32(y[2], ab[1], as[1]);
  split_tf32(y[1], ab[2], as[2]);
  split_tf32(y[3], ab[3], as[3]);
}

// Y[kNP][4] += A X over the head's D columns (kN8 n8 tiles, kG at a time;
// the group's tiles past D neither loaded nor multiplied): A the fragment
// of one 8-deep step, X's rows r0 .. r0 + 7 of a tile (times mul where
// kMul)
template <int kD, int kR, bool kMul>
__device__ __forceinline__ void acc_head(float (&y)[Cfg<kD>::kNP][4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const uint8_t* tile, int r0,
                                         uint32_t offB0, uint32_t offB1,
                                         float mul) {
  constexpr int kN8 = Cfg<kD>::kN8;
#pragma unroll
  for (int n0 = 0; n0 < Cfg<kD>::kNP; n0 += kG) {
    uint32_t bb[kG][2], bs[kG][2];
#pragma unroll
    for (int n = 0; n < kG; ++n)
      if (n0 + n < kN8)
        frag_b_cols<kR, kMul>(tile, r0, n0 + n, offB0, offB1, mul, bb[n],
                              bs[n]);
    mma_3xtf32(y, n0, ab, as, bb, bs, kN8 - n0 < kG ? kN8 - n0 : kG);
  }
}

// rows [row0, row0 + kR) of a [B, T, H, D] map at head h into a tile, the
// columns past D of the last atom zero
template <int kD, int kR>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int row0,
                                          int b) {
#pragma unroll
  for (int a = 0; a < Cfg<kD>::kAtoms; ++a)
#pragma unroll
    for (int r = 0; r < kR / kBox; ++r)
      tma_load_4d(dst + a * kR * 128 + r * kBox * 128, map, bar, a * kBox,
                  h, row0 + r * kBox, b);
}

// the D columns of an accumulator's row r (0: g, 1: g + 8), times mul
template <int kD>
__device__ __forceinline__ void store_acc(float* dst,
                                          const float (&y)[Cfg<kD>::kNP][4],
                                          int r, float mul, int t) {
#pragma unroll
  for (int n = 0; n < Cfg<kD>::kN8; ++n)
    *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) =
        make_float2(y[n][2 * r] * mul, y[n][2 * r + 1] * mul);
}

// stats[0][b, h, t] = lse[b, h, t], stats[1][b, h, t] = sum_d dO * O
// (dout and out contiguous [B, T, H, D]); rows Tq <= t < Tp: +inf and 0.
// One warp per row.
template <int kD>
__global__ void __launch_bounds__(128)
d2_delta_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                const float* __restrict__ lse, int B, int T, int H, int Tp,
                float* __restrict__ stats) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int rows = B * H * Tp;
  if (row >= rows) return;
  const int t = row % Tp, bh = row / Tp;
  if (t >= T) {
    if (lane == 0) {
      stats[row] = INFINITY;
      stats[rows + row] = 0.f;
    }
    return;
  }
  const int b = bh / H, h = bh % H;
  const size_t off = (((size_t)b * T + t) * H + h) * kD;
  float acc = 0.f;
  if (lane * 4 < kD) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(dout + off) + lane);
    const float4 y = __ldg(reinterpret_cast<const float4*>(out + off) + lane);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  acc = vdn::warp_sum(acc);
  if (lane == 0) {
    stats[row] = lse[(size_t)bh * T + t];
    stats[rows + row] = acc;
  }
}

struct Lanes {
  uint32_t a, b0, b1;
};

__device__ __forceinline__ Lanes lanes(int lane) {
  const uint32_t g = lane >> 2, t = lane & 3;
  return {(g << 7) | (g << 4) | (t << 2),
          ((2 * t) << 7) | (((g >> 2) ^ (2 * t)) << 4) | ((g & 3) << 2),
          ((2 * t + 1) << 7) | (((g >> 2) ^ (2 * t + 1)) << 4) |
              ((g & 3) << 2)};
}

// dK, dV of one 64-key tile over every q row
template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
d2_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_st, int Tq, int Tk,
               int H, float qscale, float dk_scale, float* __restrict__ dk,
               float* __restrict__ dv) {
  using C = Cfg<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (base - raw) +
                                               C::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int k0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int n_q = (Tq + kStage - 1) / kStage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_init(smem_u32(kv_full), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      const uint32_t kb = smem_u32(kv_full);
      mbar_expect_tx(kb, 2 * C::kBlockTile);
      load_rows<kD, kBlockRows>(base, &map_k, kb, h, k0, b);
      load_rows<kD, kBlockRows>(base + C::kBlockTile, &map_v, kb, h, k0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_q; ++i) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t bar = smem_u32(&full[stage]);
        const uint32_t dst = base + C::kRingOff + stage * 2 * C::kStageTile;
        mbar_expect_tx(bar, 2 * C::kStageTile + kStatBytes);
        load_rows<kD, kStage>(dst, &map_q, bar, h, i * kStage, b);
        load_rows<kD, kStage>(dst + C::kStageTile, &map_do, bar, h, i * kStage, b);
        tma_load_3d(base + C::kStatOff + stage * kStatBytes, &map_st, bar,
                    i * kStage, b * H + h, 0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warp w owns keys k0 + 16 w .. k0 + 16 w + 15
  const int t = lane & 3, r_k = 16 * warp;
  const Lanes ln = lanes(lane);
  const bool active = k0 + r_k < Tk;
  float adv[C::kNP][4], adk[C::kNP][4];
#pragma unroll
  for (int n = 0; n < C::kNP; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) adv[n][i] = adk[n][i] = 0.f;
  mbar_wait(smem_u32(kv_full), 0);
  const uint8_t* Ks = sm;
  const uint8_t* Vs = sm + C::kBlockTile;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_q; ++i) {
    mbar_wait(smem_u32(&full[stage]), phase);
    if (active) {
      const uint8_t* Qs = sm + C::kRingOff + stage * 2 * C::kStageTile;
      const uint8_t* Gs = Qs + C::kStageTile;  // dO
      const float* st =
          reinterpret_cast<const float*>(sm + C::kStatOff + stage * kStatBytes);
      // 8-row steps of the stage that hold a q row < Tq
      const int steps = min(kStage / 8, (Tq - i * kStage + 7) / 8);
      // S^T = K (q qscale)^T, dP^T = V dO^T: keys x 32 q rows
      float s[kStage / 8][4], dp[kStage / 8][4];
#pragma unroll
      for (int j = 0; j < kStage / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk) {
        uint32_t ab[4], as[4], bb[kStage / 8][2], bs[kStage / 8][2];
        frag_a<kBlockRows>(Ks, r_k, kk, ln.a, 1.f, ab, as);
#pragma unroll
        for (int j = 0; j < kStage / 8; ++j)
          frag_b_rows<kStage, true>(Qs, 8 * j, kk, ln.a, qscale, bb[j],
                                    bs[j]);
        mma_3xtf32(s, 0, ab, as, bb, bs, steps);
        frag_a<kBlockRows>(Vs, r_k, kk, ln.a, 1.f, ab, as);
#pragma unroll
        for (int j = 0; j < kStage / 8; ++j)
          frag_b_rows<kStage>(Gs, 8 * j, kk, ln.a, 1.f, bb[j], bs[j]);
        mma_3xtf32(dp, 0, ab, as, bb, bs, steps);
      }
      // p = exp2(S - lse) (0 on q rows past Tq: lse +inf), dS = p (dP -
      // delta), both at (key, q row 8j + 2t + e % 2)
#pragma unroll
      for (int j = 0; j < kStage / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
        const float2 d =
            *reinterpret_cast<const float2*>(st + kStage + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - ((e & 1) ? l.y : l.x));
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? d.y : d.x));
          s[j][e] = p;
        }
      }
      // dV += P^T dO, dK += dS^T (q qscale): one 8-deep step per 8 q rows
#pragma unroll
      for (int j = 0; j < kStage / 8; ++j) {
        if (j >= steps) break;
        uint32_t ab[4], as[4];
        acc_to_a(s[j], ab, as);
        acc_head<kD, kStage, false>(adv, ab, as, Gs, 8 * j, ln.b0, ln.b1, 1.f);
        acc_to_a(dp[j], ab, as);
        acc_head<kD, kStage, true>(adk, ab, as, Qs, 8 * j, ln.b0, ln.b1,
                               qscale);
      }
    }
    mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r_k + (lane >> 2) + 8 * r;
    if (key >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key) * H + h) * kD;
    store_acc<kD>(dv + off, adv, r, 1.f, t);
    store_acc<kD>(dk + off, adk, r, dk_scale, t);
  }
}

// dQ of one 64-row q tile over every key
template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
d2_dq_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_do,
             const __grid_constant__ CUtensorMap map_st, int Tq, int Tk,
             int H, float qscale, float scale, float* __restrict__ dq) {
  using C = Cfg<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (base - raw) +
                                               C::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int n_k = (Tk + kStage - 1) / kStage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_init(smem_u32(q_full), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      const uint32_t qb = smem_u32(q_full);
      mbar_expect_tx(qb, 2 * C::kBlockTile + 2 * kStatBytes);
      load_rows<kD, kBlockRows>(base, &map_q, qb, h, q0, b);
      load_rows<kD, kBlockRows>(base + C::kBlockTile, &map_do, qb, h, q0, b);
      for (int r = 0; r < kBlockRows / kStage; ++r)
        tma_load_3d(base + C::kStatOff + r * kStatBytes, &map_st, qb,
                    q0 + r * kStage, b * H + h, 0);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_k; ++i) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t bar = smem_u32(&full[stage]);
        const uint32_t dst = base + C::kRingOff + stage * 2 * C::kStageTile;
        mbar_expect_tx(bar, 2 * C::kStageTile);
        load_rows<kD, kStage>(dst, &map_k, bar, h, i * kStage, b);
        load_rows<kD, kStage>(dst + C::kStageTile, &map_v, bar, h, i * kStage, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warp w owns q rows q0 + 16 w .. q0 + 16 w + 15
  const int g = lane >> 2, t = lane & 3, r_q = 16 * warp;
  const Lanes ln = lanes(lane);
  const bool active = q0 + r_q < Tq;
  float adq[C::kNP][4];
#pragma unroll
  for (int n = 0; n < C::kNP; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) adq[n][i] = 0.f;
  mbar_wait(smem_u32(q_full), 0);
  const uint8_t* Qs = sm;
  const uint8_t* Gs = sm + C::kBlockTile;  // dO
  // the thread's rows r_q + g and r_q + g + 8: lse (+inf past Tq), delta
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_q + g + 8 * r;
    const float* st = reinterpret_cast<const float*>(
        sm + C::kStatOff + (row / kStage) * kStatBytes);
    lr[r] = st[row % kStage];
    dr[r] = st[kStage + row % kStage];
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_k; ++i) {
    mbar_wait(smem_u32(&full[stage]), phase);
    if (active) {
      const uint8_t* Ks = sm + C::kRingOff + stage * 2 * C::kStageTile;
      const uint8_t* Vs = Ks + C::kStageTile;
      const int kbase = i * kStage;
      // 8-key steps of the stage that hold a key < Tk
      const int steps = min(kStage / 8, (Tk - kbase + 7) / 8);
      // S = (q qscale) K^T, dP = dO V^T: 16 q rows x 32 keys
      float s[kStage / 8][4], dp[kStage / 8][4];
#pragma unroll
      for (int j = 0; j < kStage / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk) {
        uint32_t ab[4], as[4], bb[kStage / 8][2], bs[kStage / 8][2];
        frag_a<kBlockRows, true>(Qs, r_q, kk, ln.a, qscale, ab, as);
#pragma unroll
        for (int j = 0; j < kStage / 8; ++j)
          frag_b_rows<kStage>(Ks, 8 * j, kk, ln.a, 1.f, bb[j], bs[j]);
        mma_3xtf32(s, 0, ab, as, bb, bs, steps);
        frag_a<kBlockRows>(Gs, r_q, kk, ln.a, 1.f, ab, as);
#pragma unroll
        for (int j = 0; j < kStage / 8; ++j)
          frag_b_rows<kStage>(Vs, 8 * j, kk, ln.a, 1.f, bb[j], bs[j]);
        mma_3xtf32(dp, 0, ab, as, bb, bs, steps);
      }
      // p = exp2(S - lse), 0 at keys >= Tk; dS = p (dP - delta)
      const bool tail = kbase + kStage > Tk;
#pragma unroll
      for (int j = 0; j < kStage / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[j][e] - lr[e >> 1]);
          if (tail && kbase + 8 * j + 2 * t + (e & 1) >= Tk) p = 0.f;
          dp[j][e] = p * (dp[j][e] - dr[e >> 1]);
        }
      // dQ += dS K: one 8-deep step per 8 keys
#pragma unroll
      for (int j = 0; j < kStage / 8; ++j) {
        if (j >= steps) break;
        uint32_t ab[4], as[4];
        acc_to_a(dp[j], ab, as);
        acc_head<kD, kStage, false>(adq, ab, as, Ks, 8 * j, ln.b0, ln.b1, 1.f);
      }
    }
    mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_q + g + 8 * r;
    if (row >= Tq) continue;
    store_acc<kD>(dq + (((size_t)b * Tq + row) * H + h) * kD, adq, r, scale, t);
  }
}

// [B, T, H, D] fp32 rows with their own row and batch strides (elements),
// moved as boxes of 32 floats (128 bytes, one atom of a head) by 32 rows of
// one frame in the 128-byte swizzle: rows >= T and columns >= D load as
// zeros
cudaError_t encode_rows_f32(CUtensorMap* map, const void* ptr, int B, int T,
                            int H, int D, long long row, long long batch) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)row * 4,
                                 (cuuint64_t)batch * 4};
  const cuuint32_t box[4] = {kBox, 1, kBox, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// stats [2, BH, Tp] fp32 moved as 32 rows of lse and the same 32 of delta
cudaError_t encode_stats(CUtensorMap* map, const void* ptr, int BH, int Tp) {
  const cuuint64_t dims[3] = {(cuuint64_t)Tp, (cuuint64_t)BH, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Tp * 4, (cuuint64_t)BH * Tp * 4};
  const cuuint32_t box[3] = {kStage, 1, 2};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, int B, int Tq, int Tk, int H,
           long long sqb, long long sqt, long long skb, long long skt,
           long long svb, long long svt, float qscale, float scale,
           void* stats, void* dq, void* dk, void* dv, cudaStream_t s) {
  using C = Cfg<kD>;
  const int Tp = (Tq + kPad - 1) / kPad * kPad;
  CUtensorMap map_q, map_k, map_v, map_do, map_st;
  cudaError_t err = encode_rows_f32(&map_q, q, B, Tq, H, kD, sqt, sqb);
  if (err == cudaSuccess)
    err = encode_rows_f32(&map_k, k, B, Tk, H, kD, skt, skb);
  if (err == cudaSuccess)
    err = encode_rows_f32(&map_v, v, B, Tk, H, kD, svt, svb);
  if (err == cudaSuccess)
    err = encode_rows_f32(&map_do, dout, B, Tq, H, kD, (long long)H * kD,
                          (long long)Tq * H * kD);
  if (err == cudaSuccess) err = encode_stats(&map_st, stats, B * H, Tp);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr_kv =
      allow_smem(d2_dkdv_kernel<kD>, C::kSmem);
  static const cudaError_t attr_q = allow_smem(d2_dq_kernel<kD>, C::kSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;

  const int rows = B * H * Tp;
  float* st = static_cast<float*>(stats);
  d2_delta_kernel<kD><<<(rows + 3) / 4, 128, 0, s>>>(
      static_cast<const float*>(dout), static_cast<const float*>(out),
      static_cast<const float*>(lse), B, Tq, H, Tp, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  d2_dkdv_kernel<kD><<<dim3((Tk + kBlockRows - 1) / kBlockRows, H, B),
                       kThreads, C::kSmem, s>>>(
      map_q, map_k, map_v, map_do, map_st, Tq, Tk, H, qscale, scale / qscale,
      static_cast<float*>(dk), static_cast<float*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  d2_dq_kernel<kD><<<dim3((Tq + kBlockRows - 1) / kBlockRows, H, B),
                     kThreads, C::kSmem, s>>>(map_q, map_k, map_v, map_do,
                                              map_st, Tq, Tk, H, qscale,
                                              scale, static_cast<float*>(dq));
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k / v [B, Tk, H, D] fp32 with their own batch and row
// strides in elements (as vdn_flash_attention_bthd_f32 reads them; rows
// and bases 16-byte aligned); out and dout [B, Tq, H, D] and lse [B, H,
// Tq] fp32 contiguous -> stats [2, B, H, Tp] (scratch, Tp = Tq up to a
// multiple of 64), dq [B, Tq, H, D], dk / dv [B, Tk, H, D] fp32
// contiguous.  qscale is fp32(scale * log2 e) as the forward took it.
// D = 56, 72 or 96.
extern "C" int vdn_flash_attention_bthd_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, int B, int Tq, int Tk, int H, int D,
    long long sqb, long long sqt, long long skb, long long skt, long long svb,
    long long svt, float qscale, float scale, void* stats, void* dq, void* dk,
    void* dv, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 56)
    return launch<56>(q, k, v, out, dout, lse, B, Tq, Tk, H, sqb, sqt, skb,
                      skt, svb, svt, qscale, scale, stats, dq, dk, dv, s);
  if (D == 72)
    return launch<72>(q, k, v, out, dout, lse, B, Tq, Tk, H, sqb, sqt, skb,
                      skt, svb, svt, qscale, scale, stats, dq, dk, dv, s);
  if (D == 96)
    return launch<96>(q, k, v, out, dout, lse, B, Tq, Tk, H, sqb, sqt, skb,
                      skt, svb, svt, qscale, scale, stats, dq, dk, dv, s);
  return cudaErrorInvalidValue;
}
