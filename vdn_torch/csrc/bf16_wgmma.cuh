// The warp-specialised bf16 GEMM core on Hopper's wgmma and TMA (A2 in
// ln_mlp.cu, D3 in ln_mlp_bwd.cu, A4 in ln_geglu.cu, A3 in
// temporal_attn.cu, D4 in temporal_attn_bwd.cu):
//   outs = epi( A @ B^T )                 one product
//   outs = epi( A @ B^T, A2 @ B2^T )      the paired mode: two products over
//                                         the same [M, N] tiles and K
//
//   A, A2  [M, K] bf16, K contiguous (token rows)
//   B, B2  either K-major [N, K] (a torch Linear weight as it is stored) or
//          MN-major [K, N], N contiguous (a Linear weight [out, in] used as
//          its transpose), read through wgmma's transpose bit; or (B only)
//          kHalves: K-major [2N, K], a gated layer's two halves (A4's w0:
//          hidden rows [0, N), gate rows [N, 2N))
//   outs   Epi::kOuts bf16 tensors [M, N] (Epi the epilogue functor, below)
//
// It runs the products of vdn/ops/pallas/mlp.py's _ln_mlp_kernel and
// _mlp_bwd_dx_kernel, geglu.py's _geglu_kernel and temporal_attention.py's
// _kernel and _bwd_kernel (A3's qkv and out products, D4's qkv, doh and
// dx), which ran on an mma.sync tile template before.  One
// persistent block per SM walks the TM x BN output tiles (tile t: rows (t /
// n_tiles) * TM, columns (t % n_tiles) * BN; block b takes t = b, b +
// grid, ..., so neighbouring blocks share A's rows in L2 and the weights
// stay there).  Warpgroup 2 is the producer, one thread of which keeps TMA
// loads of 64-wide K slices of the block's tiles, in order, in flight
// through a ring of kStages stages, each guarded by a "full" and an
// "empty" mbarrier: A as a TM-row box and B K-major as a BN-row box, both
// 128-byte rows in the 128-byte swizzle; B MN-major as BN / 64 boxes of 64
// K rows x 64 N values (one swizzle atom along N each, 8 KB apart: the
// descriptor's leading byte offset).  Warpgroups 0 and 1 are the
// consumers, issuing wgmma m64nBNk16 f32.bf16.bf16 from shared memory (one
// slice's group in flight while the next is issued), in one of two modes:
//   ping-pong: each takes every other tile of the block whole (WR = TM =
//     128 rows: two m64 row blocks, 128 fp32 sums a thread) and runs its
//     epilogue while the other issues the next tile's products.  A
//     warpgroup waits for the ring only once the other has issued every
//     product of the tile before (the "turn" barriers), so the products
//     alternate and no wait on a stage's parity runs more than one phase
//     ahead of its loads.  A2's fc1 / fc2 and D3's dy;
//   cooperative (kCoop): both take every tile, WR = 64 rows each of TM =
//     128, sharing its B stages, and run their epilogues together: the
//     paired product (D3), whose two accumulators fill a thread's 128
//     sums at 64 rows (in ping-pong on 64-row tiles, which load twice the
//     B bytes per product, it took 1.060 ms at the v4 shape against 0.910:
//     PERF.md, section 6).
// setmaxnreg moves registers from the producer to the consumers.
//
// kHalves gives a tile BN / 2 output columns [n0, n0 + BN / 2): its B stage
// holds rows [n0, n0 + BN / 2) of the first half and [N + n0, ...) of the
// second, two TMA boxes of BN / 2 rows on one mbarrier (the 128-byte
// swizzle repeats every 8 rows, so they lie as one BN-row box would).  A
// thread's sums at accumulator columns c and c + BN / 2 (col_in_tile + 8 i
// covers both halves) are then one output's two halves, which the epilogue
// pairs in registers, as the paired mode pairs its two products.
//
// With Epi::kEdge, N need only be a multiple of 64: the last column tile
// may be half empty (A4's fc2 at C 64 / 192).  TMA loads B's rows past N
// as zeros, no column past N is loaded into the staging tile or stored,
// and Epi::col reads no bias past N.  Without it (every other epilogue)
// the tile width divides N and the kernel has no such checks.
//
// The epilogue: Epi::col(n) gives what a column pair reads (biases,
// scales), then Epi(col, sums, residual, outs) maps a thread's two adjacent
// sums of one row (the paired mode and kHalves: and the second product's or
// half's) to a bf16 pair of each output.  The pairs go to the warpgroup's staging tile in
// shared memory (the TMA layout, 128-byte swizzle: a warp's stores hit 32
// banks) and one thread stores it with TMA, which writes no row past M; a
// second output's pairs wait in the second product's registers until the
// first's store has read the tile.  (Stored from registers, four bytes a
// thread, A2's tiles took 0.15 ms more in fc1 and 0.09 in fc2.)  With
// Epi::kResidual the staging tile is loaded by TMA, at the start of the
// tile, with the tile of a residual [M, N] that Epi reads in place (A2's
// x).  With Epi::kColSumOut >= 0 the warpgroup also sums each column of
// that output's staged tile over its rows, in row order, into
// Epi::colsum [ceil(M / WR), N] fp32, for a deterministic second pass.
//
// Bound by the products (2 * M * N * K FLOP each, 989 TFLOP/s bf16
// dense).  A stuck mbarrier wait (sm90.cuh) or a failed tensor-map encode
// ends the launch with an error, never a hang.  The fp32 sums of one
// output run in one order (K slices in order, 16 a step) in every launch:
// no atomics, so a launch's bits repeat.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

#include <type_traits>

namespace vdn {
namespace wgbf {

using namespace vdn::wg;

constexpr int kBK = 64;         // bf16 of K per stage: one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 64 * kRowBytes;  // a 64 x 64 MN-major B box
constexpr int kWarpgroup = 128;
constexpr int kTM = 128;        // rows of a block tile
constexpr int kSmemMax = 232448;  // an H100 block's dynamic shared memory

// how a product's B operand lies in device memory
enum BLayout : int { kKMajor = 0, kMNMajor = 1, kNoB = 2, kHalves = 3 };

// A block tile: kTM rows by BN columns; in ping-pong (!kCoop) a consumer
// warpgroup takes it whole (WR = 128 rows), in the cooperative mode the
// two split it (WR = 64 rows each, sharing its B stages).
template <int BN, int kB1, int kB2, bool kCoop, int kOuts>
struct Tile {
  // 128 wide: at a streamed frame's rows 64-wide tiles, twice as many,
  // ran A2's fc2 slower on the H100 (PERF.md, section 6)
  static_assert(BN == 128, "tile width");
  static_assert(kB1 != kNoB, "the first product");
  static constexpr bool kPaired = kB2 != kNoB;
  static_assert(kOuts == 1 || (kOuts == 2 && kPaired), "outputs");
  static_assert(kB2 != kHalves && (kB1 != kHalves || !kPaired),
                "kHalves: one product");
  static constexpr int kTileN = kB1 == kHalves ? BN / 2 : BN;  // outputs
  static constexpr int TM = kTM;
  static constexpr int WR = kCoop ? kTM / 2 : kTM;  // a warpgroup's rows
  static constexpr int kBlocks = WR / 64;  // m64 row blocks of a warpgroup
  static constexpr int kRegs = BN / 2;     // sums per thread and row block
  static_assert((kPaired ? 2 : 1) * kBlocks * kRegs <= 128,
                "a consumer thread's sums");
  static constexpr int kABytes = TM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;   // either layout
  static constexpr int kStageBytes =
      (kPaired ? 2 : 1) * (kABytes + kBBytes);     // 1024-aligned
  // a warpgroup's staging tile: kTileN / 64 atoms of WR rows x 128 bytes,
  // which its outputs pass through one after the other
  static constexpr int kOutBytes = WR * kTileN * 2;
  static constexpr int kStaging = 2 * kOutBytes;
  // barriers: full and empty per stage, two turns, two residual loads
  static constexpr int kBarrierBytes = 8 * 64;
  static constexpr int kFit =
      (kSmemMax - 1024 - kBarrierBytes - kStaging) / kStageBytes;
  // ping-pong 128 x 128: 5 stages (kHalves: 6); cooperative paired: 3
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(2 * kStages + 4 <= kBarrierBytes / 8, "barrier slots");
  // the ring, the staging tiles, the barriers, 1024 bytes of alignment
  static constexpr int kSmem =
      kStages * kStageBytes + kStaging + kBarrierBytes + 1024;
  static_assert(kSmem <= kSmemMax, "an H100 block's dynamic shared memory");
  static constexpr int kThreads = 3 * kWarpgroup;
  // registers per thread after setmaxnreg, producer and consumers:
  // setmaxnreg only moves registers within the block's allocation at
  // launch (384 x 168 = 128 x 40 + 256 x 232), a larger sum blocks forever
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
};

// The descriptor of a B operand step of 16 along K at ``base`` (a stage's
// B region): K-major (and kHalves), 32 bytes along each 128-byte row;
// MN-major, 16 rows of 128 bytes (2048 bytes), the second 64 N values (BN
// 128) one atom (kAtomBytes) on, the leading byte offset.
template <int kB>
__device__ __forceinline__ uint64_t desc_b(uint32_t base, int kk) {
  if constexpr (kB != kMNMajor) return desc_sw128(base + 32 * kk);
  const uint64_t d = desc_sw128(base + 2048 * kk);
  return (d & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 16);
}

#define VDN_WG_D32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define VDN_WG_D32_HI(d)                                                    \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),      \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),      \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),      \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),      \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),      \
      "+f"(d[62]), "+f"(d[63])
#define VDN_WG_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define VDN_WG_R64_HI                                                       \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
  "%60, %61, %62, %63"

// D += A B for a 64 x BN x 16 step, A and B from shared memory (B MN-major
// where kTrans), in the accumulator layout of row_in_tile / col_in_tile
// (sm90.cuh): thread t's d[4i + e] is row row_in_tile(t) + 8 (e / 2),
// column col_in_tile(t) + 8 i + e % 2
template <int kTrans>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" VDN_WG_R32
      VDN_WG_R64_HI "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : VDN_WG_D32(d), VDN_WG_D32_HI(d)
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

template <int BN, int kB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  wgmma_n128<kB == kMNMajor>(d, da, db);
}

// A stage's B operand: K-major, one box of BN rows of 64 K values;
// kHalves, two boxes of BN / 2 such rows, at n0 and N + n0; MN-major, BN /
// 64 boxes of 64 K rows x 64 N values, kAtomBytes apart.
template <int BN, int kB>
__device__ __forceinline__ void load_b(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int k0, int n0, int N) {
  if constexpr (kB == kKMajor) {
    tma_load_2d(dst, map, bar, k0, n0);
  } else if constexpr (kB == kHalves) {
    tma_load_2d(dst, map, bar, k0, n0);
    tma_load_2d(dst + (BN / 2) * kRowBytes, map, bar, k0, N + n0);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_2d(dst + j * kAtomBytes, map, bar, n0 + 64 * j, k0);
  }
}

// The maps of the products' operands, the outputs and the residual.
struct Maps {
  CUtensorMap a, b, a2, b2, out[2], res;
};

template <int BN, int kB1, int kB2, bool kCoop, class Epi>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
gemm_bf16_wgmma_kernel(const __grid_constant__ Maps maps, int M, int N,
                       int K, Epi epi) {
  using T = Tile<BN, kB1, kB2, kCoop, Epi::kOuts>;
  constexpr int TM = T::TM;
  constexpr int WR = T::WR;
  constexpr bool kPaired = T::kPaired;
  constexpr bool kHalf = kB1 == kHalves;
  constexpr int kTileN = T::kTileN;
  constexpr int kBlocks = T::kBlocks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t staging = ring + T::kStages * T::kStageBytes;
  uint8_t* base = smem_raw + (ring - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + T::kStages * T::kStageBytes + T::kStaging);
  uint64_t* empty = full + T::kStages;
  uint64_t* turn = empty + T::kStages;  // [w]: warpgroup w may issue
  uint64_t* resid = turn + 2;           // [w]: w's residual tile loaded

  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int tiles = ((M + TM - 1) / TM) * n_tiles;
  const int slices = K / kBK;
  const int wgi = threadIdx.x / kWarpgroup;
  // a stage: A, B, then (paired) A2, B2
  constexpr int kOffB = T::kABytes;
  constexpr int kOffA2 = T::kABytes + T::kBBytes;
  constexpr int kOffB2 = 2 * T::kABytes + T::kBBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      // the consuming warpgroup, or both
      mbar_init(smem_u32(&empty[s]), (kCoop ? 2 : 1) * kWarpgroup);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(smem_u32(&turn[w]), kWarpgroup);
      mbar_init(smem_u32(&resid[w]), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // ---- producer: one thread issues every TMA load, tile after tile
    regs_dec<T::kProducerRegs>();
    if (threadIdx.x == 2 * kWarpgroup) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * TM;
        const int n0 = (tile % n_tiles) * kTileN;
        for (int kb = 0; kb < slices; ++kb) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t dst = ring + stage * T::kStageBytes;
          mbar_expect_tx(bar, T::kStageBytes);
          tma_load_2d(dst, &maps.a, bar, kb * kBK, m0);
          load_b<BN, kB1>(dst + kOffB, &maps.b, bar, kb * kBK, n0, N);
          if constexpr (kPaired) {
            tma_load_2d(dst + kOffA2, &maps.a2, bar, kb * kBK, m0);
            load_b<BN, kB2>(dst + kOffB2, &maps.b2, bar, kb * kBK, n0, N);
          }
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers.  Ping-pong: warpgroup wgi takes the block's tiles j =
  // wgi, wgi + 2, ..., whose slices sit at ring positions j * slices
  // onwards.  Cooperative: both take every tile, wgi its rows [WR wgi, WR
  // wgi + WR).
  regs_inc<T::kConsumerRegs>();
  constexpr int kStep = kCoop ? 1 : 2;
  const int t = threadIdx.x % kWarpgroup;
  const bool leader = t == 0;
  const int row_in = row_in_tile(t);
  const int col_in = col_in_tile(t);
  const int a_row = kCoop ? wgi * WR : 0;  // the warpgroup's rows of A
  const uint32_t stage_out = staging + wgi * T::kOutBytes;
  float acc[kBlocks][T::kRegs];
  float acc2[kPaired ? kBlocks : 1][kPaired ? T::kRegs : 1];
  int j = kCoop ? 0 : wgi;
  for (int tile = blockIdx.x + j * gridDim.x; tile < tiles;
       tile += kStep * gridDim.x, j += kStep) {
    const int m0 = (tile / n_tiles) * TM + a_row;  // the warpgroup's rows
    const int n0 = (tile % n_tiles) * kTileN;
    const int round = j / kStep;  // the warpgroup's tiles before this one
    // the tile's 64-column atoms that lie inside N
    const int atoms =
        Epi::kEdge ? min(kTileN / 64, (N - n0) / 64) : kTileN / 64;
    if (leader) {
      // the staging tile is free once the last tile's stores read it
      bulk_wait<true>();
      if constexpr (Epi::kResidual) {
        const uint32_t bar = smem_u32(&resid[wgi]);
        mbar_expect_tx(bar, atoms * WR * kRowBytes);
        for (int a = 0; a < atoms; ++a)
          tma_load_2d(stage_out + a * WR * kRowBytes, &maps.res, bar,
                      n0 + 64 * a, m0);
      }
    }
    const int pos = j * slices;
    int stage = pos % T::kStages;
    uint32_t phase = (pos / T::kStages) & 1;
    if (!kCoop && j > 0)
      mbar_wait(smem_u32(&turn[wgi]), ((j - 1) >> 1) & 1);
#pragma unroll
    for (int r = 0; r < kBlocks; ++r)
#pragma unroll
      for (int i = 0; i < T::kRegs; ++i) acc[r][i] = 0.f;
    if constexpr (kPaired) {
#pragma unroll
      for (int r = 0; r < kBlocks; ++r)
#pragma unroll
        for (int i = 0; i < T::kRegs; ++i) acc2[r][i] = 0.f;
    }
    // one slice's wgmma group stays in flight while the next one is
    // issued; a stage is released once its group has finished
    int held = -1;
#pragma unroll 1
    for (int kb = 0; kb < slices; ++kb) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t st = ring + stage * T::kStageBytes + a_row * kRowBytes;
      const uint32_t sb = ring + stage * T::kStageBytes;
#pragma unroll
      for (int r = 0; r < kBlocks; ++r) {
        fence_regs(acc[r]);
        if constexpr (kPaired) fence_regs(acc2[r]);
      }
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < kBlocks; ++r)
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_bf16<BN, kB1>(acc[r],
                              desc_sw128(st + r * 64 * kRowBytes + 32 * kk),
                              desc_b<kB1>(sb + kOffB, kk));
      if constexpr (kPaired) {
#pragma unroll
        for (int r = 0; r < kBlocks; ++r)
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_bf16<BN, kB2>(
                acc2[r],
                desc_sw128(st + kOffA2 + r * 64 * kRowBytes + 32 * kk),
                desc_b<kB2>(sb + kOffB2, kk));
      }
      wgmma_commit();
      if (held >= 0) {
        wgmma_wait<1>();
        mbar_arrive(smem_u32(&empty[held]));
      }
      held = stage;
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (!kCoop) mbar_arrive(smem_u32(&turn[wgi ^ 1]));
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kBlocks; ++r) {
      fence_regs(acc[r]);
      if constexpr (kPaired) fence_regs(acc2[r]);
    }
    mbar_arrive(smem_u32(&empty[held]));

    // ---- epilogue: each output's bf16 pairs into the staging tile, then
    // a TMA store; a second output waits in the second product's
    // registers, which the first pass has read
    if constexpr (Epi::kResidual)
      mbar_wait(smem_u32(&resid[wgi]), round & 1);
#pragma unroll
    for (int q = 0; q < Epi::kOuts; ++q) {
      if (q > 0 && leader) bulk_wait<true>();
      // every thread past the leader's wait for the last stores
      named_sync(1 + wgi, kWarpgroup);
      // kHalves: group i's columns pair with group i + kTileN / 8's.  In
      // a half-empty last tile (kEdge) the groups past N read the last
      // column pair's Epi::col and are not stored (no branch in the loop).
#pragma unroll
      for (int i = 0; i < kTileN / 8; ++i) {
        const int col = col_in + 8 * i;
        const auto c = epi.col(Epi::kEdge ? min(n0 + col, N - 2) : n0 + col);
#pragma unroll
        for (int r = 0; r < kBlocks; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 64 * r + row_in + 8 * h;
            const int e = 4 * i + 2 * h;
            const uint32_t dst = staged_tile<WR>(stage_out, row, col);
            uint32_t o[Epi::kOuts];
            if (q == 0) {
              if constexpr (kHalf) {
                constexpr int g = T::kRegs / 2;  // the second half's sums
                epi(c, acc[r][e], acc[r][e + 1], acc[r][e + g],
                    acc[r][e + g + 1], o);
              } else if constexpr (kPaired) {
                epi(c, acc[r][e], acc[r][e + 1], acc2[r][e], acc2[r][e + 1],
                    o);
                if constexpr (Epi::kOuts == 2)
                  acc2[r][e] = __uint_as_float(o[1]);
              } else {
                float2 res = make_float2(0.f, 0.f);
                if constexpr (Epi::kResidual) {
                  uint32_t bits;
                  asm volatile("ld.shared.b32 %0, [%1];\n"
                               : "=r"(bits) : "r"(dst));
                  res = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(&bits));
                }
                epi(c, acc[r][e], acc[r][e + 1], res, o);
              }
            } else if constexpr (kPaired) {
              o[0] = __float_as_uint(acc2[r][e]);
            }
            asm volatile("st.shared.b32 [%0], %1;\n"
                         :: "r"(dst), "r"(o[0]) : "memory");
          }
      }
      fence_async_shared();
      named_sync(1 + wgi, kWarpgroup);
      if (leader) {
        for (int a = 0; a < atoms; ++a)
          tma_store_2d(&maps.out[q], stage_out + a * WR * kRowBytes,
                       n0 + 64 * a, m0);
        bulk_commit();
      }
      if constexpr (Epi::kColSumOut >= 0) {
        if (q != Epi::kColSumOut || m0 >= M) continue;
        // column c of the staged output over the warpgroup's rows, in row
        // order, into colsum [ceil(M / WR), N]
        const int rows = min(WR, M - m0);
#pragma unroll 1
        for (int c = t; c < 64 * atoms; c += kWarpgroup) {
          float s = 0.f;
#pragma unroll 4
          for (int row = 0; row < rows; ++row) {
            unsigned short bits;
            asm volatile("ld.shared.u16 %0, [%1];\n"
                         : "=h"(bits) : "r"(staged_tile<WR>(stage_out, row, c)));
            s += __bfloat162float(__ushort_as_bfloat16(bits));
          }
          epi.colsum[(size_t)(m0 / WR) * N + n0 + c] = s;
        }
      }
    }
  }
  if (leader) bulk_wait<false>();
}

// B's map: K-major [N, K] as BN-row boxes, kHalves [2N, K] as BN / 2-row
// boxes, MN-major [K, N] as 64 x 64 boxes
template <int BN, int kB>
inline cudaError_t encode_b(CUtensorMap* map, const void* ptr, int N,
                            int K) {
  return kB == kKMajor   ? encode_bf16(map, ptr, K, N, BN)
         : kB == kHalves ? encode_bf16(map, ptr, K, 2 * N, BN / 2)
                         : encode_bf16(map, ptr, N, K, 64);
}

// Requires K % 64 == 0, N a multiple of the tile's output columns (of 64
// with Epi::kEdge), 16-byte aligned pointers (checked by the Python
// wrappers); grid is the number of persistent blocks (at most the tile
// count).  A2 / B2 are read in the paired mode only, out[1] with
// two outputs, res with Epi::kResidual ([M, N] bf16).
template <int BN, int kB1, int kB2, bool kCoop, class Epi>
cudaError_t launch_gemm_bf16_wgmma(int M, int N, int K, const void* A,
                                   const void* B, const void* A2,
                                   const void* B2, void* const* out,
                                   const void* res, Epi epi, int grid,
                                   cudaStream_t stream) {
  using T = Tile<BN, kB1, kB2, kCoop, Epi::kOuts>;
  if (M < 1 || N % (Epi::kEdge ? 64 : T::kTileN) || K % kBK || grid < 1)
    return cudaErrorInvalidValue;
  Maps maps;
  cudaError_t err = encode_bf16(&maps.a, A, K, M, T::TM);
  if (err == cudaSuccess) err = encode_b<BN, kB1>(&maps.b, B, N, K);
  if (err == cudaSuccess && T::kPaired)
    err = encode_bf16(&maps.a2, A2, K, M, T::TM);
  if (err == cudaSuccess && T::kPaired)
    err = encode_b<BN, kB2>(&maps.b2, B2, N, K);
  for (int q = 0; q < Epi::kOuts && err == cudaSuccess; ++q)
    err = encode_bf16(&maps.out[q], out[q], N, M, T::WR);
  if (err == cudaSuccess && Epi::kResidual)
    err = encode_bf16(&maps.res, res, N, M, T::WR);
  if (err != cudaSuccess) return err;
  auto* kernel = gemm_bf16_wgmma_kernel<BN, kB1, kB2, kCoop, Epi>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(maps, M, N, K, epi);
  return cudaGetLastError();
}

// What TMA cannot do: the LayerNorm prologue of an A operand.  Row ``row``
// of x [M, C] bf16 into registers, lane l holding the 8-value groups at l *
// 8 + 256 i (kV of them, C <= 256 kV), and its fp32 LayerNorm ((x - mean)
// * rstd) * w + b in place: the mean as the sum of value pairs over the
// lane's groups, then across the warp, / C; the variance likewise from the
// squared deviations; rstd = rsqrtf(var + eps), the approximate rsqrt.
// One warp per row.
template <int kV>
__device__ __forceinline__ void ln_row(const __nv_bfloat16* __restrict__ xr,
                                       int C, int lane,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b,
                                       float eps, float (&v)[kV][8],
                                       float& mu, float& rstd) {
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (lane * 8 + 256 * i < C)
      load_vec<__nv_bfloat16, 8>(xr + lane * 8 + 256 * i, v[i]);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (lane * 8 + 256 * i >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) s += v[i][2 * j] + v[i][2 * j + 1];
  }
  mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (lane * 8 + 256 * i >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q += (v[i][2 * j] - mu) * (v[i][2 * j] - mu) +
           (v[i][2 * j + 1] - mu) * (v[i][2 * j + 1] - mu);
  }
  rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int k = lane * 8 + 256 * i;
    if (k >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[i][j] = (v[i][j] - mu) * rstd * w[k + j] + b[k + j];
  }
}

// The launch of a row kernel on ln_row: f(std::integral_constant<int,
// kV>{}) with the least kV of 2, 3, 4, 8 that holds a row of C <= 2048.
template <class Fn>
inline cudaError_t with_ln_row(int C, Fn&& f) {
  return C <= 512    ? f(std::integral_constant<int, 2>{})
         : C <= 768  ? f(std::integral_constant<int, 3>{})
         : C <= 1024 ? f(std::integral_constant<int, 4>{})
                     : f(std::integral_constant<int, 8>{});
}

namespace {

// y = bf16(LN(x)) per row of x [M, C] (C <= 256 kV), the A operand of A2's
// fc1 and A4's: one warp per row, the row held in registers.  Internal
// linkage, a copy in each source that launches it; Caller, an empty tag
// type of that source (A2Rows, A4Rows), puts its name in the kernel's, so
// a profiler's trace files each caller's rows apart.
template <int kV, class Caller>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const __nv_bfloat16* __restrict__ x, int M, int C,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b,
               float eps, __nv_bfloat16* __restrict__ y) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float v[kV][8], mu, rstd;
  ln_row<kV>(x + (size_t)row * C, C, lane, ln_w, ln_b, eps, v, mu, rstd);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int k = lane * 8 + 256 * i;
    if (k < C) store_vec<__nv_bfloat16, 8>(y + (size_t)row * C + k, v[i]);
  }
}

template <class Caller>
inline cudaError_t launch_ln_rows(const __nv_bfloat16* x, int M, int C,
                                  const float* ln_w, const float* ln_b,
                                  float eps, __nv_bfloat16* y,
                                  cudaStream_t s) {
  return with_ln_row(C, [&](auto kv) {
    ln_rows_kernel<decltype(kv)::value, Caller><<<(M + 7) / 8, 256, 0, s>>>(
        x, M, C, ln_w, ln_b, eps, y);
    return cudaGetLastError();
  });
}

}  // namespace

}  // namespace wgbf
}  // namespace vdn
