// The warp-specialised int8 GEMM core on Hopper's wgmma and TMA (F1-F5):
//   out = epi( sum_j (float(A_j @ W_j^T) * rs[m, j]) * cs[n] )
//
//   A   [M, K] int8, K contiguous (rows quantized by a row kernel)
//   W   [N, K] int8, K contiguous (a quantized torch Linear weight); in
//       the paired mode [2N, K], rows [0, N) a SwiGLU gate half and [N, 2N)
//       its value half
//   rs  fp32 row scales [M, kChunks]; K splits into kChunks equal chunks j,
//       each summed exactly in int32 and dequantized on its own
//   cs  fp32 column scales [N] (paired: [2N]), the weight's
//       per-output-channel scales
//   epi epilogue functor (below)
//
// The products of vdn/ops/pallas/int8.py's _ln_linear_kernel,
// _linear_kernel, _proj_residual_kernel, _ln_mlp_int8_kernel and
// _ln_swiglu_int8_kernel:
// int8 wgmma takes K-major operands only, which A and W already are.  One
// persistent block per SM walks the 128 x BN output tiles (tile t: rows
// (t / n_tiles) * 128, columns (t % n_tiles) * BN, paired BN / 2; block b
// takes t = b, b + grid, ...).  Warpgroup 2 is the producer, one thread of which keeps
// TMA loads of 128-byte K slices (A 128 rows, W BN rows, 128-byte swizzle)
// in flight through a ring of kStages stages, each guarded by a "full"
// and an "empty" mbarrier; warpgroups 0 and 1 are the consumers, 64 rows
// each, issuing wgmma m64nBNk32 s8 x s8 -> s32 from shared memory (A and
// B), four per slice, and dequantizing.  setmaxnreg moves registers from
// the producer to the warpgroups that hold values.  The producer runs
// ahead through the ring while the consumers finish a tile.
//
// The paired mode (F5's w12) gives a tile BN / 2 output columns [n0, n0 +
// BN / 2): its B stage holds weight rows [n0, n0 + BN / 2) of the gate
// half and [N + n0, N + n0 + BN / 2) of the value half, two TMA boxes of
// BN / 2 rows counted on one mbarrier (the 128-byte swizzle repeats every
// 8 rows, so they lie as one BN-row box would).  In the accumulator layout
// the thread that holds accumulator column c holds c + BN / 2 too: value
// i < kRegs / 2 of a thread is a gate column and value i + kRegs / 2 the
// value column of the same output, paired by the epilogue in registers.
//
// The epilogue runs in one of two places.  Inline, in the consumers after
// their K loop, out = epi(epi.col(n), v0, v1[, res]) for two adjacent
// values of one row into a swizzled staging tile [128, BN] bf16 that one
// thread stores with TMA (from registers, four bytes a thread, the
// residual loads and output stores took 0.13 of F3's 0.19 ms at the
// cached window on the H100: PERF.md, section 6).  With Epi::kResidual
// (F3's product, F4's fc2, F5's w3) one consumer thread first loads the
// residual tile into the staging tile by TMA, at the tile's start, under
// the K loop, and the pairs go back into it in place; without (F1's and
// F2's bias epilogue) the consumers only wait for the last tile's store
// to have read it.  Or, with kEpiWarps, epi(v, m, n, M) over one
// consumer thread's values of a tile, in two more warpgroups: the
// consumers drop a tile's dequantized values
// into a shared staging buffer, laid out [value][consumer thread], and go
// on with the next tile's products, while epilogue thread i takes consumer
// thread i's values (the same rows and columns) and runs the epilogue
// (fc1's GELU or w12's SwiGLU, about 25 dependent instructions a value; on
// the card the products did not overlap an epilogue that the consumers ran
// between a wgmma group's issue and its wait).  TMA zero-fills rows past
// M; nothing past M is stored.  v[4i + e] of a thread is row m + 8 (e /
// 2), column n + 8 i + e % 2 (row_in_tile, col_in_tile).
//
// The int32 sums are exact, so the order of the K loop changes nothing;
// the dequantization keeps vdn's order, (float(acc) * rs) * cs per chunk,
// each product rounded on its own (dequant, int8_gemm.cuh), and the chunks
// added in order in fp32.  A failed tensor-map encode or a stuck mbarrier
// wait (sm90.cuh) ends the launch with an error, never a hang.
#pragma once

#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace vdn {
namespace wg {

constexpr int kBM = 128;  // output rows per tile: two warpgroups of 64
constexpr int kBK = 128;  // bytes of K per stage: one swizzle row
constexpr int kConsumers = 256;

template <int BN, bool kEpiWarps>
struct Tile {
  static_assert(BN == 64 || BN == 128, "tile width");
  static_assert(!kEpiWarps || BN == 128, "the staging buffer holds 128 x 128");
  static constexpr int kRegs = BN / 2;  // accumulators per consumer thread
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;  // 1024-aligned
  static constexpr int kStages = kEpiWarps ? 4 : BN == 128 ? 6 : 8;
  // the fp32 values handed to the epilogue warpgroups, or the bf16
  // residual / output tile of the inline epilogue (1024-aligned)
  static constexpr int kStaging =
      kEpiWarps ? kRegs * kConsumers * 4 : kBM * BN * 2;
  static constexpr int kBarriers = 2 * kStages + 2;
  // the ring and the staging buffer (192 KB together with the epilogue
  // warpgroups, 224 / 208 KB inline), 1024 bytes of alignment slack and
  // the barriers
  static constexpr int kSmem =
      kStages * kStageBytes + kStaging + 1024 + 8 * kBarriers;
  static_assert(kSmem <= 232448, "an H100 block's dynamic shared memory");
  // two epilogue warpgroups, thread i mirroring consumer thread i (more
  // would leave the kernel fewer than the 90 registers at launch that
  // ptxas asks for a wgmma of 64 accumulators)
  static constexpr int kEpiThreads = kEpiWarps ? kConsumers : 0;
  static constexpr int kThreads = 384 + kEpiThreads;
  // registers per thread after setmaxnreg: producer, consumers (0: as at
  // launch), epilogue.  setmaxnreg only moves registers within the block's
  // allocation at launch, threads x the count ptxas gives the kernel under
  // its launch bounds (384 x 168 = 128 x 40 + 256 x 232; 640 x 96 >=
  // 128 x 24 + 256 x 96 + 256 x 120): a larger sum blocks forever.
  static constexpr int kProducerRegs = kEpiWarps ? 24 : 40;
  static constexpr int kConsumerRegs = kEpiWarps ? 0 : 232;
  static constexpr int kEpilogueRegs = 120;
};

// D (+)= A B for a 64 x N x 32 step, A and B from shared memory, in the
// accumulator layout of row_in_tile / col_in_tile (sm90.cuh).
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BN == 64) wgmma_s8_n64(d, da, db, accumulate);
  else wgmma_s8_n128(d, da, db, accumulate);
}

template <int BN, int kChunks, bool kEpiWarps, bool kPaired, class Epi>
__global__ void __launch_bounds__((Tile<BN, kEpiWarps>::kThreads), 1)
gemm_s8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_res,
                     const __grid_constant__ CUtensorMap map_out, int M,
                     int N, int K, const float* __restrict__ rs,
                     const float* __restrict__ cs, Epi epi) {
  using T = Tile<BN, kEpiWarps>;
  static_assert(!kEpiWarps || kChunks == 1, "staged tiles take one chunk");
  constexpr int kTileN = kPaired ? BN / 2 : BN;  // output columns a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* base = smem_raw + (ring - raw);
  float* staging = reinterpret_cast<float*>(base + T::kStages * T::kStageBytes);
  const uint32_t stage_res = ring + T::kStages * T::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + T::kStages * T::kStageBytes + T::kStaging);
  uint64_t* empty = full + T::kStages;
  // values in the staging buffer (inline: the residual tile loaded)
  uint64_t* staged = empty + T::kStages;
  uint64_t* drained = staged + 1;           // staging buffer read

  const int n_tiles = N / kTileN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int slices = K / kBK;
  const int per_chunk = slices / kChunks;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);  // every consumer thread
    }
    mbar_init(smem_u32(staged), kEpiWarps ? kConsumers : 1);
    mbar_init(smem_u32(drained), T::kEpiThreads);  // every epilogue thread
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // ---- producer: one thread issues every TMA load
    regs_dec<T::kProducerRegs>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * kTileN;
        for (int kb = 0; kb < slices; ++kb) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t dst = ring + stage * T::kStageBytes;
          mbar_expect_tx(bar, T::kStageBytes);
          tma_load_2d(dst, &map_a, bar, kb * kBK, m0);
          tma_load_2d(dst + T::kABytes, &map_w, bar, kb * kBK, n0);
          if constexpr (kPaired)  // the value half's rows of these outputs
            tma_load_2d(dst + T::kABytes + kTileN * kBK, &map_w, bar,
                        kb * kBK, N + n0);
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (wgi < 2) {
    // ---- consumers: warpgroup wgi takes rows [64 wgi, 64 wgi + 64)
    if constexpr (T::kConsumerRegs > 0) regs_inc<T::kConsumerRegs>();
    const int row_in = row_in_tile(threadIdx.x);
    const int col_in = col_in_tile(threadIdx.x);
    int acc[T::kRegs];
    float val[kEpiWarps ? 1 : T::kRegs];  // chunk sums, inline epilogue
    int stage = 0;
    uint32_t phase = 0;
    uint32_t round = 0;  // tiles staged
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * kTileN;
      const int m = m0 + row_in;
      const int n = n0 + col_in;
      if constexpr (!kEpiWarps) {
        if constexpr (Epi::kResidual) {
          if (threadIdx.x == 0) {
            // the residual tile, once the last tile's store has read the
            // staging tile
            bulk_wait<true>();
            const uint32_t bar = smem_u32(staged);
            mbar_expect_tx(bar, T::kStaging);
#pragma unroll
            for (int a = 0; a < BN / 64; ++a)
              tma_load_2d(stage_res + a * kBM * 128, &map_res, bar,
                          n0 + 64 * a, m0);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
#pragma unroll
        for (int i = 0; i < T::kRegs; ++i) acc[i] = 0;
        // one slice's wgmma group stays in flight while the next one is
        // issued; a stage is released once its group has finished
        int held = -1;
#pragma unroll 1
        for (int kb = 0; kb < per_chunk; ++kb) {
          mbar_wait(smem_u32(&full[stage]), phase);
          const uint32_t a = ring + stage * T::kStageBytes + wgi * 64 * kBK;
          const uint32_t w = ring + stage * T::kStageBytes + T::kABytes;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk)
            wgmma_s8<BN>(acc, desc_sw128(a + 32 * kk),
                         desc_sw128(w + 32 * kk), 1);
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
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(smem_u32(&empty[held]));
        // chunk j: (acc * rs[m, j]) * cs[n], added to the earlier chunks
        float r[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          r[h] = m + 8 * h < M ? rs[(size_t)(m + 8 * h) * kChunks + j] : 0.f;
        if constexpr (kEpiWarps)
          mbar_wait(smem_u32(drained), (round & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < T::kRegs / 4; ++i) {
          // paired: groups i >= kRegs / 8 are the value half's columns
          const int cn = kPaired && i >= T::kRegs / 8 ? N + n + 8 * i - kTileN
                                                      : n + 8 * i;
          const float c0 = cs[cn], c1 = cs[cn + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pj = dequant(acc[4 * i + e], r[e >> 1], e & 1 ? c1 : c0);
            if constexpr (kEpiWarps)
              staging[(4 * i + e) * kConsumers + threadIdx.x] = pj;
            else
              val[4 * i + e] = j == 0 ? pj : __fadd_rn(val[4 * i + e], pj);
          }
        }
      }
      if constexpr (kEpiWarps) {
        mbar_arrive(smem_u32(staged));
      } else {
        // each pair (against its residual pair, in place) into the
        // staging tile, then one TMA store of the tile (no row past M)
        if constexpr (Epi::kResidual) {
          mbar_wait(smem_u32(staged), round & 1);
        } else {
          if (threadIdx.x == 0) bulk_wait<true>();  // the last tile's store
          named_sync(1, kConsumers);
        }
#pragma unroll
        for (int i = 0; i < T::kRegs / 4; ++i) {
          const int col = col_in + 8 * i;
          const auto c = epi.col(n0 + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t at = staged_tile<kBM>(stage_res, row_in + 8 * h,
                                                 col);
            uint32_t bits;
            if constexpr (Epi::kResidual) {
              asm volatile("ld.shared.b32 %0, [%1];\n"
                           : "=r"(bits) : "r"(at));
              const float2 res = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&bits));
              bits = epi(c, val[4 * i + 2 * h], val[4 * i + 2 * h + 1], res);
            } else {
              bits = epi(c, val[4 * i + 2 * h], val[4 * i + 2 * h + 1]);
            }
            asm volatile("st.shared.b32 [%0], %1;\n"
                         :: "r"(at), "r"(bits) : "memory");
          }
        }
        fence_async_shared();
        named_sync(1, kConsumers);
        if (threadIdx.x == 0) {
#pragma unroll
          for (int a = 0; a < BN / 64; ++a)
            tma_store_2d(&map_out, stage_res + a * kBM * 128, n0 + 64 * a,
                         m0);
          bulk_commit();
        }
      }
      ++round;
    }
    if (!kEpiWarps && threadIdx.x == 0) bulk_wait<false>();
  } else if constexpr (kEpiWarps) {
    // ---- epilogue: thread t mirrors consumer thread t
    regs_inc<T::kEpilogueRegs>();
    const int t = threadIdx.x - 384;
    const int row_in = row_in_tile(t), col_in = col_in_tile(t);
    uint32_t round = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float v[T::kRegs];
      mbar_wait(smem_u32(staged), round & 1);
#pragma unroll
      for (int i = 0; i < T::kRegs; ++i) v[i] = staging[i * kConsumers + t];
      mbar_arrive(smem_u32(drained));
      ++round;
      epi(v, (tile / n_tiles) * kBM + row_in,
          (tile % n_tiles) * kTileN + col_in, M);
    }
  }
}

// The CUtensorMap of a row-major [rows, K] int8 operand, loaded as boxes
// of 128 bytes of K by box_rows rows in the 128-byte swizzle.
inline cudaError_t encode_rows(CUtensorMap* map, const int8_t* ptr, int K,
                               int rows, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Requires K % (128 * kChunks) == 0, N % BN == 0 (paired: N % (BN / 2)
// == 0, W [2N, K]), K-contiguous rows and 16-byte aligned pointers
// (checked by the Python wrappers); grid is the number of persistent
// blocks (at most the tile count).  The inline epilogue (no kEpiWarps)
// writes out and, with Epi::kResidual, reads the residual res, both [M,
// N] bf16.
template <int BN, int kChunks, bool kEpiWarps, bool kPaired = false,
          class Epi>
cudaError_t launch_gemm_s8_wgmma(int M, int N, int K, const int8_t* A,
                                 const int8_t* W, const float* rs,
                                 const float* cs, Epi epi, int grid,
                                 cudaStream_t stream,
                                 const void* res = nullptr,
                                 void* out = nullptr) {
  using T = Tile<BN, kEpiWarps>;
  constexpr int kTileN = kPaired ? BN / 2 : BN;
  static_assert(kEpiWarps || !kPaired, "the inline epilogue's tile");
  if (M < 1 || N % kTileN || K % (kBK * kChunks) || grid < 1)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w, map_res{}, map_out{};
  cudaError_t err = encode_rows(&map_a, A, K, M, kBM);
  if (err != cudaSuccess) return err;
  err = encode_rows(&map_w, W, K, kPaired ? 2 * N : N, kTileN);
  if constexpr (!kEpiWarps) {
    if (err == cudaSuccess && Epi::kResidual)
      err = encode_bf16(&map_res, res, N, M, kBM);
  }
  if (err == cudaSuccess && !kEpiWarps)
    err = encode_bf16(&map_out, out, N, M, kBM);
  if (err != cudaSuccess) return err;
  auto* kernel = gemm_s8_wgmma_kernel<BN, kChunks, kEpiWarps, kPaired, Epi>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(map_a, map_w, map_res,
                                                  map_out, M, N, K, rs, cs,
                                                  epi);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace vdn
