// The warp-specialised int8 GEMM core on Hopper's wgmma and TMA (F4; F5,
// F3 and F1 adopt it in their turn):
//   out = epi( sum_j (float(A_j @ W_j^T) * rs[m, j]) * cs[n] )
//
//   A   [M, K] int8, K contiguous (rows quantized by a row kernel)
//   W   [N, K] int8, K contiguous (a quantized torch Linear weight)
//   rs  fp32 row scales [M, kChunks]; K splits into kChunks equal chunks j,
//       each summed exactly in int32 and dequantized on its own
//   cs  fp32 column scales [N] (the weight's per-output-channel scales)
//   epi epilogue functor, epi(v, m, n, M) over one consumer thread's
//       dequantized values of a tile (layout below)
//
// Replaces the mma.sync template (int8_gemm.cuh) for the products of
// vdn/ops/pallas/int8.py's _ln_mlp_int8_kernel: int8 wgmma takes K-major
// operands only, which A and W already are.  One persistent block per SM
// walks the 128 x BN output tiles (tile t: rows (t / (N / BN)) * 128,
// columns (t % (N / BN)) * BN; block b takes t = b, b + grid, ...).
// Warpgroup 2 is the producer, one thread of which keeps TMA loads of
// 128-byte K slices (A 128 rows, W BN rows, 128-byte swizzle) in flight
// through a ring of kStages stages, each guarded by a "full" and an
// "empty" mbarrier; warpgroups 0 and 1 are the consumers, 64 rows each,
// issuing wgmma m64nBNk32 s8 x s8 -> s32 from shared memory (A and B), four
// per slice, and dequantizing.  setmaxnreg moves registers from the
// producer to the warpgroups that hold values.  The producer runs ahead
// through the ring while the consumers finish a tile.
//
// The epilogue runs in one of two places.  Inline, in the consumers after
// their K loop (fc2's residual epilogue, light).  Or, with kEpiWarps, in
// two more warpgroups: the consumers drop a tile's dequantized values
// into a shared staging buffer, laid out [value][consumer thread], and go
// on with the next tile's products, while epilogue thread i takes consumer
// thread i's values (the same rows and columns) and runs the epilogue
// (fc1's GELU, about 25 dependent instructions a value; on the card the
// products did not overlap an epilogue that the consumers ran between a
// wgmma group's issue and its wait).  TMA zero-fills rows past M; nothing
// past M is stored.
//
// The int32 sums are exact, so the order of the K loop changes nothing;
// the dequantization keeps vdn's order, (float(acc) * rs) * cs per chunk,
// each product rounded on its own (dequant, int8_gemm.cuh), and the chunks
// added in order in fp32.
//
// Tensor maps are encoded on the host at every launch (microseconds; the
// caching allocator reuses pointers) through the driver entry point that
// the runtime hands out, so the library needs no -lcuda.  A failed encode
// or a wait on an mbarrier that outlives kWaitNs (a trap, reported as a
// launch failure) ends the launch with an error, never a hang.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only)

#include "int8_gemm.cuh"

namespace vdn {
namespace wg {

constexpr int kBM = 128;  // output rows per tile: two warpgroups of 64
constexpr int kBK = 128;  // bytes of K per stage: one swizzle row
constexpr int kConsumers = 256;
constexpr unsigned long long kWaitNs = 4000000000ull;

template <int BN, bool kEpiWarps>
struct Tile {
  static_assert(BN == 64 || BN == 128, "tile width");
  static_assert(!kEpiWarps || BN == 128, "the staging buffer holds 128 x 128");
  static constexpr int kRegs = BN / 2;  // accumulators per consumer thread
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;  // 1024-aligned
  static constexpr int kStages = kEpiWarps ? 4 : BN == 128 ? 6 : 8;
  static constexpr int kStaging = kEpiWarps ? kRegs * kConsumers * 4 : 0;
  static constexpr int kBarriers = 2 * kStages + 2;
  // the ring, the staging buffer (192 KB together at every width), 1024
  // bytes of alignment slack and the barriers
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kWaitNs) __trap();
}

// one 2-D tile (c0: byte of K, c1: row) into shared memory, counted on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), layout type 1 (B128).  The
// tile base is 1024-aligned; a step of 32 bytes along K adds to the start
// address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (+)= A B for a 64 x N x 32 step, A and B from shared memory.  The
// accumulator layout (PTX ISA, "wgmma .m64nNk32" register fragments), for
// thread w * 32 + l of the warpgroup: d[4i + e] is row 16 w + l / 4 + 8
// (e / 2), column 8 i + 2 (l % 4) + e % 2.
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

// A pair epilogue (int8_gemm.cuh's functors: e(m, n, v0, v1) for two
// adjacent columns of one row) over a consumer thread's values: v[4i + e]
// is row m + 8 (e / 2), column n + 8 i + e % 2; rows >= M are skipped.
template <class E>
struct PairEpi {
  E e;
  template <int kR>
  __device__ __forceinline__ void operator()(const float (&v)[kR], int m,
                                             int n, int M) const {
#pragma unroll
    for (int i = 0; i < kR / 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (m + 8 * r < M) e(m + 8 * r, n + 8 * i, v[4 * i + 2 * r],
                             v[4 * i + 2 * r + 1]);
  }
};

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// consumer thread t's first row and column within a tile
__device__ __forceinline__ int row_in_tile(int t) {
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
}
__device__ __forceinline__ int col_in_tile(int t) { return 2 * (t & 3); }

template <int BN, int kChunks, bool kEpiWarps, class Epi>
__global__ void __launch_bounds__((Tile<BN, kEpiWarps>::kThreads), 1)
gemm_s8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, int M, int N,
                     int K, const float* __restrict__ rs,
                     const float* __restrict__ cs, Epi epi) {
  using T = Tile<BN, kEpiWarps>;
  static_assert(!kEpiWarps || kChunks == 1, "staged tiles take one chunk");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* base = smem_raw + (ring - raw);
  float* staging = reinterpret_cast<float*>(base + T::kStages * T::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + T::kStages * T::kStageBytes + T::kStaging);
  uint64_t* empty = full + T::kStages;
  uint64_t* staged = empty + T::kStages;    // values in the staging buffer
  uint64_t* drained = staged + 1;           // staging buffer read

  const int n_tiles = N / BN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int slices = K / kBK;
  const int per_chunk = slices / kChunks;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);  // every consumer thread
    }
    mbar_init(smem_u32(staged), kConsumers);
    mbar_init(smem_u32(drained), T::kEpiThreads);  // every epilogue thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // ---- producer: one thread issues every TMA load
    regs_dec<T::kProducerRegs>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
        for (int kb = 0; kb < slices; ++kb) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t dst = ring + stage * T::kStageBytes;
          mbar_expect_tx(bar, T::kStageBytes);
          tma_load_2d(dst, &map_a, bar, kb * kBK, m0);
          tma_load_2d(dst + T::kABytes, &map_w, bar, kb * kBK, n0);
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
      const int m = (tile / n_tiles) * kBM + row_in;
      const int n = (tile % n_tiles) * BN + col_in;
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
          const float c0 = cs[n + 8 * i], c1 = cs[n + 8 * i + 1];
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
        ++round;
      } else {
        epi(val, m, n, M);
      }
    }
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
      epi(v, (tile / n_tiles) * kBM + row_in, (tile % n_tiles) * BN + col_in,
          M);
    }
  }
}

// The CUtensorMap of a row-major [rows, K] int8 operand, loaded as boxes
// of 128 bytes of K by box_rows rows in the 128-byte swizzle.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

inline cudaError_t encode_rows(CUtensorMap* map, const int8_t* ptr, int K,
                               int rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<int8_t*>(ptr), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Requires K % (128 * kChunks) == 0, N % BN == 0, K-contiguous rows and
// 16-byte aligned pointers (checked by the Python wrappers); grid is the
// number of persistent blocks (at most the tile count).
template <int BN, int kChunks, bool kEpiWarps, class Epi>
cudaError_t launch_gemm_s8_wgmma(int M, int N, int K, const int8_t* A,
                                 const int8_t* W, const float* rs,
                                 const float* cs, Epi epi, int grid,
                                 cudaStream_t stream) {
  using T = Tile<BN, kEpiWarps>;
  if (M < 1 || N % BN || K % (kBK * kChunks) || grid < 1)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t err = encode_rows(&map_a, A, K, M, kBM);
  if (err != cudaSuccess) return err;
  err = encode_rows(&map_w, W, K, N, BN);
  if (err != cudaSuccess) return err;
  auto* kernel = gemm_s8_wgmma_kernel<BN, kChunks, kEpiWarps, Epi>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(map_a, map_w, M, N, K, rs,
                                                  cs, epi);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace vdn
