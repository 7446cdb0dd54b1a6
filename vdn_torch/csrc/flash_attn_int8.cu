// F6: the int8 serving mode's self-attention off the fused qkv projection.
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention_int8_fused_qkv
// (_flash_cols_int8_kernel via _flash_int8_call): qkv [B, T, 3, H, D] ->
// out [B, T, H, D], bf16, D = 64, at vitl's B = 22 / 32 / 1 frames of
// T = 1370 (1814 for the 480 x 640 image), H = 16, and vitg's H = 24.  The
// mode picks the int8 products: "qk" (QK^T), "pv" (P V), "all" (both); one
// kernel template on <kQK, kPV>.
//
// Bound on the H100 by the tensor-core products (2 * B * H * T^2 * D each,
// int8 at 1979 TOP/s where quantized, bf16 at 989 TFLOP/s where not, QK^T
// taken twice), by the exp2 of every logit (MUFU, 16 a clock an SM) and by
// the fp32 work around it.  What does not carry over from the TPU kernel,
// and what the design does about it:
//   - the scales depend on all T tokens (k's mean and its one absmax per
//     (frame, head); v's per-channel mean mu and absmax av), and the TPU
//     kernel recomputed them in every q block out of VMEM.  Here a
//     pre-pass (quantize_qkv_kernel) does it once, its blocks split by
//     role so that a single frame still spreads over the card: per
//     (frame, head) one block for each 1,536 q rows, one for k, one for
//     v.  A block reads
//     its rows of qkv once, by TMA in boxes of 256 rows into shared memory
//     (1,536 rows fit: a k or v slice of 1,370 rows is 175 KB), each box
//     on an mbarrier of its own so that the work on the first rows runs
//     under the loads of the last; k's and v's means and absmax come from
//     that copy and the codes are written from it (a slice past 1,536 rows
//     is read again in 1,536-row chunks).  q per row (qi, aq), k centred
//     (ki, ak), v centred and per channel (av, mu), int8 [B, H, Tp, 64]
//     with Tp = T rounded up to 128, zero rows past T; v transposed, [B,
//     H, 64, Tp] (vt), since s8 wgmma reads both operands K-major (the
//     transpose bit is for 16-bit types only) and P V's K is the keys.
//     Within each 32-key group vt stores the keys in the order of the s8
//     A fragment (vt_pos below), so that P's codes go from S's
//     accumulator layout into A fragments with no exchange between lanes;
//   - p is quantized against the exact row max (pi = rint(exp2(s - (m -
//     log2 127))) in [0, 127]), and an online softmax would quantize
//     against a running max and give other codes (nor can int32 sums be
//     rescaled exactly).  The main kernel (f6_flash_kernel) is A1's
//     skeleton (flash_attn_qkv.cu): persistent blocks over a1_plan's
//     (frame, head, 128-row q tile) items, a producer warp issuing TMA
//     loads (the item's q tile, a ring of 128-key K and V tiles; 3-D maps
//     zero-fill past T) and two consumer warpgroups of 64 rows in
//     ping-pong.  Each item walks the keys twice: pass 1 takes the row
//     max, pass 2 recomputes S and accumulates P V;
//   - pass 1 in "qk" / "all": S = qi ki^T as wgmma m64n128k32 s8, and only
//     the integer row max is kept.  s =
//     float(si) * rs (rs = aq * (ak * c2f) > 0) is exact in float(si)
//     (|si| <= 127^2 * 64 < 2^24) and monotone in si, so m = float(max
//     si) * rs is vdn's max(s) bit for bit with no float work per logit.
//     In "pv" it is A1's bf16 S with a float max; the same instructions
//     give the same bits in both passes;
//   - pass 2 in "pv" / "all": pi as above, float(si) by the magic-number
//     trick (an integer add and an fp32 subtract; the conversion unit runs
//     at the MUFU's rate) and rint by adding 1.5 * 2^23, whose low byte is
//     the code; P V as register-A wgmma m64n80k32 s8 against the vt tile
//     and 16 rows of int8 ones below it, so that O's columns 64-79 hold l,
//     exact in int32.  The A fragment of a thread holds keys 4t..4t+3 and
//     4t+16..4t+19 of each 32-key group, its accumulator keys {2t, 2t +
//     1} + 8j: vt's key order maps one onto the other.  The int32 sums are
//     exact, so the order of the keys changes no bit.  In "qk" P V is A1's
//     bf16 m64n72k16 with the ones atom, p = bf16(exp2(s - m)) held to the
//     exact max of pass 1.  Each turn issues S_j and P_{j-1} V_{j-1} as
//     A1 does, each case (S alone, both, P V alone) a sequence behind its
//     own wgmma fence: one fence ahead of products under conditions makes
//     ptxas serialize every wgmma of the kernel (C7520;
//     tools/f6_variants.py fence_once).  P V left running under the next
//     softmax (m is exact, so no rescale touches O) did not pay: with P in
//     registers ptxas serialized the wgmma, with P through shared memory
//     the stores and a softmax masked on every tile cost more than it hid
//     (PERF.md);
//   - the epilogue: out = (float(pv) * av) / float(l) + mu ("pv", "all")
//     or out = O / l ("qk"), each division correctly rounded by one
//     reciprocal a row and div_rn (IEEE division's subroutine had cost
//     ~0.08 ms at the cached window), into the warpgroup's swizzled
//     staging tile, stored by TMA (rows >= T are not written).
// Rounding as vdn's (see flash_attention_int8_fused_qkv_plain): reciprocal
// then multiply, half to even, s = float(si) * (aq * (ak * c2f)), every
// step rounded on its own.  The means sum in another order than vdn's,
// which can move a code by one at a tie; the MUFU's exp2 can move a p code
// at a tie.
#include <math.h>
#include <limits.h>

#include <type_traits>

#include "attn_wgmma.cuh"

namespace {

constexpr int kD = 64;
constexpr int kRows = 128;       // q rows of an item, keys of a tile; Tp's unit
constexpr int kThreads = 288;    // two consumer warpgroups, a producer warp
constexpr int kConsumers = 256;
constexpr int kTurn = 1, kOwn = 3;  // named barriers, as in A1
constexpr int kOutBytes = 64 * kD * 2;  // a warpgroup's staging tile
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kLog2_127 = 6.988684686772166f;
// 1.5 * 2^23: x + kMagic rounds x to an integer half to even for |x| <
// 2^22, and the float's bits are kMagicBits + that integer
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// the pre-pass
constexpr int kPreThreads = 1024;  // 128 row groups x 8 chunks of 8 channels
constexpr int kBox = 256;          // rows of a TMA box
constexpr int kBoxes = 6;
constexpr int kSliceRows = kBox * kBoxes;  // rows held in shared memory,
                                           // and q rows of a block
constexpr int kWarps = kPreThreads / 32;
constexpr int kPreSmem = 1024 + kSliceRows * 128 + kD * kRows +
                         3 * kWarps * kD * 4 + 2 * kD * 4 + 8 * kBoxes;
static_assert(kPreSmem <= 232448, "an H100 block's dynamic shared memory");

// the int8 code of x * inv, half to even, as the low byte of its bits
__device__ __forceinline__ uint32_t code_bits(float x, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(x, inv), kMagic));
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack_low(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// vt's position of key k within its 32-key group: the s8 A fragment's
// byte q of register pair (t, hf) is key 2t + 8 (q / 2) + q % 2 + 16 hf,
// at position 4t + q + 16 hf
__device__ __forceinline__ int vt_pos(int k) {
  return (k & 16) | ((k & 6) << 1) | ((k & 8) >> 2) | (k & 1);
}

// eight bf16 values (16 bytes of shared memory) as fp32
__device__ __forceinline__ void load8_shared(uint32_t at, float (&x)[8]) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// The int8 codes and scales of the mode.  Grid (B * H, roles): with kQK,
// one block for each kSliceRows q rows of Tp, then one for k; with kPV, one
// for v (the last).  map: qkv as [B, T, 3C] bf16, boxes of 64 columns by
// kBox rows, no swizzle.
__global__ void __launch_bounds__(kPreThreads, 1)
quantize_qkv_kernel(const __grid_constant__ CUtensorMap map, int T, int Tp,
                    int H, int mode, int8_t* __restrict__ qi,
                    float* __restrict__ aq, int8_t* __restrict__ ki,
                    float* __restrict__ ak, int8_t* __restrict__ vt,
                    float* __restrict__ av, float* __restrict__ mu) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t slice = (raw + 1023u) & ~1023u;   // [kSliceRows, 64] bf16
  uint8_t* gbase = smem_raw + (slice - raw);
  const uint32_t vtile = slice + kSliceRows * 128;  // [64, 128] int8
  float* part = reinterpret_cast<float*>(gbase + kSliceRows * 128 +
                                         kD * kRows);  // [3][kWarps][64]
  float* mean = part + 3 * kWarps * kD;
  float* amax = mean + kD;
  uint64_t* bar = reinterpret_cast<uint64_t*>(amax + kD);

  const CUtensorMap* qkv_map = &map;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int C = H * kD;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rg = tid >> 3, cg = tid & 7;  // row group, 8-channel chunk
  const int nq = (mode & 1) ? (Tp + kSliceRows - 1) / kSliceRows : 0;
  const int role = blockIdx.y;
  const int which = role < nq ? 0 : ((mode & 1) && role == nq) ? 1 : 2;

  if (tid == 0) {
    for (int k = 0; k < kBoxes; ++k) mbar_init(smem_u32(&bar[k]), 1);
    mbar_fence_init();
  }
  __syncthreads();
  // bit k: the parity of box k's latest load
  uint32_t parity = 0xFFFFFFFFu;
  // rows [r0, r0 + n) of this role's tensor into the slice
  auto load = [&](int r0, int n) {
    __syncthreads();  // every thread is done with the slice
    const int boxes = (n + kBox - 1) / kBox;
    if (tid == 0) {
      fence_async_shared();
      for (int k = 0; k < boxes; ++k) {
        const uint32_t bk = smem_u32(&bar[k]);
        mbar_expect_tx(bk, kBox * 128);
        tma_load_3d(slice + k * kBox * 128, qkv_map, bk, which * C + h * kD,
                    r0 + k * kBox, b);
      }
    }
    parity ^= (1u << boxes) - 1u;
  };
  // the 16 bytes (8 channels) of chunk cg of slice row rr, its box waited
  auto read = [&](int rr, float (&x)[8]) {
    const int k = rr / kBox;
    mbar_wait(smem_u32(&bar[k]), (parity >> k) & 1u);
    load8_shared(slice + rr * 128 + cg * 16, x);
  };

  if (which == 0) {
    // q: per row, its absmax over the 64 channels (8 lanes)
    const int q0 = role * kSliceRows, n = min(kSliceRows, Tp - q0);
    load(q0, n);
    for (int rr = rg; rr < n; rr += kPreThreads / 8) {
      const int r = q0 + rr;
      float x[8];
      read(rr, x);
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) a = fmaxf(a, fabsf(x[c]));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 4));
      const float s = scale_of(a);
      const float inv = __fdiv_rn(1.f, s);
      uint2 w = make_uint2(0, 0);
      if (r < T) {
        w.x = pack_low(code_bits(x[0], inv), code_bits(x[1], inv),
                       code_bits(x[2], inv), code_bits(x[3], inv));
        w.y = pack_low(code_bits(x[4], inv), code_bits(x[5], inv),
                       code_bits(x[6], inv), code_bits(x[7], inv));
      }
      *reinterpret_cast<uint2*>(qi + ((size_t)bh * Tp + r) * kD + 8 * cg) =
          w;
      if (cg == 0) aq[(size_t)bh * Tp + r] = r < T ? s : 0.f;
    }
    return;
  }

  // k and v: each channel's mean over the T tokens (a thread's rows in
  // order, then its warp's four row groups, then the warps in order; sum
  // / T) and amax, the largest |x - mean| rounded as the quantizer rounds
  // it.  fl(x - mean) grows with x, so that largest value is at the
  // channel's min or max: amax = max(|fl(max - mean)|, |fl(min - mean)|),
  // exactly the max over every row, without a second pass.
  const int chunks = (Tp + kSliceRows - 1) / kSliceRows;
  float sum[8], lo[8], hi[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sum[c] = 0.f;
    lo[c] = INFINITY;
    hi[c] = -INFINITY;
  }
  for (int ch = 0; ch < chunks; ++ch) {
    const int r0 = ch * kSliceRows, n = min(kSliceRows, Tp - r0);
    load(r0, n);
    for (int rr = rg; rr < n && r0 + rr < T; rr += kPreThreads / 8) {
      float x[8];
      read(rr, x);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sum[c] = __fadd_rn(sum[c], x[c]);
        lo[c] = fminf(lo[c], x[c]);
        hi[c] = fmaxf(hi[c], x[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
      sum[c] = __fadd_rn(sum[c], __shfl_xor_sync(0xffffffffu, sum[c], off));
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], off));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], off));
    }
  if ((tid & 31) < 8) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      part[warp * kD + 8 * cg + c] = sum[c];
      part[(kWarps + warp) * kD + 8 * cg + c] = lo[c];
      part[(2 * kWarps + warp) * kD + 8 * cg + c] = hi[c];
    }
  }
  __syncthreads();
  if (tid < kD) {
    float s = 0.f, l = INFINITY, g = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      s = __fadd_rn(s, part[w * kD + tid]);
      l = fminf(l, part[(kWarps + w) * kD + tid]);
      g = fmaxf(g, part[(2 * kWarps + w) * kD + tid]);
    }
    const float m = __fdiv_rn(s, static_cast<float>(T));
    mean[tid] = m;
    amax[tid] = fmaxf(fabsf(__fsub_rn(g, m)), fabsf(__fsub_rn(l, m)));
  }
  __syncthreads();
  float mc[8], inv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) mc[c] = mean[8 * cg + c];
  if (which == 1) {
    // k: centred over tokens, one absmax per (frame, head)
    float a = 0.f;
    for (int i = 0; i < kD; ++i) a = fmaxf(a, amax[i]);
    const float s = scale_of(a);
#pragma unroll
    for (int c = 0; c < 8; ++c) inv[c] = __fdiv_rn(1.f, s);
    if (tid == 0) ak[bh] = s;
  } else {
    // v: centred over tokens, one absmax per channel
#pragma unroll
    for (int c = 0; c < 8; ++c)
      inv[c] = __fdiv_rn(1.f, scale_of(amax[8 * cg + c]));
    if (tid < kD) {
      av[(size_t)bh * kD + tid] = scale_of(amax[tid]);
      mu[(size_t)bh * kD + tid] = mean[tid];
    }
  }
  // the codes of one slice row (zeros past T)
  auto codes = [&](int rr, int r, uint32_t (&w)[2]) {
    w[0] = w[1] = 0;
    if (r >= T) return;
    float x[8];
    read(rr, x);
    uint32_t u[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      u[c] = code_bits(__fsub_rn(x[c], mc[c]), inv[c]);
    w[0] = pack_low(u[0], u[1], u[2], u[3]);
    w[1] = pack_low(u[4], u[5], u[6], u[7]);
  };
  for (int ch = 0; ch < chunks; ++ch) {
    const int r0 = ch * kSliceRows, n = min(kSliceRows, Tp - r0);
    if (chunks > 1) load(r0, n);
    if (which == 1) {
      for (int rr = rg; rr < n; rr += kPreThreads / 8) {
        uint32_t w[2];
        codes(rr, r0 + rr, w);
        *reinterpret_cast<uint2*>(ki + ((size_t)bh * Tp + r0 + rr) * kD +
                                  8 * cg) = make_uint2(w[0], w[1]);
      }
      continue;
    }
    // v, transposed one 128-key tile at a time through vtile: channel c's
    // row, its 16-byte chunk j at chunk j ^ ((c / 8) % 8) (no two of a
    // warp's byte stores on one bank)
    for (int k0 = 0; k0 < n; k0 += kRows) {
      uint32_t w[2];
      codes(k0 + rg, r0 + k0 + rg, w);
      const int pos = (rg & ~31) | vt_pos(rg & 31);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int chn = 8 * cg + c;
        const uint32_t at = vtile + chn * kRows +
                            ((((pos >> 4) ^ cg) << 4) | (pos & 15));
        asm volatile("st.shared.u8 [%0], %1;\n"
                     :: "r"(at), "r"(w[c >> 2] >> (8 * (c & 3))) : "memory");
      }
      __syncthreads();
      if (tid < kD * kRows / 16) {
        const int chn = tid >> 3, j = tid & 7;
        uint4 v;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(vtile + chn * kRows + ((j ^ (chn >> 3)) << 4)));
        *reinterpret_cast<uint4*>(vt + ((size_t)bh * kD + chn) * Tp + r0 +
                                  k0 + 16 * j) = v;
      }
      __syncthreads();
    }
  }
}

// ---- the main kernel

#define VDN_I8(d, o)                                                     \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),            \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// D (+)= A B, 64 x 128 x 32 s8 -> s32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " VDN_R64
      ", %64, %65, p;\n}\n"
      : VDN_I8(d, 0), VDN_I8(d, 8), VDN_I8(d, 16), VDN_I8(d, 24),
        VDN_I8(d, 32), VDN_I8(d, 40), VDN_I8(d, 48), VDN_I8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B, 64 x 80 x 32 s8 -> s32, A from registers (the s8 fragment of
// a 64 x 32 slice), B K-major in shared memory: the vt tile's 64 channel
// rows and 16 rows of ones below them
__device__ __forceinline__ void wgmma_s8_rs_n80(int (&d)[40],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p;\n}\n"
      : VDN_I8(d, 0), VDN_I8(d, 8), VDN_I8(d, 16), VDN_I8(d, 24),
        VDN_I8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// wgmma descriptor of a K-major tile of 64-byte rows in the 64-byte
// swizzle (TMA's SWIZZLE_64B): 8-row groups 512 bytes apart (SBO), layout
// type 2; the tile base is 512-aligned, and a step of 32 bytes along K
// adds to the start address
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

template <bool kQK, bool kPV>
struct F6 {
  // q and K tiles: int8 codes (64-byte rows) or bf16 (128-byte rows)
  static constexpr int kQBytes = kRows * kD * (kQK ? 1 : 2);
  static constexpr int kKBytes = kQBytes;
  // a V stage: the vt tile [64 channels, 128 keys] int8 and 16 rows of
  // int8 ones, or a bf16 [128 keys, 64] tile (the ones: a 16 KB bf16 atom
  // after the ring)
  static constexpr int kVLoad = kRows * kD * (kPV ? 1 : 2);
  static constexpr int kVBytes = kPV ? kVLoad + 16 * kRows : kVLoad;
  static constexpr int kStageBytes = kKBytes + kVBytes;  // 1024-aligned
  static constexpr int kOnesBytes = kPV ? 0 : kRows * kD * 2;
  static constexpr int kStages = kQK && kPV ? 8 : 6;
  static constexpr int kBarriers = 2 * kStages + 4;
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kOutBytes +
                               kStages * kStageBytes + kOnesBytes +
                               8 * kBarriers;
  static_assert(kSmem <= 232448, "an H100 block's dynamic shared memory");
  static_assert(kStageBytes % 1024 == 0 && kQBytes % 1024 == 0, "alignment");
  // accumulators: S s32 or fp32; O s32 [64 | 16 of l] or fp32 [64 | 8]
  using SAcc = std::conditional_t<kQK, int, float>;
  using OAcc = std::conditional_t<kPV, int, float>;
  static constexpr int kO = kPV ? 40 : 36;
  // P's A fragments: 32-key s8 slices or 16-key bf16 slices
  static constexpr int kSlices = kPV ? 4 : 8;
};

// S = Q K^T of the warpgroup's 64 rows against a 128-key tile
template <bool kQK>
__device__ __forceinline__ void product_s(
    std::conditional_t<kQK, int, float> (&s)[64], uint32_t qw,
    uint32_t k_s) {
  if constexpr (kQK) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_s8_n128(s, desc_sw64(qw + 32 * kk), desc_sw64(k_s + 32 * kk), kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(s, desc_sw128(qw + 32 * kk), desc_sw128(k_s + 32 * kk),
                    kk);
  }
}

// O += P [V | 1]: s8 against the vt tile and its ones rows, or bf16
// against V read MN-major and the ones atom at ones_s
template <bool kPV>
__device__ __forceinline__ void product_pv(
    std::conditional_t<kPV, int, float> (&o)[kPV ? 40 : 36],
    const uint32_t (&pa)[kPV ? 4 : 8][4], uint32_t v_s, uint32_t ones_s) {
  if constexpr (kPV) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8_rs_n80(o, pa[kk], desc_sw128(v_s + 32 * kk));
  } else {
    const uint64_t lbo = static_cast<uint64_t>((ones_s - v_s) >> 4) << 16;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_n72(o, pa[kk],
                   (desc_sw128(v_s + 2048 * kk) & ~(0x3FFFull << 16)) | lbo);
  }
}

// One pass-2 turn's products, each case a sequence of its own behind its
// own fence (a fence ahead of conditional products makes ptxas insert
// warpgroup arrives in the branches and serialize every wgmma): S = Q K^T
// (kS) and O += P [V | 1] (kPVg), each a wgmma group, S's first
template <bool kS, bool kPVg, bool kQK, bool kPV>
__device__ __forceinline__ void issue(
    std::conditional_t<kQK, int, float> (&s)[64],
    std::conditional_t<kPV, int, float> (&o)[kPV ? 40 : 36],
    const uint32_t (&pa)[kPV ? 4 : 8][4], uint32_t qw, uint32_t k_s,
    uint32_t v_s, uint32_t ones_s) {
  wgmma_fence();
  if constexpr (kS) {
    product_s<kQK>(s, qw, k_s);
    wgmma_commit();
  }
  if constexpr (kPVg) {
    product_pv<kPV>(o, pa, v_s, ones_s);
    wgmma_commit();
  }
}

// fp32 s of accumulator value x: float(si) * rs (exact float(si) for |si|
// < 2^22 by the magic number), or the bf16 product's logit as it is
template <bool kQK>
__device__ __forceinline__ float logit(
    std::conditional_t<kQK, int, float> x, float rs) {
  if constexpr (kQK)
    return __fmul_rn(__fsub_rn(__int_as_float(x + kMagicBits), kMagic), rs);
  else
    return x;
}

// pass 1: the running row max of one tile (keys >= T skipped where kMask)
template <bool kMask, bool kQK>
__device__ __forceinline__ void tile_max(
    const std::conditional_t<kQK, int, float> (&s)[64],
    std::conditional_t<kQK, int, float> (&mx)[2], int key0,
    int T) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!kMask || key0 + 8 * i + (e & 1) < T)
        mx[e >> 1] = max(mx[e >> 1], s[4 * i + e]);
}

// pass 2: P of one tile as the A fragments of P V.  kPV: pi = rint(exp2(s
// - shift)), shift = m - log2 127, packed by bytes (slice kk, register 2
// hf + r: row r's accumulator columns 8 (4 kk + 2 hf) + 2t (+1) and 8 (4
// kk + 2 hf + 1) + 2t (+1), vt's key order); else p = bf16(exp2(s - m)) in
// A1's layout.  Keys >= T (kMask) get p = 0.
template <bool kMask, bool kQK, bool kPV>
__device__ __forceinline__ void tile_p(
    const std::conditional_t<kQK, int, float> (&s)[64],
    uint32_t (&pa)[kPV ? 4 : 8][4], const float (&rs)[2],
    const float (&shift)[2], int key0, int T) {
  auto p_of = [&](int i, int e) {
    float x = logit<kQK>(s[4 * i + e], rs[e >> 1]);
    if (kMask && key0 + 8 * i + (e & 1) >= T) x = -INFINITY;
    return ex2(__fsub_rn(x, shift[e >> 1]));
  };
  if constexpr (kPV) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * kk + 2 * hf;
          uint32_t u[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            u[q] = __float_as_uint(
                __fadd_rn(p_of(i + (q >> 1), 2 * r + (q & 1)), kMagic));
          pa[kk][2 * hf + r] = pack_low(u[0], u[1], u[2], u[3]);
        }
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 2 * kk + (q >> 1), e = 2 * (q & 1);
        pa[kk][q] = vdn::pack_bf16(p_of(i, e), p_of(i, e + 1));
      }
  }
}

// maps: q / k the code maps (kQK) or qkv's; v vt's (kPV) or qkv's; out
// [B, T, C] bf16.  qscale: bf16(scale * log2 e) ("pv"'s bf16 QK^T), c2f:
// fp32(scale * log2 e).
template <bool kQK, bool kPV>
__global__ void __launch_bounds__(kThreads, 1)
f6_flash_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_out, int B, int T,
                int H, float c2f, float qscale,
                const float* __restrict__ aq, const float* __restrict__ ak,
                const float* __restrict__ av, const float* __restrict__ mu) {
  using F = F6<kQK, kPV>;
  using SAcc = typename F::SAcc;
  using OAcc = typename F::OAcc;
  constexpr int kStages = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                       // two q tiles
  const uint32_t out_s = base + 2 * F::kQBytes;    // two staging tiles
  const uint32_t ring = out_s + 2 * kOutBytes;     // stage: K, then V
  const uint32_t ones_s = ring + kStages * F::kStageBytes;  // bf16 1.0
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gbase + (ones_s - base) + F::kOnesBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 2;

  const int C = H * kD;
  const int n_t = (T + kRows - 1) / kRows;  // q tiles, and key tiles
  const int Tp = n_t * kRows;
  const int items = B * H * n_t;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_u32(&q_full[i]), 1);
      mbar_init(smem_u32(&q_empty[i]), kConsumers);
    }
    mbar_fence_init();
  }
  if constexpr (kPV) {
    // int8 ones: rows 64-79 of each stage's V operand
    for (int c = threadIdx.x; c < kStages * 16 * kRows / 16; c += kThreads) {
      const int st = c / (kRows), part = c % kRows;
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n"
                   :: "r"(ring + st * F::kStageBytes + F::kKBytes +
                          F::kVLoad + 16 * part),
                      "r"(0x01010101u) : "memory");
    }
  } else {
    for (int c = threadIdx.x; c < F::kOnesBytes / 16; c += kThreads)
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n"
                   :: "r"(ones_s + 16 * c), "r"(0x3F803F80u) : "memory");
  }
  fence_async_shared();
  __syncthreads();

  if (wgi == 2) {
    if (threadIdx.x == 256) {
      const CUtensorMap* pk = &map_k;
      const CUtensorMap* pv = &map_v;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x, i = 0; it < items; it += gridDim.x, ++i) {
        const int qt = it % n_t, h = (it / n_t) % H, b = it / (n_t * H);
        const int bh = b * H + h;
        const int qb = i & 1;
        const uint32_t qbar = smem_u32(&q_full[qb]);
        mbar_wait(smem_u32(&q_empty[qb]), ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(qbar, F::kQBytes);
        if constexpr (kQK)
          tma_load_3d(q_s + qb * F::kQBytes, &map_q, qbar, 0, qt * kRows, bh);
        else
          tma_load_3d(q_s + qb * F::kQBytes, &map_q, qbar, h * kD,
                      qt * kRows, b);
        // one stage: key tile j of K, and with v that of V
        auto load_stage = [&](int j, bool v) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t dst = ring + stage * F::kStageBytes;
          mbar_expect_tx(bar, F::kKBytes + (v ? F::kVLoad : 0));
          if constexpr (kQK)
            tma_load_3d(dst, pk, bar, 0, j * kRows, bh);
          else
            tma_load_3d(dst, pk, bar, C + h * kD, j * kRows, b);
          if (v) {
            if constexpr (kPV)
              tma_load_3d(dst + F::kKBytes, pv, bar, j * kRows, 0, bh);
            else
              tma_load_3d(dst + F::kKBytes, pv, bar, 2 * C + h * kD,
                          j * kRows, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        };
        // pass 1: the K tiles; pass 2: the K and V tiles
        for (int j = 0; j < n_t; ++j) load_stage(j, false);
        for (int j = 0; j < n_t; ++j) load_stage(j, true);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns q rows [64 wgi, 64 wgi + 64) of
  // each item's tile
  const int t = threadIdx.x;
  const int lt = t & 127;
  const int c2 = 2 * (t & 3);
  const int row = wg_row(t);  // and row + 8
  const uint32_t stage_o = out_s + wgi * kOutBytes;
  if (wgi == 1) named_arrive(kTurn, kConsumers);  // warpgroup 0 goes first
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x, i = 0; it < items; it += gridDim.x, ++i) {
    const int qt = it % n_t, h = (it / n_t) % H, b = it / (n_t * H);
    const int bh = b * H + h;
    const int qb = i & 1;
    const uint32_t qw = q_s + qb * F::kQBytes + wgi * (F::kQBytes / 2);
    const int row0 = qt * kRows + wgi * 64;
    mbar_wait(smem_u32(&q_full[qb]), (i >> 1) & 1);
    float rs[2] = {1.f, 1.f};  // the rows' scales aq * (ak * c2f)
    if constexpr (kQK) {
      const float kc = __fmul_rn(ak[bh], c2f);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rs[r] = __fmul_rn(aq[(size_t)bh * Tp + row0 + row + 8 * r], kc);
    } else {
      // qs = bf16(q * qscale) in place, 16 bytes a step
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t at = qw + 16 * (lt + 128 * c);
        uint4 v;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(at));
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(hv[k]);
          hv[k] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(at), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                     : "memory");
      }
      fence_async_shared();
      named_sync(kOwn + wgi, 128);
    }

    // ---- pass 1: the exact row max, one product a turn
    SAcc s[64];
    SAcc mx[2];
    if constexpr (kQK)
      mx[0] = mx[1] = INT_MIN;
    else
      mx[0] = mx[1] = -INFINITY;
#pragma unroll 1
    for (int j = 0; j < n_t; ++j) {
      const uint32_t k_s = ring + stage * F::kStageBytes;
      mbar_wait(smem_u32(&full[stage]), phase);
      named_sync(kTurn + wgi, kConsumers);
      wgmma_fence();
      product_s<kQK>(s, qw, k_s);
      wgmma_commit();
      named_arrive(kTurn + (wgi ^ 1), kConsumers);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(smem_u32(&empty[stage]));
      if ((j + 1) * kRows > T)
        tile_max<true, kQK>(s, mx, j * kRows + c2, T);
      else
        tile_max<false, kQK>(s, mx, j * kRows + c2, T);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // m = max(s): for kQK float(max si) * rs, exact
      const float m = kQK ? __fmul_rn(static_cast<float>(mx[r]), rs[r])
                          : static_cast<float>(mx[r]);
      shift[r] = kPV ? __fsub_rn(m, kLog2_127) : m;
    }

    // ---- pass 2: turn j issues S_j (j < n_t) and P_{j-1} V_{j-1} (j >
    // 0), then P_j from S_j
    OAcc o[F::kO];
#pragma unroll
    for (int k = 0; k < F::kO; ++k) o[k] = 0;
    uint32_t pa[F::kSlices][4];
    int prev = 0;  // the stage of P's V
#pragma unroll 1
    for (int j = 0; j <= n_t; ++j) {
      const uint32_t k_s = ring + stage * F::kStageBytes;
      const uint32_t v_s = ring + prev * F::kStageBytes + F::kKBytes;
      if (j < n_t) mbar_wait(smem_u32(&full[stage]), phase);
      named_sync(kTurn + wgi, kConsumers);
      if (j == 0)
        issue<true, false, kQK, kPV>(s, o, pa, qw, k_s, v_s, ones_s);
      else if (j < n_t)
        issue<true, true, kQK, kPV>(s, o, pa, qw, k_s, v_s, ones_s);
      else
        issue<false, true, kQK, kPV>(s, o, pa, qw, k_s, v_s, ones_s);
      named_arrive(kTurn + (wgi ^ 1), kConsumers);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < F::kSlices; ++kk) fence_regs(pa[kk]);
      if (j > 0) mbar_arrive(smem_u32(&empty[prev]));
      if (j == n_t) break;
      if ((j + 1) * kRows > T)
        tile_p<true, kQK, kPV>(s, pa, rs, shift, j * kRows + c2, T);
      else
        tile_p<false, kQK, kPV>(s, pa, rs, shift, j * kRows + c2, T);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_arrive(smem_u32(&q_empty[qb]));

    // ---- epilogue into the staging tile, one TMA store of the
    // warpgroup's 64 rows: "pv" / "all" (float(pv) * av) / float(l) + mu,
    // "qk" O / l (l in O's columns 64-71), each division correctly
    // rounded (div_rn)
    const float l[2] = {static_cast<float>(o[32]), static_cast<float>(o[34])};
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    if (lt == 0) bulk_wait<true>();  // the last item's store has read it
    named_sync(kOwn + wgi, 128);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      float2 a2 = make_float2(0.f, 0.f), m2 = a2;
      if constexpr (kPV) {
        a2 = *reinterpret_cast<const float2*>(av + (size_t)bh * kD + 8 * n8 +
                                              c2);
        m2 = *reinterpret_cast<const float2*>(mu + (size_t)bh * kD + 8 * n8 +
                                              c2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const OAcc x = o[4 * n8 + 2 * r + e];
          if constexpr (kPV)
            y[e] = __fadd_rn(div_rn(__fmul_rn(__int2float_rn(x),
                                              e ? a2.y : a2.x),
                                    l[r], rl[r]),
                             e ? m2.y : m2.x);
          else
            y[e] = div_rn(x, l[r], rl[r]);
        }
        const uint32_t at = staged_tile<64>(stage_o, row + 8 * r, 8 * n8 + c2);
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(at), "r"(vdn::pack_bf16(y[0], y[1])) : "memory");
      }
    }
    fence_async_shared();
    named_sync(kOwn + wgi, 128);
    if (lt == 0 && row0 < T) {
      tma_store_3d(&map_out, stage_o, h * kD, row0, b);
      bulk_commit();
    }
  }
  if (wgi == 0) named_sync(kTurn, kConsumers);  // warpgroup 1's last turn
  if (lt == 0) bulk_wait<false>();
}

// [BH, rows, inner] int8 moved as boxes of box_inner x box_rows in the
// given swizzle
cudaError_t encode_codes(CUtensorMap* map, const void* ptr, int BH, int rows,
                         int inner, int box_inner, int box_rows,
                         CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)inner,
                                 (cuuint64_t)inner * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ptr, dims,
                    strides, box, swizzle);
}

template <bool kQK, bool kPV>
cudaError_t launch_f6(const void* qkv, int B, int T, int H, float c2f,
                      float qscale, const void* qi, const float* aq,
                      const void* ki, const float* ak, const void* vt,
                      const float* av, const float* mu, void* out, int grid,
                      cudaStream_t s) {
  using F = F6<kQK, kPV>;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  CUtensorMap map_qkv, map_q, map_k, map_v, map_out;
  cudaError_t err = encode_rows_bf16(&map_qkv, qkv, B, T, 3 * H * kD, kRows);
  if (err == cudaSuccess)
    err = encode_rows_bf16(&map_out, out, B, T, H * kD, 64);
  map_q = map_k = map_v = map_qkv;
  if (err == cudaSuccess && kQK)
    err = encode_codes(&map_q, qi, B * H, Tp, kD, kD, kRows,
                       CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess && kQK)
    err = encode_codes(&map_k, ki, B * H, Tp, kD, kD, kRows,
                       CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess && kPV)
    err = encode_codes(&map_v, vt, B * H, kD, Tp, kRows, kD,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      f6_flash_kernel<kQK, kPV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::kSmem);
  if (attr != cudaSuccess) return attr;
  f6_flash_kernel<kQK, kPV><<<grid, kThreads, F::kSmem, s>>>(
      map_q, map_k, map_v, map_out, B, T, H, c2f, qscale, aq, ak, av, mu);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, T, 3 * H * 64] bf16 -> out [B, T, H * 64] bf16.  mode 1 (qk), 2
// (pv) or 3 (all).  c2f is fp32(scale * log2 e), qscale bf16(scale *
// log2 e) (the bf16 QK^T's fold into q).  Scratch, Tp = T rounded up to
// 128, written here and readable after the call, 16-byte aligned: with
// mode & 1, qi [B, H, Tp, 64] int8, aq [B, H, Tp], ki [B, H, Tp, 64] int8,
// ak [B, H] fp32; with mode & 2, vt [B, H, 64, Tp] int8 (each 32-key group
// in vt_pos's order), av and mu [B, H, 64] fp32 (the other pointers may be
// null).  grid: the persistent blocks (the Python plan's, a1_plan).  Two
// launches: the pre-pass, then the attention.
extern "C" int vdn_flash_attention_int8(const void* qkv, int B, int T, int H,
                                        int mode, float c2f, float qscale,
                                        void* qi, void* aq, void* ki, void* ak,
                                        void* vt, void* av, void* mu,
                                        void* out, int grid, void* stream) {
  if (B < 1 || T < 1 || H < 1 || mode < 1 || mode > 3 || grid < 1 ||
      (size_t)B * H > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)3 * H * kD, (cuuint64_t)T,
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)3 * H * kD * 2,
                                   (cuuint64_t)3 * H * kD * 2 * T};
    const cuuint32_t box[3] = {kD, kBox, 1};
    const cudaError_t err =
        encode_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qkv, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      quantize_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPreSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 pre(B * H, ((mode & 1) ? (Tp + kSliceRows - 1) / kSliceRows + 1 : 0) +
                            ((mode & 2) ? 1 : 0));
  quantize_qkv_kernel<<<pre, kPreThreads, kPreSmem, s>>>(
      map, T, Tp, H, mode, static_cast<int8_t*>(qi), static_cast<float*>(aq),
      static_cast<int8_t*>(ki), static_cast<float*>(ak),
      static_cast<int8_t*>(vt), static_cast<float*>(av),
      static_cast<float*>(mu));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* faq = static_cast<const float*>(aq);
  const float* fak = static_cast<const float*>(ak);
  const float* fav = static_cast<const float*>(av);
  const float* fmu = static_cast<const float*>(mu);
  if (mode == 1)
    return launch_f6<true, false>(qkv, B, T, H, c2f, qscale, qi, faq, ki,
                                  fak, vt, fav, fmu, out, grid, s);
  if (mode == 2)
    return launch_f6<false, true>(qkv, B, T, H, c2f, qscale, qi, faq, ki,
                                  fak, vt, fav, fmu, out, grid, s);
  return launch_f6<true, true>(qkv, B, T, H, c2f, qscale, qi, faq, ki, fak,
                               vt, fav, fmu, out, grid, s);
}
