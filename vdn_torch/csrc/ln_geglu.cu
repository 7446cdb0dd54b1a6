// A4: fused LayerNorm -> net_0 -> hidden * gelu(gate) -> net_2 -> + b2 + x.
//
// Replaces vdn/ops/pallas/geglu.py fused_ln_geglu_residual (_geglu_kernel
// via _geglu_pallas), the motion-module feed-forward tail at rows =
// tokens * 32 frames (43808 or 175232 rows at vitl), C = 64 / 128 / 256 /
// 384 / 1024 / 1536 (the models' motion widths), F = 4C, bf16.
//
// Bound on the H100 by the two products (6 * rows * C * F FLOP) at C 1024
// and 1536, by the bytes of x, h and out at C 256 and below.  The TPU kernel
// kept w0 [2F, C] and w2 [C, F] resident in VMEM and never wrote the
// hidden; a Hopper block holds 227 KB, so the tail runs as three launches,
// the products on the wgmma + TMA core (bf16_wgmma.cuh), as A2's:
//   1. ln_rows_kernel (bf16_wgmma.cuh, shared with A2): y = bf16(LN(x))
//      [rows, C], one warp per row, the row in registers;
//   2. fc1 in the core's kHalves mode, ping-pong: a 128 x 128 tile's B
//      stage is w0's hidden rows [n0, n0 + 64) and gate rows [F + n0, F +
//      n0 + 64), so a thread holds one output's hidden and gate sums and
//      the GEGLU epilogue pairs them in registers, writing 64 columns of h
//      [rows, F] bf16 through the staging tile and a TMA store;
//   3. fc2, ping-pong, w2 K-major, x's tile staged by TMA, (x + o) + b2.
//      At C 64 and 192 its last column tile is half empty (its epilogue
//      sets kEdge, so the core takes N % 64 == 0).
// The hidden round trip is 2 * rows * F * 2 bytes (0.72 GB at 175,232
// rows, C 256: 0.21 ms at 3.35 TB/s).
// Rounding as geglu.py:49-65: hidden and gate rounded to bf16, each + its
// bias in bf16, hidden * gelu(gate) in fp32 (tanh-form GELU, the bf16
// flavour) rounded to bf16; the net_2 sum rounded, then (x + o) + b2 in bf16.
#include "bf16_wgmma.cuh"

namespace {

using vdn::bf16r;
namespace wgbf = vdn::wgbf;

constexpr int kBN = 128;  // fc2's tile width; fc1's B rows (64 outputs)
struct A4Rows {};         // the row kernel's caller tag

__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* b, int n) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + n));
}

// fc1's epilogue: h = bf16(hid * gelu(gate)), hid = bf16(bf16(acc_h) +
// b0[n]), gate = bf16(bf16(acc_g) + b0[F + n])
struct EpiGeglu {
  static constexpr int kOuts = 1;
  static constexpr bool kResidual = false;
  static constexpr int kColSumOut = -1;
  static constexpr bool kEdge = false;
  const __nv_bfloat16* b;  // [2F]
  int F;
  __device__ __forceinline__ float4 col(int n) const {
    const float2 h = bias_pair(b, n), g = bias_pair(b, F + n);
    return make_float4(h.x, h.y, g.x, g.y);
  }
  __device__ __forceinline__ void operator()(float4 c, float h0, float h1,
                                             float g0, float g1,
                                             uint32_t (&o)[1]) const {
    const float hid0 = bf16r(bf16r(h0) + c.x);
    const float hid1 = bf16r(bf16r(h1) + c.y);
    const float gate0 = bf16r(bf16r(g0) + c.z);
    const float gate1 = bf16r(bf16r(g1) + c.w);
    o[0] = vdn::pack_bf16(hid0 * vdn::gelu_tanh(gate0),
                          hid1 * vdn::gelu_tanh(gate1));
  }
};

// fc2's epilogue: out = bf16(bf16(x + bf16(acc)) + b2), x the residual
// tile staged by TMA
struct EpiResidualBias {
  static constexpr int kOuts = 1;
  static constexpr bool kResidual = true;
  static constexpr int kColSumOut = -1;
  static constexpr bool kEdge = true;
  const __nv_bfloat16* b;
  __device__ __forceinline__ float2 col(int n) const {
    return bias_pair(b, n);
  }
  __device__ __forceinline__ void operator()(float2 bias, float v0, float v1,
                                             float2 x,
                                             uint32_t (&o)[1]) const {
    o[0] = vdn::pack_bf16(bf16r(x.x + bf16r(v0)) + bias.x,
                          bf16r(x.y + bf16r(v1)) + bias.y);
  }
};

}  // namespace

// x, out [M, C]; w0 [2F, C]; b0 [2F]; w2 [C, F]; b2 [C] bf16; ln_w, ln_b
// [C] fp32; scratch: y [M, C], h [M, F] bf16.  C % 64 == 0, C <= 2048, F
// % 64 == 0.  grid1 and grid2: the persistent blocks of fc1 and fc2.
extern "C" int vdn_ln_geglu_residual(const void* x, int M, int C, int F,
                                     const void* ln_w, const void* ln_b,
                                     const void* w0, const void* b0,
                                     const void* w2, const void* b2,
                                     float eps, void* y, void* h, void* out,
                                     int grid1, int grid2, void* stream) {
  if (M < 1 || C % 64 || C > 2048 || F % 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaError_t err = wgbf::launch_ln_rows<A4Rows>(
      xb, M, C, static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), eps, yb, s);
  if (err != cudaSuccess) return err;
  err = wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kHalves, wgbf::kNoB, false>(
      M, F, C, yb, w0, nullptr, nullptr, &h, nullptr,
      EpiGeglu{static_cast<const __nv_bfloat16*>(b0), F}, grid1, s);
  if (err != cudaSuccess) return err;
  return wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kKMajor, wgbf::kNoB, false>(
      M, C, F, h, w2, nullptr, nullptr, &out, x,
      EpiResidualBias{static_cast<const __nv_bfloat16*>(b2)}, grid2, s);
}
