// A2: fused LayerNorm -> fc1 -> GELU -> fc2 -> x LayerScale -> + residual.
//
// Replaces vdn/ops/pallas/mlp.py fused_ln_mlp_residual (_ln_mlp_kernel via
// _ln_mlp_pallas3 / _ln_mlp_pallas), the ViT block tail
// x + gamma * fc2(gelu(fc1(LN(x)) + b1)) + b2 at rows = frames * 1370, C
// 384 / 768 / 1024 (vits / vitb / vitl), F = 4 C, bf16.
//
// Bound on the H100 by the two products (4 * rows * C * F FLOP; 0.511 ms
// at vitl's cached window, 30,140 rows, at 989 TFLOP/s).  The TPU kernel
// kept W1 and W2 (8 MB each in bf16) resident in VMEM and never wrote the
// hidden activations; a Hopper block holds 227 KB, so the tail runs as
// three launches, the products on the wgmma + TMA core (bf16_wgmma.cuh):
//   1. ln_rows_kernel (bf16_wgmma.cuh, shared with A4): y = bf16(LN(x))
//      [rows, C], one warp per row, the row held in registers (the value
//      the products read: TMA cannot apply a LayerNorm prologue);
//   2. fc1 on 128 x 128 tiles, W1 [F, C] K-major, the + b1, GELU epilogue
//      writing h [rows, F] bf16 (the TPU kernel's rounding point anyway);
//   3. fc2 on 128 x 128 tiles, W2 [C, F] K-major, the + b2, x gamma, + x
//      epilogue, x's tile staged by TMA.
// The hidden round trip costs 2 * rows * F * 2 bytes (494 MB at the cached
// window, 0.15 ms at 3.35 TB/s), written by one consumer warpgroup's
// epilogue while the other's products run (the core's ping-pong).
// Rounding points as mlp.py:137-149: the sums rounded to bf16, + b1 in
// bf16, GELU (tanh form, the bf16 flavour) in fp32 rounded to bf16; o
// rounded, + b2, then x + bf16(o * gamma).
#include "bf16_wgmma.cuh"

namespace {

using vdn::bf16r;
using vdn::bf2f;
namespace wgbf = vdn::wgbf;

constexpr int kBN = 128;  // fc1's and fc2's tile width
struct A2Rows {};         // the row kernel's caller tag

// fc1's epilogue: h = bf16(gelu(bf16(bf16(acc) + b1)))
struct EpiFc1Gelu {
  static constexpr int kOuts = 1;
  static constexpr bool kResidual = false;
  static constexpr int kColSumOut = -1;
  static constexpr bool kEdge = false;
  const __nv_bfloat16* b;
  __device__ __forceinline__ float2 col(int n) const {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + n));
  }
  __device__ __forceinline__ void operator()(float2 bias, float v0, float v1,
                                             float2, uint32_t (&o)[1]) const {
    const float h0 = bf16r(bf16r(v0) + bias.x);
    const float h1 = bf16r(bf16r(v1) + bias.y);
    o[0] = vdn::pack_bf16(vdn::gelu_tanh(h0), vdn::gelu_tanh(h1));
  }
};

// fc2's epilogue: out = x + bf16(bf16(bf16(acc) + b2) * gamma), x the
// residual tile staged by TMA
struct EpiFc2Residual {
  static constexpr int kOuts = 1;
  static constexpr bool kResidual = true;
  static constexpr int kColSumOut = -1;
  static constexpr bool kEdge = false;
  const __nv_bfloat16* b;
  const __nv_bfloat16* gamma;
  __device__ __forceinline__ float4 col(int n) const {
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b + n));
    const float2 g = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(gamma + n));
    return make_float4(bb.x, bb.y, g.x, g.y);
  }
  __device__ __forceinline__ void operator()(float4 c, float v0, float v1,
                                             float2 x,
                                             uint32_t (&o)[1]) const {
    const float o0 = bf16r(bf16r(v0) + c.x);
    const float o1 = bf16r(bf16r(v1) + c.y);
    o[0] = vdn::pack_bf16(x.x + bf16r(o0 * c.z), x.y + bf16r(o1 * c.w));
  }
};

}  // namespace

// x, out [M, C]; w1 [F, C]; w2 [C, F]; b1 [F], b2, gamma [C] bf16; ln_w,
// ln_b [C] fp32; scratch: y [M, C], h [M, F] bf16.  C % 128 == 0, C <=
// 2048, F % 128 == 0.  grid1 and grid2: the persistent blocks of fc1 and
// fc2.
extern "C" int vdn_ln_mlp_residual(const void* x, int M, int C, int F,
                                   const void* ln_w, const void* ln_b,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* b2,
                                   const void* gamma, float eps, void* y,
                                   void* h, void* out, int grid1, int grid2,
                                   void* stream) {
  if (M < 1 || C % kBN || C > 2048 || F % kBN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  const auto* w = static_cast<const float*>(ln_w);
  const auto* b = static_cast<const float*>(ln_b);
  cudaError_t err = wgbf::launch_ln_rows<A2Rows>(xb, M, C, w, b, eps, yb, s);
  if (err != cudaSuccess) return err;
  void* hout = hb;
  err = wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kKMajor, wgbf::kNoB, false>(
      M, F, C, yb, w1, nullptr, nullptr, &hout, nullptr,
      EpiFc1Gelu{static_cast<const __nv_bfloat16*>(b1)}, grid1, s);
  if (err != cudaSuccess) return err;
  const EpiFc2Residual epi{static_cast<const __nv_bfloat16*>(b2),
                           static_cast<const __nv_bfloat16*>(gamma)};
  return wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kKMajor, wgbf::kNoB, false>(
      M, C, F, hb, w2, nullptr, nullptr, &out, x, epi, grid2, s);
}
