// A2: fused LayerNorm -> fc1 -> GELU -> fc2 -> x LayerScale -> + residual.
//
// Replaces vdn/ops/pallas/mlp.py fused_ln_mlp_residual (_ln_mlp_kernel via
// _ln_mlp_pallas3 / _ln_mlp_pallas), the ViT-L block tail
// x + gamma * fc2(gelu(fc1(LN(x)) + b1)) + b2 at rows = frames * 1370,
// C = 1024, F = 4096, bf16.
//
// Bound on the H100 by the two products (4 * rows * C * F FLOP; the bytes
// are x in and out plus a [rows, F] hidden round trip).  The TPU kernel
// kept W1 and W2 (8 MB each in bf16) resident in VMEM and never wrote the
// hidden activations; a Hopper block holds 227 KB, so the port splits the
// tail into three launches:
//   1. row_stats_kernel: fp32 mean / rstd per row;
//   2. gemm_tile with the LayerNorm prologue and a +b1, GELU epilogue,
//      writing h [rows, F] bf16 (the TPU kernel's rounding point anyway);
//   3. gemm_tile on h with a +b2, x gamma, + x epilogue.
// The hidden round trip costs 2 * rows * F * 2 bytes (~0.5 GB per vitl
// window layer), small next to the 0.5 TFLOP of the two products.
// Rounding points as mlp.py:137-149: h rounded to bf16, + b1 in bf16, GELU
// (tanh form, the bf16 flavour) in fp32 rounded to bf16; o rounded, + b2,
// then x + o * gamma in bf16.
#include "gemm_tile.cuh"

namespace {

using vdn::bf16r;
using vdn::bf2f;

struct EpiBiasGelu {
  const __nv_bfloat16* b;
  __nv_bfloat16* out;
  int ldo;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const float h0 = bf16r(bf16r(v0) + bf2f(b[n]));
    const float h1 = bf16r(bf16r(v1) + bf2f(b[n + 1]));
    *reinterpret_cast<uint32_t*>(out + (size_t)m * ldo + n) =
        vdn::pack_bf16(vdn::gelu_tanh(h0), vdn::gelu_tanh(h1));
  }
};

struct EpiBiasScaleResidual {
  const __nv_bfloat16* b;
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const size_t i = (size_t)m * ld + n;
    const float2 xv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + i));
    const float o0 = bf16r(bf16r(v0) + bf2f(b[n]));
    const float o1 = bf16r(bf16r(v1) + bf2f(b[n + 1]));
    *reinterpret_cast<uint32_t*>(out + i) =
        vdn::pack_bf16(xv.x + bf16r(o0 * bf2f(gamma[n])),
                       xv.y + bf16r(o1 * bf2f(gamma[n + 1])));
  }
};

}  // namespace

// x, out [M, C]; w1 [F, C]; w2 [C, F]; b1 [F], b2, gamma [C] bf16;
// ln_w, ln_b [C] fp32; scratch: mean, rstd [M] fp32, h [M, F] bf16.
extern "C" int vdn_ln_mlp_residual(const void* x, int M, int C, int F,
                                   const void* ln_w, const void* ln_b,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* b2,
                                   const void* gamma, float eps, void* mean,
                                   void* rstd, void* h, void* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  cudaError_t err = vdn::launch_row_stats(xb, M, C, eps,
                                          static_cast<float*>(mean),
                                          static_cast<float*>(rstd), s);
  if (err != cudaSuccess) return err;
  vdn::ProLayerNorm ln{static_cast<const float*>(mean),
                       static_cast<const float*>(rstd),
                       static_cast<const float*>(ln_w),
                       static_cast<const float*>(ln_b)};
  err = vdn::launch_gemm<false>(
      M, F, C, xb, C, static_cast<const __nv_bfloat16*>(w1), ln,
      EpiBiasGelu{static_cast<const __nv_bfloat16*>(b1), hb, F}, s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm<false>(
      M, C, F, hb, F, static_cast<const __nv_bfloat16*>(w2),
      vdn::ProIdentity{},
      EpiBiasScaleResidual{static_cast<const __nv_bfloat16*>(b2),
                           static_cast<const __nv_bfloat16*>(gamma), xb,
                           static_cast<__nv_bfloat16*>(out), C},
      s);
}
