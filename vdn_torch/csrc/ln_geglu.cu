// A4: fused LayerNorm -> net_0 -> hidden * gelu(gate) -> net_2 -> + b2 + x.
//
// Replaces vdn/ops/pallas/geglu.py fused_ln_geglu_residual (_geglu_kernel
// via _geglu_pallas), the motion-module feed-forward tail at rows =
// tokens * 32 frames (43808 or 175232 rows), C = 1024 or 256, F = 4C, bf16.
//
// Bound on the H100 by the two products (6 * rows * C * F FLOP).  The TPU
// kernel kept w0 [C, 2F] and w2 [F, C] resident in VMEM; here they are
// tiled, in three launches:
//   1. row_stats_kernel: fp32 mean / rstd per row;
//   2. gemm_tile in its dual mode with the LayerNorm prologue: each block
//      multiplies the matching column tiles of both halves of w0 (hidden
//      column j and gate column F + j land in the same thread), and the
//      GEGLU epilogue writes h = hidden * gelu(gate) [rows, F] bf16;
//   3. gemm_tile on h with a + x, + b2 epilogue.
// Rounding as geglu.py:49-65: hidden and gate rounded to bf16, each + its
// bias in bf16, hidden * gelu(gate) in fp32 (tanh-form GELU, the bf16
// flavour) rounded to bf16; the net_2 sum rounded, then (x + o) + b2 in bf16.
#include "gemm_tile.cuh"

namespace {

using vdn::bf16r;
using vdn::bf2f;

struct EpiGeglu {
  const __nv_bfloat16* b0;  // [2F]
  __nv_bfloat16* out;       // [M, F]
  int F;
  __device__ void operator()(int m, int n, float h0, float h1, float g0,
                             float g1) const {
    const float hid0 = bf16r(bf16r(h0) + bf2f(b0[n]));
    const float hid1 = bf16r(bf16r(h1) + bf2f(b0[n + 1]));
    const float gate0 = bf16r(bf16r(g0) + bf2f(b0[F + n]));
    const float gate1 = bf16r(bf16r(g1) + bf2f(b0[F + n + 1]));
    *reinterpret_cast<uint32_t*>(out + (size_t)m * F + n) =
        vdn::pack_bf16(hid0 * vdn::gelu_tanh(gate0),
                       hid1 * vdn::gelu_tanh(gate1));
  }
};

struct EpiResidualBias {
  const __nv_bfloat16* b;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const size_t i = (size_t)m * ld + n;
    const float2 xv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + i));
    *reinterpret_cast<uint32_t*>(out + i) =
        vdn::pack_bf16(bf16r(xv.x + bf16r(v0)) + bf2f(b[n]),
                       bf16r(xv.y + bf16r(v1)) + bf2f(b[n + 1]));
  }
};

}  // namespace

// x, out [M, C]; w0 [2F, C]; b0 [2F]; w2 [C, F]; b2 [C] bf16;
// ln_w, ln_b [C] fp32; scratch: mean, rstd [M] fp32, h [M, F] bf16.
extern "C" int vdn_ln_geglu_residual(const void* x, int M, int C, int F,
                                     const void* ln_w, const void* ln_b,
                                     const void* w0, const void* b0,
                                     const void* w2, const void* b2,
                                     float eps, void* mean, void* rstd,
                                     void* h, void* out, void* stream) {
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
  err = vdn::launch_gemm<true>(
      M, F, C, xb, C, static_cast<const __nv_bfloat16*>(w0), ln,
      EpiGeglu{static_cast<const __nv_bfloat16*>(b0), hb, F}, s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm<false>(
      M, C, F, hb, F, static_cast<const __nv_bfloat16*>(w2),
      vdn::ProIdentity{},
      EpiResidualBias{static_cast<const __nv_bfloat16*>(b2), xb,
                      static_cast<__nv_bfloat16*>(out), C},
      s);
}
