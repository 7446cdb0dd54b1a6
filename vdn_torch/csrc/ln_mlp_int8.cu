// F4: fp32 LayerNorm -> int8 fc1 -> GELU (fp32) -> int8 fc2 ->
// x LayerScale -> + residual, the W8A8 ViT block tail.
//
// Replaces vdn/ops/pallas/int8.py fused_ln_mlp_residual_int8
// (_ln_mlp_int8_kernel through _call_3d's pallas_call) at rows = frames *
// 1370, C 1024, F 4096, bf16.  The TPU kernel keeps both int8 weights in
// VMEM and the hidden activations in registers; a Hopper block cannot hold
// 4 MB of weights, so the tail runs as four launches:
//   1. quant_rows_kernel: LayerNorm in fp32, per-row quantization of the
//      fp32 output (no bf16 round), int8 yq [rows, C] and sy [rows];
//   2. gemm_s8 (fc1) with the epilogue h = gelu((acc * sy) * s1 + b1),
//      written in fp32 [rows, F] (the tanh form, the bf16 flavour of
//      vdn/ops/pallas/mlp.py _gelu_fast_f32);
//   3. quant_rows_kernel on h with two segments: the per-(row, F / 2 chunk)
//      scales of vdn's _F_CHUNKS = 2, int8 hq [rows, F] and sh [rows, 2];
//   4. gemm_s8 (fc2) whose K loop stops at F / 2 to dequantize chunk 0,
//      (acc0 * sh0) * s2, into an fp32 sum before chunk 1 adds its own;
//      then + b2 and x + bf16(o * gamma) (int8.py:201-215).
// Bound by the two products, 4 * rows * C * F int8 operations (0.256 ms
// per layer for the cached window at 1979 TOP/s); the fp32 hidden round
// trip (rows * F * 4 bytes out and back, plus its int8 copy) costs about
// 1.2 GB per window layer, which makes the tail bytes-bound in this form.
#include "int8_gemm.cuh"

namespace {

using vdn::bf16r;

struct EpiI8Gelu {
  const float* b;
  float* h;
  int ldh;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<float2*>(h + (size_t)m * ldh + n) =
        make_float2(vdn::gelu_tanh(__fadd_rn(v0, b[n])),
                    vdn::gelu_tanh(__fadd_rn(v1, b[n + 1])));
  }
};

struct EpiI8MlpResidual {
  const float* b;
  const float* gamma;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const size_t i = (size_t)m * ld + n;
    const float2 xv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + i));
    const float o0 = __fmul_rn(__fadd_rn(v0, b[n]), gamma[n]);
    const float o1 = __fmul_rn(__fadd_rn(v1, b[n + 1]), gamma[n + 1]);
    *reinterpret_cast<uint32_t*>(out + i) =
        vdn::pack_bf16(xv.x + bf16r(o0), xv.y + bf16r(o1));
  }
};

}  // namespace

// x, out [M, C] bf16; ln_w, ln_b [C] fp32; w1q [F, C], w2q [C, F] int8;
// s1, b1 [F], s2, b2, gamma [C] fp32; scratch: yq [M, C] int8, sy [M],
// h [M, F] fp32, hq [M, F] int8, sh [M, 2] fp32.  F % 128 == 0.
extern "C" int vdn_ln_mlp_int8(const void* x, int M, int C, int F,
                               const void* ln_w, const void* ln_b, float eps,
                               const void* w1q, const void* s1,
                               const void* b1, const void* w2q,
                               const void* s2, const void* b2,
                               const void* gamma, void* yq, void* sy,
                               void* h, void* hq, void* sh, void* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* y8 = static_cast<int8_t*>(yq);
  auto* h8 = static_cast<int8_t*>(hq);
  auto* hf = static_cast<float*>(h);
  cudaError_t err = vdn::launch_quant_rows<__nv_bfloat16, true>(
      xb, M, C, 1, static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), eps, y8, static_cast<float*>(sy), s);
  if (err != cudaSuccess) return err;
  err = vdn::launch_gemm_s8<1>(
      M, F, C, y8, C, static_cast<const int8_t*>(w1q),
      static_cast<const float*>(sy), static_cast<const float*>(s1),
      EpiI8Gelu{static_cast<const float*>(b1), hf, F}, s);
  if (err != cudaSuccess) return err;
  err = vdn::launch_quant_rows<float, false>(hf, M, F, 2, nullptr, nullptr,
                                             0.f, h8, static_cast<float*>(sh),
                                             s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm_s8<2>(
      M, C, F, h8, F, static_cast<const int8_t*>(w2q),
      static_cast<const float*>(sh), static_cast<const float*>(s2),
      EpiI8MlpResidual{static_cast<const float*>(b2),
                       static_cast<const float*>(gamma), xb,
                       static_cast<__nv_bfloat16*>(out), C},
      s);
}
