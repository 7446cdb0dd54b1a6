// F5: fp32 LayerNorm -> int8 w12 -> silu(x1) * x2 (fp32) -> int8 w3 ->
// x LayerScale -> + residual, the W8A8 tail of vitg's SwiGLU block.
//
// Replaces vdn/ops/pallas/int8.py fused_ln_swiglu_residual_int8
// (_ln_swiglu_int8_kernel through _call_3d's pallas_call) at rows = frames
// * 1370, C 1536, F 4096 (w12 [2F, C] = [gate | value], w3 [C, F]), bf16.
// The TPU kernel keeps both int8 weights (12 MB + 6 MB) in VMEM and pairs
// gate chunk j with value chunk j in registers; a Hopper block cannot hold
// them, so the tail runs as four launches, F4's plan (ln_mlp_int8.cu):
//   1. quant_rows_kernel: LayerNorm in fp32, per-row quantization of the
//      fp32 output (no bf16 round), int8 yq [rows, C] and sy [rows];
//   2. gemm_s8 in its dual mode on w12: each block multiplies the matching
//      column tiles of both halves, so gate column j and value column F + j
//      land in one thread; the epilogue forms x1 = (acc * sy) * s12 + b12,
//      x2 likewise, and h = x1 * sig * x2 with sig = 1 / (1 + exp2(x1 *
//      -log2 e)) (int8.py:319-327: a true division, exp2f, no FMA
//      contraction), written in fp32 [rows, F];
//   3. quant_rows_kernel on h with two segments: the per-(row, F / 2 chunk)
//      scales of vdn's _F_CHUNKS = 2 (int8.py:339-353 chunks whenever
//      F % 2 == 0), int8 hq [rows, F] and sh [rows, 2];
//   4. gemm_s8 on w3 whose K loop stops at F / 2 to dequantize chunk 0,
//      (acc0 * sh0) * s3, into an fp32 sum before chunk 1 adds its own;
//      then + b3 and x + bf16(o * gamma).
// Bound by the two products, 6 * rows * C * F int8 operations (0.575 ms per
// layer for the cached window at 1979 TOP/s); the fp32 hidden round trip
// (rows * F * 4 bytes out and back, plus its int8 copy) is the price of not
// keeping h on chip, as in F4.
#include "int8_gemm.cuh"

namespace {

struct EpiI8Swiglu {
  const float* b;  // [2F]: gate bias, then value bias
  float* h;        // [M, F]
  int F;
  __device__ static float swiglu(float x1, float x2) {
    const float sig = __fdiv_rn(
        1.f, __fadd_rn(1.f, exp2f(__fmul_rn(x1, -1.4426950408889634f))));
    return __fmul_rn(__fmul_rn(x1, sig), x2);
  }
  __device__ void operator()(int m, int n, float g0, float g1, float v0,
                             float v1) const {
    *reinterpret_cast<float2*>(h + (size_t)m * F + n) = make_float2(
        swiglu(__fadd_rn(g0, b[n]), __fadd_rn(v0, b[F + n])),
        swiglu(__fadd_rn(g1, b[n + 1]), __fadd_rn(v1, b[F + n + 1])));
  }
};

}  // namespace

// x, out [M, C] bf16; ln_w, ln_b [C] fp32; w12q [2F, C], w3q [C, F] int8;
// s12, b12 [2F], s3, b3, gamma [C] fp32; scratch: yq [M, C] int8, sy [M],
// h [M, F] fp32, hq [M, F] int8, sh [M, 2] fp32.  F % 128 == 0.
extern "C" int vdn_ln_swiglu_int8(const void* x, int M, int C, int F,
                                  const void* ln_w, const void* ln_b,
                                  float eps, const void* w12q,
                                  const void* s12, const void* b12,
                                  const void* w3q, const void* s3,
                                  const void* b3, const void* gamma,
                                  void* yq, void* sy, void* h, void* hq,
                                  void* sh, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 128) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* y8 = static_cast<int8_t*>(yq);
  auto* h8 = static_cast<int8_t*>(hq);
  auto* hf = static_cast<float*>(h);
  cudaError_t err = vdn::launch_quant_rows<__nv_bfloat16, true>(
      xb, M, C, 1, static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), eps, y8, static_cast<float*>(sy), s);
  if (err != cudaSuccess) return err;
  err = vdn::launch_gemm_s8<1, true>(
      M, F, C, y8, C, static_cast<const int8_t*>(w12q),
      static_cast<const float*>(sy), static_cast<const float*>(s12),
      EpiI8Swiglu{static_cast<const float*>(b12), hf, F}, s);
  if (err != cudaSuccess) return err;
  err = vdn::launch_quant_rows<float, false>(hf, M, F, 2, nullptr, nullptr,
                                             0.f, h8, static_cast<float*>(sh),
                                             s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm_s8<2>(
      M, C, F, h8, F, static_cast<const int8_t*>(w3q),
      static_cast<const float*>(sh), static_cast<const float*>(s3),
      vdn::EpiI8Residual{static_cast<const float*>(b3),
                         static_cast<const float*>(gamma), xb,
                         static_cast<__nv_bfloat16*>(out), C},
      s);
}
