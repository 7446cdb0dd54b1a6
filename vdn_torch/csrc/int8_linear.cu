// F1 / F2: LayerNorm (or nothing) -> per-row int8 quantization -> int8
// product -> (acc * sx) * sw + b; and F3: the same without the LayerNorm
// -> residual + bf16(((acc * sx) * sw + b) * gamma).
//
// Replaces vdn/ops/pallas/int8.py int8_ln_linear (_ln_linear_kernel, the
// encoder's qkv projection with LN1 inside), int8_linear (_linear_kernel)
// and int8_proj_residual (_proj_residual_kernel, the out-projection with
// LayerScale and the block residual), all through _call_3d's pallas_call.
// vitl: rows = frames * 1370, C 1024, F 3072 (qkv) or 1024 (proj), bf16.
//
// Two launches each, on the wgmma + TMA core as F4's stages run
// (int8_tail.cuh, int8_wgmma.cuh): a row kernel, ln_quant_rows_kernel
// (the row held in registers, read once; F1 with the LayerNorm and its
// caller tag F1Rows, F2 and F3 without), writes the int8 rows [rows, C]
// and their fp32 scales (the TPU kernel quantizes in VMEM and never writes
// them; here they cost rows * C bytes out and back, a third of x's bf16
// bytes); then the product in persistent 128 x 128 tiles with one K chunk
// (a scale per row) and the dequantization in its inline epilogue, the
// output tile staged in shared memory and stored by TMA.  F1 / F2's
// epilogue adds the bias (EpiI8Linear, no residual); F3's loads res's tile
// by TMA first and adds it (EpiI8Residual).  The grids are the Python
// plan's (int8.py linear_plan).  F1 is bound by its product (2 * rows * C
// * F int8 operations: 0.096 ms at 1979 TOP/s for the cached window's
// qkv), F3, a third of F1's product, by its bytes (x, the residual and the
// output in bf16).
// Rounding points as vdn's: the LayerNorm output is quantized in fp32 with
// no bf16 round; the output rounds once to bf16 (F1 / F2), or the gamma
// product rounds to bf16 before the bf16 residual add (F3).
#include "int8_tail.cuh"

namespace {

struct F1Rows {};  // the row kernel's caller tag

// bf16(v + b), F1's and F2's epilogue (int8.py _ln_linear_kernel,
// _linear_kernel): no residual
struct EpiI8Linear {
  static constexpr bool kResidual = false;
  const float* b;
  __device__ __forceinline__ float2 col(int n) const {
    return make_float2(b[n], b[n + 1]);
  }
  __device__ __forceinline__ uint32_t operator()(float2 c, float v0,
                                                 float v1) const {
    return vdn::pack_bf16(__fadd_rn(v0, c.x), __fadd_rn(v1, c.y));
  }
};

}  // namespace

// F1 (ln_w, ln_b given) or F2 (both null): x [M, C] bf16, wq [F, C] int8,
// sw, b [F] fp32, ln_w, ln_b [C] fp32; scratch xq [M, C] int8, sx [M] fp32;
// out [M, F] bf16.  C % 128 == 0, C <= 2048, F % 128 == 0; grid the
// persistent blocks.
extern "C" int vdn_int8_ln_linear(const void* x, int M, int C, int F,
                                  const void* ln_w, const void* ln_b,
                                  float eps, const void* wq, const void* sw,
                                  const void* b, void* xq, void* sx,
                                  void* out, int grid, void* stream) {
  if (M < 1 || C % vdn::wg::kBK || C > 2048 || F % 128)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* q = static_cast<int8_t*>(xq);
  auto* sc = static_cast<float*>(sx);
  cudaError_t err =
      ln_w != nullptr
          ? launch_rows<true, F1Rows>(xb, M, C,
                                      static_cast<const float*>(ln_w),
                                      static_cast<const float*>(ln_b), eps,
                                      q, sc, nullptr, s)
          : launch_rows<false>(xb, M, C, nullptr, nullptr, 0.f, q, sc,
                               nullptr, s);
  if (err != cudaSuccess) return err;
  return vdn::wg::launch_gemm_s8_wgmma<128, 1, false>(
      M, F, C, q, static_cast<const int8_t*>(wq), sc,
      static_cast<const float*>(sw),
      EpiI8Linear{static_cast<const float*>(b)}, grid, s, nullptr, out);
}

// F3: x, res, out [M, C] bf16 (res may not alias out), wq [C, C] int8,
// sw, b, gamma [C] fp32; scratch xq [M, C] int8, sx [M] fp32.  C % 128 ==
// 0, C <= 2048; grid the persistent blocks.
extern "C" int vdn_int8_proj_residual(const void* x, const void* res, int M,
                                      int C, const void* wq, const void* sw,
                                      const void* b, const void* gamma,
                                      void* xq, void* sx, void* out, int grid,
                                      void* stream) {
  if (M < 1 || C % vdn::wg::kBK || C > 2048) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<int8_t*>(xq);
  auto* sc = static_cast<float*>(sx);
  cudaError_t err = launch_rows<false>(static_cast<const __nv_bfloat16*>(x),
                                       M, C, nullptr, nullptr, 0.f, q, sc,
                                       nullptr, s);
  if (err != cudaSuccess) return err;
  const EpiI8Residual epi{static_cast<const float*>(b),
                          static_cast<const float*>(gamma)};
  return launch_fc2_at<128, 1>(M, C, C, q, static_cast<const int8_t*>(wq),
                               sc, static_cast<const float*>(sw), epi,
                               static_cast<const __nv_bfloat16*>(res),
                               static_cast<__nv_bfloat16*>(out), grid, s);
}
