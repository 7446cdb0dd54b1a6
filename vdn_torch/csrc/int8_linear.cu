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
// Two launches each: quant_rows_kernel writes the int8 rows [rows, C] and
// their fp32 scales (the TPU kernel quantizes in VMEM and never writes
// them; here they cost rows * C bytes out and back, a third of x's bf16
// bytes), then gemm_s8 with the dequantization in its epilogue.  F1 / F2
// are bound by the product (2 * rows * C * F int8 operations: 0.096 ms at
// 1979 TOP/s for the cached window's qkv); F3's product is a third of
// that, and its bytes (x, the residual and the output in bf16) bound it.
// Rounding points as vdn's: the LayerNorm output is quantized in fp32 with
// no bf16 round; the output rounds once to bf16 (F1 / F2), or the gamma
// product rounds to bf16 before the bf16 residual add (F3).
#include "int8_gemm.cuh"

namespace {

struct EpiI8Bias {
  const float* b;
  __nv_bfloat16* out;
  int ldo;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)m * ldo + n) =
        vdn::pack_bf16(__fadd_rn(v0, b[n]), __fadd_rn(v1, b[n + 1]));
  }
};

}  // namespace

// F1 (ln_w, ln_b given) or F2 (both null): x [M, C] bf16, wq [F, C] int8,
// sw, b [F] fp32, ln_w, ln_b [C] fp32; scratch xq [M, C] int8, sx [M] fp32;
// out [M, F] bf16.
extern "C" int vdn_int8_ln_linear(const void* x, int M, int C, int F,
                                  const void* ln_w, const void* ln_b,
                                  float eps, const void* wq, const void* sw,
                                  const void* b, void* xq, void* sx,
                                  void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* q = static_cast<int8_t*>(xq);
  auto* sc = static_cast<float*>(sx);
  cudaError_t err =
      ln_w != nullptr
          ? vdn::launch_quant_rows<true>(
                xb, M, C, static_cast<const float*>(ln_w),
                static_cast<const float*>(ln_b), eps, q, sc, s)
          : vdn::launch_quant_rows<false>(
                xb, M, C, nullptr, nullptr, 0.f, q, sc, s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm_s8(
      M, F, C, q, C, static_cast<const int8_t*>(wq), sc,
      static_cast<const float*>(sw),
      EpiI8Bias{static_cast<const float*>(b),
                static_cast<__nv_bfloat16*>(out), F},
      s);
}

// F3: x, res, out [M, F == C] bf16 (res may not alias out), wq [F, C] int8,
// sw, b, gamma [F] fp32; scratch xq [M, C] int8, sx [M] fp32.
extern "C" int vdn_int8_proj_residual(const void* x, const void* res, int M,
                                      int C, int F, const void* wq,
                                      const void* sw, const void* b,
                                      const void* gamma, void* xq, void* sx,
                                      void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<int8_t*>(xq);
  auto* sc = static_cast<float*>(sx);
  cudaError_t err = vdn::launch_quant_rows<false>(
      static_cast<const __nv_bfloat16*>(x), M, C, nullptr, nullptr, 0.f,
      q, sc, s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm_s8(
      M, F, C, q, C, static_cast<const int8_t*>(wq), sc,
      static_cast<const float*>(sw),
      vdn::EpiI8Residual{static_cast<const float*>(b),
                         static_cast<const float*>(gamma),
                         static_cast<const __nv_bfloat16*>(res),
                         static_cast<__nv_bfloat16*>(out), F},
      s);
}
