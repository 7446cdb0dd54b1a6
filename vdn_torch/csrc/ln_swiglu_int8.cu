// F5: fp32 LayerNorm -> int8 w12 -> silu(x1) * x2 (fp32) -> int8 w3 ->
// x LayerScale -> + residual, the W8A8 tail of vitg's SwiGLU block.
//
// Replaces vdn/ops/pallas/int8.py fused_ln_swiglu_residual_int8
// (_ln_swiglu_int8_kernel through _call_3d's pallas_call) at rows = frames
// * 1370, C 1536, F 4096 (w12 [2F, C] = [gate | value], w3 [C, F]), bf16.
// The TPU kernel keeps both int8 weights (12 MB + 6 MB) in VMEM and pairs
// gate chunk j with value chunk j in registers; a Hopper block cannot hold
// them, so the tail runs as F4's four stages (ln_mlp_int8.cu), the
// products on the wgmma + TMA core (int8_wgmma.cuh):
//   1. ln_quant_rows_kernel (int8_tail.cuh): LayerNorm in fp32, per-row
//      quantization of the fp32 output (no bf16 round), int8 yq [rows, C]
//      and sy [rows], the row's two absmax slots of stage 2 zeroed;
//   2. w12 in the core's paired mode: a 128 x 128 tile holds the gate
//      columns [j, j + 64) and the value columns [F + j, F + j + 64) of
//      128 rows (two 64-row TMA boxes of w12 in one B stage, no permuted
//      copy of the weight), so gate column c and value column F + c land in
//      one thread; the epilogue, in the two epilogue warpgroups, forms x1 =
//      (acc * sy) * s12 + b12, x2 likewise, and h = x1 * sig * x2 with sig
//      = 1 / (1 + exp2(x1 * -log2 e)) (int8.py:319-327: a true division,
//      exp2f, no FMA contraction), written in fp32 [rows, F], and the
//      absmax of h per (row, F / 2 chunk), vdn's _F_CHUNKS = 2, by
//      atomicMax on the bits of |h|; a 64-column tile lies in one chunk
//      (F / 2 is a multiple of 64);
//   3. quant_hidden_kernel: hq = round(h / s), int8 [rows, F], sh [rows, 2];
//   4. w3 on 128 x 128 (or 128 x 64: the plan, int8.f5_plan) tiles, whose
//      K loop dequantizes chunk 0, (acc0 * sh0) * s3, into fp32 before
//      chunk 1 adds its own; then + b3 and x + bf16(o * gamma), x's tile
//      staged and the output stored by TMA.
// Bound by the two products, 6 * rows * C * F int8 operations (0.575 ms per
// layer for the cached window at 1979 TOP/s); the fp32 hidden round trip
// (rows * F * 4 bytes out and back, plus its int8 copy) is the price of not
// keeping h on chip, as in F4.
#include "int8_tail.cuh"

namespace {

constexpr int kBN1 = 128;  // w12's tile width: 64 gate + 64 value columns

// w12's epilogue over an epilogue thread's values of a paired tile: v[4i +
// e] for i < 8 are gate columns n + 8 i + e % 2, v[4 (i + 8) + e] the value
// columns of the same outputs; h = silu(x1) * x2 in fp32, and the absmax of
// each (row, chunk) over the thread's columns and the four lanes of a row.
struct EpiSwigluHidden {
  const float* b;  // [2F]: gate bias, then value bias
  float* h;        // [M, F]
  unsigned* amax;  // [M, 2]
  int F;
  __device__ static float swiglu(float x1, float x2) {
    const float sig = __fdiv_rn(
        1.f, __fadd_rn(1.f, exp2f(__fmul_rn(x1, -1.4426950408889634f))));
    return __fmul_rn(__fmul_rn(x1, sig), x2);
  }
  template <int kR>
  __device__ __forceinline__ void operator()(const float (&v)[kR], int m,
                                             int n, int M) const {
    constexpr int kHalf = kR / 2;
    float mx[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kHalf / 4; ++i) {
      const int c = n + 8 * i;
      const float bg0 = b[c], bg1 = b[c + 1];
      const float bv0 = b[F + c], bv1 = b[F + c + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int g = 4 * i + 2 * r, u = kHalf + g;
        const float h0 = swiglu(__fadd_rn(v[g], bg0), __fadd_rn(v[u], bv0));
        const float h1 =
            swiglu(__fadd_rn(v[g + 1], bg1), __fadd_rn(v[u + 1], bv1));
        mx[r] = fmaxf(mx[r], fmaxf(fabsf(h0), fabsf(h1)));
        if (m + 8 * r < M)
          *reinterpret_cast<float2*>(h + (size_t)(m + 8 * r) * F + c) =
              make_float2(h0, h1);
      }
    }
    const int chunk = n / (F / 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if ((threadIdx.x & 3) == 0 && m + 8 * r < M)
        atomicMax(amax + (size_t)(m + 8 * r) * 2 + chunk,
                  __float_as_uint(mx[r]));
    }
  }
};

}  // namespace

// x, out [M, C] bf16; ln_w, ln_b [C] fp32; w12q [2F, C], w3q [C, F] int8;
// s12, b12 [2F], s3, b3, gamma [C] fp32; scratch: yq [M, C] int8, sy [M],
// h [M, F] fp32, amax [M, 2] fp32, hq [M, F] int8, sh [M, 2] fp32.  C %
// 128 == 0, C <= 2048 and F % 256 == 0.  bn2 (128 or 64) is w3's tile
// width, grid1 and grid2 the persistent blocks of w12 and w3.
extern "C" int vdn_ln_swiglu_int8(const void* x, int M, int C, int F,
                                  const void* ln_w, const void* ln_b,
                                  float eps, const void* w12q,
                                  const void* s12, const void* b12,
                                  const void* w3q, const void* s3,
                                  const void* b3, const void* gamma,
                                  void* yq, void* sy, void* h, void* amax,
                                  void* hq, void* sh, void* out, int bn2,
                                  int grid1, int grid2, void* stream) {
  if (M < 1 || F % (2 * kBN1) || C % vdn::wg::kBK || C > 2048 ||
      (bn2 != 128 && bn2 != 64))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* y8 = static_cast<int8_t*>(yq);
  auto* h8 = static_cast<int8_t*>(hq);
  auto* hf = static_cast<float*>(h);
  auto* am = static_cast<unsigned*>(amax);
  auto* sc = static_cast<float*>(sy);
  auto* scale = static_cast<float*>(sh);
  cudaError_t err = launch_rows(xb, M, C, static_cast<const float*>(ln_w),
                                static_cast<const float*>(ln_b), eps, y8, sc,
                                am, s);
  if (err != cudaSuccess) return err;
  err = vdn::wg::launch_gemm_s8_wgmma<kBN1, 1, true, true>(
      M, F, C, y8, static_cast<const int8_t*>(w12q), sc,
      static_cast<const float*>(s12),
      EpiSwigluHidden{static_cast<const float*>(b12), hf, am, F}, grid1, s);
  if (err != cudaSuccess) return err;
  err = launch_quant_hidden(hf, am, M, F, h8, scale, s);
  if (err != cudaSuccess) return err;
  const EpiI8Residual epi{static_cast<const float*>(b3),
                          static_cast<const float*>(gamma)};
  return launch_fc2(bn2, M, C, F, h8, static_cast<const int8_t*>(w3q), scale,
                    static_cast<const float*>(s3), epi, xb,
                    static_cast<__nv_bfloat16*>(out), grid2, s);
}
