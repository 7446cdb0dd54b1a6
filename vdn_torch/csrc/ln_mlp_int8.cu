// F4: fp32 LayerNorm -> int8 fc1 -> GELU (fp32) -> int8 fc2 ->
// x LayerScale -> + residual, the W8A8 ViT block tail.
//
// Replaces vdn/ops/pallas/int8.py fused_ln_mlp_residual_int8
// (_ln_mlp_int8_kernel through _call_3d's pallas_call) at rows = frames *
// 1370, C 1024, F 4096, bf16.  The TPU kernel keeps both int8 weights in
// VMEM and the hidden activations in registers; a Hopper block cannot hold
// 4 MB of weights, so the tail runs as four stages, the products on the
// wgmma + TMA core (int8_wgmma.cuh):
//   1. ln_quant_rows_kernel (int8_tail.cuh, as stages 3 and 4): LayerNorm in fp32, per-row quantization of
//      the fp32 output (no bf16 round), int8 yq [rows, C] and sy [rows],
//      and the row's two absmax slots of stage 2 zeroed; one warp per
//      row, the row read once and held in registers;
//   2. fc1 on 128 x 128 tiles with the epilogue h = gelu((acc * sy) * s1 +
//      b1) (the tanh form, the bf16 flavour of vdn/ops/pallas/mlp.py
//      _gelu_fast_f32), written in fp32 [rows, F], and the absmax of h per
//      (row, F / 2 chunk), vdn's _F_CHUNKS = 2, by atomicMax on the bits of
//      |h|, which order as their unsigned ints; the epilogue (about 40
//      instructions a value, more than the tile's products take) runs in
//      two warpgroups of its own while the consumers go on to the next
//      tile;
//   3. quant_hidden_kernel: hq = round(h / s), s = max(amax / 127, 1e-30),
//      int8 [rows, F] and sh [rows, 2], h read once;
//   4. fc2 on 128 x 128 tiles (128 x 64 when 128 x 128 would leave SMs
//      idle: the Python wrapper's plan), whose K loop dequantizes chunk 0,
//      (acc0 * sh0) * s2, into fp32 before chunk 1 adds its own; then + b2
//      and x + bf16(o * gamma) (int8.py:201-215).
// Bound by the two products, 4 * rows * C * F int8 operations (0.256 ms
// per layer for the cached window at 1979 TOP/s).  The fp32 hidden costs
// 1.1 GB a layer (written, read back, its int8 copy written), 0.33 ms at
// 3.35 TB/s; running fc1 a second time to quantize in its epilogue in
// place of stage 3 kept it out of device memory but cost more (a second
// GELU epilogue).  On the card fc1's epilogue, not its products, sets
// fc1's pace: its GELU and its fp32 stores add to the products' time
// (PERF.md, section 6).
#include "int8_tail.cuh"

namespace {

constexpr int kBN1 = 128;  // fc1's tile width

// fc1's epilogue over an epilogue thread's values of a tile: h =
// gelu(v + b1) written in fp32, and the absmax of each (row, chunk), over
// the thread's columns and then the four lanes of a row, into amax (fp32
// bits).  F / 2 is a multiple of the tile width, so a tile lies in one
// chunk.
struct EpiHidden {
  const float* b;
  float* h;        // [M, F]
  unsigned* amax;  // [M, 2]
  int F;
  template <int kR>
  __device__ __forceinline__ void operator()(const float (&v)[kR], int m,
                                             int n, int M) const {
    float mx[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kR / 4; ++i) {
      const int c = n + 8 * i;
      const float b0 = b[c], b1 = b[c + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float h0 = vdn::gelu_tanh(__fadd_rn(v[4 * i + 2 * r], b0));
        const float h1 = vdn::gelu_tanh(__fadd_rn(v[4 * i + 2 * r + 1], b1));
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

// x, out [M, C] bf16; ln_w, ln_b [C] fp32; w1q [F, C], w2q [C, F] int8;
// s1, b1 [F], s2, b2, gamma [C] fp32; scratch: yq [M, C] int8, sy [M],
// h [M, F] fp32, amax [M, 2] fp32, hq [M, F] int8, sh [M, 2] fp32.  C %
// 128 == 0, C <= 2048 and F % 256 == 0.  bn2 (128 or 64) is fc2's tile
// width, grid1 and grid2 the persistent blocks of fc1 and fc2.
extern "C" int vdn_ln_mlp_int8(const void* x, int M, int C, int F,
                               const void* ln_w, const void* ln_b, float eps,
                               const void* w1q, const void* s1,
                               const void* b1, const void* w2q,
                               const void* s2, const void* b2,
                               const void* gamma, void* yq, void* sy,
                               void* h, void* amax, void* hq, void* sh,
                               void* out, int bn2, int grid1, int grid2,
                               void* stream) {
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
  const auto* w = static_cast<const float*>(ln_w);
  const auto* b = static_cast<const float*>(ln_b);
  cudaError_t err = launch_rows(xb, M, C, w, b, eps, y8, sc, am, s);
  if (err != cudaSuccess) return err;
  err = vdn::wg::launch_gemm_s8_wgmma<kBN1, 1, true>(
      M, F, C, y8, static_cast<const int8_t*>(w1q), sc,
      static_cast<const float*>(s1),
      EpiHidden{static_cast<const float*>(b1), hf, am, F}, grid1, s);
  if (err != cudaSuccess) return err;
  err = launch_quant_hidden(hf, am, M, F, h8, scale, s);
  if (err != cudaSuccess) return err;
  const vdn::EpiI8Residual epi{static_cast<const float*>(b2),
                               static_cast<const float*>(gamma), xb,
                               static_cast<__nv_bfloat16*>(out), C};
  return launch_fc2(bn2, M, C, F, h8, static_cast<const int8_t*>(w2q),
                    scale, static_cast<const float*>(s2), epi, grid2, s);
}
