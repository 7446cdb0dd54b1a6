// F4: fp32 LayerNorm -> int8 fc1 -> GELU (fp32) -> int8 fc2 ->
// x LayerScale -> + residual, the W8A8 ViT block tail.
//
// Replaces vdn/ops/pallas/int8.py fused_ln_mlp_residual_int8
// (_ln_mlp_int8_kernel through _call_3d's pallas_call) at rows = frames *
// 1370, C 1024, F 4096, bf16.  The TPU kernel keeps both int8 weights in
// VMEM and the hidden activations in registers; a Hopper block cannot hold
// 4 MB of weights, so the tail runs as four stages, the products on the
// wgmma + TMA core (int8_wgmma.cuh):
//   1. ln_quant_rows_kernel: LayerNorm in fp32, per-row quantization of
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
#include "int8_wgmma.cuh"

namespace {

constexpr int kBN1 = 128;  // fc1's tile width

// Per row of x [M, C] bf16: vdn's fp32 LayerNorm ((x - mean) * rsqrt(var +
// eps)) * w + b (two-pass statistics), then s = max(amax / 127, 1e-30) and
// q = round_half_even(y * (1 / s)) into yq [M, C] and sy [M]: the sums and
// roundings of quant_rows_kernel<bf16, true> (int8_gemm.cuh) in the same
// order, lane l holding the 8-value groups at l * 8 + 256 i (kV of them,
// C <= 256 kV) from one read of the row.  One warp per row.
template <int kV>
__global__ void __launch_bounds__(256)
ln_quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int M, int C,
                     const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, float eps,
                     int8_t* __restrict__ q, float* __restrict__ s,
                     unsigned* __restrict__ hidden_amax) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * C;
  float v[kV][8];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (lane * 8 + 256 * i < C) vdn::load8(xr + lane * 8 + 256 * i, v[i]);
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (lane * 8 + 256 * i >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[i][j];
  }
  const float mu = vdn::warp_sum(acc) / C;
  acc = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (lane * 8 + 256 * i >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += (v[i][j] - mu) * (v[i][j] - mu);
  }
  const float rstd = 1.f / sqrtf(vdn::warp_sum(acc) / C + eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int k = lane * 8 + 256 * i;
    if (k >= C) continue;
    float w[8], b[8];
    vdn::load8(ln_w + k, w);
    vdn::load8(ln_b + k, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j] - mu, rstd), w[j]),
                          b[j]);
      amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  const float sc = fmaxf(vdn::warp_max(amax) / 127.f, 1e-30f);
  const float inv = 1.f / sc;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int k = lane * 8 + 256 * i;
    if (k >= C) continue;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = __float2int_rn(__fmul_rn(v[i][j], inv));
      w[j >> 2] |= (uint32_t)(qi & 0xff) << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(q + (size_t)row * C + k) = make_uint2(w[0], w[1]);
  }
  if (lane == 0) {
    s[row] = sc;
    // the row's two slots of fc1's atomicMax (stage 2)
    hidden_amax[2 * row] = hidden_amax[2 * row + 1] = 0u;
  }
}

template <int kV>
cudaError_t launch_ln_quant_rows(const __nv_bfloat16* x, int M, int C,
                                 const float* ln_w, const float* ln_b,
                                 float eps, int8_t* q, float* s,
                                 unsigned* amax, cudaStream_t stream) {
  ln_quant_rows_kernel<kV><<<(M + 7) / 8, 256, 0, stream>>>(
      x, M, C, ln_w, ln_b, eps, q, s, amax);
  return cudaGetLastError();
}

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

// hq = round(h * (1 / s)) with s = max(amax / 127, 1e-30) per (row, F / 2
// chunk), as quant_rows_kernel<float, false> with two segments rounds it;
// 8 values a thread, h read once; the thread at a chunk's first column
// writes sh.
__global__ void quant_hidden_kernel(const float* __restrict__ h,
                                    const unsigned* __restrict__ amax, int M,
                                    int F, int8_t* __restrict__ hq,
                                    float* __restrict__ sh) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (size_t)M * F / 8) return;
  const size_t e = g * 8;
  const int row = (int)(e / F), col = (int)(e % F), half = F / 2;
  const int chunk = col / half;
  const float s =
      fmaxf(__uint_as_float(amax[(size_t)row * 2 + chunk]) / 127.f, 1e-30f);
  const float inv = 1.f / s;
  float v[8];
  vdn::load8(h + e, v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qi = __float2int_rn(__fmul_rn(v[j], inv));
    w[j >> 2] |= (uint32_t)(qi & 0xff) << (8 * (j & 3));
  }
  *reinterpret_cast<uint2*>(hq + e) = make_uint2(w[0], w[1]);
  if (col % half == 0) sh[(size_t)row * 2 + chunk] = s;
}

template <int BN2>
cudaError_t launch_fc2(int M, int C, int F, const int8_t* hq,
                       const int8_t* w2q, const float* sh, const float* s2,
                       vdn::EpiI8Residual epi, int grid, cudaStream_t s) {
  return vdn::wg::launch_gemm_s8_wgmma<BN2, 2, false>(
      M, C, F, hq, w2q, sh, s2, vdn::wg::PairEpi<vdn::EpiI8Residual>{epi},
      grid, s);
}

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
  cudaError_t err =
      C <= 512    ? launch_ln_quant_rows<2>(xb, M, C, w, b, eps, y8, sc, am, s)
      : C <= 768  ? launch_ln_quant_rows<3>(xb, M, C, w, b, eps, y8, sc, am, s)
      : C <= 1024 ? launch_ln_quant_rows<4>(xb, M, C, w, b, eps, y8, sc, am, s)
      : C <= 1536 ? launch_ln_quant_rows<6>(xb, M, C, w, b, eps, y8, sc, am, s)
                  : launch_ln_quant_rows<8>(xb, M, C, w, b, eps, y8, sc, am, s);
  if (err != cudaSuccess) return err;
  err = vdn::wg::launch_gemm_s8_wgmma<kBN1, 1, true>(
      M, F, C, y8, static_cast<const int8_t*>(w1q), sc,
      static_cast<const float*>(s1),
      EpiHidden{static_cast<const float*>(b1), hf, am, F}, grid1, s);
  if (err != cudaSuccess) return err;
  const size_t groups = (size_t)M * F / 8;
  quant_hidden_kernel<<<(unsigned)((groups + 255) / 256), 256, 0, s>>>(
      hf, am, M, F, h8, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const vdn::EpiI8Residual epi{static_cast<const float*>(b2),
                               static_cast<const float*>(gamma), xb,
                               static_cast<__nv_bfloat16*>(out), C};
  const auto* w2 = static_cast<const int8_t*>(w2q);
  const auto* cs = static_cast<const float*>(s2);
  return bn2 == 128
             ? launch_fc2<128>(M, C, F, h8, w2, scale, cs, epi, grid2, s)
             : launch_fc2<64>(M, C, F, h8, w2, scale, cs, epi, grid2, s);
}
