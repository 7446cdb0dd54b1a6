// The stages that F4 (ln_mlp_int8.cu) and F5 (ln_swiglu_int8.cu) share
// around their first product: the LayerNorm + quantize row kernel, the
// hidden's quantizer, and the second product with its residual epilogue
// on the wgmma core (int8_wgmma.cuh).  Internal linkage: each source that
// includes it gets its own copy.
#pragma once

#include "int8_wgmma.cuh"

namespace {

// Per row of x [M, C] bf16: vdn's fp32 LayerNorm ((x - mean) * rsqrt(var +
// eps)) * w + b (two-pass statistics), then s = max(amax / 127, 1e-30) and
// q = round_half_even(y * (1 / s)) into yq [M, C] and sy [M]: the sums and
// roundings of quant_rows_kernel<true> (int8_gemm.cuh) in the same
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

// the row kernel at the least kV that holds C (C % 128 == 0, C <= 2048)
cudaError_t launch_rows(const __nv_bfloat16* x, int M, int C,
                        const float* w, const float* b, float eps, int8_t* q,
                        float* s, unsigned* amax, cudaStream_t st) {
  return C <= 512    ? launch_ln_quant_rows<2>(x, M, C, w, b, eps, q, s, amax, st)
         : C <= 768  ? launch_ln_quant_rows<3>(x, M, C, w, b, eps, q, s, amax, st)
         : C <= 1024 ? launch_ln_quant_rows<4>(x, M, C, w, b, eps, q, s, amax, st)
         : C <= 1536 ? launch_ln_quant_rows<6>(x, M, C, w, b, eps, q, s, amax, st)
                     : launch_ln_quant_rows<8>(x, M, C, w, b, eps, q, s, amax, st);
}

// hq = round(h * (1 / s)) with s = max(amax / 127, 1e-30) per (row, F / 2
// chunk), as quantize_rows (kernels/int8.py) with two chunks rounds it;
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

cudaError_t launch_quant_hidden(const float* h, const unsigned* amax, int M,
                               int F, int8_t* hq, float* sh,
                               cudaStream_t s) {
  const size_t groups = (size_t)M * F / 8;
  quant_hidden_kernel<<<(unsigned)((groups + 255) / 256), 256, 0, s>>>(
      h, amax, M, F, hq, sh);
  return cudaGetLastError();
}

template <int BN2>
cudaError_t launch_fc2_at(int M, int C, int F, const int8_t* hq,
                       const int8_t* w2q, const float* sh, const float* s2,
                       vdn::EpiI8Residual epi, int grid, cudaStream_t s) {
  return vdn::wg::launch_gemm_s8_wgmma<BN2, 2, false>(
      M, C, F, hq, w2q, sh, s2, vdn::wg::PairEpi<vdn::EpiI8Residual>{epi},
      grid, s);
}

// the second product, out = x + bf16(((hq w2^T) dequantized by chunk + b2)
// * gamma), at tile width bn2 (128 or 64)
cudaError_t launch_fc2(int bn2, int M, int C, int F, const int8_t* hq,
                       const int8_t* w2q, const float* sh, const float* s2,
                       vdn::EpiI8Residual epi, int grid, cudaStream_t s) {
  return bn2 == 128
             ? launch_fc2_at<128>(M, C, F, hq, w2q, sh, s2, epi, grid, s)
             : launch_fc2_at<64>(M, C, F, hq, w2q, sh, s2, epi, grid, s);
}
}  // namespace
