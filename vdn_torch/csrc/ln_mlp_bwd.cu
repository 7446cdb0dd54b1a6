// D3: the backward of A2 (LayerNorm -> fc1 -> GELU -> fc2 -> x gamma -> +
// residual) for everything but the two weight products.
//
// Replaces vdn/ops/pallas/mlp.py _mlp_bwd_dx_pallas / _mlp_bwd_dx_pallas3
// (_mlp_bwd_dx_kernel), which _bwd_via_kernel runs for rows >= 2048: x, the
// cotangent g [M, C] -> dx [M, C] and what vdn's XLA-side dW products read,
// y = LN(x), h = gelu(hpre), dhpre [M, F], plus the column sums dls, dlb
// [C] and db1 [F] in fp32.  vitl's training step has M = 16 * 1370 =
// 21920, C = 1024, F = 4096, bf16.
//
// Bound on the H100 by its three products (6 * M * C * F FLOP).  The TPU
// kernel kept W1 and W2 resident in VMEM, recomputed the forward per row
// block and carried the column sums across its sequential grid; here, as A2
// was built (ln_mlp.cu), the work runs as row kernels around three
// gemm_tile launches, and the column sums are two-pass (per 128-row chunk,
// then over the chunks) rather than carried:
//   1. row_stats_kernel (fp32 mean / rstd), then y = bf16(LN(x));
//   2. GEMM y W1^T with a + b1 epilogue: hpre = bf16(bf16(acc) + b1) kept
//      in scratch, h = bf16(gelu(hpre)) written;
//   3. GEMM (g * gamma) W2 (gamma applied in the prologue, rounded to bf16
//      as vdn's go), the epilogue rounds dh to bf16, multiplies by
//      gelu'(hpre) in fp32 and writes dhpre rounded to bf16;
//   4. GEMM dhpre W1 -> dy rounded once to bf16 (mlp.py:313);
//   5. the LayerNorm backward per row, fp32, with the residual: dx = g +
//      bf16(dxf) (mlp.py:328-335);
//   6. column sums db1 = sum dhpre, dls = sum dy * xhat, dlb = sum dy.
// GELU is the tanh form, the bf16 flavour of the forward (_dgelu_f32).  W2
// and W1 enter products 3 and 4 transposed ([F, C] and [C, F], K
// contiguous, made by the wrapper), the layout gemm_tile reads.
#include "gemm_tile.cuh"

namespace {

using vdn::bf16r;
using vdn::bf2f;

constexpr int kColRows = 128;  // rows per partial column sum

// gelu'(x) of the tanh form (vdn/ops/pallas/mlp.py _dgelu_f32, bf16)
__device__ __forceinline__ float dgelu_tanh(float x) {
  const float kA = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kB = 0.044715f;
  const float u = kA * (x + kB * x * x * x);
  const float th = 1.0f - 2.0f / (exp2f(u * (2.0f * 1.4426950408889634f)) + 1.0f);
  return 0.5f * (1.0f + th) +
         0.5f * x * (1.0f - th * th) * kA * (1.0f + 3.0f * kB * x * x);
}

// y = bf16(LN(x)) from the row statistics, 8 elements per thread
__global__ void ln_apply_kernel(const __nv_bfloat16* __restrict__ x, int M,
                                int C, const float* __restrict__ mean,
                                const float* __restrict__ rstd,
                                const float* __restrict__ ln_w,
                                const float* __restrict__ ln_b,
                                __nv_bfloat16* __restrict__ y) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= (size_t)M * C) return;
  const int m = i / C, k = i % C;
  float f[8];
  vdn::load_vec<__nv_bfloat16, 8>(x + i, f);
  vdn::ProLayerNorm{mean, rstd, ln_w, ln_b}(m, k, f);
  vdn::store_vec<__nv_bfloat16, 8>(y + i, f);
}

// g * gamma[k] in fp32, rounded to bf16 by gemm_tile: vdn's go
struct ProScale {
  static constexpr bool kIdentity = false;
  const __nv_bfloat16* gamma;
  __device__ void operator()(int, int k, float (&v)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= bf2f(gamma[k + i]);
  }
};

struct EpiHpreGelu {
  const __nv_bfloat16* b1;
  __nv_bfloat16* hpre;
  __nv_bfloat16* h;
  int F;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const float h0 = bf16r(bf16r(v0) + bf2f(b1[n]));
    const float h1 = bf16r(bf16r(v1) + bf2f(b1[n + 1]));
    const size_t i = (size_t)m * F + n;
    *reinterpret_cast<uint32_t*>(hpre + i) = vdn::pack_bf16(h0, h1);
    *reinterpret_cast<uint32_t*>(h + i) =
        vdn::pack_bf16(vdn::gelu_tanh(h0), vdn::gelu_tanh(h1));
  }
};

struct EpiDhpre {
  const __nv_bfloat16* hpre;
  __nv_bfloat16* dhpre;
  int F;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const size_t i = (size_t)m * F + n;
    const float2 hp = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(hpre + i));
    *reinterpret_cast<uint32_t*>(dhpre + i) = vdn::pack_bf16(
        bf16r(v0) * dgelu_tanh(hp.x), bf16r(v1) * dgelu_tanh(hp.y));
  }
};

struct EpiStoreDy {
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)m * ld + n) =
        vdn::pack_bf16(v0, v1);
  }
};

// The LayerNorm backward of one row per warp, fp32, as mlp.py:320-335:
// dxh = dy * ls, dxc = dxh * inv + (2 / C) * xc * dvar with dvar =
// sum(dxh * xc) * -0.5 * inv^3, dxf = dxc - mean(dxc), dx = g + bf16(dxf).
__global__ void ln_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                   const __nv_bfloat16* __restrict__ g,
                                   const __nv_bfloat16* __restrict__ dy,
                                   int M, int C,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ rstd,
                                   const float* __restrict__ ln_w,
                                   __nv_bfloat16* __restrict__ dx) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * C;
  const float mu = mean[row], inv = rstd[row];
  float s1 = 0.f;
  for (int k = lane * 8; k < C; k += 256) {
    float xf[8], d[8];
    vdn::load_vec<__nv_bfloat16, 8>(x + off + k, xf);
    vdn::load_vec<__nv_bfloat16, 8>(dy + off + k, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) s1 += d[i] * ln_w[k + i] * (xf[i] - mu);
  }
  const float dvar = vdn::warp_sum(s1) * -0.5f * inv * inv * inv;
  const float c2 = 2.0f / C;
  float s2 = 0.f;
  for (int k = lane * 8; k < C; k += 256) {
    float xf[8], d[8];
    vdn::load_vec<__nv_bfloat16, 8>(x + off + k, xf);
    vdn::load_vec<__nv_bfloat16, 8>(dy + off + k, d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s2 += d[i] * ln_w[k + i] * inv + c2 * (xf[i] - mu) * dvar;
  }
  const float mean_dxc = vdn::warp_sum(s2) / C;
  for (int k = lane * 8; k < C; k += 256) {
    float xf[8], d[8], gf[8], o[8];
    vdn::load_vec<__nv_bfloat16, 8>(x + off + k, xf);
    vdn::load_vec<__nv_bfloat16, 8>(dy + off + k, d);
    vdn::load_vec<__nv_bfloat16, 8>(g + off + k, gf);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dxc = d[i] * ln_w[k + i] * inv + c2 * (xf[i] - mu) * dvar;
      o[i] = gf[i] + bf16r(dxc - mean_dxc);
    }
    vdn::store_vec<__nv_bfloat16, 8>(dx + off + k, o);
  }
}

// column sums, pass 1: partial[chunk, n] = sum over the chunk's kColRows
// rows of val(m, n); one thread per column
struct ColValue {
  const __nv_bfloat16* a;
  int ld;
  __device__ float operator()(int m, int n) const {
    return bf2f(a[(size_t)m * ld + n]);
  }
};

// dy * xhat, xhat = (x - mean) * rstd (the dls sum)
struct ColDyXhat {
  const __nv_bfloat16* dy;
  const __nv_bfloat16* x;
  const float* mean;
  const float* rstd;
  int ld;
  __device__ float operator()(int m, int n) const {
    const size_t i = (size_t)m * ld + n;
    return bf2f(dy[i]) * ((bf2f(x[i]) - mean[m]) * rstd[m]);
  }
};

template <class Val>
__global__ void colsum_partial_kernel(int M, int N, Val val,
                                      float* __restrict__ partial) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * kColRows;
  const int m1 = min(M, m0 + kColRows);
  float acc = 0.f;
  for (int m = m0; m < m1; ++m) acc += val(m, n);
  partial[(size_t)blockIdx.y * N + n] = acc;
}

// pass 2: out[n] = sum over the chunks, in chunk order
__global__ void colsum_reduce_kernel(const float* __restrict__ partial,
                                     int chunks, int N,
                                     float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * N + n];
  out[n] = acc;
}

template <class Val>
cudaError_t launch_colsum(int M, int N, Val val, float* partial, float* out,
                          cudaStream_t s) {
  const int chunks = (M + kColRows - 1) / kColRows;
  colsum_partial_kernel<<<dim3((N + 255) / 256, chunks), 256, 0, s>>>(
      M, N, val, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_reduce_kernel<<<(N + 255) / 256, 256, 0, s>>>(partial, chunks, N,
                                                       out);
  return cudaGetLastError();
}

}  // namespace

// x, g [M, C]; w1 [F, C]; b1 [F]; w1t [C, F] (= w1^T); w2t [F, C] (= w2^T,
// w2 the [C, F] fc2 weight); gamma [C]: bf16.  ln_w [C] fp32.
// Scratch: mean, rstd [M] fp32; hpre [M, F] bf16; dy [M, C] bf16; partial
// [ceil(M / 128), F] fp32 (F >= C).  Out: y, dx [M, C] and h, dhpre [M, F]
// bf16; dls, dlb [C] and db1 [F] fp32.  C, F multiples of 32.
extern "C" int vdn_ln_mlp_residual_bwd(
    const void* x, const void* g, int M, int C, int F, const void* ln_w,
    const void* ln_b, const void* w1, const void* b1, const void* w1t,
    const void* w2t, const void* gamma, float eps, void* mean, void* rstd,
    void* hpre, void* dy, void* partial, void* y, void* h, void* dhpre,
    void* dx, void* dls, void* dlb, void* db1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  auto* meanf = static_cast<float*>(mean);
  auto* rstdf = static_cast<float*>(rstd);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* hpreb = static_cast<__nv_bfloat16*>(hpre);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* dhpreb = static_cast<__nv_bfloat16*>(dhpre);
  auto* dyb = static_cast<__nv_bfloat16*>(dy);
  auto* partf = static_cast<float*>(partial);
  const auto* lnw = static_cast<const float*>(ln_w);

  cudaError_t err = vdn::launch_row_stats(xb, M, C, eps, meanf, rstdf, s);
  if (err != cudaSuccess) return err;
  const size_t vecs = (size_t)M * C / 8;
  ln_apply_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, s>>>(
      xb, M, C, meanf, rstdf, lnw, static_cast<const float*>(ln_b), yb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = vdn::launch_gemm<false>(
      M, F, C, yb, C, static_cast<const __nv_bfloat16*>(w1),
      vdn::ProIdentity{},
      EpiHpreGelu{static_cast<const __nv_bfloat16*>(b1), hpreb, hb, F}, s);
  if (err != cudaSuccess) return err;
  err = vdn::launch_gemm<false>(
      M, F, C, gb, C, static_cast<const __nv_bfloat16*>(w2t),
      ProScale{static_cast<const __nv_bfloat16*>(gamma)},
      EpiDhpre{hpreb, dhpreb, F}, s);
  if (err != cudaSuccess) return err;
  err = vdn::launch_gemm<false>(
      M, C, F, dhpreb, F, static_cast<const __nv_bfloat16*>(w1t),
      vdn::ProIdentity{}, EpiStoreDy{dyb, C}, s);
  if (err != cudaSuccess) return err;
  const int rows_per_block = 8;
  ln_bwd_rows_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                       32 * rows_per_block, 0, s>>>(
      xb, gb, dyb, M, C, meanf, rstdf, lnw, static_cast<__nv_bfloat16*>(dx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_colsum(M, F, ColValue{dhpreb, F}, partf,
                      static_cast<float*>(db1), s);
  if (err != cudaSuccess) return err;
  err = launch_colsum(M, C, ColDyXhat{dyb, xb, meanf, rstdf, C}, partf,
                      static_cast<float*>(dls), s);
  if (err != cudaSuccess) return err;
  return launch_colsum(M, C, ColValue{dyb, C}, partf,
                       static_cast<float*>(dlb), s);
}
