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
// Bound on the H100 by its three products (6 * M * C * F FLOP; 0.558 ms at
// the v4 shape at 989 TFLOP/s).  The TPU kernel kept W1 and W2 resident in
// VMEM, recomputed the forward per row block and carried the column sums
// across its sequential grid; here the products run on the wgmma + TMA
// core (bf16_wgmma.cuh) between row kernels, and the column sums are
// two-pass (per row tile, then over the tiles in order), so nothing
// depends on the order blocks run in and dx repeats bit for bit:
//   1. d3_rows_kernel, one warp per row held in registers: y = bf16(LN(x))
//      and go = bf16(g * gamma) (vdn's go), the A operands of step 2 (TMA
//      cannot apply a prologue), and the row's mean / rstd;
//   2. the paired product over 128 x 128 tiles of [M, F], K = C: hpre =
//      y W1^T (W1 [F, C] K-major) and dh = go W2 (W2 [C, F] read MN-major
//      through the transpose bit) into two accumulators of one tile, whose
//      epilogue
//      writes h = bf16(gelu(hpre)) and dhpre = bf16(bf16(dh) * gelu'(hpre))
//      with hpre = bf16(bf16(acc) + b1) straight from registers (vdn
//      computes hacc and dh for one F slice back to back, mlp.py:283-296;
//      no hpre scratch);
//   3. dy = dhpre W1 (W1 read MN-major), rounded once to bf16 (mlp.py:313);
//   4. the LayerNorm backward per row, fp32, with the residual: dx = g +
//      bf16(dxf) (mlp.py:328-335);
//   5. column sums: db1 = sum dhpre, its first pass per 64-row tile in the
//      paired product's epilogue (from the staged dhpre tile); dls = sum dy
//      * xhat and dlb = sum dy per 128-row chunk in one kernel; then the
//      chunks in order.
// GELU is the tanh form, the bf16 flavour of the forward (_dgelu_f32).  The
// weights enter as stored: no transposed copies.
#include "bf16_wgmma.cuh"

namespace {

using vdn::bf16r;
using vdn::bf2f;
namespace wgbf = vdn::wgbf;

constexpr int kColRows = 128;  // rows per partial column sum
// every product's tiles: 128 rows x kWidth columns; the paired product's
// split between the consumer warpgroups (cooperative: 64 rows each, two
// products, 128 fp32 sums a thread), which also give db1's first-pass
// chunks of 64 rows
constexpr int kPairRows = 64, kWidth = 128;

// Per row of x, g [M, C]: y = bf16(LN(x)) and go = bf16(g * gamma) [M, C],
// mean and rstd [M]; C <= 256 kV, one warp per row.
template <int kV>
__global__ void __launch_bounds__(256)
d3_rows_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ g, int M, int C,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b,
               const __nv_bfloat16* __restrict__ gamma, float eps,
               __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ go,
               float* __restrict__ mean, float* __restrict__ rstd) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * C;
  float v[kV][8], mu, rs;
  wgbf::ln_row<kV>(x + off, C, lane, ln_w, ln_b, eps, v, mu, rs);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int k = lane * 8 + 256 * i;
    if (k >= C) continue;
    vdn::store_vec<__nv_bfloat16, 8>(y + off + k, v[i]);
    float gv[8];
    vdn::load_vec<__nv_bfloat16, 8>(g + off + k, gv);
#pragma unroll
    for (int j = 0; j < 8; ++j) gv[j] *= bf2f(gamma[k + j]);
    vdn::store_vec<__nv_bfloat16, 8>(go + off + k, gv);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// the paired product's epilogue: hpre = bf16(bf16(hacc) + b1), h =
// bf16(gelu(hpre)), dhpre = bf16(bf16(dh) * gelu'(hpre)); the column sums
// of each warpgroup's 64 rows of dhpre (db1's first pass) into colsum
// [ceil(M / 64), F]
struct EpiHDhpre {
  static constexpr int kOuts = 2;  // h, dhpre
  static constexpr bool kResidual = false;
  static constexpr int kColSumOut = 1;
  static constexpr bool kEdge = false;
  const __nv_bfloat16* b1;
  float* colsum;
  __device__ __forceinline__ float2 col(int n) const {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b1 + n));
  }
  __device__ __forceinline__ void operator()(float2 bias, float a0, float a1,
                                             float d0, float d1,
                                             uint32_t (&o)[2]) const {
    const float h0 = bf16r(bf16r(a0) + bias.x);
    const float h1 = bf16r(bf16r(a1) + bias.y);
    float g0, g1, dg0, dg1;
    vdn::gelu_dgelu_tanh(h0, g0, dg0);
    vdn::gelu_dgelu_tanh(h1, g1, dg1);
    o[0] = vdn::pack_bf16(g0, g1);
    o[1] = vdn::pack_bf16(bf16r(d0) * dg0, bf16r(d1) * dg1);
  }
};

// dy = bf16(dhpre W1)
struct EpiDy {
  static constexpr int kOuts = 1;
  static constexpr bool kResidual = false;
  static constexpr int kColSumOut = -1;
  static constexpr bool kEdge = false;
  struct None {};
  __device__ __forceinline__ None col(int) const { return {}; }
  __device__ __forceinline__ void operator()(None, float v0, float v1,
                                             float2, uint32_t (&o)[1]) const {
    o[0] = vdn::pack_bf16(v0, v1);
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

// dls and dlb, pass 1: per kColRows-row chunk and column n < C, the sums
// of dy * xhat (xhat = (x - mean) * rstd) and of dy over the chunk's rows
// in row order, into partial[chunk, n] and partial[chunk, C + n]
__global__ void ln_colsum_kernel(const __nv_bfloat16* __restrict__ dy,
                                 const __nv_bfloat16* __restrict__ x, int M,
                                 int C, const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 float* __restrict__ partial) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= C) return;
  const int m0 = blockIdx.y * kColRows;
  const int m1 = min(M, m0 + kColRows);
  float s_ls = 0.f, s_lb = 0.f;
  for (int m = m0; m < m1; ++m) {
    const size_t i = (size_t)m * C + n;
    const float d = bf2f(dy[i]);
    s_ls += d * ((bf2f(x[i]) - mean[m]) * rstd[m]);
    s_lb += d;
  }
  partial[(size_t)blockIdx.y * 2 * C + n] = s_ls;
  partial[(size_t)blockIdx.y * 2 * C + C + n] = s_lb;
}

// pass 2: out[n] = sum over the chunks of partial [chunks, N], in chunk
// order
__global__ void colsum_reduce_kernel(const float* __restrict__ partial,
                                     int chunks, int N,
                                     float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * N + n];
  out[n] = acc;
}

cudaError_t launch_reduce(const float* partial, int chunks, int N,
                          float* out, cudaStream_t s) {
  colsum_reduce_kernel<<<(N + 255) / 256, 256, 0, s>>>(partial, chunks, N,
                                                       out);
  return cudaGetLastError();
}

}  // namespace

// x, g [M, C]; w1 [F, C]; b1 [F]; w2 [C, F]; gamma [C]: bf16.  ln_w, ln_b
// [C] fp32.  Scratch: mean, rstd [M] fp32; go, dy [M, C] bf16; part_f
// [ceil(M / 64), F] and part_c [ceil(M / 128), 2 C] fp32.  Out: y, dx [M,
// C] and h, dhpre [M, F] bf16; dls_dlb [2 C] (dls, then dlb) and db1 [F]
// fp32.  C % 128 == 0, C <= 2048, F % 128 == 0.  grid_f and grid_c: the
// persistent blocks of the paired product and of dy (128 x 128 tiles).
extern "C" int vdn_ln_mlp_residual_bwd(
    const void* x, const void* g, int M, int C, int F, const void* ln_w,
    const void* ln_b, const void* w1, const void* b1, const void* w2,
    const void* gamma, float eps, void* mean, void* rstd, void* go,
    void* dy, void* part_f, void* part_c, void* y, void* h, void* dhpre,
    void* dx, void* dls_dlb, void* db1, int grid_f, int grid_c,
    void* stream) {
  if (M < 1 || C % kWidth || C > 2048 || F % kWidth)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* gam = static_cast<const __nv_bfloat16*>(gamma);
  auto* meanf = static_cast<float*>(mean);
  auto* rstdf = static_cast<float*>(rstd);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* gob = static_cast<__nv_bfloat16*>(go);
  auto* dyb = static_cast<__nv_bfloat16*>(dy);
  auto* pf = static_cast<float*>(part_f);
  auto* pc = static_cast<float*>(part_c);
  const auto* lnw = static_cast<const float*>(ln_w);
  const auto* lnb = static_cast<const float*>(ln_b);

  cudaError_t err = wgbf::with_ln_row(C, [&](auto kv) {
    d3_rows_kernel<decltype(kv)::value><<<(M + 7) / 8, 256, 0, s>>>(
        xb, gb, M, C, lnw, lnb, gam, eps, yb, gob, meanf, rstdf);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  void* pair_out[2] = {h, dhpre};
  err = wgbf::launch_gemm_bf16_wgmma<kWidth, wgbf::kKMajor,
                                     wgbf::kMNMajor, true>(
      M, F, C, yb, w1, gob, w2, pair_out, nullptr,
      EpiHDhpre{static_cast<const __nv_bfloat16*>(b1), pf}, grid_f, s);
  if (err != cudaSuccess) return err;
  err = wgbf::launch_gemm_bf16_wgmma<kWidth, wgbf::kMNMajor, wgbf::kNoB,
                                     false>(
      M, C, F, dhpre, w1, nullptr, nullptr, &dy, nullptr, EpiDy{}, grid_c, s);
  if (err != cudaSuccess) return err;
  const int rows_per_block = 8;
  ln_bwd_rows_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                       32 * rows_per_block, 0, s>>>(
      xb, gb, dyb, M, C, meanf, rstdf, lnw, static_cast<__nv_bfloat16*>(dx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = (M + kColRows - 1) / kColRows;
  ln_colsum_kernel<<<dim3((C + 255) / 256, chunks), 256, 0, s>>>(
      dyb, xb, M, C, meanf, rstdf, pc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_reduce(pc, chunks, 2 * C, static_cast<float*>(dls_dlb), s);
  if (err != cudaSuccess) return err;
  return launch_reduce(pf, (M + kPairRows - 1) / kPairRows, F,
                       static_cast<float*>(db1), s);
}
