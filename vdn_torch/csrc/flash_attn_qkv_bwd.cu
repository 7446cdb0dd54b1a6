// D1: the backward of A1, ViT self-attention off the fused qkv projection.
//
// Replaces vdn/ops/pallas/flash_attention.py _flash_bwd_cols
// (_flash_bwd_cols_kernel), the vjp of flash_attention_fused_qkv: qkv
// [B, T, 3, H, D], the forward's out [B, T, H, D] and row log-sum-exp lse
// [B, H, T] (base 2, from the training variant of A1), dO [B, T, H, D] ->
// dqkv [B, T, 3, H, D], at vitl's B = 16 frames, T = 1370, H = 16, D = 64,
// bf16.
//
// Bound on the H100 by five tensor-core products per (q tile, key tile)
// (10 * B * H * T^2 * D FLOP; this design recomputes S and dP once more,
// 14 * B * H * T^2 * D issued).  The TPU kernel walked the q blocks of one
// head in order and carried dK / dV in VMEM across the grid; Hopper blocks
// run in no order, so the work is split without atomics into three
// launches:
//   1. delta = sum_d dO * O in fp32 per (b, h, row);
//   2. dK / dV: one block of four warps per (frame, head, 64-key tile),
//      each warp owning 16 keys, looping over all q tiles with fp32 dK and
//      dV accumulators in registers.  S^T = K q^T and dP^T = V dO^T come
//      out with keys as rows, so P^T and dS^T feed the next two products
//      straight from the accumulator registers (as P feeds P V in A1);
//   3. dQ: one block per (frame, head, 64-row q tile), each warp owning 16
//      rows, streaming 64-key K / V tiles by cp.async as A1 does.
// All products are mma.sync m16n8k16 bf16 -> fp32.  vdn's math
// (flash_attention.py:578-663): q * bf16(scale * log2 e) in bf16, S in
// fp32; p = exp2(S - lse), already normalized; dV takes p rounded to bf16;
// dS = p * (dP - delta) rounded to bf16; dQ = dS K * scale and dK = dS^T q
// * scale with the unscaled q and scale (not scale * log2 e: d exp2(c x) /
// dx carries the ln 2 that log2 e cancels).  The ragged tail (T = 1370 =
// 21 * 64 + 26): rows >= T read zero q and dO and take p = 0, keys >= T take
// p = 0, so no padded row or column reaches a sum, and nothing past T is
// stored.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kTile = 64;      // q rows or keys per tile
constexpr int kLd = kD + 8;    // 144-byte rows: conflict-free loads
constexpr int kThreads = 128;  // four warps of 16 rows (or keys)

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in fp32
__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                                       const __nv_bfloat16* __restrict__ out,
                                       int B, int T, int H,
                                       float* __restrict__ delta) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * T * H) return;
  const int h = idx % H, bt = idx / H;
  const int b = bt / T, t = bt % T;
  const size_t off = (size_t)bt * H * kD + h * kD;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kD; d += 8) {
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + d);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + off + d);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(g2[j]);
      const float2 o = __bfloat1622float2(o2[j]);
      acc += a.x * o.x + a.y * o.y;
    }
  }
  delta[((size_t)b * H + h) * T + t] = acc;
}

// 8 bf16 of one row, each times qscale and rounded to bf16
__device__ __forceinline__ uint4 scale_row8(uint4 v, float qscale) {
  __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(hv[j]);
    hv[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
  }
  return v;
}

// A fragments (16 rows x 64 d) of rows [r0, r0 + 16) of a [64][kLd] tile
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[kD / 16][4],
                                             const __nv_bfloat16* s, int r0,
                                             int g, int t) {
  const int r = r0 + g;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = *reinterpret_cast<const uint32_t*>(&s[r * kLd + c]);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(&s[(r + 8) * kLd + c]);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(&s[r * kLd + c + 8]);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(&s[(r + 8) * kLd + c + 8]);
  }
}

// acc[nj] += A (16 x 64 d, fragments) . B^T where B is a [64][kLd] tile of
// 64 rows x 64 d: the product's columns are B's rows (the "col" operand).
__device__ __forceinline__ void mma_rows(float (&acc)[kTile / 8][4],
                                         const uint32_t (&a)[kD / 16][4],
                                         const __nv_bfloat16* s, int g,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj) {
      const int r = nj * 8 + g;
      uint32_t bfr[2];
      bfr[0] = *reinterpret_cast<const uint32_t*>(&s[r * kLd + c]);
      bfr[1] = *reinterpret_cast<const uint32_t*>(&s[r * kLd + c + 8]);
      vdn::mma_bf16_16816(acc[nj], a[kk], bfr);
    }
  }
}

// acc (16 x 64 d) += P (16 x 64, the fp32 accumulators of a 16 x 64
// product, rounded to bf16) . S, where S is a row-major [64][kLd] tile
// (64 rows of the contraction x 64 d), read transposed by ldmatrix.
__device__ __forceinline__ void mma_acc_tile(float (&acc)[kD / 8][4],
                                             const float (&p)[kTile / 8][4],
                                             const __nv_bfloat16* s,
                                             int lane) {
  const int mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    a[0] = vdn::pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = vdn::pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = vdn::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = vdn::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const int row = kk * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
    for (int nd = 0; nd < kD / 16; ++nd) {
      uint32_t b4[4];
      vdn::ldmatrix_x4_trans(b4, &s[row * kLd + (2 * nd + (mat >> 1)) * 8]);
      const uint32_t b0[2] = {b4[0], b4[1]};
      const uint32_t b1[2] = {b4[2], b4[3]};
      vdn::mma_bf16_16816(acc[2 * nd], a, b0);
      vdn::mma_bf16_16816(acc[2 * nd + 1], a, b1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int T, int H,
                      float qscale, float scale,
                      __nv_bfloat16* __restrict__ dqkv) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Vs[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Qs[kTile * kLd];  // q * qscale
  __shared__ __align__(16) __nv_bfloat16 Qu[kTile * kLd];  // q
  __shared__ __align__(16) __nv_bfloat16 Gs[kTile * kLd];  // dO
  __shared__ float Ls[kTile];
  __shared__ float Ds[kTile];

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = H * kD, ld = 3 * C;
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld + h * kD;
  const __nv_bfloat16* gbase = dout + (size_t)b * T * C + h * kD;
  const float* lse_b = lse + ((size_t)b * H + h) * T;
  const float* delta_b = delta + ((size_t)b * H + h) * T;

  // this block's K and V tile; keys >= T are zero
  for (int c = tid; c < 2 * kTile * (kD / 8); c += kThreads) {
    const int which = c / (kTile * (kD / 8));  // 0: K, 1: V
    const int r = (c / (kD / 8)) % kTile;
    const int d = (c % (kD / 8)) * 8;
    const int row = k0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < T)
      v = *reinterpret_cast<const uint4*>(base + (size_t)row * ld +
                                          (which + 1) * C + d);
    *reinterpret_cast<uint4*>((which ? Vs : Ks) + r * kLd + d) = v;
  }
  __syncthreads();
  uint32_t kf[kD / 16][4], vf[kD / 16][4];
  load_a_frags(kf, Ks, warp * 16, g, t);
  load_a_frags(vf, Vs, warp * 16, g, t);

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  const int n_q = (T + kTile - 1) / kTile;
  for (int i = 0; i < n_q; ++i) {
    const int q0 = i * kTile;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kTile * (kD / 8); c += kThreads) {
      const int r = c / (kD / 8), d = (c % (kD / 8)) * 8;
      const int row = q0 + r;
      uint4 qv = make_uint4(0, 0, 0, 0), gv = make_uint4(0, 0, 0, 0);
      if (row < T) {
        qv = *reinterpret_cast<const uint4*>(base + (size_t)row * ld + d);
        gv = *reinterpret_cast<const uint4*>(gbase + (size_t)row * C + d);
      }
      *reinterpret_cast<uint4*>(&Qu[r * kLd + d]) = qv;
      *reinterpret_cast<uint4*>(&Qs[r * kLd + d]) = scale_row8(qv, qscale);
      *reinterpret_cast<uint4*>(&Gs[r * kLd + d]) = gv;
    }
    for (int r = tid; r < kTile; r += kThreads) {
      const int row = q0 + r;
      Ls[r] = row < T ? lse_b[row] : 0.f;
      Ds[r] = row < T ? delta_b[row] : 0.f;
    }
    __syncthreads();

    // S^T = K (q * qscale)^T and dP^T = V dO^T: rows = this warp's keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nj][e] = dp[nj][e] = 0.f;
    mma_rows(s, kf, Qs, g, t);
    mma_rows(dp, vf, Gs, g, t);

    // P^T = exp2(S^T - lse) and dS^T = P^T (dP^T - delta), both fp32
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + g + (e >> 1) * 8;
        const int qi = nj * 8 + 2 * t + (e & 1);
        const float p = (key < T && q0 + qi < T)
                            ? exp2f(s[nj][e] - Ls[qi]) : 0.f;
        dp[nj][e] = p * (dp[nj][e] - Ds[qi]);
        s[nj][e] = p;
      }

    // dV += bf16(P^T) dO and dK += bf16(dS^T) q
    mma_acc_tile(dv, s, Gs, lane);
    mma_acc_tile(dk, dp, Qu, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + r * 8;
    if (key >= T) continue;
    __nv_bfloat16* dst = dqkv + ((size_t)b * T + key) * ld + h * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dst + C + nd * 8) =
          vdn::pack_bf16(dk[nd][2 * r] * scale, dk[nd][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dst + 2 * C + nd * 8) =
          vdn::pack_bf16(dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int T, int H,
                    float qscale, float scale,
                    __nv_bfloat16* __restrict__ dqkv) {
  __shared__ __align__(16) __nv_bfloat16 Ks[2][kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][kTile * kLd];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = H * kD, ld = 3 * C;
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld + h * kD;
  const __nv_bfloat16* gbase = dout + (size_t)b * T * C + h * kD;
  const float* lse_b = lse + ((size_t)b * H + h) * T;
  const float* delta_b = delta + ((size_t)b * H + h) * T;

  // stage q * qscale and dO through the second K / V buffers, keep their
  // A fragments in registers; rows >= T are zero
  for (int c = tid; c < kTile * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), d = (c % (kD / 8)) * 8;
    const int row = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0), gv = make_uint4(0, 0, 0, 0);
    if (row < T) {
      qv = *reinterpret_cast<const uint4*>(base + (size_t)row * ld + d);
      gv = *reinterpret_cast<const uint4*>(gbase + (size_t)row * C + d);
    }
    *reinterpret_cast<uint4*>(&Ks[1][r * kLd + d]) = scale_row8(qv, qscale);
    *reinterpret_cast<uint4*>(&Vs[1][r * kLd + d]) = gv;
  }
  __syncthreads();
  uint32_t qf[kD / 16][4], gf[kD / 16][4];
  load_a_frags(qf, Ks[1], warp * 16, g, t);
  load_a_frags(gf, Vs[1], warp * 16, g, t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    lse_r[r] = row < T ? lse_b[row] : 0.f;
    delta_r[r] = row < T ? delta_b[row] : 0.f;
  }
  __syncthreads();

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * kTile;
    for (int c = tid; c < 2 * kTile * (kD / 8); c += kThreads) {
      const int which = c / (kTile * (kD / 8));  // 0: K, 1: V
      const int r = (c / (kD / 8)) % kTile;
      const int d = (c % (kD / 8)) * 8;
      const int row = k0 + r;
      const __nv_bfloat16* src =
          base + (size_t)(row < T ? row : T - 1) * ld + (which + 1) * C + d;
      __nv_bfloat16* dst = (which ? Vs[buf] : Ks[buf]) + r * kLd + d;
      vdn::cp_async_16(dst, src, row < T ? 16 : 0);
    }
    vdn::cp_async_commit();
  };

  float dq[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;

  const int n_tiles = (T + kTile - 1) / kTile;
  load_kv(0, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, buf ^ 1);
      vdn::cp_async_wait<1>();
    } else {
      vdn::cp_async_wait<0>();
    }
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nj][e] = dp[nj][e] = 0.f;
    mma_rows(s, qf, Ks[buf], g, t);
    mma_rows(dp, gf, Vs[buf], g, t);

    // dS = exp2(S - lse) (dP - delta), fp32
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kTile + nj * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const int row = q0 + warp * 16 + g + r * 8;
        const float p = (key < T && row < T)
                            ? exp2f(s[nj][e] - lse_r[r]) : 0.f;
        s[nj][e] = p * (dp[nj][e] - delta_r[r]);
      }

    // dQ += bf16(dS) K
    mma_acc_tile(dq, s, Ks[buf], lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= T) continue;
    __nv_bfloat16* dst = dqkv + ((size_t)b * T + row) * ld + h * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          vdn::pack_bf16(dq[nd][2 * r] * scale, dq[nd][2 * r + 1] * scale);
  }
}

}  // namespace

// qkv [B, T, 3 * H * 64], out and dout [B, T, H * 64] bf16; lse [B, H, T]
// fp32 (the training forward's); scratch delta [B, H, T] fp32 ->
// dqkv [B, T, 3 * H * 64] bf16.  qscale is bf16(scale * log2 e), as the
// forward took it.  Head width 64 only.
extern "C" int vdn_flash_attention_qkv_bwd(const void* qkv, const void* out,
                                           const void* dout, const void* lse,
                                           int B, int T, int H, float qscale,
                                           float scale, void* delta,
                                           void* dqkv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qkvb = static_cast<const __nv_bfloat16*>(qkv);
  const auto* gb = static_cast<const __nv_bfloat16*>(dout);
  const auto* lsef = static_cast<const float*>(lse);
  auto* deltaf = static_cast<float*>(delta);
  auto* dqkvb = static_cast<__nv_bfloat16*>(dqkv);
  const int n = B * T * H;
  flash_bwd_delta_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      gb, static_cast<const __nv_bfloat16*>(out), B, T, H, deltaf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_bwd_dkdv_kernel<<<grid, kThreads, 0, s>>>(qkvb, gb, lsef, deltaf, T,
                                                  H, qscale, scale, dqkvb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<grid, kThreads, 0, s>>>(qkvb, gb, lsef, deltaf, T, H,
                                                qscale, scale, dqkvb);
  return cudaGetLastError();
}
