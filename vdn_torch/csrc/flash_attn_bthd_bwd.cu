// D2: the backward of C2 (attention over [B, T, H, D]) in fp32, for
// hieradet's global blocks on the v1 training path: q, k, v [b * s, 256,
// 4, 96] fp32 (read in place as slices of the fused qkv projection), the
// forward's out and dO [B, Tq, H, D], its base-2 row log-sum-exp lse
// [B, H, Tq] -> dq [B, Tq, H, D], dk and dv [B, Tk, H, D], fp32.
//
// Replaces vdn/ops/pallas/flash_attention.py _flash_bwd_bhtd
// (_flash_bwd_kernel), the VJP of flash_attention: P recomputed, delta =
// rowsum(dO * O), dV = P^T dO, dS = P * (dP - delta) with dP = dO V^T, dQ =
// dS K * scale, dK = dS^T q * scale.
//
// Bound on the H100 by its fp32 FMAs: 10 * B * H * Tq * Tk * D FLOP at the
// card's 67 TFLOP/s (0.060 ms at v1's [16, 256, 4, 96]); this design
// recomputes S and dP once more (14 * B * H * Tq * Tk * D issued).  The TPU
// kernel walked one head's q blocks in order and carried dK / dV in VMEM
// across that sequential grid axis; Hopper blocks run in no order, so the
// work splits as D1's (flash_attn_qkv_bwd.cu), with no atomics, into three
// launches:
//   1. delta = sum_d dO * O per (b, h, row), one warp per row;
//   2. dK / dV: one block per (32-key tile, head, batch) holding its K and V
//      tiles, looping over the 32-row q tiles with dK and dV accumulated in
//      registers;
//   3. dQ: one block per (32-row q tile, head, batch), looping over the key
//      tiles.
// In place of vdn's full-row recompute (rowmax, rowsum, 1 / l folded into
// the [bq, d] operands) p = exp2(S - lse) comes out normalized from the
// forward's statistic; S is recomputed from q * fp32(scale * log2 e) as the
// forward took it, so dK = dS^T (q * qscale) * (scale / qscale).  Every
// product and sum is an fp32 FMA on shared tiles (attn_f32.cuh).  Ragged
// tails: q rows >= Tq take p = 0 (so dS = 0), keys >= Tk take p = 0, and
// nothing past either is stored.
#include "attn_f32.cuh"

namespace {

using namespace vdn::attn_f32;

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]; dout and out
// contiguous [B, T, H, D]; one warp per row
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_f32_kernel(const float* __restrict__ dout,
                           const float* __restrict__ out, int B, int T, int H,
                           float* __restrict__ delta) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * T * H) return;
  const int h = row % H, bt = row / H;
  const int b = bt / T, t = bt % T;
  const float* g = dout + (size_t)row * D;
  const float* o = out + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane * 4; d < D; d += 128) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(g + d));
    const float4 y = __ldg(reinterpret_cast<const float4*>(o + d));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  acc = vdn::warp_sum(acc);
  if (lane == 0) delta[((size_t)b * H + h) * T + t] = acc;
}

// dK, dV of one 32-key tile over every q tile
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int Tq, int Tk,
                          int H, long long sqb, long long sqt, long long skb,
                          long long skt, long long svb, long long svt,
                          float qscale, float dk_scale,
                          float* __restrict__ dk, float* __restrict__ dv) {
  using Dm = Dims<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + Dm::kTile;
  float* Qs = Vs + Dm::kTile;
  float* Gs = Qs + Dm::kTile;          // dO
  float* Ps = Gs + Dm::kTile;          // [32 q][kPld]
  float* Ss = Ps + kRows * kPld;       // dS, [32 q][kPld]
  float* Ls = Ss + kRows * kPld;       // lse of the q tile
  float* Ds = Ls + kRows;              // delta of the q tile

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, jr = tid >> 2, sub = tid & 3;
  const Operand qo = operand(q, sqb, sqt, b, h, D);
  const Operand go = operand(dout, (long long)Tq * H * D, (long long)H * D, b,
                             h, D);
  const float* lse_bh = lse + ((size_t)b * H + h) * Tq;
  const float* delta_bh = delta + ((size_t)b * H + h) * Tq;

  load_tile<D>(Ks, operand(k, skb, skt, b, h, D), k0, Tk, 1.f);
  load_tile<D>(Vs, operand(v, svb, svt, b, h, D), k0, Tk, 1.f);

  float4 adk[Dm::kVec], adv[Dm::kVec];
#pragma unroll
  for (int i = 0; i < Dm::kVec; ++i) {
    adk[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    adv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int q0 = 0; q0 < Tq; q0 += kRows) {
    __syncthreads();  // the previous q tile's readers are done
    load_tile<D>(Qs, qo, q0, Tq, qscale);
    load_tile<D>(Gs, go, q0, Tq, 1.f);
    load_rowstat(Ls, lse_bh, q0, Tq);
    load_rowstat(Ds, delta_bh, q0, Tq);
    __syncthreads();
    // p and dS at (q row i, key jr) for the thread's rows i = sub + 4 t
#pragma unroll 2
    for (int t = 0; t < kRows / 4; ++t) {
      const int i = sub + 4 * t;
      float p = 0.f, ds = 0.f;
      if (q0 + i < Tq) {
        const float s = dot_rows<D>(Qs + i * Dm::kLd, Ks + jr * Dm::kLd);
        const float dp = dot_rows<D>(Gs + i * Dm::kLd, Vs + jr * Dm::kLd);
        p = exp2f(s - Ls[i]);
        ds = p * (dp - Ds[i]);
      }
      Ps[i * kPld + jr] = p;
      Ss[i * kPld + jr] = ds;
    }
    __syncthreads();
    // dV[jr] += sum_i p[i][jr] dO[i];  dK[jr] += sum_i dS[i][jr] (q qscale)[i]
#pragma unroll 2
    for (int i = 0; i < kRows; ++i) {
      axpy_row<D>(adv, Ps[i * kPld + jr], Gs + i * Dm::kLd, sub);
      axpy_row<D>(adk, Ss[i * kPld + jr], Qs + i * Dm::kLd, sub);
    }
  }

  const int key = k0 + jr;
  if (key >= Tk) return;
  const size_t off = ((size_t)b * Tk + key) * H * D + (size_t)h * D;
  store_row<D>(dv + off, adv, 1.f, sub);
  store_row<D>(dk + off, adk, dk_scale, sub);
}

// dQ of one 32-row q tile over every key tile
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int Tq, int Tk,
                        int H, long long sqb, long long sqt, long long skb,
                        long long skt, long long svb, long long svt,
                        float qscale, float scale, float* __restrict__ dq) {
  using Dm = Dims<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + Dm::kTile;          // dO
  float* Ks = Gs + Dm::kTile;
  float* Vs = Ks + Dm::kTile;
  float* Ss = Vs + Dm::kTile;          // dS, [32 q][kPld]
  float* Ls = Ss + kRows * kPld;
  float* Ds = Ls + kRows;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ir = tid >> 2, sub = tid & 3;
  const Operand ko = operand(k, skb, skt, b, h, D);
  const Operand vo = operand(v, svb, svt, b, h, D);

  load_tile<D>(Qs, operand(q, sqb, sqt, b, h, D), q0, Tq, qscale);
  load_tile<D>(Gs, operand(dout, (long long)Tq * H * D, (long long)H * D, b,
                           h, D), q0, Tq, 1.f);
  load_rowstat(Ls, lse + ((size_t)b * H + h) * Tq, q0, Tq);
  load_rowstat(Ds, delta + ((size_t)b * H + h) * Tq, q0, Tq);

  float4 adq[Dm::kVec];
#pragma unroll
  for (int i = 0; i < Dm::kVec; ++i) adq[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < Tk; k0 += kRows) {
    __syncthreads();  // the previous key tile's readers are done
    load_tile<D>(Ks, ko, k0, Tk, 1.f);
    load_tile<D>(Vs, vo, k0, Tk, 1.f);
    __syncthreads();
    const float l = Ls[ir], dl = Ds[ir];
#pragma unroll 2
    for (int t = 0; t < kRows / 4; ++t) {
      const int j = sub + 4 * t;
      float ds = 0.f;
      if (k0 + j < Tk) {
        const float s = dot_rows<D>(Qs + ir * Dm::kLd, Ks + j * Dm::kLd);
        const float dp = dot_rows<D>(Gs + ir * Dm::kLd, Vs + j * Dm::kLd);
        const float p = exp2f(s - l);
        ds = p * (dp - dl);
      }
      Ss[ir * kPld + j] = ds;
    }
    __syncwarp();  // a row's dS comes from the four lanes of that row
#pragma unroll 4
    for (int j = 0; j < kRows; ++j)
      axpy_row<D>(adq, Ss[ir * kPld + j], Ks + j * Dm::kLd, sub);
  }

  const int row = q0 + ir;
  if (row >= Tq) return;
  store_row<D>(dq + ((size_t)b * Tq + row) * H * D + (size_t)h * D, adq,
               scale, sub);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, int B, int Tq, int Tk, int H,
           long long sqb, long long sqt, long long skb, long long skt,
           long long svb, long long svt, float qscale, float scale,
           void* delta, void* dq, void* dk, void* dv, cudaStream_t s) {
  using Dm = Dims<D>;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const int smem_kv =
      (4 * Dm::kTile + 2 * kRows * kPld + 2 * kRows) * (int)sizeof(float);
  const int smem_q =
      (4 * Dm::kTile + kRows * kPld + 2 * kRows) * (int)sizeof(float);
  static const cudaError_t attr_kv =
      allow_smem(flash_bwd_dkdv_f32_kernel<D>, smem_kv);
  static const cudaError_t attr_q =
      allow_smem(flash_bwd_dq_f32_kernel<D>, smem_q);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;

  const int rows = B * Tq * H;
  flash_bwd_delta_f32_kernel<D>
      <<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
          gf, static_cast<const float*>(out), B, Tq, H, df);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_f32_kernel<D>
      <<<dim3((Tk + kRows - 1) / kRows, H, B), kThreads, smem_kv, s>>>(
          qf, kf, vf, gf, lf, df, Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
          qscale, scale / qscale, static_cast<float*>(dk),
          static_cast<float*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<D>
      <<<dim3((Tq + kRows - 1) / kRows, H, B), kThreads, smem_q, s>>>(
          qf, kf, vf, gf, lf, df, Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
          qscale, scale, static_cast<float*>(dq));
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k / v [B, Tk, H, D] fp32 with their own batch and row
// strides in elements (as vdn_flash_attention_bthd_f32 reads them); out and
// dout [B, Tq, H, D] and lse [B, H, Tq] fp32 contiguous -> delta
// [B, H, Tq] (scratch), dq [B, Tq, H, D], dk / dv [B, Tk, H, D] fp32
// contiguous.  qscale is fp32(scale * log2 e) as the forward took it.
// D = 96 only.
extern "C" int vdn_flash_attention_bthd_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, int B, int Tq, int Tk, int H, int D,
    long long sqb, long long sqt, long long skb, long long skt, long long svb,
    long long svt, float qscale, float scale, void* delta, void* dq, void* dk,
    void* dv, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 96)
    return launch<96>(q, k, v, out, dout, lse, B, Tq, Tk, H, sqb, sqt, skb,
                      skt, svb, svt, qscale, scale, delta, dq, dk, dv, s);
  return cudaErrorInvalidValue;
}
