// C2 in fp32: attention over [B, T, H, D] with every product and sum in
// fp32, for hieradet's global blocks (vdn/nn/hiera.py:120) on the v1 model:
// q, k, v [b * s, 256, 4, 96] fp32 (16 x 16 tokens at 256 x 256; 324 at
// 288), read in place as slices of the block's fused qkv projection.
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention
// (_flash_kernel via _flash_bhtd) at fp32, where vdn's math is an exact
// full-K softmax: q * (scale * log2 e) rounded to fp32, S = q k^T, p =
// exp2(S - rowmax), out = (p V) / rowsum(p).  The bf16 D = 64 case stays
// in flash_attn_bthd.cu on the tensor cores.
//
// Bound on the H100 by its fp32 FMAs, 4 * B * H * Tq * Tk * D FLOP at the
// card's 67 TFLOP/s (0.024 ms at v1's [16, 256, 4, 96]); q, k, v and out
// are 6.3 MB, 0.002 ms of memory.  The TPU kernel held a head's whole K and
// V in VMEM and took the exact softmax in one pass; here one block per
// (32-row q tile, head, batch) streams 32-key K / V tiles through shared
// memory with an online softmax in base 2 (the running max and row sum in
// registers, O rescaled per tile), so the result differs from the exact
// softmax by fp32 rounding only.  A simple kernel: plain FMAs on shared
// tiles (attn_f32.cuh), no tensor cores and no copy/compute overlap; 3xTF32
// or wgmma are later work.  Ragged tails (Tq, Tk = 324 = 10 * 32 + 4): q
// rows >= Tq are zero and never stored, keys >= Tk take -inf logits.
//
// For the backward (D2, flash_attn_bthd_bwd.cu) the training variant also
// writes the row log-sum-exp in base 2, lse = m + log2(l), [B, H, Tq].
#include "attn_f32.cuh"

namespace {

using namespace vdn::attn_f32;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bthd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, int Tq, int Tk, int H,
                      long long sqb, long long sqt, long long skb,
                      long long skt, long long svb, long long svt,
                      float qscale, float* __restrict__ out,
                      float* __restrict__ lse) {
  using Dm = Dims<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + Dm::kTile;
  float* Vs = Ks + Dm::kTile;
  float* Ps = Vs + Dm::kTile;  // [32][kPld]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const Operand qo = operand(q, sqb, sqt, b, h, D);
  const Operand ko = operand(k, skb, skt, b, h, D);
  const Operand vo = operand(v, svb, svt, b, h, D);

  load_tile<D>(Qs, qo, q0, Tq, qscale);  // q * qscale, as the plain version

  float4 o[Dm::kVec];
#pragma unroll
  for (int i = 0; i < Dm::kVec; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run = -INFINITY, l_run = 0.f;  // l_run: this thread's columns

  for (int k0 = 0; k0 < Tk; k0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, ko, k0, Tk, 1.f);
    load_tile<D>(Vs, vo, k0, Tk, 1.f);
    __syncthreads();

    float s[kRows / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRows / 4; ++j) {
      const int c = sub + 4 * j;
      s[j] = k0 + c < Tk
                 ? dot_rows<D>(Qs + r * Dm::kLd, Ks + c * Dm::kLd)
                 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every tile holds a key < Tk, so m_new is finite; on the first tile
    // alpha = exp2(-inf) = 0 rescales nothing that was accumulated
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int j = 0; j < kRows / 4; ++j) {
      const float p = exp2f(s[j] - m_new);
      l_run += p;
      Ps[r * kPld + sub + 4 * j] = p;
    }
#pragma unroll
    for (int i = 0; i < Dm::kVec; ++i) {
      o[i].x *= alpha;
      o[i].y *= alpha;
      o[i].z *= alpha;
      o[i].w *= alpha;
    }
    __syncwarp();  // a row's p comes from the four lanes of that row
#pragma unroll 4
    for (int c = 0; c < kRows; ++c)
      axpy_row<D>(o, Ps[r * kPld + c], Vs + c * Dm::kLd, sub);
  }

  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  const int row = q0 + r;
  if (row >= Tq) return;
  float* dst = out + ((size_t)b * Tq + row) * H * D + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < Dm::kVec; ++i) {
    const float4 a = o[i];
    *reinterpret_cast<float4*>(dst + 4 * (sub + 4 * i)) =
        make_float4(a.x / l_run, a.y / l_run, a.z / l_run, a.w / l_run);
  }
  if (lse != nullptr && sub == 0)
    lse[((size_t)b * H + h) * Tq + row] = m_run + log2f(l_run);
}

template <int D>
int launch(const void* q, const void* k, const void* v, int B, int Tq,
           int Tk, int H, long long sqb, long long sqt, long long skb,
           long long skt, long long svb, long long svt, float qscale,
           void* out, void* lse, cudaStream_t s) {
  using Dm = Dims<D>;
  const int smem = (3 * Dm::kTile + kRows * kPld) * (int)sizeof(float);
  static const cudaError_t attr = allow_smem(flash_bthd_f32_kernel<D>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_bthd_f32_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
      qscale, static_cast<float*>(out), static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k / v [B, Tk, H, D] fp32, each with its own batch and
// row strides in elements (head stride D, elements contiguous, rows and
// bases 16-byte aligned) -> out [B, Tq, H, D] fp32 contiguous; lse
// [B, H, Tq] fp32 (base 2) where not null.  qscale is fp32(scale * log2 e).
// D = 96 (hieradet) only.
extern "C" int vdn_flash_attention_bthd_f32(
    const void* q, const void* k, const void* v, int B, int Tq, int Tk, int H,
    int D, long long sqb, long long sqt, long long skb, long long skt,
    long long svb, long long svt, float qscale, void* out, void* lse,
    void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 96)
    return launch<96>(q, k, v, B, Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
                      qscale, out, lse, s);
  return cudaErrorInvalidValue;
}
