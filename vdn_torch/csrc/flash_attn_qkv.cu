// A1: ViT self-attention read straight off the fused qkv projection.
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention_fused_qkv
// (_flash_cols_kernel via _flash_cols_call): qkv [B, T, 3, H, D] ->
// out [B, T, H, D], at vitl's B = 22 or 32 frames, T = 1370, H = 16,
// D = 64, bf16.
//
// Bound on the H100 by the two tensor-core products (4 * B * H * T^2 * D
// FLOP) and the exp2 of every logit.  The TPU kernel held one head's whole
// K and V (2 * 1370 * 64 * 2 B = 350 KB) in VMEM and took an exact full-K
// softmax; that does not fit a Hopper block's shared memory, so this kernel
// streams 64-key tiles with an online softmax (FlashAttention-2):
//   - one block of four warps per (frame, head, 64-row q tile), each warp
//     owning 16 q rows; q, k and v are read through strides straight out of
//     [B, T, 3C] (no split or transpose copies, the point of the TPU
//     kernel), the next K/V tile arriving by cp.async while the current one
//     is multiplied;
//   - S = q k^T and O += P V with mma.sync m16n8k16, fp32 accumulators;
//     P's accumulator fragments are reused as the A operand of P V, and V's
//     B fragments come from ldmatrix.trans;
//   - fp32 running max and sum, base 2: scale * log2(e) is rounded to bf16
//     and folded into q in bf16, as the TPU kernel; p is rounded to bf16
//     before P V and the row sum is taken from the rounded p;
//   - the ragged tail (T = 1370 = 21 * 64 + 26) is masked: q rows >= T are
//     zero and never stored, key columns >= T get -inf logits and zero V.
// Online rescaling rounds p against the running max instead of the final
// one, so results differ from the TPU kernel by a few bf16 ulps at most.
//
// The training forward (_flash_cols_call(save_lse=True)) is the same kernel
// with kLse: it also writes each row's base-2 log-sum-exp m + log2(l) in
// fp32 from the final running max and sum, laid out [B, H, T] (vdn's
// [B, n_colblocks, hb, T] is a TPU lane constraint).  The backward (D1,
// flash_attn_qkv_bwd.cu) recomputes the normalized softmax from it.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kTile = 64;      // q rows and keys per tile
constexpr int kLd = kD + 8;    // 144-byte rows: conflict-free loads
constexpr int kThreads = 128;  // four warps of 16 q rows

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_qkv_kernel(const __nv_bfloat16* __restrict__ qkv, int T, int H,
                 float qscale, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Ks[2][kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][kTile * kLd];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = H * kD, ld = 3 * C;
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld + h * kD;

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

  const int n_tiles = (T + kTile - 1) / kTile;
  load_kv(0, 0);

  // q tile, pre-scaled by bf16(scale * log2 e) and rounded to bf16
  for (int c = tid; c < kTile * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), d = (c % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < T) {
      v = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ld + d);
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(hv[j]);
        hv[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
    }
    *reinterpret_cast<uint4*>(&Qs[r * kLd + d]) = v;
  }
  __syncthreads();

  uint32_t qf[kD / 16][4];
  {
    const int r = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(&Qs[r * kLd + c]);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r + 8) * kLd + c]);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(&Qs[r * kLd + c + 8]);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r + 8) * kLd + c + 8]);
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[nd][q] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, buf ^ 1);
      vdn::cp_async_wait<1>();
    } else {
      vdn::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = Ks[buf];
    const __nv_bfloat16* vs = Vs[buf];

    float s[kTile / 8][4];
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[nj][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
#pragma unroll
      for (int nj = 0; nj < kTile / 8; ++nj) {
        const int r = nj * 8 + g;
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(&ks[r * kLd + c]);
        bfr[1] = *reinterpret_cast<const uint32_t*>(&ks[r * kLd + c + 8]);
        vdn::mma_bf16_16816(s[nj], qf[kk], bfr);
      }
    }

    // mask, running max, p = bf16(exp2(s - m))
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj) {
      const int key = j * kTile + nj * 8 + 2 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (key + (q & 1) >= T) s[nj][q] = -INFINITY;
        mx[q >> 1] = fmaxf(mx[q >> 1], s[nj][q]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float p = vdn::bf16r(exp2f(s[nj][q] - m_run[q >> 1]));
        s[nj][q] = p;
        l_run[q >> 1] += p;
      }
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
      for (int q = 0; q < 4; ++q) o[nd][q] *= alpha[q >> 1];

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a[0] = vdn::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = vdn::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = vdn::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = vdn::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mat = lane >> 3;
      const int key = kk * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
      for (int nd = 0; nd < kD / 16; ++nd) {
        uint32_t v4[4];
        vdn::ldmatrix_x4_trans(v4, &vs[key * kLd + (2 * nd + (mat >> 1)) * 8]);
        const uint32_t b0[2] = {v4[0], v4[1]};
        const uint32_t b1[2] = {v4[2], v4[3]};
        vdn::mma_bf16_16816(o[2 * nd], a, b0);
        vdn::mma_bf16_16816(o[2 * nd + 1], a, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= T) continue;
    const float l = l_run[r];
    if constexpr (kLse) {
      if (t == 0) lse[((size_t)b * H + h) * T + row] = m_run[r] + log2f(l);
    }
    __nv_bfloat16* dst = out + ((size_t)b * T + row) * C + h * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          vdn::pack_bf16(o[nd][2 * r] / l, o[nd][2 * r + 1] / l);
  }
}

}  // namespace

// qkv [B, T, 3 * H * 64] bf16 -> out [B, T, H * 64] bf16.  qscale is
// bf16(scale * log2 e).  Head width 64 only.
extern "C" int vdn_flash_attention_qkv(const void* qkv, int B, int T, int H,
                                       float qscale, void* out,
                                       void* stream) {
  dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_qkv_kernel<false>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(qkv), T, H, qscale,
          static_cast<__nv_bfloat16*>(out), nullptr);
  return cudaGetLastError();
}

// The training forward: as above, and lse [B, H, T] fp32, the base-2
// log-sum-exp of each row's logits (scaled by qscale).
extern "C" int vdn_flash_attention_qkv_lse(const void* qkv, int B, int T,
                                           int H, float qscale, void* out,
                                           void* lse, void* stream) {
  dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_qkv_kernel<true>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(qkv), T, H, qscale,
          static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse));
  return cudaGetLastError();
}
