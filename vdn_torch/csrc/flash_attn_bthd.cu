// C1: attention over [B, T, H, D] tensors with an additive bias per key
// column (the memory bank's slot mask).
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention_colbias
// (_flash_colbias_kernel via _flash_bhtd_colbias): q [B, Tq, H, D],
// k / v [B, Tk, H, D], bias [Tk] -> out [B, Tq, H, D], bf16, D = 64.  On
// the single-image depth path: the cross-attention to the memory bank at
// Tq = 1369 (1813 at a 480 x 640 image) and Tk = 6 * Tq keys with the
// bank's slot mask as the bias (0 for written slots, -inf for the leading
// empty ones), H = 16.  (C2, the same attention without a bias, runs A1's
// kernel in its kBthd form: flash_attn_qkv.cu.)
//
// Bound on the H100 by the two tensor-core products (4 * B * H * Tq * Tk *
// D FLOP over the live keys) and the exp2 of every logit; q, k, v and out
// together are read and written once.  The TPU kernel held one head's
// whole K and V in VMEM (2 * 8214 * 64 * 2 B = 2.1 MB) and took an exact
// full-K softmax over three [B, T, H, D] -> [BH, T, D] copies.  Neither
// carries over:
//   - one block of four warps per (batch, head, 64-row q tile) streams
//     64-key tiles with an online fp32 softmax, the next K/V tile arriving
//     by cp.async while the current one is multiplied;
//   - q, k, v and out are indexed in place through the row stride H * D and
//     the head offset h * D: no transpose copies in or out;
//   - the arithmetic is A1's: scale * log2(e) rounded to bf16 and folded
//     into q in bf16, S = q k^T and O += P V with mma.sync m16n8k16 in fp32,
//     bias * log2(e) added to the logits in fp32, p = bf16(exp2(s - m)),
//     the row sum taken from the rounded p;
//   - a key tile whose columns are all -inf is skipped without being
//     loaded (its p would be 0; with one slot of six written that is 5/6
//     of the keys); a first pass over the bias marks the live tiles in
//     shared memory.  A live tile has a finite column for every row, so the
//     running max is finite from the first tile that is multiplied; the
//     rescale is guarded all the same, so that -inf - (-inf) is never
//     evaluated;
//   - ragged tails (Tq = 1369 = 21 * 64 + 25, Tk = 8214 = 128 * 64 + 22):
//     q rows >= Tq are zero and never stored, key columns >= Tk get -inf
//     logits and zero V.
// Online rescaling rounds p against the running max instead of the final
// one, so results differ from the TPU kernel by a few bf16 ulps at most.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kTile = 64;      // q rows and keys per tile
constexpr int kLd = kD + 8;    // 144-byte rows: conflict-free loads
constexpr int kThreads = 128;  // four warps of 16 q rows
constexpr float kLog2e = 1.4426950408889634f;
// static shared memory below is 46,592 bytes; the live-tile flags (one byte
// per key tile, dynamic) fill the rest of the 48 KB a block gets by default
constexpr int kMaxTiles = 2560;

__global__ void __launch_bounds__(kThreads)
flash_bthd_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ bias, int Tq, int Tk, int H,
                  float qscale, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Ks[2][kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][kTile * kLd];
  __shared__ __align__(16) float Bs[2][kTile];
  extern __shared__ unsigned char live[];  // [n_tiles]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ld = H * kD;  // row stride of q, k, v: [B, T, H, D]
  const __nv_bfloat16* qb = q + (size_t)b * Tq * ld + h * kD;
  const __nv_bfloat16* kb = k + (size_t)b * Tk * ld + h * kD;
  const __nv_bfloat16* vb = v + (size_t)b * Tk * ld + h * kD;
  const int n_tiles = (Tk + kTile - 1) / kTile;

  // a tile is live if any of its columns can carry weight
  for (int j = tid; j < n_tiles; j += kThreads) {
    const int k1 = min((j + 1) * kTile, Tk);
    bool any = false;
    for (int c = j * kTile; c < k1; ++c) any |= bias[c] > -INFINITY;
    live[j] = any;
  }
  __syncthreads();
  auto next_live = [&](int j) {
    while (j < n_tiles && !live[j]) ++j;
    return j;
  };

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * kTile;
    for (int c = tid; c < 2 * kTile * (kD / 8); c += kThreads) {
      const int which = c / (kTile * (kD / 8));  // 0: K, 1: V
      const int r = (c / (kD / 8)) % kTile;
      const int d = (c % (kD / 8)) * 8;
      const int row = k0 + r;
      const __nv_bfloat16* src =
          (which ? vb : kb) + (size_t)(row < Tk ? row : Tk - 1) * ld + d;
      __nv_bfloat16* dst = (which ? Vs[buf] : Ks[buf]) + r * kLd + d;
      vdn::cp_async_16(dst, src, row < Tk ? 16 : 0);
    }
    if (tid < kTile / 4) {
      // 16 bytes = 4 columns; the chunk that straddles Tk is cut short and
      // zero-filled (those columns are masked below)
      const int c0 = k0 + tid * 4;
      const int left = Tk - c0;
      vdn::cp_async_16(&Bs[buf][tid * 4], bias + (left > 0 ? c0 : 0),
                       left >= 4 ? 16 : (left > 0 ? left * 4 : 0));
    }
    vdn::cp_async_commit();
  };

  int j = next_live(0);
  if (j < n_tiles) load_kv(j, 0);

  // q tile, pre-scaled by bf16(scale * log2 e) and rounded to bf16
  for (int c = tid; c < kTile * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), d = (c % (kD / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (q0 + r < Tq) {
      x = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * ld + d);
      __nv_bfloat162* hx = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(hx[i]);
        hx[i] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
    }
    *reinterpret_cast<uint4*>(&Qs[r * kLd + d]) = x;
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
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  int buf = 0;
  while (j < n_tiles) {
    const int j_next = next_live(j + 1);
    if (j_next < n_tiles) {
      load_kv(j_next, buf ^ 1);
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
      for (int i = 0; i < 4; ++i) s[nj][i] = 0.f;
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

    // bias, mask, running max, p = bf16(exp2(s - m))
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj) {
      const int col = nj * 8 + 2 * t;
      const int key = j * kTile + col;
      const float2 bv = *reinterpret_cast<const float2*>(&Bs[buf][col]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nj][i] = __fadd_rn(s[nj][i],
                             __fmul_rn((i & 1) ? bv.y : bv.x, kLog2e));
        if (key + (i & 1) >= Tk) s[nj][i] = -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nj][i]);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // while no finite logit has been seen, nothing is accumulated yet:
      // keep the sums as they are and shift by 0, so every p is exp2(-inf)
      const bool none = m_new == -INFINITY;
      alpha[r] = none ? 1.f : exp2f(m_run[r] - m_new);
      m_use[r] = none ? 0.f : m_new;
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = vdn::bf16r(exp2f(s[nj][i] - m_use[i >> 1]));
        s[nj][i] = p;
        l_run[i >> 1] += p;
      }
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nd][i] *= alpha[i >> 1];

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
    j = j_next;
    buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Tq) continue;
    const float l = l_run[r];
    __nv_bfloat16* dst =
        out + ((size_t)b * Tq + row) * ld + h * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          vdn::pack_bf16(o[nd][2 * r] / l, o[nd][2 * r + 1] / l);
  }
}

}  // namespace

// q [B, Tq, H * 64], k / v [B, Tk, H * 64] bf16 and bias [Tk] fp32
// (natural-log units, -inf allowed, at least one column finite) added to
// every row's logits -> out [B, Tq, H * 64] bf16.  qscale is bf16(scale *
// log2 e).  Head width 64 only; Tk up to 64 * 2560.
extern "C" int vdn_flash_attention_colbias(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           int B, int Tq, int Tk, int H,
                                           float qscale, void* out,
                                           void* stream) {
  const int n_tiles = (Tk + kTile - 1) / kTile;
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || n_tiles > kMaxTiles)
    return cudaErrorInvalidValue;
  dim3 grid((Tq + kTile - 1) / kTile, H, B);
  flash_bthd_kernel<<<grid, kThreads, n_tiles,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(bias), Tq, Tk, H, qscale,
      static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}
