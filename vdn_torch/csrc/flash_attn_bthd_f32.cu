// C2 in fp32: attention over [B, T, H, D] at fp32 accuracy, for hieradet's
// global blocks (vdn/nn/hiera.py:120) on the v1 model: q, k, v [b * s,
// 256, 4, 96] fp32 (16 x 16 tokens at 256 x 256; 324 at 288), read in
// place as slices of the block's fused qkv projection; and SAM2's fp32
// path: the trunks' global blocks at 1024 x 1024 off the fused qkv,
// [1, 4096, 8, 56] (hiera_base_plus), [1, 4096, 8, 72] (hiera_large) and
// [1, 4096, 4, 96] (hiera_tiny, hiera_small), and the memory attention's
// one 256-wide head, q [1,
// 4096, 1, 256] against 4096 keys (self) or 4096 m + 4 p (cross: m mask
// memories, p object pointers; up to 28,736).
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention
// (_flash_kernel via _flash_bhtd) at fp32, where vdn's math is an exact
// full-K softmax: q * (scale * log2 e) rounded to fp32, S = q k^T, p =
// exp2(S - rowmax), out = (p V) / rowsum(p).  The bf16 D = 64 case is A1's
// kernel in its kBthd form (flash_attn_qkv.cu).
//
// Bound on the H100 by its tensor-core products: 4 * B * H * Tq * Tk * D
// FLOP, issued three times over (3xTF32, attn_f32.cuh) at the card's 495
// TF32 TFLOP/s (0.010 ms at v1's [16, 256, 4, 96]); q, k, v and out are
// 6.3 MB, 0.002 ms of memory.  The plain fp32 FMA units (67 TFLOP/s) would
// take 0.024 ms for the same work, and a single TF32 product keeps too few
// bits for the 1e-5 checks.  The TPU kernel held a head's whole K and V in
// VMEM and took the exact softmax in one pass; here one block of four
// warps per (64-row q tile, head, batch) streams 64-key K / V tiles
// through shared memory, double-buffered by cp.async, with an online
// softmax in base 2 (the running max and row sum in registers, O rescaled
// per tile), so the result differs from the exact softmax by fp32 rounding
// only.  Each warp owns 16 q rows: q (times qscale, rounded as the plain
// version's product) stays in registers as the A fragments of S = q k^T;
// the logits' accumulators are the A fragments of P V with the keys of
// each 8-key step taken in the order 2t, 2t + 1 (logical t, t + 4), so p
// never leaves registers, and V's rows are read in the same order.  Every
// operand is split into big and small in registers.  Ragged tails (Tq, Tk
// = 324 = 5 * 64 + 4): q rows >= Tq are zero and never stored, keys >= Tk
// are zero-filled and take -inf logits.
//
// For the backward (D2, flash_attn_bthd_bwd.cu) the training variant also
// writes the row log-sum-exp in base 2, lse = m + log2(l), [B, H, Tq].
//
// At D = 256 a block takes all of an SM's shared memory, and SAM2's one
// head of 4096 rows is 64 blocks on 132 SMs: there the host's plan
// (c2_f32_plan) splits each block's key tiles into ``splits`` shares
// (blockIdx.z = b * splits + share), each share writing O unnormalized with
// its rows' max m and sum l to a scratch buffer, and a second launch
// (combine_f32_kernel) takes out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s -
// M) l_s, M = max_s m_s (exp2f, an IEEE division).  Not with lse.
#include "attn_f32.cuh"

namespace {

using namespace vdn::attn_f32;

constexpr int kQRows = 64;     // q rows per block: four warps of 16
constexpr int kTcThreads = 128;

// The layout of one head width.  Up to D = 128 the warp's q rows stay in
// registers as the A fragments of S (kN * 4 a thread) and the K / V tiles
// hold 64 keys.  At D = 256 those fragments (128 registers) do not fit
// beside O's (128): q, times qscale, waits in shared memory and each
// 8-wide step of S reads its fragment there, and the tiles hold 32 keys,
// so that K and V double-buffered and q fit a block's shared memory.
template <int D>
struct TcDims {
  static_assert(D % 8 == 0, "head width must be a multiple of 8");
  static constexpr bool kQSmem = D > 128;
  static constexpr int kKeys = kQSmem ? 32 : 64;  // keys per K / V tile
  static constexpr int kLd = D + 4;          // floats per shared row
  static constexpr int kTile = kKeys * kLd;  // floats per K or V tile
  static constexpr int kN = D / 8;           // 8-wide steps of the head
  // K and V, two buffers each, and q's 64 rows where kQSmem
  static constexpr int kSmem =
      (4 * kTile + (kQSmem ? kQRows * kLd : 0)) * (int)sizeof(float);
  static_assert(kSmem <= 232448, "an H100 block's dynamic shared memory");
};

// cp.async of rows [t0, t0 + kKeys) of x into a shared tile, rows >= T
// zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(float* tile, Operand x,
                                                int t0, int T) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  constexpr int kKeys = TcDims<D>::kKeys;
  for (int c = threadIdx.x; c < kKeys * kChunks; c += kTcThreads) {
    const int r = c / kChunks, d = (c % kChunks) * 4;
    const bool in = t0 + r < T;
    const float* src = x.base + (in ? (t0 + r) * x.row : 0) + d;
    vdn::cp_async_16(tile + r * TcDims<D>::kLd + d, src, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bthd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, int Tq, int Tk, int H,
                      long long sqb, long long sqt, long long skb,
                      long long skt, long long svb, long long svt,
                      float qscale, float* __restrict__ out,
                      float* __restrict__ lse, int splits,
                      float* __restrict__ o_part,
                      float2* __restrict__ stats) {
  using Dm = TcDims<D>;
  constexpr int kN = Dm::kN;
  constexpr int kKeys = Dm::kKeys;
  constexpr int kS = kKeys / 8;  // 8-key steps per tile
  extern __shared__ __align__(16) float smem[];
  float* const Ks = smem;                 // [2][kKeys][kLd]
  float* const Vs = smem + 2 * Dm::kTile;
  float* const Qs = smem + 4 * Dm::kTile;  // kQSmem: [kQRows][kLd]

  const int q0 = blockIdx.x * kQRows, h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Operand qo = operand(q, sqb, sqt, b, h, D);
  const Operand ko = operand(k, skb, skt, b, h, D);
  const Operand vo = operand(v, svb, svt, b, h, D);
  const int n_all = (Tk + kKeys - 1) / kKeys;
  const int chunk = (n_all + splits - 1) / splits;  // key tiles a share
  const int j0 = split * chunk, ntiles = min(j0 + chunk, n_all);

  load_tile_async<D>(Ks, ko, j0 * kKeys, Tk);
  load_tile_async<D>(Vs, vo, j0 * kKeys, Tk);
  vdn::cp_async_commit();

  // the warp's q rows r0 = q0 + 16 warp + g and r0 + 8 as A fragments:
  // qa[kk] = {q[r0][8kk+t], q[r0+8][8kk+t], q[r0][8kk+t+4], q[r0+8][8kk+t+4]}
  const int r0 = q0 + warp * 16 + g;
  // a warp whose 16 rows all lie past Tq only loads and syncs
  const bool active = q0 + warp * 16 < Tq;
  constexpr int kQa = Dm::kQSmem ? 1 : kN;
  float qa[kQa][4];
  if constexpr (Dm::kQSmem) {
    // q * qscale into shared memory (rows >= Tq zero); the first tile's
    // __syncthreads publishes it
    for (int c = threadIdx.x; c < kQRows * (D / 4); c += kTcThreads) {
      const int r = c / (D / 4), d = (c % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Tq) {
        x = __ldg(reinterpret_cast<const float4*>(qo.base +
                                                  (q0 + r) * qo.row + d));
        x = make_float4(__fmul_rn(x.x, qscale), __fmul_rn(x.y, qscale),
                        __fmul_rn(x.z, qscale), __fmul_rn(x.w, qscale));
      }
      *reinterpret_cast<float4*>(Qs + r * Dm::kLd + d) = x;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kN; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i & 1) * 8;
        const int d = 8 * kk + t + (i >> 1) * 4;
        qa[kk][i] = row < Tq ? __fmul_rn(__ldg(qo.base + row * qo.row + d),
                                         qscale)
                             : 0.f;
      }
  }

  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // running max and this thread's share of the row sum, rows r0 and r0 + 8
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = j0; j < ntiles; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < ntiles) {  // its buffer was last read before the previous sync
      load_tile_async<D>(Ks + (buf ^ 1) * Dm::kTile, ko, (j + 1) * kKeys, Tk);
      load_tile_async<D>(Vs + (buf ^ 1) * Dm::kTile, vo, (j + 1) * kKeys, Tk);
    }
    vdn::cp_async_commit();
    vdn::cp_async_wait<1>();
    __syncthreads();
    const float* ks = Ks + buf * Dm::kTile;
    const float* vs = Vs + buf * Dm::kTile;
    const int kbase = j * kKeys;
    // 8-key steps of the tile that hold a key < Tk (all but in the last)
    const int steps = min(kS, (Tk - kbase + 7) / 8);
    if (active) {

    // S = q k^T over the tile's 64 keys: s[n] holds keys 8n + 2t, 8n + 2t + 1
    float s[kS][4];
#pragma unroll
    for (int n = 0; n < kS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (Dm::kQSmem) {
        const float* qr = Qs + (warp * 16 + g) * Dm::kLd + 8 * kk + t;
        split_tf32(qr[0], ab[0], as[0]);
        split_tf32(qr[8 * Dm::kLd], ab[1], as[1]);
        split_tf32(qr[4], ab[2], as[2]);
        split_tf32(qr[8 * Dm::kLd + 4], ab[3], as[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(qa[kk][i], ab[i], as[i]);
      }
      uint32_t bb[kS][2], bs[kS][2];
#pragma unroll
      for (int n = 0; n < kS; ++n) {
        const float* kr = ks + (8 * n + g) * Dm::kLd + 8 * kk + t;
        split_tf32(kr[0], bb[n][0], bs[n][0]);
        split_tf32(kr[4], bb[n][1], bs[n][1]);
      }
      mma_3xtf32(s, 0, ab, as, bb, bs, steps);
    }

    // keys >= Tk take -inf; every tile holds a key < Tk, so the new max is
    // finite, and on the first tile alpha = exp2(-inf) = 0
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kbase + 8 * n + 2 * t + (i & 1) >= Tk) s[n][i] = -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - mx[i >> 1]);
        l_run[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];

    // O += P V: step kk takes keys 8kk + 2t (logical t) and 8kk + 2t + 1
    // (logical t + 4), which is where S's accumulators left them
#pragma unroll
    for (int kk = 0; kk < kS; ++kk) {
      if (kk >= steps) break;
      uint32_t ab[4], as[4];
      split_tf32(s[kk][0], ab[0], as[0]);
      split_tf32(s[kk][2], ab[1], as[1]);
      split_tf32(s[kk][1], ab[2], as[2]);
      split_tf32(s[kk][3], ab[3], as[3]);
      const float* vr = vs + (8 * kk + 2 * t) * Dm::kLd + g;
      // the head's columns in groups of kG n8 tiles (registers)
      constexpr int kG = kN % 6 == 0 ? 6 : kN % 4 == 0 ? 4
                         : kN % 3 == 0 ? 3 : 1;
#pragma unroll
      for (int n0 = 0; n0 < kN; n0 += kG) {
        uint32_t bb[kG][2], bs[kG][2];
#pragma unroll
        for (int n = 0; n < kG; ++n) {
          split_tf32(vr[8 * (n0 + n)], bb[n][0], bs[n][0]);
          split_tf32(vr[Dm::kLd + 8 * (n0 + n)], bb[n][1], bs[n][1]);
        }
        mma_3xtf32(o, n0, ab, as, bb, bs);
      }
    }
    }  // active
    __syncthreads();  // the tile's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!active) break;
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = r0 + 8 * r;
    if (row >= Tq) continue;
    if (splits > 1) {
      const size_t sb = (size_t)split * (gridDim.z / splits) + b;
      float* part = o_part + ((sb * Tq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kN; ++n)
        *reinterpret_cast<float2*>(part + 8 * n) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (t == 0)
        stats[(sb * H + h) * Tq + row] = make_float2(m_run[r], l_run[r]);
      continue;
    }
    float* dst = out + ((size_t)b * Tq + row) * H * D + (size_t)h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * r] / l_run[r], o[n][2 * r + 1] / l_run[r]);
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Tq + row] = m_run[r] + log2f(l_run[r]);
  }
}

// out [B, Tq, H, D] fp32 from the shares' partial O and (m, l) (o_part
// [splits, B, Tq, H, D], stats [splits, B, H, Tq]): one block of D
// threads a (batch, row, head), thread d its column
template <int D>
__global__ void __launch_bounds__(D)
combine_f32_kernel(const float* __restrict__ o_part,
                   const float2* __restrict__ stats, int splits, int B,
                   int Tq, int H, float* __restrict__ out) {
  const int row = blockIdx.x;  // (b * Tq + q) * H + h
  const int h = row % H, q = (row / H) % Tq, b = row / (H * Tq);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, stats[(((size_t)s * B + b) * H + h) * Tq + q].x);
  float acc = 0.f, l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = stats[(((size_t)s * B + b) * H + h) * Tq + q];
    const float w = exp2f(ml.x - m);
    l = fmaf(w, ml.y, l);
    acc = fmaf(w, o_part[((size_t)s * B * Tq * H + row) * D + threadIdx.x],
               acc);
  }
  out[(size_t)row * D + threadIdx.x] = acc / l;
}

template <int D>
int launch(const void* q, const void* k, const void* v, int B, int Tq,
           int Tk, int H, long long sqb, long long sqt, long long skb,
           long long skt, long long svb, long long svt, float qscale,
           void* out, void* lse, int splits, void* o_part, void* stats,
           cudaStream_t s) {
  using Dm = TcDims<D>;
  static const cudaError_t attr =
      allow_smem(flash_bthd_f32_kernel<D>, Dm::kSmem);
  if (attr != cudaSuccess) return attr;
  if (splits < 1 || (splits > 1 && (lse != nullptr || o_part == nullptr ||
                                    stats == nullptr)) ||
      (Tk + Dm::kKeys - 1) / Dm::kKeys < splits)
    return cudaErrorInvalidValue;
  dim3 grid((Tq + kQRows - 1) / kQRows, H, B * splits);
  flash_bthd_f32_kernel<D><<<grid, kTcThreads, Dm::kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
      qscale, static_cast<float*>(out), static_cast<float*>(lse), splits,
      static_cast<float*>(o_part), static_cast<float2*>(stats));
  if (splits == 1) return cudaGetLastError();
  combine_f32_kernel<D><<<B * Tq * H, D, 0, s>>>(
      static_cast<const float*>(o_part), static_cast<const float2*>(stats),
      splits, B, Tq, H, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k / v [B, Tk, H, D] fp32, each with its own batch and
// row strides in elements (head stride D, elements contiguous, rows and
// bases 16-byte aligned) -> out [B, Tq, H, D] fp32 contiguous; lse
// [B, H, Tq] fp32 (base 2) where not null.  qscale is fp32(scale * log2 e).
// splits (the Python plan's, c2_f32_plan; 1 with lse): the shares of each
// block's key tiles, o_part [splits, B, Tq, H, D] and stats [splits, B,
// H, Tq, 2] fp32 their scratch (null at 1).
// D = 56 (SAM2's hiera_base_plus), 72 (hiera_large), 96 (hieradet,
// hiera_tiny / small) or 256 (SAM2's memory attention).
extern "C" int vdn_flash_attention_bthd_f32(
    const void* q, const void* k, const void* v, int B, int Tq, int Tk, int H,
    int D, long long sqb, long long sqt, long long skb, long long skt,
    long long svb, long long svt, float qscale, void* out, void* lse,
    int splits, void* o_part, void* stats, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || (long long)B * splits > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 56)
    return launch<56>(q, k, v, B, Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
                      qscale, out, lse, splits, o_part, stats, s);
  if (D == 72)
    return launch<72>(q, k, v, B, Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
                      qscale, out, lse, splits, o_part, stats, s);
  if (D == 96)
    return launch<96>(q, k, v, B, Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
                      qscale, out, lse, splits, o_part, stats, s);
  if (D == 256)
    return launch<256>(q, k, v, B, Tq, Tk, H, sqb, sqt, skb, skt, svb, svt,
                       qscale, out, lse, splits, o_part, stats, s);
  return cudaErrorInvalidValue;
}
