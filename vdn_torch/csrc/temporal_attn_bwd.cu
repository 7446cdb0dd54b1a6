// D4: dx of A3, the motion-module temporal attention block.
//
// Replaces vdn/ops/pallas/temporal_attention.py _fused_bwd_dx_impl
// (_bwd_kernel): for out = proj_o(attn_T(x + pe)) + bo over [BN, T, C]
// tokens and the cotangent g, dx [BN, T, C] -- the only cotangent that
// survives when the temporal head is frozen (the v4 recipe), and the one
// the encoder needs.  vitl's training step (b2 t8) runs it at (BN, C) =
// (2738, 1024), (722, 1024), (2738, 256), (10952, 256), T = 8, bf16.
//
// Bound on the H100 by its C x C products: the recomputed q / k / v
// projection (6 * BN * T * C^2 FLOP), doh = g Wo (2 *) and the three
// unprojections (6 *); the T x T core is 10 * BN * T^2 * C.  The TPU kernel
// kept the four weights in VMEM and did the whole backward per token
// block; here, as A3 (temporal_attn.cu), the products go through gemm_tile
// and the core is one small block per (token, head), four launches:
//   1. gemm_tile with the + pe prologue against [wq | wk | wv]: q, k, v
//      [BN * T, 3C] rounded to bf16 (the forward's first launch again);
//   2. gemm_tile g Wo -> doh [BN * T, C] rounded to bf16;
//   3. temporal_bwd_core_kernel: q, k, v and doh of one (token, head) in
//      shared memory, one warp per query row with lane j holding key j:
//      logits and the fp32 softmax (exp, not exp2, as the forward), dp =
//      doh v^T, delta = sum dp * probs, ds = bf16(probs (dp - delta)
//      scale), then dv = bf16(probs)^T doh, dq = ds k and dk = ds^T q, each
//      summed in fp32 and rounded to bf16 into dqkv [BN * T, 3C];
//   4. gemm_tile dqkv [wq; wk; wv] -> dx: one fp32 sum over K = 3C,
//      rounded once -- vdn's three unprojections summed in fp32
//      (temporal_attention.py:199-205).
// Wo and [wq; wk; wv] enter launches 2 and 4 transposed (made by the
// wrapper), the K-contiguous layout gemm_tile reads.
#include <math.h>

#include "gemm_tile.cuh"

namespace {

using vdn::bf16r;

struct EpiStoreTemporalBwd {
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)m * ld + n) =
        vdn::pack_bf16(v0, v1);
  }
};

constexpr int kMaxT = 32;
constexpr int kCoreThreads = 128;

// qkv [BN * T, 3C], doh [BN * T, C] -> dqkv [BN * T, 3C], one (token,
// head) per block
template <int DH>
__global__ void __launch_bounds__(kCoreThreads)
temporal_bwd_core_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ doh, int T, int C,
                         float scale, __nv_bfloat16* __restrict__ dqkv) {
  constexpr int LD = DH + 2;  // odd word stride: lane j reads row j conflict-free
  __shared__ __align__(16) __nv_bfloat16 qs[kMaxT * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[kMaxT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kMaxT * LD];
  __shared__ __align__(16) __nv_bfloat16 gs[kMaxT * LD];
  __shared__ float ps[kMaxT][kMaxT + 1];   // bf16(probs)
  __shared__ float dss[kMaxT][kMaxT + 1];  // bf16(ds)

  const int token = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)token * T;
  const int ld3 = 3 * C;

  // stage q / k / v / doh of this head; rows >= T are zero
  constexpr int kChunks = DH / 8;
  for (int c = tid; c < 4 * kMaxT * kChunks; c += kCoreThreads) {
    const int which = c / (kMaxT * kChunks);
    const int r = (c / kChunks) % kMaxT;
    const int d = (c % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < T) {
      const __nv_bfloat16* src =
          which < 3 ? qkv + (row0 + r) * ld3 + which * C + head * DH + d
                    : doh + (row0 + r) * C + head * DH + d;
      v = *reinterpret_cast<const uint4*>(src);
    }
    __nv_bfloat16* dst =
        (which == 0 ? qs : which == 1 ? ks : which == 2 ? vs : gs) + r * LD + d;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reinterpret_cast<__nv_bfloat162*>(dst)[j] = h[j];
  }
  __syncthreads();

  // warp w takes query rows w, w + 4, ...; lane = key
  for (int i = warp; i < T; i += kCoreThreads / 32) {
    float s = -INFINITY, dp = 0.f;
    if (lane < T) {
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qs + i * LD);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(ks + lane * LD);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(gs + i * LD);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(vs + lane * LD);
      float acc = 0.f, dacc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH / 2; ++d) {
        const float2 a = __bfloat1622float2(q2[d]);
        const float2 b = __bfloat1622float2(k2[d]);
        const float2 gg = __bfloat1622float2(g2[d]);
        const float2 vv = __bfloat1622float2(v2[d]);
        acc += a.x * b.x + a.y * b.y;
        dacc += gg.x * vv.x + gg.y * vv.y;
      }
      s = acc * scale;
      dp = dacc;
    }
    const float m = vdn::warp_max(s);
    const float e = lane < T ? expf(s - m) : 0.f;
    const float p = e / vdn::warp_sum(e);
    const float delta = vdn::warp_sum(dp * p);
    ps[i][lane] = bf16r(p);
    dss[i][lane] = bf16r(p * (dp - delta) * scale);
  }
  __syncthreads();

  // thread -> one column pair of one row: dq_i = sum_j ds_ij k_j, dk_i =
  // sum_j ds_ji q_j, dv_i = sum_j bf16(p)_ji doh_j
  constexpr int kPairs = DH / 2;
  const int cp = tid % kPairs;
  for (int i = tid / kPairs; i < T; i += kCoreThreads / kPairs) {
    float dq0 = 0.f, dq1 = 0.f, dk0 = 0.f, dk1 = 0.f, dv0 = 0.f, dv1 = 0.f;
    for (int j = 0; j < T; ++j) {
      const float2 kv = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(ks + j * LD)[cp]);
      const float2 qv = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(qs + j * LD)[cp]);
      const float2 gv = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(gs + j * LD)[cp]);
      const float a = dss[i][j], b = dss[j][i], p = ps[j][i];
      dq0 += a * kv.x;
      dq1 += a * kv.y;
      dk0 += b * qv.x;
      dk1 += b * qv.y;
      dv0 += p * gv.x;
      dv1 += p * gv.y;
    }
    __nv_bfloat16* dst = dqkv + (row0 + i) * ld3 + head * DH + 2 * cp;
    *reinterpret_cast<uint32_t*>(dst) = vdn::pack_bf16(dq0, dq1);
    *reinterpret_cast<uint32_t*>(dst + C) = vdn::pack_bf16(dk0, dk1);
    *reinterpret_cast<uint32_t*>(dst + 2 * C) = vdn::pack_bf16(dv0, dv1);
  }
}

template <int DH>
cudaError_t launch_core(const __nv_bfloat16* qkv, const __nv_bfloat16* doh,
                        int BN, int T, int C, int heads, float scale,
                        __nv_bfloat16* dqkv, cudaStream_t s) {
  temporal_bwd_core_kernel<DH><<<dim3(BN, heads), kCoreThreads, 0, s>>>(
      qkv, doh, T, C, scale, dqkv);
  return cudaGetLastError();
}

}  // namespace

// x, g, dx [BN * T, C]; pe [T, C]; wqkv [3C, C] (to_q | to_k | to_v
// weights); woT [C, C] (= to_out weight^T); wqkvT [C, 3C] (= wqkv^T); all
// bf16.  Scratch: qkv and dqkv [BN * T, 3C], doh [BN * T, C].  T <= 32 and
// C / heads in {32, 64, 128}; other shapes return cudaErrorInvalidValue.
extern "C" int vdn_temporal_attention_bwd(
    const void* x, const void* g, int BN, int T, int C, int heads,
    const void* pe, const void* wqkv, const void* woT, const void* wqkvT,
    float scale, void* qkv, void* doh, void* dqkv, void* dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = BN * T;
  const int dh = C / heads;
  if (T > kMaxT || dh * heads != C || (dh != 32 && dh != 64 && dh != 128))
    return cudaErrorInvalidValue;
  auto* qkvb = static_cast<__nv_bfloat16*>(qkv);
  auto* dohb = static_cast<__nv_bfloat16*>(doh);
  auto* dqkvb = static_cast<__nv_bfloat16*>(dqkv);
  cudaError_t err = vdn::launch_gemm<false>(
      M, 3 * C, C, static_cast<const __nv_bfloat16*>(x), C,
      static_cast<const __nv_bfloat16*>(wqkv),
      vdn::ProAddPe{static_cast<const __nv_bfloat16*>(pe), T, C},
      EpiStoreTemporalBwd{qkvb, 3 * C}, s);
  if (err != cudaSuccess) return err;
  err = vdn::launch_gemm<false>(
      M, C, C, static_cast<const __nv_bfloat16*>(g), C,
      static_cast<const __nv_bfloat16*>(woT), vdn::ProIdentity{},
      EpiStoreTemporalBwd{dohb, C}, s);
  if (err != cudaSuccess) return err;
  if (dh == 128) err = launch_core<128>(qkvb, dohb, BN, T, C, heads, scale, dqkvb, s);
  else if (dh == 64) err = launch_core<64>(qkvb, dohb, BN, T, C, heads, scale, dqkvb, s);
  else err = launch_core<32>(qkvb, dohb, BN, T, C, heads, scale, dqkvb, s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm<false>(
      M, C, 3 * C, dqkvb, 3 * C, static_cast<const __nv_bfloat16*>(wqkvT),
      vdn::ProIdentity{},
      EpiStoreTemporalBwd{static_cast<__nv_bfloat16*>(dx), C}, s);
}
