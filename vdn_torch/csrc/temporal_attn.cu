// A3: the motion-module temporal attention block, out = proj_o(attn_T(x +
// pe)) + bo, over tokens [BN, T, C] (T <= 32 frames, 8 heads, no residual).
//
// Replaces vdn/ops/pallas/temporal_attention.py temporal_attention_block
// (_kernel via _fused_fwd_impl) at (BN, C) = (1369, 1024), (361, 1024),
// (1369, 256), (5476, 256), T = 32, dh = 128 / 32, bf16.
//
// Bound on the H100 by the four C x C projections (8 * BN * T * C^2 FLOP);
// the T x T attention core is 4 * BN * T^2 * C FLOP, 1-3% of that.  The TPU
// kernel kept all four weight matrices resident in VMEM and ran the whole
// block per token group; here the projections go through gemm_tile and the
// block is three launches:
//   1. gemm_tile with the + pe prologue against [wq | wk | wv] -> qkv
//      [BN * T, 3C] bf16 (q, k, v rounded to bf16, as the TPU kernel);
//   2. temporal_core_kernel: one block per (token, head); q, k, v of that
//      head in shared memory, one warp per query row with lane j holding
//      key j, so the 32 x 32 fp32 logits and the softmax stay in registers;
//      probs rounded to bf16, pv = probs @ v in fp32 rounded to bf16.  The
//      core is small, so it uses fp32 FMA rather than the tensor cores;
//   3. gemm_tile for pv @ wo^T (the fp32 sum over all heads at once), the
//      sum rounded to bf16, then + bo in bf16.
// The qkv and pv round trips are 4 * BN * T * C * 2 bytes, which the
// projections' arithmetic covers many times over.
#include <math.h>

#include "gemm_tile.cuh"

namespace {

using vdn::bf16r;
using vdn::bf2f;

struct EpiStore {
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)m * ld + n) =
        vdn::pack_bf16(v0, v1);
  }
};

struct EpiBias {
  const __nv_bfloat16* b;
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)m * ld + n) =
        vdn::pack_bf16(bf16r(v0) + bf2f(b[n]), bf16r(v1) + bf2f(b[n + 1]));
  }
};

constexpr int kMaxT = 32;
constexpr int kCoreThreads = 128;

// qkv [BN * T, 3C] -> pv [BN * T, C] for one (token, head) per block.
template <int DH>
__global__ void __launch_bounds__(kCoreThreads)
temporal_core_kernel(const __nv_bfloat16* __restrict__ qkv, int T, int C,
                     float scale, __nv_bfloat16* __restrict__ pv) {
  constexpr int LD = DH + 2;  // odd word stride: lane j reads row j conflict-free
  __shared__ __align__(16) __nv_bfloat16 qs[kMaxT * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[kMaxT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kMaxT * LD];
  __shared__ float ps[kMaxT][kMaxT + 1];

  const int token = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)token * T;
  const int ld3 = 3 * C;

  // stage q / k / v of this head; rows >= T are zero
  constexpr int kChunks = DH / 8;
  for (int c = tid; c < 3 * kMaxT * kChunks; c += kCoreThreads) {
    const int which = c / (kMaxT * kChunks);
    const int r = (c / kChunks) % kMaxT;
    const int d = (c % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < T)
      v = *reinterpret_cast<const uint4*>(
          qkv + (row0 + r) * ld3 + which * C + head * DH + d);
    __nv_bfloat16* dst = (which == 0 ? qs : which == 1 ? ks : vs) + r * LD + d;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reinterpret_cast<__nv_bfloat162*>(dst)[j] = h[j];
  }
  __syncthreads();

  // logits and softmax: warp w takes query rows w, w + 4, ...; lane = key
  for (int i = warp; i < T; i += kCoreThreads / 32) {
    float s = -INFINITY;
    if (lane < T) {
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qs + i * LD);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(ks + lane * LD);
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH / 2; ++d) {
        const float2 a = __bfloat1622float2(q2[d]);
        const float2 b = __bfloat1622float2(k2[d]);
        acc += a.x * b.x + a.y * b.y;
      }
      s = acc * scale;
    }
    const float m = vdn::warp_max(s);
    const float e = lane < T ? expf(s - m) : 0.f;
    const float sum = vdn::warp_sum(e);
    ps[i][lane] = bf16r(e / sum);
  }
  __syncthreads();

  // pv = probs @ v: thread -> one column pair, a stride of rows
  constexpr int kPairs = DH / 2;
  const int cp = tid % kPairs;
  for (int i = tid / kPairs; i < T; i += kCoreThreads / kPairs) {
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < T; ++j) {
      const float p = ps[i][j];
      const float2 v = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(vs + j * LD)[cp]);
      a0 += p * v.x;
      a1 += p * v.y;
    }
    *reinterpret_cast<uint32_t*>(pv + (row0 + i) * C + head * DH + 2 * cp) =
        vdn::pack_bf16(a0, a1);
  }
}

template <int DH>
cudaError_t launch_core(const __nv_bfloat16* qkv, int BN, int T, int C,
                        int heads, float scale, __nv_bfloat16* pv,
                        cudaStream_t s) {
  temporal_core_kernel<DH><<<dim3(BN, heads), kCoreThreads, 0, s>>>(
      qkv, T, C, scale, pv);
  return cudaGetLastError();
}

}  // namespace

// x, out [BN * T, C]; pe [T, C]; wqkv [3C, C] (to_q | to_k | to_v weights);
// wo [C, C]; bo [C]; all bf16.  Scratch: qkv [BN * T, 3C], pv [BN * T, C].
// T <= 32 and C / heads in {32, 64, 128}; other shapes return
// cudaErrorInvalidValue.
extern "C" int vdn_temporal_attention(const void* x, int BN, int T, int C,
                                      int heads, const void* pe,
                                      const void* wqkv, const void* wo,
                                      const void* bo, float scale, void* qkv,
                                      void* pv, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = BN * T;
  const int dh = C / heads;
  if (T > kMaxT || dh * heads != C || (dh != 32 && dh != 64 && dh != 128))
    return cudaErrorInvalidValue;
  auto* qkvb = static_cast<__nv_bfloat16*>(qkv);
  auto* pvb = static_cast<__nv_bfloat16*>(pv);
  cudaError_t err = vdn::launch_gemm<false>(
      M, 3 * C, C, static_cast<const __nv_bfloat16*>(x), C,
      static_cast<const __nv_bfloat16*>(wqkv),
      vdn::ProAddPe{static_cast<const __nv_bfloat16*>(pe), T, C},
      EpiStore{qkvb, 3 * C}, s);
  if (err != cudaSuccess) return err;
  if (dh == 128) err = launch_core<128>(qkvb, BN, T, C, heads, scale, pvb, s);
  else if (dh == 64) err = launch_core<64>(qkvb, BN, T, C, heads, scale, pvb, s);
  else err = launch_core<32>(qkvb, BN, T, C, heads, scale, pvb, s);
  if (err != cudaSuccess) return err;
  return vdn::launch_gemm<false>(
      M, C, C, pvb, C, static_cast<const __nv_bfloat16*>(wo),
      vdn::ProIdentity{},
      EpiBias{static_cast<const __nv_bfloat16*>(bo),
              static_cast<__nv_bfloat16*>(out), C},
      s);
}
