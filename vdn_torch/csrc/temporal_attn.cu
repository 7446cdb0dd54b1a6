// A3: the motion-module temporal attention block, out = proj_o(attn_T(x +
// pe)) + bo, over tokens [BN, T, C] (T <= 32 frames, 8 heads, no residual).
//
// Replaces vdn/ops/pallas/temporal_attention.py temporal_attention_block
// (_kernel via _fused_fwd_impl) at (BN, C) = (1369, 1024), (361, 1024),
// (1369, 256), (5476, 256), T = 32, dh = 128 / 32, bf16 (vitl; T 8 in
// training, T 1 on a stream's first frame), and at C 1536 / 384, dh = 192
// / 48 (vitg; vdn's gate has no dh condition).
//
// Bound on the H100 by its four C x C products (8 * BN * T * C^2 FLOP);
// the T x T core is 4 * BN * T^2 * C FLOP, 1-3% of that, bound by its
// bytes (it reads qkv and writes pv, 4 * BN * T * C * 2 bytes).  The TPU
// kernel kept the four weights resident in VMEM and ran the whole block
// per token group; a Hopper block holds 227 KB, so the block is four
// launches from one host call:
//   1. pe_rows_kernel (temporal_attn.cuh): xp = bf16(x + pe[row % T]) [M,
//      C], M = BN * T (TMA applies no prologue to an A operand);
//   2. qkv = xp [wq; wk; wv]^T on the bf16 wgmma + TMA core
//      (bf16_wgmma.cuh, ping-pong, 128 x 128 tiles), the stacked [3C, C]
//      weight K-major as stored, the sums rounded to bf16 (vdn's q, k, v)
//      and stored through the staging tile by TMA;
//   3. a3_core_kernel, the T x T core on the tensor cores
//      (temporal_attn.cuh): one warp per (token, head), S = q k^T on
//      mma.sync, the fp32 softmax (expf, a true division), probs rounded
//      to bf16 and repacked from S's accumulators into A fragments, pv =
//      probs v with v's B fragments by ldmatrix.trans, rounded to bf16
//      into pv [M, C];
//   4. out = bf16(bf16(pv wo^T) + bo) on the core, wo K-major as stored
//      (the fp32 sum over all heads at once, rounded, + bo in bf16).
// xp lives in pv's buffer (the qkv product has read it before the core
// writes pv).  Rounding points as vdn's _kernel (temporal_attention.py:
// 56-93).
#include "temporal_attn.cuh"

namespace {

using vdn::bf16r;
namespace wgbf = vdn::wgbf;
namespace ta = vdn::tattn;

constexpr int kBN = 128;  // the products' tile width
struct A3Rows {};         // the row kernel's caller tag
struct A3Qkv {};          // the qkv product's epilogue tag

// out = bf16(bf16(acc) + bo)
struct EpiOutBias {
  static constexpr int kOuts = 1;
  static constexpr bool kResidual = false;
  static constexpr int kColSumOut = -1;
  static constexpr bool kEdge = false;
  const __nv_bfloat16* b;
  __device__ __forceinline__ float2 col(int n) const {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + n));
  }
  __device__ __forceinline__ void operator()(float2 bias, float v0, float v1,
                                             float2, uint32_t (&o)[1]) const {
    o[0] = vdn::pack_bf16(bf16r(v0) + bias.x, bf16r(v1) + bias.y);
  }
};

template <int DH, int KT>
using Fwd = ta::Core<DH, KT, 3, 0>;

// qkv [M, 3C] -> pv [M, C]: items token * heads + head, each a warp's
template <int DH, int KT>
__global__ void __launch_bounds__(Fwd<DH, KT>::kThreads, 1)
a3_core_kernel(const __nv_bfloat16* __restrict__ qkv, int items, int heads,
               int T, int C, float scale, __nv_bfloat16* __restrict__ pv) {
  using F = Fwd<DH, KT>;
  constexpr int LD = F::LD;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(smem_raw) +
                         warp * F::kStages * F::kSlot;
  ta::zero_tail<LD>(slots, 3 * F::kStages, F::kTensor, F::kRows, T, lane);
  __syncwarp();
  const size_t ld = 3 * (size_t)C;
  // q, k, v of item ``it`` into slot ``st``; one cp.async group a call
  auto fetch = [&](int it, int st) {
    if (it < items) {
      const int token = it / heads, head = it - token * heads;
      const __nv_bfloat16* src = qkv + (size_t)token * T * ld + head * DH;
      __nv_bfloat16* dst = slots + st * F::kSlot;
#pragma unroll
      for (int w = 0; w < 3; ++w)
        ta::load_rows<DH, LD>(dst + w * F::kTensor, src + w * C, ld, T, lane);
    }
    vdn::cp_async_commit();
  };
  const int stride = gridDim.x * F::kWarps;
  int item = blockIdx.x * F::kWarps + warp;
  fetch(item, 0);
#pragma unroll 1
  for (int n = 0; item < items; ++n, item += stride) {
    fetch(item + stride, (n + 1) % F::kStages);
    vdn::cp_async_wait<1>();
    __syncwarp();
    __nv_bfloat16* qs = slots + (n % F::kStages) * F::kSlot;
    const __nv_bfloat16* ks = qs + F::kTensor;
    const __nv_bfloat16* vs = qs + 2 * F::kTensor;
    float s[KT][2 * KT][4];
    ta::rows_by_keys<DH, KT, LD>(s, qs, ks, lane);
    ta::softmax_rows<KT>(s, T, scale, lane);
    uint32_t pa[KT][KT][4];
    ta::pack_a<KT>(pa, s);
    __syncwarp();  // every lane's q reads done: pv is staged over q
#pragma unroll
    for (int c0 = 0; c0 < DH / 8; c0 += F::kCT) {
      float o[KT][F::kCT][4];
      ta::zero(o);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int nd = 0; nd < F::kCT; nd += 2) {
          uint32_t b[4];
          ta::frag_b_t<LD>(b, vs, kk, c0 + nd, lane);
#pragma unroll
          for (int mi = 0; mi < KT; ++mi) {
            ta::mma(o[mi][nd], pa[mi][kk], b[0], b[1]);
            ta::mma(o[mi][nd + 1], pa[mi][kk], b[2], b[3]);
          }
        }
      ta::stage_pairs<KT, F::kCT, LD>(qs, o, 8 * c0, lane);
    }
    __syncwarp();
    const int token = item / heads, head = item - token * heads;
    ta::store_rows<DH, LD>(pv + (size_t)token * T * C + head * DH, qs, C, T,
                           lane);
    __syncwarp();  // the slot's reads done before its next load
  }
  vdn::cp_async_wait<0>();
}

template <int DH>
cudaError_t launch_core(const __nv_bfloat16* qkv, int BN, int T, int C,
                        int heads, float scale, __nv_bfloat16* pv, int grid,
                        cudaStream_t s) {
  return ta::with_kt(T, [&](auto kt) {
    constexpr int KT = decltype(kt)::value;
    using F = Fwd<DH, KT>;
    auto* kernel = a3_core_kernel<DH, KT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, F::kThreads, F::kSmem, s>>>(qkv, BN * heads, heads, T, C,
                                               scale, pv);
    return cudaGetLastError();
  });
}

}  // namespace

// x, out [BN * T, C]; pe [T, C]; wqkv [3C, C] (to_q | to_k | to_v
// weights); wo [C, C]; bo [C]; all bf16.  Scratch: qkv [BN * T, 3C], pv
// [BN * T, C] (xp first).  T <= 32, C % 128 == 0 and C / heads in {32, 48,
// 64, 128, 192}; other shapes return cudaErrorInvalidValue.  grid_qkv,
// grid_c and grid_core: the persistent blocks of the qkv product, the out
// product and the core (kernels/temporal_attention.py temporal_plan).
extern "C" int vdn_temporal_attention(const void* x, int BN, int T, int C,
                                      int heads, const void* pe,
                                      const void* wqkv, const void* wo,
                                      const void* bo, float scale, void* qkv,
                                      void* pv, void* out, int grid_qkv,
                                      int grid_c, int grid_core,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = BN * T;
  const int dh = heads > 0 ? C / heads : 0;
  if (BN < 1 || T < 1 || T > ta::kMaxT || C % kBN || dh * heads != C ||
      (dh != 32 && dh != 48 && dh != 64 && dh != 128 && dh != 192) ||
      grid_core < 1)
    return cudaErrorInvalidValue;
  auto* qkvb = static_cast<__nv_bfloat16*>(qkv);
  auto* pvb = static_cast<__nv_bfloat16*>(pv);
  cudaError_t err = vdn::launch_pe_rows<A3Rows>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(pe), M, T, C, pvb, s);
  if (err != cudaSuccess) return err;
  void* qkv_out = qkvb;
  err = wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kKMajor, wgbf::kNoB, false>(
      M, 3 * C, C, pvb, wqkv, nullptr, nullptr, &qkv_out, nullptr,
      vdn::EpiStore<A3Qkv>{}, grid_qkv, s);
  if (err != cudaSuccess) return err;
  switch (dh) {
    case 192: err = launch_core<192>(qkvb, BN, T, C, heads, scale, pvb, grid_core, s); break;
    case 128: err = launch_core<128>(qkvb, BN, T, C, heads, scale, pvb, grid_core, s); break;
    case 64: err = launch_core<64>(qkvb, BN, T, C, heads, scale, pvb, grid_core, s); break;
    case 48: err = launch_core<48>(qkvb, BN, T, C, heads, scale, pvb, grid_core, s); break;
    default: err = launch_core<32>(qkvb, BN, T, C, heads, scale, pvb, grid_core, s);
  }
  if (err != cudaSuccess) return err;
  return wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kKMajor, wgbf::kNoB, false>(
      M, C, C, pvb, wo, nullptr, nullptr, &out, nullptr,
      EpiOutBias{static_cast<const __nv_bfloat16*>(bo)}, grid_c, s);
}
