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
// unprojections (6 *); the T x T core is 10 * BN * T^2 * C FLOP, bound by
// its bytes (qkv and doh in, dqkv out: 7 * BN * T * C * 2).  The TPU
// kernel kept the four weights in VMEM and did the whole backward per
// token block; here, as A3 (temporal_attn.cu), the products run on the
// bf16 wgmma + TMA core (bf16_wgmma.cuh, ping-pong, 128 x 128 tiles) and
// the core on mma.sync, five launches from one host call:
//   1. pe_rows_kernel: xp = bf16(x + pe[row % T]) [M, C] (in doh's buffer,
//      which the qkv product has read before doh is written);
//   2. qkv = xp [wq; wk; wv]^T, K-major as stored, rounded to bf16 (the
//      forward's q, k, v);
//   3. doh = bf16(g Wo), to_out's weight as stored read MN-major (the
//      core's transpose bit: no transposed copy);
//   4. d4_core_kernel, one warp per (token, head) (temporal_attn.cuh): S =
//      q k^T and dP = doh v^T on mma.sync, the fp32 softmax P (expf, a true
//      division, as the forward), delta = sum dP * P, ds = bf16(P (dP -
//      delta) scale); bf16(P) and ds into shared memory, whence
//      ldmatrix.trans reads the A fragments of dv = bf16(P)^T doh and dk =
//      ds^T q, while dq = ds k takes ds's A fragments from the registers;
//      the operands' B fragments by ldmatrix.trans; dq, dk and dv rounded
//      to bf16 into dqkv [M, 3C];
//   5. dx = dqkv [wq; wk; wv], the stacked weight as stored read MN-major:
//      one fp32 sum over K = 3C, rounded once -- vdn's three unprojections
//      summed in fp32 (temporal_attention.py:199-205).
#include "temporal_attn.cuh"

namespace {

namespace wgbf = vdn::wgbf;
namespace ta = vdn::tattn;

constexpr int kBN = 128;  // the products' tile width
struct D4Rows {};         // the row kernel's caller tag
struct D4Qkv {};          // the products' epilogue tags
struct D4Doh {};
struct D4Dx {};

// a warp's bf16(P) and ds tiles [16 KT, 16 KT + 8] (rows: queries)
template <int KT>
constexpr int kPdLd = 16 * KT + 8;
template <int KT>
constexpr int kPdBytes = 2 * 16 * KT * kPdLd<KT> * 2;

template <int DH, int KT>
using Bwd = ta::Core<DH, KT, 4, kPdBytes<KT>>;

// qkv [M, 3C], doh [M, C] -> dqkv [M, 3C]: items token * heads + head,
// each a warp's
template <int DH, int KT>
__global__ void __launch_bounds__(Bwd<DH, KT>::kThreads, 1)
d4_core_kernel(const __nv_bfloat16* __restrict__ qkv,
               const __nv_bfloat16* __restrict__ doh, int items, int heads,
               int T, int C, float scale, __nv_bfloat16* __restrict__ dqkv) {
  using F = Bwd<DH, KT>;
  constexpr int LD = F::LD;
  constexpr int PL = kPdLd<KT>;
  constexpr int CT = F::kCT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* mine = smem_raw + warp * F::kWarpBytes;
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(mine);
  __nv_bfloat16* pd_s = slots + F::kStages * F::kSlot;  // bf16(P)
  __nv_bfloat16* ds_s = pd_s + F::kRows * PL;           // ds
  ta::zero_tail<LD>(slots, 4 * F::kStages, F::kTensor, F::kRows, T, lane);
  __syncwarp();
  const size_t ld = 3 * (size_t)C;
  // q, k, v, doh of item ``it`` into slot ``st``; one cp.async group
  auto fetch = [&](int it, int st) {
    if (it < items) {
      const int token = it / heads, head = it - token * heads;
      const size_t row0 = (size_t)token * T;
      __nv_bfloat16* dst = slots + st * F::kSlot;
#pragma unroll
      for (int w = 0; w < 3; ++w)
        ta::load_rows<DH, LD>(dst + w * F::kTensor,
                              qkv + row0 * ld + w * C + head * DH, ld, T,
                              lane);
      ta::load_rows<DH, LD>(dst + 3 * F::kTensor, doh + row0 * C + head * DH,
                            C, T, lane);
    }
    vdn::cp_async_commit();
  };
  const int g = lane >> 2, t = lane & 3;
  const int stride = gridDim.x * F::kWarps;
  int item = blockIdx.x * F::kWarps + warp;
  fetch(item, 0);
#pragma unroll 1
  for (int n = 0; item < items; ++n, item += stride) {
    fetch(item + stride, (n + 1) % F::kStages);
    vdn::cp_async_wait<1>();
    __syncwarp();
    __nv_bfloat16* qs = slots + (n % F::kStages) * F::kSlot;
    __nv_bfloat16* ks = qs + F::kTensor;
    __nv_bfloat16* vs = qs + 2 * F::kTensor;
    __nv_bfloat16* gs = qs + 3 * F::kTensor;  // doh
    float p[KT][2 * KT][4], dp[KT][2 * KT][4];
    ta::rows_by_keys<DH, KT, LD>(p, qs, ks, lane);
    ta::rows_by_keys<DH, KT, LD>(dp, gs, vs, lane);
    ta::softmax_rows<KT>(p, T, scale, lane);
    // delta = sum_j dP P (fp32 P) per row, across the quad; ds = bf16(P
    // (dP - delta) scale) into dp; bf16(P) and ds into their tiles
#pragma unroll
    for (int mi = 0; mi < KT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float delta = 0.f;
#pragma unroll
        for (int nj = 0; nj < 2 * KT; ++nj)
          delta += dp[mi][nj][2 * h] * p[mi][nj][2 * h] +
                   dp[mi][nj][2 * h + 1] * p[mi][nj][2 * h + 1];
        delta += __shfl_xor_sync(0xffffffffu, delta, 1);
        delta += __shfl_xor_sync(0xffffffffu, delta, 2);
        const int row = 16 * mi + g + 8 * h;
#pragma unroll
        for (int nj = 0; nj < 2 * KT; ++nj) {
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e)
            dp[mi][nj][e] =
                vdn::bf16r(p[mi][nj][e] * (dp[mi][nj][e] - delta) * scale);
          const int at = row * PL + 8 * nj + 2 * t;
          *reinterpret_cast<uint32_t*>(pd_s + at) =
              vdn::pack_bf16(p[mi][nj][2 * h], p[mi][nj][2 * h + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + at) =
              vdn::pack_bf16(dp[mi][nj][2 * h], dp[mi][nj][2 * h + 1]);
        }
      }
    uint32_t da[KT][KT][4];  // ds as A fragments (rows: queries)
    ta::pack_a<KT>(da, dp);
    __syncwarp();  // the tiles written; v's reads done (dv is staged there)
    float acc[KT][CT][4];
    // dv = bf16(P)^T doh: rows keys, k over the queries
#pragma unroll
    for (int c0 = 0; c0 < DH / 8; c0 += CT) {
      ta::zero(acc);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[KT][4];
#pragma unroll
        for (int mj = 0; mj < KT; ++mj)
          ta::frag_a_t(a[mj], pd_s, PL, mj, kk, lane);
#pragma unroll
        for (int nd = 0; nd < CT; nd += 2) {
          uint32_t b[4];
          ta::frag_b_t(b, gs, LD, kk, c0 + nd, lane);
#pragma unroll
          for (int mj = 0; mj < KT; ++mj) {
            ta::mma(acc[mj][nd], a[mj], b[0], b[1]);
            ta::mma(acc[mj][nd + 1], a[mj], b[2], b[3]);
          }
        }
      }
      ta::stage_pairs<KT, CT, LD>(vs, acc, 8 * c0, lane);
    }
    __syncwarp();  // doh's reads done: dq is staged there
    // dq = ds k: rows queries, k over the keys
#pragma unroll
    for (int c0 = 0; c0 < DH / 8; c0 += CT) {
      ta::zero(acc);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int nd = 0; nd < CT; nd += 2) {
          uint32_t b[4];
          ta::frag_b_t(b, ks, LD, kk, c0 + nd, lane);
#pragma unroll
          for (int mi = 0; mi < KT; ++mi) {
            ta::mma(acc[mi][nd], da[mi][kk], b[0], b[1]);
            ta::mma(acc[mi][nd + 1], da[mi][kk], b[2], b[3]);
          }
        }
      ta::stage_pairs<KT, CT, LD>(gs, acc, 8 * c0, lane);
    }
    __syncwarp();  // k's reads done: dk is staged there
    // dk = ds^T q: rows keys, k over the queries
#pragma unroll
    for (int c0 = 0; c0 < DH / 8; c0 += CT) {
      ta::zero(acc);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[KT][4];
#pragma unroll
        for (int mj = 0; mj < KT; ++mj)
          ta::frag_a_t(a[mj], ds_s, PL, mj, kk, lane);
#pragma unroll
        for (int nd = 0; nd < CT; nd += 2) {
          uint32_t b[4];
          ta::frag_b_t(b, qs, LD, kk, c0 + nd, lane);
#pragma unroll
          for (int mj = 0; mj < KT; ++mj) {
            ta::mma(acc[mj][nd], a[mj], b[0], b[1]);
            ta::mma(acc[mj][nd + 1], a[mj], b[2], b[3]);
          }
        }
      }
      ta::stage_pairs<KT, CT, LD>(ks, acc, 8 * c0, lane);
    }
    __syncwarp();
    const int token = item / heads, head = item - token * heads;
    __nv_bfloat16* dst = dqkv + (size_t)token * T * ld + head * DH;
    ta::store_rows<DH, LD>(dst, gs, ld, T, lane);         // dq
    ta::store_rows<DH, LD>(dst + C, ks, ld, T, lane);     // dk
    ta::store_rows<DH, LD>(dst + 2 * C, vs, ld, T, lane); // dv
    __syncwarp();  // the slot's and the tiles' reads done
  }
  vdn::cp_async_wait<0>();
}

template <int DH>
cudaError_t launch_core(const __nv_bfloat16* qkv, const __nv_bfloat16* doh,
                        int BN, int T, int C, int heads, float scale,
                        __nv_bfloat16* dqkv, int grid, cudaStream_t s) {
  return ta::with_kt(T, [&](auto kt) {
    constexpr int KT = decltype(kt)::value;
    using F = Bwd<DH, KT>;
    auto* kernel = d4_core_kernel<DH, KT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, F::kThreads, F::kSmem, s>>>(qkv, doh, BN * heads, heads,
                                               T, C, scale, dqkv);
    return cudaGetLastError();
  });
}

}  // namespace

// x, g, dx [BN * T, C]; pe [T, C]; wqkv [3C, C] (to_q | to_k | to_v
// weights); wo [C, C] (to_out's weight); all bf16, the weights as stored.
// Scratch: qkv and dqkv [BN * T, 3C], doh [BN * T, C] (xp first).  T <= 32,
// C % 128 == 0 and C / heads in {32, 64, 128}; other shapes return
// cudaErrorInvalidValue.  grid_qkv, grid_c and grid_core: the persistent
// blocks of the qkv product, of the doh and dx products and of the core
// (kernels/temporal_attention.py temporal_plan).
extern "C" int vdn_temporal_attention_bwd(
    const void* x, const void* g, int BN, int T, int C, int heads,
    const void* pe, const void* wqkv, const void* wo, float scale, void* qkv,
    void* doh, void* dqkv, void* dx, int grid_qkv, int grid_c, int grid_core,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = BN * T;
  const int dh = heads > 0 ? C / heads : 0;
  if (BN < 1 || T < 1 || T > ta::kMaxT || C % kBN || dh * heads != C ||
      (dh != 32 && dh != 64 && dh != 128) || grid_core < 1)
    return cudaErrorInvalidValue;
  auto* qkvb = static_cast<__nv_bfloat16*>(qkv);
  auto* dohb = static_cast<__nv_bfloat16*>(doh);
  auto* dqkvb = static_cast<__nv_bfloat16*>(dqkv);
  cudaError_t err = vdn::launch_pe_rows<D4Rows>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(pe), M, T, C, dohb, s);
  if (err != cudaSuccess) return err;
  void* out = qkvb;
  err = wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kKMajor, wgbf::kNoB, false>(
      M, 3 * C, C, dohb, wqkv, nullptr, nullptr, &out, nullptr,
      vdn::EpiStore<D4Qkv>{}, grid_qkv, s);
  if (err != cudaSuccess) return err;
  out = dohb;
  err = wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kMNMajor, wgbf::kNoB, false>(
      M, C, C, g, wo, nullptr, nullptr, &out, nullptr,
      vdn::EpiStore<D4Doh>{}, grid_c, s);
  if (err != cudaSuccess) return err;
  if (dh == 128) err = launch_core<128>(qkvb, dohb, BN, T, C, heads, scale, dqkvb, grid_core, s);
  else if (dh == 64) err = launch_core<64>(qkvb, dohb, BN, T, C, heads, scale, dqkvb, grid_core, s);
  else err = launch_core<32>(qkvb, dohb, BN, T, C, heads, scale, dqkvb, grid_core, s);
  if (err != cudaSuccess) return err;
  return wgbf::launch_gemm_bf16_wgmma<kBN, wgbf::kMNMajor, wgbf::kNoB, false>(
      M, C, 3 * C, dqkvb, wqkv, nullptr, nullptr, &dx, nullptr,
      vdn::EpiStore<D4Dx>{}, grid_c, s);
}
