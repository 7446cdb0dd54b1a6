// A1: ViT self-attention read straight off the fused qkv projection.
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention_fused_qkv
// (_flash_cols_kernel via _flash_cols_call): qkv [B, T, 3, H, D] ->
// out [B, T, H, D], D = 64, bf16; vitl's B = 22 or 32 frames, T = 1370,
// H = 16 (vits 6, vitb 12, vitg 24 heads; T 1814 at a 480 x 640 image).
//
// Bound on the H100 by the two tensor-core products (4 * B * H * T^2 * D
// FLOP) and, as much, by the exp2 of every logit: at D = 64 the two
// products of a 64-row x 128-key tile take ~512 clocks of an SM's tensor
// cores and its 8,192 exp2 as many of its MUFU (16 a clock).  The TPU
// kernel held one head's whole K and V in VMEM and took an exact full-K
// softmax; here the keys stream through shared memory with an online
// softmax, and one warpgroup's softmax runs under the other's products
// (FlashAttention-3's ping-pong), on wgmma and TMA (sm90.cuh):
//   - persistent blocks (the Python plan's grid, one per SM) walk the
//     work items (frame, head, 128-row q tile), the q tiles of one head on
//     neighbouring blocks, so that its K and V stay in L2;
//   - a producer warp keeps TMA loads in flight: each item's q tile (two
//     buffers, so the next item's loads run under this one's products) and
//     a ring of kStages stages, a 128-key K tile and its V tile each, all
//     128-byte rows in the 128-byte swizzle behind full / empty mbarriers.
//     The tensor maps keep the frame as a dimension of its own ([B, T,
//     3C]), so TMA zero-fills rows >= T of the ragged tail (1370 = 10 *
//     128 + 90) and never reads the next frame's;
//   - two consumer warpgroups own 64 q rows each.  Each scales its rows in
//     shared memory in place, qs = bf16(q * bf16(scale * log2 e)) as the
//     TPU kernel folds it, and then per key tile j, in its turn, issues O
//     += P_{j-1} V_{j-1} (register-A wgmma m64n64k16: P as bf16 A
//     fragments, V read MN-major through the descriptor's transpose bit)
//     and S_j = qs K_j^T (wgmma m64n128k16 from shared memory), hands the
//     turn to the other warpgroup (named barriers), waits for both
//     products, and runs the online softmax of S_j in registers while the
//     other warpgroup's products run: the running max m, alpha = exp2(m_old
//     - m) on O, p = bf16(exp2(S - m)) by the MUFU's ex2.approx.ftz.  qs
//     stays in shared memory: as A fragments its 16 registers a thread
//     would not fit beside S (64), P (32) and O (36) in the 168 that ptxas
//     gives a thread of 288;
//   - the row sum l of the rounded p comes from the tensor cores: P V runs
//     as m64n72k16, V's 64 columns and 8 of a constant tile of ones in
//     shared memory (its second swizzle atom along N, reached through the
//     descriptor's leading byte offset), so O's columns 64-71 hold l in
//     fp32 and the online rescale scales it with O.  Summed in registers
//     (unpack and add, four instructions a pair of p) the row sums cost
//     more than the exp2 (tools/a1_variants.py, PERF.md section 6);
//   - the epilogue: O * (1 / l) to bf16 into the warpgroup's swizzled
//     staging tile, stored by TMA through a 3-D map of out (rows >= T are
//     not written).
// Online rescaling rounds p against the running max instead of the final
// one, so results differ from the TPU kernel's by a few bf16 ulps at most.
//
// The kernel has four forms (kForm):
//   - kA1, the forward above;
//   - kA1Lse, the training forward (_flash_cols_call(save_lse=True)): it
//     also writes each row's base-2 log-sum-exp m + log2(l) in fp32 from
//     the final running max and sum, laid out [B, H, T] (vdn's [B,
//     n_colblocks, hb, T] is a TPU lane constraint).  The backward (D1,
//     flash_attn_qkv_bwd.cu) recomputes the normalized softmax from it;
//   - kC3, C3: replaces flash_attention_qkv (_flash_qkv_kernel), the same
//     function written head-major, out [B, H, T, D], with vdn's
//     natural-unit arithmetic for it: q is not scaled, s = fp32(q k^T) *
//     scale, p = exp(s - m) in fp32 (as exp2(S c - m c) with c = scale *
//     log2 e, one rounding fewer than vdn's steps: within an fp32 ulp or
//     two of p), the row sum l of the unrounded p taken in registers (the
//     ones column would sum the rounded p), p rounded to bf16 for P V only
//     (m64n64k16), out = O / l, stored through a 3-D map of out as [B * H,
//     T, 64].  No model path calls it;
//   - kBthd, C2: replaces flash_attention (_flash_kernel via _flash_bhtd),
//     attention over separate q [B, Tq, H, D] and k, v [B, Tk, H, D] (the
//     memory block's self-attention, Tq = Tk = 1369 or 1813, H 16, D 64;
//     SAM2's hiera_base_plus global blocks, Tq = Tk = 4096, H 8, D 56):
//     A1's arithmetic unchanged, q, k and v each read in place through a
//     4-D map of its own ([B, T, H, D] with the operand's strides: q, k
//     and v may be slices of one fused qkv), the box 64 columns of one
//     head, so that a 56-wide head's columns 56-63 load as zeros (they add
//     nothing to S, and O's columns there are not stored); the q tiles
//     counted over Tq and the key tiles over Tk, keys >= Tk masked in the
//     tail tile, out [B, Tq, H, D] through a 4-D map of its own.  D = 256
//     (SAM2's memory attention) is a kernel of its own
//     (flash_attn_wide.cu): its O does not fit beside A1's S.
//   - kC1, C1: replaces flash_attention_colbias (_flash_colbias_kernel
//     via _flash_bhtd_colbias), kBthd's attention with an additive fp32
//     bias per key column (the memory bank's slot mask: 0 for written
//     slots, -inf for the leading empty ones; Tk = 6 Tq): the block first
//     marks the live key tiles (a column above -inf) from the bias and
//     lists them in order in shared memory, and producer and consumers
//     walk that list alone (with one slot of six written, 5/6 of the keys
//     are never loaded).  The whole producer warp carries each stage's 128
//     bias values, bias * log2 e rounded to fp32 (-inf past Tk), into
//     shared memory beside its K and V tiles (each lane arrives on the
//     stage's mbarrier); softmax_tile adds them to S before the row max
//     and masks keys >= Tk after.  A live tile has a finite logit in every
//     row, as the bias is one per column; the rescale is guarded all the
//     same (a row max of -inf shifts by 0), so that -inf - (-inf) is never
//     evaluated.
// Each form is a template case, not a branch in another form's path.
#include <math.h>

#include "attn_wgmma.cuh"

namespace {

constexpr int kD = 64;          // head width: one 128-byte swizzle row
constexpr int kRows = 128;      // q rows of a work item, keys of a stage
constexpr int kTileBytes = kRows * kD * 2;  // 16 KB, 1024-aligned
constexpr int kOutBytes = 64 * kD * 2;      // a warpgroup's staging tile
constexpr int kStages = 4;
// consumers: warpgroups 0 and 1; producer: one warp
constexpr int kThreads = 288;
constexpr int kConsumers = 256;
constexpr int kBarriers = 2 * kStages + 4;
// two q tiles, two staging tiles, the ring, the tile of ones, the
// barriers, 1024 bytes of alignment
constexpr int kSmem = 1024 + 2 * kTileBytes + 2 * kOutBytes +
                      kStages * 2 * kTileBytes + kTileBytes + 8 * kBarriers;
static_assert(kSmem <= 232448, "an H100 block's dynamic shared memory");
// kC1 also: after the barriers (128 bytes from their start), each stage's
// 128 bias values, then the live-tile flags, the live list and its length
constexpr int kMaxKeyTiles = 4096;
constexpr int kBiasBytes = kRows * 4;
constexpr int kC1Smem = kSmem + (128 - 8 * kBarriers) + kStages * kBiasBytes +
                        kMaxKeyTiles * 3 + 16;
static_assert(kC1Smem <= 232448, "an H100 block's dynamic shared memory");
// named barriers: kTurn + w, warpgroup w's turn at the tensor cores;
// kOwn + w, warpgroup w's own 128 threads
constexpr int kTurn = 1, kOwn = 3;
constexpr float kLog2e = 1.4426950408889634f;
// the kernel's forms (see the note above)
constexpr int kA1 = 0, kA1Lse = 1, kC3 = 2, kBthd = 3, kC1 = 4;

// The online softmax of one 64 x 128 tile S (accumulator layout; key0 the
// key of this thread's first column, keys >= T masked where kMask): with
// kBias first + bias * log2 e (fp32 pairs at ``bias`` in shared memory,
// the stage's values of this thread's columns), then the running max of
// the thread's two rows, O (and with it the row sums in its columns 64-71)
// rescaled, and P = bf16(exp2(S - m)) as the A fragments of the P V
// product.  With kBias a row max of -inf (no finite logit yet) keeps O
// and shifts by 0.
template <bool kMask, bool kBias = false>
__device__ __forceinline__ void softmax_tile(float (&s)[64],
                                             uint32_t (&pa)[8][4],
                                             float (&o)[36],
                                             float (&m_run)[2], int key0,
                                             int T,
                                             const float* bias = nullptr) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float2 bv;
    if constexpr (kBias)
      bv = *reinterpret_cast<const float2*>(bias + 8 * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kBias) s[4 * i + e] += (e & 1) ? bv.y : bv.x;
      if (kMask && key0 + 8 * i + (e & 1) >= T) s[4 * i + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  }
  float alpha[2], m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    if constexpr (kBias) {
      const bool none = m_new == -INFINITY;
      alpha[r] = none ? 1.f : ex2(m_run[r] - m_new);
      m_use[r] = none ? 0.f : m_new;
    } else {
      alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
      m_use[r] = m_new;
    }
    m_run[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 36; ++i) o[i] *= alpha[(i >> 1) & 1];
  // slice kk's fragment q: columns 16 kk + 8 (q / 2) + c2 (+1) of the
  // thread's row q % 2
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q & 1;
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          ex2(s[8 * kk + 2 * q] - m_use[r]),
          ex2(s[8 * kk + 2 * q + 1] - m_use[r]));
      pa[kk][q] = *reinterpret_cast<const uint32_t*>(&p);
    }
}

// C3's online softmax of one 64 x 128 tile S = q K^T (accumulator layout),
// scale in natural units: the running max m of the thread's two rows in
// S's units (scale > 0 keeps the order), O and the thread's share of the
// row sums l rescaled, p = exp(s - m) = exp2(S c - m c), c = scale * log2
// e, added to l unrounded (four chains) and rounded to bf16 into the A
// fragments of P V.
template <bool kMask>
__device__ __forceinline__ void softmax_nat(float (&s)[64],
                                            uint32_t (&pa)[8][4],
                                            float (&o)[32], float (&m_run)[2],
                                            float (&l_run)[2], int key0,
                                            int T, float c) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask && key0 + 8 * i + (e & 1) >= T) s[4 * i + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  float alpha[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = ex2((m_run[r] - m_new) * c);  // 0 on the first tile
    m_run[r] = m_new;
    ml[r] = m_new * c;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
  float ls[4] = {0.f, 0.f, 0.f, 0.f};  // by fragment q: row q % 2
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q & 1;
      const float p0 = ex2(fmaf(s[8 * kk + 2 * q], c, -ml[r]));
      const float p1 = ex2(fmaf(s[8 * kk + 2 * q + 1], c, -ml[r]));
      ls[q] += p0 + p1;
      pa[kk][q] = vdn::pack_bf16(p0, p1);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] += ls[r] + ls[r + 2];
}

// C3's products: O += P V (kPV; m64n64k16, V read MN-major) and S = q K^T
// (kS), each a wgmma group of its own.
template <bool kPV, bool kS>
__device__ __forceinline__ void issue_nat(float (&o)[32], float (&s)[64],
                                          const uint32_t (&pa)[8][4],
                                          uint32_t v_s, uint32_t qw,
                                          uint32_t k_s) {
  wgmma_fence();
  if constexpr (kPV) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<1>(o, pa[kk], desc_sw128(v_s + 2048 * kk), 1);
    wgmma_commit();
  }
  if constexpr (kS) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(s, desc_sw128(qw + 32 * kk), desc_sw128(k_s + 32 * kk),
                    kk);
    wgmma_commit();
  }
}

// One turn's products: O += P [V | 1] (kPV, V at v_s, the ones at
// ones_s) and S = qs K^T (kS, qs at qw, K at k_s), each a wgmma group of
// its own.
template <bool kPV, bool kS>
__device__ __forceinline__ void issue(float (&o)[36], float (&s)[64],
                                      const uint32_t (&pa)[8][4],
                                      uint32_t v_s, uint32_t ones_s,
                                      uint32_t qw, uint32_t k_s) {
  wgmma_fence();
  if constexpr (kPV) {
    // the leading byte offset: the ones' atom, ones_s - v_s bytes on
    const uint64_t lbo = static_cast<uint64_t>((ones_s - v_s) >> 4) << 16;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_n72(o, pa[kk],
                   (desc_sw128(v_s + 2048 * kk) & ~(0x3FFFull << 16)) | lbo);
    wgmma_commit();
  }
  if constexpr (kS) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(s, desc_sw128(qw + 32 * kk), desc_sw128(k_s + 32 * kk),
                    kk);
    wgmma_commit();
  }
}

// kC1: bias * log2 e of keys key .. key + 3 (-inf past Tk)
__device__ __forceinline__ void load_bias(float (&v)[4],
                                          const float* __restrict__ bias,
                                          int key, int Tk) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = key + e < Tk ? __fmul_rn(__ldg(bias + key + e), kLog2e)
                        : -INFINITY;
}

// qscale: kA1 / kA1Lse / kBthd / kC1 bf16(scale * log2 e), folded into q;
// kC3 the softmax scale, applied to the product.  map_qkv holds q (kBthd,
// kC1) or all of qkv; map_k and map_v, and Tk, are read by kBthd and kC1
// alone (the other forms take their keys off map_qkv, Tk = T); bias [Tk]
// (natural-log units) by kC1 alone.
template <int kForm>
__global__ void __launch_bounds__(kThreads, 1)
a1_flash_kernel(const __grid_constant__ CUtensorMap map_qkv,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_out, int B, int T,
                int Tk_bthd, int H, float qscale, float* __restrict__ lse,
                const float* __restrict__ bias) {
  constexpr bool kLse = kForm == kA1Lse, kNat = kForm == kC3;
  constexpr bool kSep = kForm == kBthd || kForm == kC1;
  constexpr bool kBias = kForm == kC1;
  const int Tk = kSep ? Tk_bthd : T;  // keys
  // O: A1's columns 64-71 the row sums
  constexpr int kO = kNat ? 32 : 36;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                     // two q tiles
  const uint32_t out_s = base + 2 * kTileBytes;  // two staging tiles
  const uint32_t ring = out_s + 2 * kOutBytes;   // stage s: K, then V
  const uint32_t ones_s = ring + kStages * 2 * kTileBytes;  // bf16 1.0
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gbase + (ones_s - base) + kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 2;
  // kC1: stage s's bias * log2 e at bias_s + s * kBiasBytes; the key
  // tiles' live flags, the live ones in order and their count
  const uint32_t bias_s = smem_u32(full) + 128;
  uint8_t* live = gbase + (bias_s - base) + kStages * kBiasBytes;
  uint16_t* list = reinterpret_cast<uint16_t*>(live + kMaxKeyTiles);
  int* n_live = reinterpret_cast<int*>(list + kMaxKeyTiles);

  const int C = H * kD;
  const int n_t = (T + kRows - 1) / kRows;    // q tiles
  const int n_all = (Tk + kRows - 1) / kRows;  // key tiles
  const int items = B * H * n_t;
  const int wgi = threadIdx.x >> 7;

  if constexpr (kBias) {
    // a tile is live if any of its columns is above -inf
    for (int j = threadIdx.x; j < n_all; j += kThreads) {
      bool any = false;
      if ((j + 1) * kRows <= Tk) {
        const float4* b4 = reinterpret_cast<const float4*>(bias + j * kRows);
#pragma unroll 8
        for (int c = 0; c < kRows / 4; ++c) {
          const float4 v = __ldg(b4 + c);
          any |= fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) > -INFINITY;
        }
      } else {
        for (int c = j * kRows; c < Tk; ++c) any |= __ldg(bias + c) > -INFINITY;
      }
      live[j] = any;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), kBias ? 32 : 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_u32(&q_full[i]), 1);
      mbar_init(smem_u32(&q_empty[i]), kConsumers);
    }
    mbar_fence_init();
  }
  for (int c = threadIdx.x; c < kTileBytes / 16; c += kThreads)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n"
                 :: "r"(ones_s + 16 * c), "r"(0x3F803F80u) : "memory");
  fence_async_shared();
  __syncthreads();
  if constexpr (kBias) {
    // the live tiles in order, by warp 0
    if (threadIdx.x < 32) {
      int n = 0;
      for (int j0 = 0; j0 < n_all; j0 += 32) {
        const int j = j0 + threadIdx.x;
        const bool on = j < n_all && live[j];
        const unsigned m = __ballot_sync(0xffffffffu, on);
        if (on) list[n + __popc(m & ((1u << threadIdx.x) - 1))] = j;
        n += __popc(m);
      }
      if (threadIdx.x == 0) *n_live = n;
    }
    __syncthreads();
  }
  const int n_k = kBias ? *n_live : n_all;  // the key tiles walked

  if (wgi == 2) {
    // kC1: the whole warp (each lane 4 bias values a stage); the other
    // forms: one thread
    const int lane = threadIdx.x & 31;
    if (kBias || lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x, i = 0; it < items; it += gridDim.x, ++i) {
        const int qt = it % n_t, h = (it / n_t) % H, b = it / (n_t * H);
        const int qb = i & 1;
        const uint32_t qbar = smem_u32(&q_full[qb]);
        mbar_wait(smem_u32(&q_empty[qb]), ((i >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(qbar, kTileBytes);
          if constexpr (kSep)
            tma_load_4d(q_s + qb * kTileBytes, &map_qkv, qbar, 0, h,
                        qt * kRows, b);
          else
            tma_load_3d(q_s + qb * kTileBytes, &map_qkv, qbar, h * kD,
                        qt * kRows, b);
        }
        float bv[4];  // kC1: this lane's values of the next tile
        if constexpr (kBias)
          if (n_k > 0) load_bias(bv, bias, list[0] * kRows + 4 * lane, Tk);
        for (int j = 0; j < n_k; ++j) {
          const int kt = kBias ? list[j] : j;
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t dst = ring + stage * 2 * kTileBytes;
          if constexpr (kBias) {
            if (lane == 0) {
              mbar_tx(bar, 2 * kTileBytes);
              tma_load_4d(dst, &map_k, bar, 0, h, kt * kRows, b);
              tma_load_4d(dst + kTileBytes, &map_v, bar, 0, h, kt * kRows,
                          b);
            }
            asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                         :: "r"(bias_s + stage * kBiasBytes + 16 * lane),
                            "f"(bv[0]), "f"(bv[1]), "f"(bv[2]), "f"(bv[3])
                         : "memory");
            mbar_arrive(bar);
            if (j + 1 < n_k)
              load_bias(bv, bias, list[j + 1] * kRows + 4 * lane, Tk);
          } else if constexpr (kSep) {
            mbar_expect_tx(bar, 2 * kTileBytes);
            tma_load_4d(dst, &map_k, bar, 0, h, kt * kRows, b);
            tma_load_4d(dst + kTileBytes, &map_v, bar, 0, h, kt * kRows, b);
          } else {
            mbar_expect_tx(bar, 2 * kTileBytes);
            tma_load_3d(dst, &map_qkv, bar, C + h * kD, kt * kRows, b);
            tma_load_3d(dst + kTileBytes, &map_qkv, bar, 2 * C + h * kD,
                        kt * kRows, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns q rows [64 wgi, 64 wgi + 64) of
  // each item's tile
  const int t = threadIdx.x;
  const int lt = t & 127;
  const int c2 = 2 * (t & 3);
  const int row = wg_row(t);  // and row + 8
  const uint32_t stage_o = out_s + wgi * kOutBytes;
  if (wgi == 1) named_arrive(kTurn, kConsumers);  // warpgroup 0 goes first
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x, i = 0; it < items; it += gridDim.x, ++i) {
    const int qt = it % n_t, h = (it / n_t) % H, b = it / (n_t * H);
    const int qb = i & 1;
    const uint32_t qw = q_s + qb * kTileBytes + wgi * (kTileBytes / 2);
    mbar_wait(smem_u32(&q_full[qb]), (i >> 1) & 1);
    // qs = bf16(q * qscale) in place, 16 bytes a step (C3: q as it is)
#pragma unroll
    for (int c = 0; c < (kNat ? 0 : 4); ++c) {
      const uint32_t at = qw + 16 * (lt + 128 * c);
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(at));
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(hv[k]);
        hv[k] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(at), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
    fence_async_shared();
    named_sync(kOwn + wgi, 128);

    float o[kO], s[64];
    uint32_t pa[8][4];
#pragma unroll
    for (int k = 0; k < kO; ++k) o[k] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // C3: the thread's share of the row sums
    int prev = 0;  // the stage of P's V
    // turn j: P_{j-1} V_{j-1} (j > 0) and S_j (j < n_k)
#pragma unroll 1
    for (int j = 0; j <= n_k; ++j) {
      const uint32_t k_s = ring + stage * 2 * kTileBytes;
      const uint32_t v_s = ring + prev * 2 * kTileBytes + kTileBytes;
      if (j < n_k) mbar_wait(smem_u32(&full[stage]), phase);
      named_sync(kTurn + wgi, kConsumers);
      if constexpr (kNat) {
        if (j == 0)
          issue_nat<false, true>(o, s, pa, v_s, qw, k_s);
        else if (j < n_k)
          issue_nat<true, true>(o, s, pa, v_s, qw, k_s);
        else
          issue_nat<true, false>(o, s, pa, v_s, qw, k_s);
      } else if (j == 0) {
        issue<false, true>(o, s, pa, v_s, ones_s, qw, k_s);
      } else if (j < n_k) {
        issue<true, true>(o, s, pa, v_s, ones_s, qw, k_s);
      } else {
        issue<true, false>(o, s, pa, v_s, ones_s, qw, k_s);
      }
      named_arrive(kTurn + (wgi ^ 1), kConsumers);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
      if (j > 0) mbar_arrive(smem_u32(&empty[prev]));
      if (j == n_k) break;
      if constexpr (kNat) {
        if ((j + 1) * kRows > Tk)
          softmax_nat<true>(s, pa, o, m_run, l_run, j * kRows + c2, Tk,
                            qscale * kLog2e);
        else
          softmax_nat<false>(s, pa, o, m_run, l_run, j * kRows + c2, Tk,
                             qscale * kLog2e);
      } else if constexpr (kBias) {
        const int kt = list[j];
        const float* bias_t = reinterpret_cast<const float*>(
            gbase + (bias_s - base) + stage * kBiasBytes) + c2;
        if ((kt + 1) * kRows > Tk)
          softmax_tile<true, true>(s, pa, o, m_run, kt * kRows + c2, Tk,
                                   bias_t);
        else
          softmax_tile<false, true>(s, pa, o, m_run, kt * kRows + c2, Tk,
                                    bias_t);
      } else if ((j + 1) * kRows > Tk) {
        softmax_tile<true>(s, pa, o, m_run, j * kRows + c2, Tk);
      } else {
        softmax_tile<false>(s, pa, o, m_run, j * kRows + c2, Tk);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_arrive(smem_u32(&q_empty[qb]));

    // ---- epilogue: O * (1 / l) (C3: O / l, correctly rounded by
    // div_rn) into the staging tile, one TMA store of the warpgroup's 64
    // rows
    float l[2];  // rows row and row + 8
    if constexpr (kNat) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
    } else {
      l[0] = o[32];
      l[1] = o[34];
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};  // C3
    const int row0 = qt * kRows + wgi * 64;
    if constexpr (kLse) {
      if ((t & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = row0 + row + 8 * r;
          if (q < T)
            lse[((size_t)b * H + h) * T + q] = m_run[r] + log2f(l[r]);
        }
      }
    }
    if (lt == 0) bulk_wait<true>();  // the last item's store has read it
    named_sync(kOwn + wgi, 128);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t at =
            staged_tile<64>(stage_o, row + 8 * r, 8 * n8 + c2);
        const float* x = &o[4 * n8 + 2 * r];
        const uint32_t bits =
            kNat ? vdn::pack_bf16(div_rn(x[0], l[r], rl[r]),
                                  div_rn(x[1], l[r], rl[r]))
                 : vdn::pack_bf16(x[0] * inv[r], x[1] * inv[r]);
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(at), "r"(bits) : "memory");
      }
    fence_async_shared();
    named_sync(kOwn + wgi, 128);
    if (lt == 0 && row0 < T) {
      if constexpr (kNat)
        tma_store_3d(&map_out, stage_o, 0, row0, b * H + h);
      else if constexpr (kSep)
        tma_store_4d(&map_out, stage_o, 0, h, row0, b);
      else
        tma_store_3d(&map_out, stage_o, h * kD, row0, b);
      bulk_commit();
    }
  }
  if (wgi == 0) named_sync(kTurn, kConsumers);  // warpgroup 1's last turn
  if (lt == 0) bulk_wait<false>();
}

template <int kForm>
cudaError_t launch_maps(const CUtensorMap& map_qkv, const CUtensorMap& map_k,
                        const CUtensorMap& map_v, const CUtensorMap& map_out,
                        int B, int T, int Tk, int H, float qscale, float* lse,
                        const float* bias, int grid, cudaStream_t s) {
  constexpr int smem = kForm == kC1 ? kC1Smem : kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      a1_flash_kernel<kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  a1_flash_kernel<kForm><<<grid, kThreads, smem, s>>>(
      map_qkv, map_k, map_v, map_out, B, T, Tk, H, qscale, lse, bias);
  return cudaGetLastError();
}

template <int kForm>
cudaError_t launch_fwd(const void* qkv, int B, int T, int H, float qscale,
                       void* out, float* lse, int grid, cudaStream_t s) {
  if (B < 1 || T < 1 || H < 1 || grid < 1) return cudaErrorInvalidValue;
  CUtensorMap map_qkv, map_out;
  cudaError_t err = encode_rows_bf16(&map_qkv, qkv, B, T, 3 * H * kD, kRows);
  if (err == cudaSuccess)
    err = kForm == kC3 ? encode_rows_bf16(&map_out, out, B * H, T, kD, 64)
                       : encode_rows_bf16(&map_out, out, B, T, H * kD, 64);
  if (err != cudaSuccess) return err;
  // the keys come off map_qkv: map_k and map_v are not read
  return launch_maps<kForm>(map_qkv, map_qkv, map_qkv, map_out, B, T, T, H,
                            qscale, lse, nullptr, grid, s);
}

// C2 (kBthd) and C1 (kC1, with bias): q [B, Tq, H, D], k / v [B, Tk, H,
// D] bf16, each through its (row, batch) strides, D = 56 or 64 (columns
// 56-63 of a 56-wide head load as zeros: they add nothing to q k^T, and
// P V's columns there are not stored) -> out [B, Tq, H, D] bf16
// contiguous
template <int kForm>
cudaError_t launch_bthd(const void* q, const void* k, const void* v,
                        const float* bias, int B, int Tq, int Tk, int H,
                        int D, const long long* strides, float qscale,
                        void* out, int grid, cudaStream_t s) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || grid < 1 ||
      (D != 56 && D != kD) ||
      (kForm == kC1 && (Tk + kRows - 1) / kRows > kMaxKeyTiles))
    return cudaErrorInvalidValue;
  const long long C = (long long)H * D;
  CUtensorMap map_q, map_k, map_v, map_out;
  cudaError_t err = encode_heads_bf16(&map_q, q, B, Tq, H, D, strides[1],
                                      strides[0], kRows);
  if (err == cudaSuccess)
    err = encode_heads_bf16(&map_k, k, B, Tk, H, D, strides[3], strides[2],
                            kRows);
  if (err == cudaSuccess)
    err = encode_heads_bf16(&map_v, v, B, Tk, H, D, strides[5], strides[4],
                            kRows);
  if (err == cudaSuccess)
    err = encode_heads_bf16(&map_out, out, B, Tq, H, D, C, C * Tq, 64);
  if (err != cudaSuccess) return err;
  return launch_maps<kForm>(map_q, map_k, map_v, map_out, B, Tq, Tk, H,
                            qscale, nullptr, bias, grid, s);
}

}  // namespace

// qkv [B, T, 3 * H * 64] bf16 -> out [B, T, H * 64] bf16.  qscale is
// bf16(scale * log2 e); grid the persistent blocks (the Python plan's).
// Head width 64 only.
extern "C" int vdn_flash_attention_qkv(const void* qkv, int B, int T, int H,
                                       float qscale, void* out, int grid,
                                       void* stream) {
  return launch_fwd<kA1>(qkv, B, T, H, qscale, out, nullptr, grid,
                         static_cast<cudaStream_t>(stream));
}

// The training forward: as above, and lse [B, H, T] fp32, the base-2
// log-sum-exp of each row's logits (scaled by qscale).
extern "C" int vdn_flash_attention_qkv_lse(const void* qkv, int B, int T,
                                           int H, float qscale, void* out,
                                           void* lse, int grid,
                                           void* stream) {
  return launch_fwd<kA1Lse>(qkv, B, T, H, qscale, out,
                            static_cast<float*>(lse), grid,
                            static_cast<cudaStream_t>(stream));
}

// C3: qkv [B, T, 3 * H * 64] bf16 -> out [B, H, T, 64] bf16, scale the
// softmax scale in natural units; grid as above.  Head width 64 only.
extern "C" int vdn_flash_attention_qkv_heads(const void* qkv, int B, int T,
                                             int H, float scale, void* out,
                                             int grid, void* stream) {
  return launch_fwd<kC3>(qkv, B, T, H, scale, out, nullptr, grid,
                         static_cast<cudaStream_t>(stream));
}

// C2: q [B, Tq, H, D], k / v [B, Tk, H, D] bf16, D = 56 or 64, each read
// in place through its batch and row strides in elements (sqb, sqt, skb,
// skt, svb, svt: a head D on, elements contiguous, strides and bases
// 16-byte aligned) -> out [B, Tq, H, D] bf16 contiguous.  qscale is
// bf16(scale * log2 e); grid the persistent blocks (the Python plan's,
// over the q tiles of Tq).  D = 256 is flash_attn_wide.cu.
extern "C" int vdn_flash_attention_bthd(
    const void* q, const void* k, const void* v, int B, int Tq, int Tk, int H,
    int D, long long sqb, long long sqt, long long skb, long long skt,
    long long svb, long long svt, float qscale, void* out, int grid,
    void* stream) {
  const long long strides[6] = {sqb, sqt, skb, skt, svb, svt};
  return launch_bthd<kBthd>(q, k, v, nullptr, B, Tq, Tk, H, D, strides,
                            qscale, out, grid,
                            static_cast<cudaStream_t>(stream));
}

// C1: as C2, plus bias [Tk] fp32 (16-byte aligned; natural-log units, -inf
// allowed) added to every row's logits; Tk at most 4096 key tiles of 128.
extern "C" int vdn_flash_attention_colbias(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           int B, int Tq, int Tk, int H,
                                           float qscale, void* out, int grid,
                                           void* stream) {
  const long long C = (long long)H * kD;
  const long long strides[6] = {C * Tq, C, C * Tk, C, C * Tk, C};
  return launch_bthd<kC1>(q, k, v, static_cast<const float*>(bias), B, Tq,
                          Tk, H, kD, strides, qscale, out, grid,
                          static_cast<cudaStream_t>(stream));
}
