// C2 in bf16 at D = 256 (SAM2's memory attention, one 256-wide head) and
// at D = 72 / 96 (SAM2's hiera_large and hiera_tiny / small trunks).
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention
// (_flash_kernel via _flash_bhtd) at the memory attention's shapes
// (vdn/models/sam2_video.py:112-116, vdn/nn/memory.py): q [1, 4096, 1,
// 256] bf16 against 4096 keys (self-attention, four layers a tracked
// frame) or 4096 m + 4 p (cross-attention to m mask memories and p object
// pointers: 4100 after the first conditioned frame, up to 28,736), k and v
// [1, Tk, 1, 256]; and at the trunks' global blocks, [1, 4096, 8, 72]
// (hiera_large) and [1, 4096, 4, 96] (hiera_tiny, hiera_small) read in
// place off the fused qkv.  The D = 56 / 64 cases are A1's kernel in its
// kBthd form (flash_attn_qkv.cu).
//
// A row of kAtoms 64-column atoms of the 128-byte swizzle: four at D 256,
// two at D 72 / 96 (128 columns; TMA zero-fills columns D .. 127 of q, K
// and V, and the store writes only columns < D, as A1's 4-D maps do for a
// 56-wide head in one atom).  The zero columns add nothing to S, and O's
// columns past D are never stored.
//
// Bound on the H100 by its two tensor-core products, 4 * B * H * Tq * Tk *
// D FLOP (120.5 GFLOP, 0.122 ms at 989 TFLOP/s, at Tk 28,736).  A1's
// layout does not carry over: a 64-row warpgroup's O is 64 x 256 fp32,
// 128 registers a thread, which leaves no room for A1's 128-key S (64)
// and its P (32) within the 224 a thread of 288 gets.  So:
//   - persistent blocks walk a1_plan's items (batch, head, 128-row q tile)
//     as A1 does; a producer warpgroup (one thread issuing, its registers
//     given to the consumers by setmaxnreg) loads each item's q tile (128 x
//     64 kAtoms, one 16 KB atom a 64-column slice, one buffer) and a
//     ring of kStages stages of 64-key K and V tiles (8 KB an atom each),
//     all by TMA through 4-D maps of [B, T, H, D] (rows >= T and columns
//     >= D load as zeros);
//   - two consumer warpgroups own 64 q rows each and take their turns at
//     the tensor cores freely (no ping-pong).  Per key tile: qs = bf16(q *
//     bf16(scale * log2 e)), scaled in place once an item, S = qs K^T as
//     4 kAtoms wgmma m64n64k16 from shared memory (32 registers), the online
//     softmax in base 2 (p = bf16(exp2(S - m)) by ex2.approx.ftz; the row
//     sum l of the rounded p in registers: A1's column of ones would make
//     P V m64n264, past wgmma's N of 256), then O += P V as kAtoms
//     m64n64k16 a 16-key slice, one a 64-column atom of V read MN-major (the
//     transpose bit), P as register A fragments;
//   - the epilogue writes O / l in bf16 over the warpgroup's own q rows
//     (the atoms' 64-row halves, 1024-aligned: the swizzle matches)
//     and stores them by TMA; the producer refills the q tile once both
//     warpgroups' stores have read it;
//   - split keys: one head of 4096 q rows is 32 items, a quarter of the
//     card's 132 SMs.  With ``splits`` > 1 (the host's c2_wide_plan) a work
//     unit is an item's share of the key tiles, and the epilogue writes O
//     unnormalized in fp32 with each row's max m and sum l to a scratch
//     buffer instead; a second launch (c2_combine_kernel) takes out = sum_s
//     2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s, M = max_s m_s, rounded once
//     to bf16 (the split rounds p against its own running max, as any key
//     tile does).
// Online rescaling rounds p against the running max instead of the final
// one, so results differ from the plain version's by a few bf16 ulps.
#include <math.h>

#include "attn_wgmma.cuh"

namespace {

constexpr int kRows = 128;             // q rows of an item
constexpr int kKeys = 64;              // keys of a stage
constexpr int kQAtom = kRows * 128;    // 16 KB: one atom of the q tile
constexpr int kKAtom = kKeys * 128;    // 8 KB: one atom of a K or V tile
// two consumer warpgroups and a producer warpgroup (one thread of it
// issues the loads): registers are handed out by whole warpgroups
constexpr int kThreads = 384;
constexpr int kConsumers = 256;
constexpr int kOwn = 1;  // named barrier kOwn + w: warpgroup w's threads

// The layout of a row of kAtoms 64-column atoms: the q tile (64 KB at D
// 256, 32 KB at 128 columns) and kStages K / V stages (32 KB a stage at D
// 256 in two stages; 16 KB at 128 columns, in four)
template <int kAtoms>
struct Wide {
  static constexpr int kD = 64 * kAtoms;  // columns a row holds
  static constexpr int kStages = kAtoms == 4 ? 2 : 4;
  static constexpr int kQBytes = kAtoms * kQAtom;
  static constexpr int kKBytes = kAtoms * kKAtom;
  static constexpr int kBarriers = 2 * kStages + 2;
  static constexpr int kSmem =
      1024 + kQBytes + kStages * 2 * kKBytes + 8 * kBarriers;
  static_assert(kSmem <= 232448, "an H100 block's dynamic shared memory");
};

// The online softmax of one 64 x 64 tile S (accumulator layout; key0 the
// key of this thread's first column, keys >= Tk masked where kMask): the
// running max of the thread's two rows, O and the thread's share of the
// row sums rescaled, P = bf16(exp2(S - m)) as the A fragments of P V and
// its rounded values added to the row sums.
template <int kAtoms, bool kMask>
__device__ __forceinline__ void softmax64(float (&s)[32],
                                          uint32_t (&pa)[4][4],
                                          float (&o)[kAtoms][32],
                                          float (&m_run)[2],
                                          float (&l_run)[2], int key0,
                                          int Tk) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask && key0 + 8 * i + (e & 1) >= Tk) s[4 * i + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i >> 1) & 1];
  // slice kk's fragment q: columns 16 kk + 8 (q / 2) + c2 (+1) of the
  // thread's row q % 2
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q & 1;
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          ex2(s[8 * kk + 2 * q] - m_run[r]),
          ex2(s[8 * kk + 2 * q + 1] - m_run[r]));
      const float2 pf = __bfloat1622float2(p);
      ls[r] += pf.x + pf.y;
      pa[kk][q] = *reinterpret_cast<const uint32_t*>(&p);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] += ls[r];
}

// qscale: bf16(scale * log2 e), folded into q; D the head's width (<= 64
// kAtoms)
// splits > 1: unit u is item u / splits, key tiles [chunk (u % splits),
// ...) of it, written to o_part [splits, B, Tq, H, D] fp32 (O, not
// normalized) and stats [splits, B, H, Tq, 2] (m, l) in place of out.
// Registers: O 32 kAtoms (128 at D 256), S 32, P 16 a consumer thread.
// A block's registers are handed out by whole warpgroups, 168 a thread
// at launch (at D 256 a producer warp beside two consumer warpgroups got
// as much and spilled 844 bytes; 224 a thread refused to launch), so the
// producer warpgroup gives its registers to the consumers by setmaxnreg:
// 128 x kProducerRegs + 256 x kConsumerRegs <= 65536.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536,
              "the block's registers");
template <int kAtoms>
__global__ void __launch_bounds__(kThreads, 1)
c2_wide_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_out, int B, int Tq,
               int Tk, int H, int D, float qscale, int splits,
               float* __restrict__ o_part, float2* __restrict__ stats) {
  using L = Wide<kAtoms>;
  constexpr int kStages = L::kStages;
  constexpr int kQBytes = L::kQBytes;
  constexpr int kKBytes = L::kKBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;            // atom a: q_s + a * kQAtom
  const uint32_t ring = q_s + kQBytes;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gbase + kQBytes + kStages * 2 * kKBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 1;

  const int n_t = (Tq + kRows - 1) / kRows;   // q tiles
  const int n_all = (Tk + kKeys - 1) / kKeys;  // key tiles
  const int chunk = (n_all + splits - 1) / splits;  // key tiles a unit
  const int units = B * H * n_t * splits;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_init(smem_u32(q_full), 1);
    mbar_init(smem_u32(q_empty), 2);  // one arrival a warpgroup
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {
        const int it = u / splits;
        const int qt = it % n_t, h = (it / n_t) % H, b = it / (n_t * H);
        const int j0 = (u % splits) * chunk, j1 = min(j0 + chunk, n_all);
        const uint32_t qbar = smem_u32(q_full);
        mbar_wait(smem_u32(q_empty), (i & 1) ^ 1);
        mbar_expect_tx(qbar, kQBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(q_s + a * kQAtom, &map_q, qbar, 64 * a, h, qt * kRows,
                      b);
        for (int j = j0; j < j1; ++j) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t dst = ring + stage * 2 * kKBytes;
          mbar_expect_tx(bar, 2 * kKBytes);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a) {
            tma_load_4d(dst + a * kKAtom, &map_k, bar, 64 * a, h, j * kKeys,
                        b);
            tma_load_4d(dst + kKBytes + a * kKAtom, &map_v, bar, 64 * a, h,
                        j * kKeys, b);
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
  // each item's tile, at qw + a * kQAtom in atom a
  regs_inc<kConsumerRegs>();
  const int t = threadIdx.x;
  const int lt = t & 127;
  const int c2 = 2 * (t & 3);
  const int row = wg_row(t);  // and row + 8
  const uint32_t qw = q_s + wgi * (kQAtom / 2);
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {
    const int it = u / splits, split = u % splits;
    const int qt = it % n_t, h = (it / n_t) % H, b = it / (n_t * H);
    const int j0 = split * chunk, j1 = min(j0 + chunk, n_all);
    mbar_wait(smem_u32(q_full), i & 1);
    // qs = bf16(q * qscale) in place, 16 bytes a step: each atom's half is
    // 512 chunks
#pragma unroll
    for (int c = 0; c < kAtoms * 4; ++c) {
      const uint32_t at =
          qw + (c >> 2) * kQAtom + 16 * (lt + 128 * (c & 3));
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

    float o[kAtoms][32], s[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int k = 0; k < 32; ++k) o[a][k] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // the thread's share of the row sums
#pragma unroll 1
    for (int j = j0; j < j1; ++j) {
      const uint32_t k_s = ring + stage * 2 * kKBytes;
      const uint32_t v_s = k_s + kKBytes;
      mbar_wait(smem_u32(&full[stage]), phase);
      // S = qs K^T: 16-wide K slice kk is atom kk / 4, 32 bytes a slice
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kAtoms; ++kk)
        wgmma_ss(s, desc_sw128(qw + (kk >> 2) * kQAtom + 32 * (kk & 3)),
                 desc_sw128(k_s + (kk >> 2) * kKAtom + 32 * (kk & 3)), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if ((j + 1) * kKeys > Tk)
        softmax64<kAtoms, true>(s, pa, o, m_run, l_run, j * kKeys + c2, Tk);
      else
        softmax64<kAtoms, false>(s, pa, o, m_run, l_run, j * kKeys + c2,
                                 Tk);
      // O += P V: keys 16 kk .. 16 kk + 15 are 2048 bytes into each atom
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          wgmma_rs<1>(o[a], pa[kk], desc_sw128(v_s + a * kKAtom + 2048 * kk),
                      1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
      mbar_arrive(smem_u32(&empty[stage]));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: O * (1 / l) in bf16 over the warpgroup's q rows, one
    // TMA store an atom; split: O, m and l to the scratch
    float l[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    if (splits > 1) {
      const int row0 = qt * kRows + wgi * 64;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = row0 + row + 8 * r;
        if (q >= Tq) continue;
        const size_t at = ((size_t)split * B + b) * Tq + q;
        float* dst = o_part + (at * H + h) * D + c2;
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
            if (64 * a + 8 * n8 + c2 < D)  // D % 8 == 0: both columns
              *reinterpret_cast<float2*>(dst + 64 * a + 8 * n8) =
                  make_float2(o[a][4 * n8 + 2 * r],
                              o[a][4 * n8 + 2 * r + 1]);
        if ((t & 3) == 0)
          stats[(((size_t)split * B + b) * H + h) * Tq + q] =
              make_float2(m_run[r], l[r]);
      }
      named_sync(kOwn + wgi, 128);  // every thread done with the item
      if (lt == 0) mbar_arrive(smem_u32(q_empty));
      continue;
    }
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t at = staged_tile<64>(qw + a * kQAtom, row + 8 * r,
                                              8 * n8 + c2);
          const float* x = &o[a][4 * n8 + 2 * r];
          asm volatile("st.shared.b32 [%0], %1;\n"
                       :: "r"(at), "r"(vdn::pack_bf16(x[0] * inv[r],
                                                      x[1] * inv[r]))
                       : "memory");
        }
    fence_async_shared();
    named_sync(kOwn + wgi, 128);
    if (lt == 0) {
      const int row0 = qt * kRows + wgi * 64;
      if (row0 < Tq) {
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          if (64 * a < D)
            tma_store_4d(&map_out, qw + a * kQAtom, 64 * a, h, row0, b);
        bulk_commit();
      }
      bulk_wait<true>();  // the stores have read the q tile
      mbar_arrive(smem_u32(q_empty));
    }
  }
  if (lt == 0) bulk_wait<false>();
}

// out [B, Tq, H, D] bf16 from the splits' partial O and (m, l): one block
// of D threads a (batch, row, head), thread d its column
__global__ void __launch_bounds__(256)
c2_combine_kernel(const float* __restrict__ o_part,
                  const float2* __restrict__ stats, int splits, int B,
                  int Tq, int H, __nv_bfloat16* __restrict__ out) {
  const int row = blockIdx.x;  // (b * Tq + q) * H + h
  const int h = row % H, q = (row / H) % Tq, b = row / (H * Tq);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, stats[(((size_t)s * B + b) * H + h) * Tq + q].x);
  float acc = 0.f, l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = stats[(((size_t)s * B + b) * H + h) * Tq + q];
    const float w = ex2(ml.x - m);
    l = fmaf(w, ml.y, l);
    acc = fmaf(w, o_part[((size_t)s * B * Tq * H + row) * blockDim.x +
                         threadIdx.x],
               acc);
  }
  out[(size_t)row * blockDim.x + threadIdx.x] =
      __float2bfloat16_rn(acc / l);
}

template <int kAtoms>
int launch(const void* q, const void* k, const void* v, int B, int Tq,
           int Tk, int H, int D, long long sqb, long long sqt, long long skb,
           long long skt, long long svb, long long svt, float qscale,
           void* out, int splits, void* o_part, void* stats, int grid,
           cudaStream_t s) {
  constexpr int kSmem = Wide<kAtoms>::kSmem;
  const long long C = (long long)H * D;
  CUtensorMap map_q, map_k, map_v, map_out;
  cudaError_t err = encode_heads_bf16(&map_q, q, B, Tq, H, D, sqt, sqb,
                                      kRows);
  if (err == cudaSuccess)
    err = encode_heads_bf16(&map_k, k, B, Tk, H, D, skt, skb, kKeys);
  if (err == cudaSuccess)
    err = encode_heads_bf16(&map_v, v, B, Tk, H, D, svt, svb, kKeys);
  if (err == cudaSuccess)
    err = encode_heads_bf16(&map_out, out, B, Tq, H, D, C, C * Tq, 64);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      c2_wide_kernel<kAtoms>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  c2_wide_kernel<kAtoms><<<grid, kThreads, kSmem, s>>>(
      map_q, map_k, map_v, map_out, B, Tq, Tk, H, D, qscale, splits,
      static_cast<float*>(o_part), static_cast<float2*>(stats));
  if (splits == 1) return cudaGetLastError();
  c2_combine_kernel<<<B * Tq * H, D, 0, s>>>(
      static_cast<const float*>(o_part), static_cast<const float2*>(stats),
      splits, B, Tq, H, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

}  // namespace

// C2 at D = 256, 96 or 72: q [B, Tq, H, D], k / v [B, Tk, H, D] bf16,
// each read in place through its batch and row strides in elements (a head
// D on, elements contiguous, strides and bases 16-byte aligned) -> out [B,
// Tq, H, D] bf16 contiguous.  qscale is bf16(scale * log2 e); splits, the
// key tiles' shares, and grid, the persistent blocks, are the Python
// plan's (c2_wide_plan: over the 128-row q tiles of Tq, times splits);
// with splits > 1, o_part [splits, B, Tq, H, D] and stats [splits, B, H,
// Tq, 2] fp32 are scratch (16-byte aligned), and a second launch combines
// them into out.
extern "C" int vdn_flash_attention_bthd_wide(
    const void* q, const void* k, const void* v, int B, int Tq, int Tk, int H,
    int D, long long sqb, long long sqt, long long skb, long long skt,
    long long svb, long long svt, float qscale, void* out, int splits,
    void* o_part, void* stats, int grid, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || grid < 1 || splits < 1 ||
      (splits > 1 && (o_part == nullptr || stats == nullptr)) ||
      (Tk + kKeys - 1) / kKeys < splits)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256)
    return launch<4>(q, k, v, B, Tq, Tk, H, D, sqb, sqt, skb, skt, svb, svt,
                     qscale, out, splits, o_part, stats, grid, s);
  if (D == 72 || D == 96)
    return launch<2>(q, k, v, B, Tq, Tk, H, D, sqb, sqt, skb, skt, svb, svt,
                     qscale, out, splits, o_part, stats, grid, s);
  return cudaErrorInvalidValue;
}
