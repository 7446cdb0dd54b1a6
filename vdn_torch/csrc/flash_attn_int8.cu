// F6: the int8 serving mode's self-attention off the fused qkv projection.
//
// Replaces vdn/ops/pallas/flash_attention.py flash_attention_int8_fused_qkv
// (_flash_cols_int8_kernel via _flash_int8_call): qkv [B, T, 3, H, D] ->
// out [B, T, H, D], bf16, D = 64, at vitl's B = 22 / 32 / 1 frames of
// T = 1370 (1814 for the 480 x 640 image), H = 16, and vitg's H = 24.  The
// mode picks the int8 products: 1 "qk" (QK^T), 2 "pv" (P V), 3 "all".
//
// Bound on the H100 by the tensor-core products (2 * B * H * T^2 * D each,
// int8 at 1979 TOP/s where quantized, bf16 at 989 TFLOP/s where not) and by
// the per-logit fp32 work around them.  What does not carry over from the
// TPU kernel, and what the design does about it:
//   - the scales depend on all T tokens (k's mean and its one absmax per
//     (frame, head); v's per-channel mean mu and absmax av), and the TPU
//     kernel recomputed them in every q block out of VMEM.  Here a
//     pre-pass (quantize_qkv_kernel) does it once, its blocks split by
//     role so that a single frame still fills the card (per (frame, head)
//     one block for each 512 q rows, one for k, one for v; k and v read
//     twice, their mean and absmax from one read): q per row (qi, aq), k
//     centred (ki, ak), v centred and per channel (av, mu), written as
//     int8 [B, H, Tp, 64] with Tp = T rounded up to 64 and zero rows past
//     T; v transposed, [B, H, 64, Tp], since P V's B operand for mma.sync
//     m16n8k32 .row.col s8 needs V's columns contiguous (ldmatrix .trans
//     moves 16-bit elements only);
//   - p is quantized against the exact row max (pi = rint(exp2(s - (m -
//     log2 127))) in [0, 127]), and an online softmax would quantize
//     against a running max and give other codes.  The main kernel
//     (flash_int8_kernel, one block of four warps per (frame, head, 64-row
//     q tile), a warp per 16 rows) walks the key tiles twice: the first
//     pass takes the row max of s, the second recomputes s and
//     accumulates.  The int32 logits are exact and the bf16 ones come from
//     the same instructions in both passes, so both see the same s;
//   - the fp32 accumulator fragment of an m16n8 product holds columns
//     {2t, 2t + 1} + 8j, the s8 A fragment of m16n8k32 columns 4t..4t+3
//     and 4t+16..4t+19, so pi is repacked with two shuffles per register
//     (__byte_perm picks the two bytes of each neighbour);
//   - the ragged tail: key columns >= T get -inf logits (so a padded key
//     enters neither the max nor the sums; its zero code adds nothing to P
//     V), q rows >= T are zero and never stored.
// Rounding as vdn's (see flash_attention_int8_fused_qkv_plain): reciprocal
// then multiply, rintf (half to even), s = float(si) * (aq * (ak * c2f)),
// out = (float(pv) * av) / float(l) + mu, every step rounded on its own;
// the "qk" mode's P V is A1's (p rounded to bf16, l from the rounded p).
// The means sum in another order than vdn's, which can move a code by one
// at a tie.  mma.sync with cp.async double buffering; no wgmma / TMA yet.
#include <math.h>

#include "common.cuh"
#include "int8_gemm.cuh"

namespace {

constexpr int kD = 64;
constexpr int kTile = 64;       // q rows and keys per tile
constexpr int kThreads = 128;   // four warps of 16 q rows
constexpr int kLd16 = kD + 8;   // bf16 rows: 144 bytes, conflict-free
constexpr int kLd8 = kD + 16;   // int8 rows: 80 bytes, conflict-free
constexpr int kTileBytes = kTile * kLd16 * 2;   // holds either layout
constexpr int kPreThreads = 1024;
constexpr int kRowGroups = kPreThreads / 32;   // a warp per row group
constexpr int kQRows = 512;    // q rows of one pre-pass block
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kLog2_127 = 6.988684686772166f;

__device__ __forceinline__ int8_t code(float x, float inv) {
  return static_cast<int8_t>(__float2int_rn(__fmul_rn(x, inv)));
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
}

// Per-channel statistics over T of the 64 channels at src (row stride ld),
// in one read: the mean (a thread sums channels 2c, 2c + 1 over rows rg,
// rg + kRowGroups, ...; the row groups' partial sums add in order; sum /
// T) and amax, the largest |x - mean| rounded as the quantizer rounds it.
// fl(x - mean) grows with x, so that largest value is at the channel's
// min or max: amax = max(|fl(max - mean)|, |fl(min - mean)|), exactly the
// max over every row, without a second pass.
struct ChannelStats {
  float sum[kRowGroups][kD];
  float lo[kRowGroups][kD];
  float hi[kRowGroups][kD];
  float mean[kD];
  float amax[kD];
};

__device__ void channel_stats(const __nv_bfloat16* src, int T, int ld,
                              ChannelStats& st) {
  const int c = threadIdx.x & 31, rg = threadIdx.x >> 5;
  float s[2] = {0.f, 0.f}, lo[2] = {INFINITY, INFINITY};
  float hi[2] = {-INFINITY, -INFINITY};
  for (int r = rg; r < T; r += kRowGroups) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)r * ld + 2 * c));
    const float x[2] = {f.x, f.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[e] = __fadd_rn(s[e], x[e]);
      lo[e] = fminf(lo[e], x[e]);
      hi[e] = fmaxf(hi[e], x[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    st.sum[rg][2 * c + e] = s[e];
    st.lo[rg][2 * c + e] = lo[e];
    st.hi[rg][2 * c + e] = hi[e];
  }
  __syncthreads();
  const int ch = threadIdx.x;
  if (ch < kD) {
    float sum = 0.f, l = INFINITY, h = -INFINITY;
    for (int i = 0; i < kRowGroups; ++i) {
      sum = __fadd_rn(sum, st.sum[i][ch]);
      l = fminf(l, st.lo[i][ch]);
      h = fmaxf(h, st.hi[i][ch]);
    }
    const float m = __fdiv_rn(sum, static_cast<float>(T));
    st.mean[ch] = m;
    st.amax[ch] = fmaxf(fabsf(__fsub_rn(h, m)), fabsf(__fsub_rn(l, m)));
  }
  __syncthreads();
}

// The int8 codes and scales of the mode.  Grid (B * H, roles): with mode &
// 1, one block for each kQRows q rows, then one block for k; with mode & 2,
// one block for v (the last).
__global__ void __launch_bounds__(kPreThreads)
quantize_qkv_kernel(const __nv_bfloat16* __restrict__ qkv, int T, int Tp,
                    int H, int mode, int8_t* __restrict__ qi,
                    float* __restrict__ aq, int8_t* __restrict__ ki,
                    float* __restrict__ ak, int8_t* __restrict__ vt,
                    float* __restrict__ av, float* __restrict__ mu) {
  __shared__ ChannelStats st;
  __shared__ __align__(16) int8_t tile[kD][kLd8];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int C = H * kD, ld = 3 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane, rg = warp;   // channels 2c, 2c + 1; rows rg + 32i
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld + h * kD;

  auto load2 = [&](const __nv_bfloat16* src, int r) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)r * ld + 2 * c));
  };
  auto store2 = [](int8_t* dst, int8_t lo, int8_t hi) {
    *reinterpret_cast<uint16_t*>(dst) =
        static_cast<uint16_t>(static_cast<uint8_t>(lo)) |
        static_cast<uint16_t>(static_cast<uint8_t>(hi)) << 8;
  };

  const int nq = (mode & 1) ? (Tp + kQRows - 1) / kQRows : 0;
  const int role = blockIdx.y;
  if (role < nq) {
    // q: one row per warp, its absmax over the 64 channels
    int8_t* qrow = qi + (size_t)bh * Tp * kD + 2 * c;
    const int r1 = min(Tp, (role + 1) * kQRows);
    for (int r = role * kQRows + rg; r < r1; r += kRowGroups) {
      if (r >= T) {
        store2(qrow + (size_t)r * kD, 0, 0);
        if (lane == 0) aq[(size_t)bh * Tp + r] = 0.f;
        continue;
      }
      const float2 f = load2(base, r);
      const float s =
          scale_of(vdn::warp_max(fmaxf(fabsf(f.x), fabsf(f.y))));
      const float inv = __fdiv_rn(1.f, s);
      store2(qrow + (size_t)r * kD, code(f.x, inv), code(f.y, inv));
      if (lane == 0) aq[(size_t)bh * Tp + r] = s;
    }
  } else if ((mode & 1) && role == nq) {
    // k: centred over tokens, one absmax per (frame, head)
    const __nv_bfloat16* kb = base + C;
    channel_stats(kb, T, ld, st);
    const float m0 = st.mean[2 * c], m1 = st.mean[2 * c + 1];
    float a = 0.f;
    for (int i = 0; i < kD; ++i) a = fmaxf(a, st.amax[i]);
    const float s = scale_of(a);
    const float inv = __fdiv_rn(1.f, s);
    if (tid == 0) ak[bh] = s;
    int8_t* krow = ki + (size_t)bh * Tp * kD + 2 * c;
    for (int r = rg; r < Tp; r += kRowGroups) {
      if (r >= T) {
        store2(krow + (size_t)r * kD, 0, 0);
        continue;
      }
      const float2 f = load2(kb, r);
      store2(krow + (size_t)r * kD, code(__fsub_rn(f.x, m0), inv),
             code(__fsub_rn(f.y, m1), inv));
    }
  } else {
    // v: centred over tokens, one absmax per channel; written transposed
    const __nv_bfloat16* vb = base + 2 * C;
    channel_stats(vb, T, ld, st);
    const float m0 = st.mean[2 * c], m1 = st.mean[2 * c + 1];
    if (tid < kD) {
      av[(size_t)bh * kD + tid] = scale_of(st.amax[tid]);
      mu[(size_t)bh * kD + tid] = st.mean[tid];
    }
    const float inv0 = __fdiv_rn(1.f, scale_of(st.amax[2 * c]));
    const float inv1 = __fdiv_rn(1.f, scale_of(st.amax[2 * c + 1]));
    int8_t* vrow = vt + (size_t)bh * kD * Tp;
    for (int r0 = 0; r0 < Tp; r0 += kTile) {
      for (int i = 0; i < kTile / kRowGroups; ++i) {
        const int rr = rg + kRowGroups * i, r = r0 + rr;
        int8_t c0 = 0, c1 = 0;
        if (r < T) {
          const float2 f = load2(vb, r);
          c0 = code(__fsub_rn(f.x, m0), inv0);
          c1 = code(__fsub_rn(f.y, m1), inv1);
        }
        tile[2 * c][rr] = c0;
        tile[2 * c + 1][rr] = c1;
      }
      __syncthreads();
      // 64 channels x 64 tokens, 16 bytes a thread
      if (tid < kD * kTile / 16) {
        const int ch = tid >> 2, part = (tid & 3) * 16;
        *reinterpret_cast<uint4*>(vrow + (size_t)ch * Tp + r0 + part) =
            *reinterpret_cast<const uint4*>(&tile[ch][part]);
      }
      __syncthreads();
    }
  }
}

template <bool kQK, bool kPV>
__global__ void __launch_bounds__(kThreads)
flash_int8_kernel(const __nv_bfloat16* __restrict__ qkv, int T, int Tp, int H,
                  float c2f, float qscale, const int8_t* __restrict__ qi,
                  const float* __restrict__ aq, const int8_t* __restrict__ ki,
                  const float* __restrict__ ak, const int8_t* __restrict__ vt,
                  const float* __restrict__ av, const float* __restrict__ mu,
                  __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) unsigned char Qs[kTileBytes];
  __shared__ __align__(16) unsigned char Ks[2][kTileBytes];
  __shared__ __align__(16) unsigned char Vs[2][kTileBytes];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = H * kD, ld = 3 * C;
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld + h * kD;
  const int8_t* kib = ki + (size_t)bh * Tp * kD;
  const int8_t* vtb = vt + (size_t)bh * kD * Tp;
  const int n_tiles = Tp / kTile;

  // one K (and with_v, one V) tile into buffer buf, by cp.async
  auto load_tile = [&](int tile, int buf, bool with_v) {
    const int k0 = tile * kTile;
    if constexpr (kQK) {
      for (int i = tid; i < kTile * (kD / 16); i += kThreads) {
        const int r = i >> 2, c = (i & 3) * 16;
        vdn::cp_async_16(&Ks[buf][r * kLd8 + c],
                         kib + (size_t)(k0 + r) * kD + c, 16);
      }
    } else {
      for (int i = tid; i < kTile * (kD / 8); i += kThreads) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = k0 + r;
        vdn::cp_async_16(
            &Ks[buf][(r * kLd16 + c) * 2],
            base + (size_t)(row < T ? row : T - 1) * ld + C + c,
            row < T ? 16 : 0);
      }
    }
    if (with_v) {
      if constexpr (kPV) {
        for (int i = tid; i < kD * (kTile / 16); i += kThreads) {
          const int ch = i >> 2, c = (i & 3) * 16;
          vdn::cp_async_16(&Vs[buf][ch * kLd8 + c],
                           vtb + (size_t)ch * Tp + k0 + c, 16);
        }
      } else {
        for (int i = tid; i < kTile * (kD / 8); i += kThreads) {
          const int r = i >> 3, c = (i & 7) * 8;
          const int row = k0 + r;
          vdn::cp_async_16(
              &Vs[buf][(r * kLd16 + c) * 2],
              base + (size_t)(row < T ? row : T - 1) * ld + 2 * C + c,
              row < T ? 16 : 0);
        }
      }
    }
    vdn::cp_async_commit();
  };

  load_tile(0, 0, false);

  // the q tile: int8 codes, or bf16 pre-scaled by bf16(scale * log2 e)
  uint32_t qa[kQK ? 2 : 4][4];
  float rs[2] = {1.f, 1.f};   // row scales aq * (ak * c2f) of rows g, g + 8
  if constexpr (kQK) {
    const int8_t* qib = qi + ((size_t)bh * Tp + q0) * kD;
    for (int i = tid; i < kTile * (kD / 16); i += kThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      *reinterpret_cast<uint4*>(&Qs[r * kLd8 + c]) =
          *reinterpret_cast<const uint4*>(qib + (size_t)r * kD + c);
    }
    const float kc = __fmul_rn(ak[bh], c2f);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rs[r] = __fmul_rn(aq[(size_t)bh * Tp + q0 + warp * 16 + g + 8 * r], kc);
  } else {
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(Qs);
    for (int i = tid; i < kTile * (kD / 8); i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q0 + r < T) {
        v = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ld + c);
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(hv[j]);
          hv[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
        }
      }
      *reinterpret_cast<uint4*>(&qs[r * kLd16 + c]) = v;
    }
  }
  __syncthreads();
  {
    const int r = warp * 16 + g;
    if constexpr (kQK) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int c = kk * 32 + 4 * t;
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(&Qs[r * kLd8 + c]);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r + 8) * kLd8 + c]);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(&Qs[r * kLd8 + c + 16]);
        qa[kk][3] =
            *reinterpret_cast<const uint32_t*>(&Qs[(r + 8) * kLd8 + c + 16]);
      }
    } else {
      const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(Qs);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = kk * 16 + 2 * t;
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(&qs[r * kLd16 + c]);
        qa[kk][1] =
            *reinterpret_cast<const uint32_t*>(&qs[(r + 8) * kLd16 + c]);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(&qs[r * kLd16 + c + 8]);
        qa[kk][3] =
            *reinterpret_cast<const uint32_t*>(&qs[(r + 8) * kLd16 + c + 8]);
      }
    }
  }

  // the logits of this warp's 16 rows against key tile j (in buffer buf),
  // base 2, keys >= T at -inf
  auto logits = [&](int j, int buf, float (&s)[kTile / 8][4]) {
    if constexpr (kQK) {
      int si[kTile / 8][4];
#pragma unroll
      for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) si[nj][q] = 0;
      const unsigned char* ks = Ks[buf];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int c = kk * 32 + 4 * t;
#pragma unroll
        for (int nj = 0; nj < kTile / 8; ++nj) {
          const int r = nj * 8 + g;
          uint32_t bfr[2];
          bfr[0] = *reinterpret_cast<const uint32_t*>(&ks[r * kLd8 + c]);
          bfr[1] = *reinterpret_cast<const uint32_t*>(&ks[r * kLd8 + c + 16]);
          vdn::mma_s8_16832(si[nj], qa[kk], bfr);
        }
      }
#pragma unroll
      for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[nj][q] = __fmul_rn(static_cast<float>(si[nj][q]), rs[q >> 1]);
    } else {
#pragma unroll
      for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[nj][q] = 0.f;
      const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(Ks[buf]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = kk * 16 + 2 * t;
#pragma unroll
        for (int nj = 0; nj < kTile / 8; ++nj) {
          const int r = nj * 8 + g;
          uint32_t bfr[2];
          bfr[0] = *reinterpret_cast<const uint32_t*>(&ks[r * kLd16 + c]);
          bfr[1] = *reinterpret_cast<const uint32_t*>(&ks[r * kLd16 + c + 8]);
          vdn::mma_bf16_16816(s[nj], qa[kk], bfr);
        }
      }
    }
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj) {
      const int key = j * kTile + nj * 8 + 2 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (key + (q & 1) >= T) s[nj][q] = -INFINITY;
    }
  };

  // pass 1: the exact row max
  float m[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, buf ^ 1, false);
      vdn::cp_async_wait<1>();
    } else {
      vdn::cp_async_wait<0>();
    }
    __syncthreads();
    float s[kTile / 8][4];
    logits(j, buf, s);
#pragma unroll
    for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) m[q >> 1] = fmaxf(m[q >> 1], s[nj][q]);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }

  // pass 2: the same logits, then P V
  load_tile(0, 0, true);
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    shift[r] = kPV ? __fsub_rn(m[r], kLog2_127) : m[r];
  int oi[kD / 8][4];
  float of[kD / 8][4];
  int l_int[2] = {0, 0};
  float l_f[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      oi[nd][q] = 0;
      of[nd][q] = 0.f;
    }
  // the neighbours whose pairs make up this thread's A-fragment bytes
  const int src0 = (lane & ~3) | (2 * (t & 1));
  const uint32_t sel = (t >> 1) ? 0x7632u : 0x5410u;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, buf ^ 1, true);
      vdn::cp_async_wait<1>();
    } else {
      vdn::cp_async_wait<0>();
    }
    __syncthreads();
    float s[kTile / 8][4];
    logits(j, buf, s);
    if constexpr (kPV) {
      // pi = rint(exp2(s - (m - log2 127))), packed by row: pk[nj][0] the
      // pair of row g, pk[nj][1] that of row g + 8
      uint32_t pk[kTile / 8][2];
#pragma unroll
      for (int nj = 0; nj < kTile / 8; ++nj) {
        int p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p[q] = __float2int_rn(exp2f(__fsub_rn(s[nj][q], shift[q >> 1])));
          l_int[q >> 1] += p[q];
        }
        pk[nj][0] = static_cast<uint32_t>(p[0] | p[1] << 8);
        pk[nj][1] = static_cast<uint32_t>(p[2] | p[3] << 8);
      }
      const unsigned char* vs = Vs[buf];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {     // keys 0-15, 16-31
          const int n = 4 * kk + 2 * half;
#pragma unroll
          for (int row = 0; row < 2; ++row) {      // rows g, g + 8
            const uint32_t w = pk[n][row] | pk[n + 1][row] << 16;
            const uint32_t u = __shfl_sync(0xffffffffu, w, src0);
            const uint32_t v = __shfl_sync(0xffffffffu, w, src0 + 1);
            a[2 * half + row] = __byte_perm(u, v, sel);
          }
        }
#pragma unroll
        for (int nd = 0; nd < kD / 8; ++nd) {
          const int ch = nd * 8 + g;
          const int c = kk * 32 + 4 * t;
          uint32_t bfr[2];
          bfr[0] = *reinterpret_cast<const uint32_t*>(&vs[ch * kLd8 + c]);
          bfr[1] = *reinterpret_cast<const uint32_t*>(&vs[ch * kLd8 + c + 16]);
          vdn::mma_s8_16832(oi[nd], a, bfr);
        }
      }
    } else {
#pragma unroll
      for (int nj = 0; nj < kTile / 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float p = vdn::bf16r(exp2f(__fsub_rn(s[nj][q], shift[q >> 1])));
          s[nj][q] = p;
          l_f[q >> 1] += p;
        }
      const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(Vs[buf]);
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
          vdn::ldmatrix_x4_trans(
              v4, &vs[key * kLd16 + (2 * nd + (mat >> 1)) * 8]);
          const uint32_t b0[2] = {v4[0], v4[1]};
          const uint32_t b1[2] = {v4[2], v4[3]};
          vdn::mma_bf16_16816(of[2 * nd], a, b0);
          vdn::mma_bf16_16816(of[2 * nd + 1], a, b1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_int[r] += __shfl_xor_sync(0xffffffffu, l_int[r], 1);
    l_int[r] += __shfl_xor_sync(0xffffffffu, l_int[r], 2);
    l_f[r] += __shfl_xor_sync(0xffffffffu, l_f[r], 1);
    l_f[r] += __shfl_xor_sync(0xffffffffu, l_f[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= T) continue;
    __nv_bfloat16* dst = out + ((size_t)b * T + row) * C + h * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (kPV) {
          const int ch = nd * 8 + 2 * t + e;
          const float l = static_cast<float>(l_int[r]);
          y[e] = __fadd_rn(
              __fdiv_rn(__fmul_rn(static_cast<float>(oi[nd][2 * r + e]),
                                  av[(size_t)bh * kD + ch]),
                        l),
              mu[(size_t)bh * kD + ch]);
        } else {
          y[e] = __fdiv_rn(of[nd][2 * r + e], l_f[r]);
        }
      }
      *reinterpret_cast<uint32_t*>(dst + nd * 8) = vdn::pack_bf16(y[0], y[1]);
    }
  }
}

}  // namespace

// qkv [B, T, 3 * H * 64] bf16 -> out [B, T, H * 64] bf16.  mode 1 (qk), 2
// (pv) or 3 (all).  c2f is fp32(scale * log2 e), qscale bf16(scale *
// log2 e) (the bf16 QK^T's fold into q).  Scratch, Tp = T rounded up to 64,
// written here and readable after the call: with mode & 1, qi [B, H, Tp,
// 64] int8, aq [B, H, Tp], ki [B, H, Tp, 64] int8, ak [B, H] fp32; with
// mode & 2, vt [B, H, 64, Tp] int8, av and mu [B, H, 64] fp32 (the other
// pointers may be null).  Two launches: the pre-pass, then the attention.
extern "C" int vdn_flash_attention_int8(const void* qkv, int B, int T, int H,
                                        int mode, float c2f, float qscale,
                                        void* qi, void* aq, void* ki, void* ak,
                                        void* vt, void* av, void* mu,
                                        void* out, void* stream) {
  if (B < 1 || T < 1 || H < 1 || mode < 1 || mode > 3 || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const int Tp = (T + kTile - 1) / kTile * kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
  const dim3 pre(B * H, ((mode & 1) ? (Tp + kQRows - 1) / kQRows + 1 : 0) +
                            ((mode & 2) ? 1 : 0));
  quantize_qkv_kernel<<<pre, kPreThreads, 0, s>>>(
      x, T, Tp, H, mode, static_cast<int8_t*>(qi), static_cast<float*>(aq),
      static_cast<int8_t*>(ki), static_cast<float*>(ak),
      static_cast<int8_t*>(vt), static_cast<float*>(av),
      static_cast<float*>(mu));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(Tp / kTile, H, B);
  auto* o = static_cast<__nv_bfloat16*>(out);
#define VDN_F6_LAUNCH(QK, PV)                                               \
  flash_int8_kernel<QK, PV><<<grid, kThreads, 0, s>>>(                      \
      x, T, Tp, H, c2f, qscale, static_cast<const int8_t*>(qi),             \
      static_cast<const float*>(aq), static_cast<const int8_t*>(ki),        \
      static_cast<const float*>(ak), static_cast<const int8_t*>(vt),        \
      static_cast<const float*>(av), static_cast<const float*>(mu), o)
  if (mode == 1)
    VDN_F6_LAUNCH(true, false);
  else if (mode == 2)
    VDN_F6_LAUNCH(false, true);
  else
    VDN_F6_LAUNCH(true, true);
#undef VDN_F6_LAUNCH
  return cudaGetLastError();
}
