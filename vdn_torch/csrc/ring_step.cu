// E1: one online-softmax update of the ring-attention carry (o, m, l) with
// one K / V block, in place.
//
// Replaces vdn/ops/pallas/ring_attention.py ring_step (_ring_step_kernel):
// s = (q k^T) * scale with fp32 sums of compute-dtype operands, m' =
// max(m, rowmax s) over the whole block before any exp, p = exp(s - m'),
// corr = exp(m - m'), l' = l corr + rowsum(p) from the unrounded p, o' = o
// corr + (p rounded to v's dtype) v with fp32 sums.  The context-parallel
// temporal attention runs it once per ring step (vdn/parallel/context.py
// cp_attention: "ring_pallas", and "auto" at 128 keys a block and more):
// q [G, Tq, D] against a block k, v [G, Tk, D], G = tokens x heads (10952
// to 43808 at vitl 518), Tq = Tk = the local frames (8, 32, 128, 256), D =
// 32 / 128 (vitl), 48 / 192 (vitg).
//
// Bound on the H100 by its bytes: q, k, v read once, the fp32 carry read
// and written (o is 8 of a bf16 element's 14 bytes); its 4 G Tq Tk D FLOP
// are 3% of that time at T 32 on the tensor cores and 20% at T 128.  The
// TPU kernel kept a block of 8 rows' logits in VMEM and took both
// products on the MXU.  Here both products run on mma.sync (bf16:
// m16n8k16 with fp32 sums, S from ldmatrix fragments, p repacked from S's
// accumulators into A fragments, v through ldmatrix.trans; fp32: 3xTF32
// m16n8k8, attn_f32.cuh, the keys of each 8-key step in the accumulators'
// order 2t, 2t + 1), and every operand, the carry's o rows included,
// travels by cp.async (16 bytes a lane) into shared memory ahead of its
// use.  o' = o corr + pv is taken in the accumulator layout against the
// staged o rows, written back over them and stored 16 bytes a lane; m and
// l by the quad's lane 0.  Rows are padded to a multiple of 16 columns
// (zero) plus 8 for conflict-free ldmatrix (bf16; fp32 rows D + 4), o
// rows to D + 8.  Two modes, chosen by the host's plan
// (kernels/ring_attention.py e1_plan) from the layout and what a launch
// holds on an SM (e1_layout.cuh, its one source):
//
// - warp (Tq, Tk <= 16 and D <= 64: T 8 at vitl's D 32 and vitg's 48,
//   where it measured faster, tools/e1_plans.py; the kernel takes Tq, Tk
//   <= 32): one warp per (row, head) item, as A3's core
//   (temporal_attn.cu): a ring of two item slots a warp (q, k, v, o),
//   persistent blocks of as many warps as fit walking the items at the
//   grid's stride, items b * H + h so neighbouring warps read neighbouring
//   heads of one row; a warp takes its item's 16-row q tiles in turn, its
//   logits in registers, the value product in passes of 64 columns;
// - block (the rest; at T 32 it beat the warp mode at every width): one
//   block a (row, 16 w-row q tile), its w warps sharing the row's K / V,
//   streamed through a ring of 32- or 64-key tiles (all threads copy, one
//   __syncthreads a tile; a 64-key tile is two independent groups of 32
//   for each warp), each warp taking a 16-row tile of q; w (1-8), the
//   ring's depth (2-4) and the tile's keys as the plan finds fastest.
//   Up to kKeepKeys keys the logits stay in registers (K tiles, then V
//   tiles); above, two passes over the K tiles: the first finds each row's
//   max, the second recomputes S in the same mma order (the same bits) and
//   takes p, l and pv against each V tile.  So the rounding points are the
//   plain version's at any Tk, and shared memory does not grow with Tk.
//
// q, k, v are read through strides: element (g, t, d) at (g / H) * sb + t
// * st + (g % H) * sh + d, which covers [G, T, D] (H = 1) and [B, T, H, D]
// (G = B * H) without a transpose; bases and strides are 16-byte aligned.
#include <math.h>

#include <type_traits>

#include "attn_f32.cuh"
#include "e1_layout.cuh"
#include "warp_mma.cuh"

namespace {

namespace mm = vdn::msync;
using vdn::attn_f32::mma_3xtf32;
using vdn::attn_f32::split_tf32;
using bf16 = __nv_bfloat16;

using namespace vdn::e1;
constexpr int kKeepGroups = kKeepKeys / kGroup;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  float* o;
  float* m;
  float* l;
  int G, Tq, Tk, D, H, stages, kc;
  long long qsb, qst, kvsb, kvst, sh;
  float scale;
};

// A walk over the 16-byte chunks of ``rows`` rows of ``ch`` chunks by
// thread ``tid`` of n: chunk i = tid + n j at (row, chunk of the row),
// stepped without a division
struct Chunks {
  int r, c, dr, dc, ch;
  __device__ __forceinline__ Chunks(int tid, int n, int ch_)
      : r(tid / ch_), c(tid % ch_), dr(n / ch_), dc(n % ch_), ch(ch_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= ch) {
      c -= ch;
      ++r;
    }
  }
};

// cp.async of rows [0, valid) of D values at src (row stride st) into dst
// (row stride ld), rows [valid, rows) zero-filled, 16 bytes a thread of n
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long st, int valid, int rows,
                                          int D, int tid, int n) {
  constexpr int V = 16 / sizeof(T);
  for (Chunks w(tid, n, D / V); w.r < rows; w.next()) {
    const bool in = w.r < valid;
    vdn::cp_async_16(dst + w.r * ld + w.c * V,
                     src + (in ? w.r * st + w.c * V : 0), in ? 16 : 0);
  }
}

// rows [0, rows) of D floats from shared src (row stride ldo) to dst (row
// stride D), 16 bytes a thread of n
__device__ __forceinline__ void store_rows(float* dst, const float* src,
                                           int ldo, int rows, int D, int tid,
                                           int n) {
  for (Chunks w(tid, n, D / 4); w.r < rows; w.next())
    *reinterpret_cast<float4*>(dst + (size_t)w.r * D + w.c * 4) =
        *reinterpret_cast<const float4*>(src + w.r * ldo + w.c * 4);
}

// bf16 at D % 16 == 8: zero columns [D, D + 8) of ``rows`` rows (the k
// steps' padding; no load writes them)
template <typename T>
__device__ __forceinline__ void zero_pad(T* s, int ld, int rows, int D,
                                         int tid, int n) {
  if (sizeof(T) == 2 && D % 16)
    for (int r = tid; r < rows; r += n)
      *reinterpret_cast<uint4*>(s + r * ld + D) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void zero4(float (&s)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
}

// S = q k^T of 16 q rows (qs, row stride ld) against 32 keys (ks), in
// ``pairs`` 16-key halves with a key < Tk: s[n] holds keys 8n + 2t, 8n + 2t
// + 1 of rows g, g + 8.  bf16: 16-wide k steps over the padded width
__device__ __forceinline__ void s_rows(float (&s)[4][4], const bf16* qs,
                                       const bf16* ks, int ld, int D,
                                       int pairs, int lane) {
  zero4(s);
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    uint32_t a[4];
    mm::frag_a(a, qs, ld, 0, 16 * kk, lane);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= pairs) break;
      uint32_t b[4];
      mm::frag_b(b, ks, ld, p, 16 * kk, lane);
      mm::mma(s[2 * p], a, b[0], b[1]);
      mm::mma(s[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// fp32: 8-wide k steps in 3xTF32, fragments read as C2 fp32's
// (flash_attn_bthd_f32.cu)
__device__ __forceinline__ void s_rows(float (&s)[4][4], const float* qs,
                                       const float* ks, int ld, int D,
                                       int pairs, int lane) {
  const int g = lane >> 2, t = lane & 3;
  zero4(s);
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(qs[(g + 8 * (i & 1)) * ld + 8 * kk + t + 4 * (i >> 1)],
                 ab[i], as[i]);
    uint32_t bb[4][2] = {}, bs[4][2] = {};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n >= 2 * pairs) break;
      const float* kr = ks + (8 * n + g) * ld + 8 * kk + t;
      split_tf32(kr[0], bb[n][0], bs[n][0]);
      split_tf32(kr[4], bb[n][1], bs[n][1]);
    }
    mma_3xtf32<4, 4>(s, 0, ab, as, bb, bs, 2 * pairs);
  }
}

// s * scale (rounded as the plain version's product), keys >= Tk -inf
// (only a 32-key group that reaches past Tk has such keys); k0: the key
// of the group's column 0
__device__ __forceinline__ void scale_mask(float (&s)[4][4], float scale,
                                           int k0, int Tk, int lane) {
  const int t = lane & 3;
  const bool full = k0 + 32 <= Tk;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[n][i] = full || k0 + 8 * n + 2 * t + (i & 1) < Tk
                    ? __fmul_rn(s[n][i], scale)
                    : -INFINITY;
}

// this thread's max of rows g (mx[0]) and g + 8 (mx[1]) over the keys <
// Tk of a group; on the unscaled sums it is the scaled sums' max before
// the scaling (x -> fl(x scale) is monotonic for scale > 0)
__device__ __forceinline__ void max_into(float (&mx)[2],
                                         const float (&s)[4][4], int k0,
                                         int Tk, int lane) {
  const int t = lane & 3;
  const bool full = k0 + 32 <= Tk;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (full || k0 + 8 * n + 2 * t + (i & 1) < Tk)
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
}

// exp(x) as ex2.approx(x log2 e), flushing results below 2^-126 to zero:
// its relative error (2^-22 and x's rounding into log2 e units, 2e-6 at x
// = -20) is far inside the checks against the plain version's exp
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

__device__ __forceinline__ void quad_max(float (&x)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x[h] = fmaxf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 1));
    x[h] = fmaxf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 2));
  }
}

__device__ __forceinline__ void quad_sum(float (&x)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x[h] += __shfl_xor_sync(0xffffffffu, x[h], 1);
    x[h] += __shfl_xor_sync(0xffffffffu, x[h], 2);
  }
}

// p = exp(s - m'), in place, and this thread's share of the row sums
__device__ __forceinline__ void exp_into(float (&s)[4][4],
                                         const float (&m)[2],
                                         float (&sum)[2]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[n][i] = exp_fast(s[n][i] - m[i >> 1]);
      sum[i >> 1] += s[n][i];
    }
}

// p as the A operand of the value product over a 32-key group: bf16, two
// 16-key steps rounded to v's dtype; fp32, S's accumulators as they are
struct PBf16 {
  uint32_t a[2][4];
};
struct PF32 {
  float p[4][4];
};
template <typename T>
using PFrag = typename std::conditional<sizeof(T) == 2, PBf16, PF32>::type;

__device__ __forceinline__ void make_p(PBf16& P, const float (&s)[4][4]) {
  mm::pack_p(P.a[0], s[0], s[1]);
  mm::pack_p(P.a[1], s[2], s[3]);
}
__device__ __forceinline__ void make_p(PF32& P, const float (&s)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) P.p[n][i] = s[n][i];
}

// acc[nd] += p v over the group's ``pairs`` 16-key halves, n8 column tiles
// c0 + nd for nd < valid (vs: the group's 32 key rows)
template <int N>
__device__ __forceinline__ void pv_rows(float (&acc)[N][4], const PBf16& P,
                                        const bf16* vs, int ld, int pairs,
                                        int c0, int valid, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (kk >= pairs) break;
#pragma unroll
    for (int nd = 0; nd < N; nd += 2) {
      if (nd >= valid) break;
      uint32_t b[4];
      mm::frag_b_t(b, vs, ld, kk, c0 + nd, lane);
      mm::mma(acc[nd], P.a[kk], b[0], b[1]);
      mm::mma(acc[nd + 1], P.a[kk], b[2], b[3]);
    }
  }
}

// fp32: 8-key step kk takes keys 8kk + 2t (logical t) and 8kk + 2t + 1
// (logical t + 4), where S's accumulators left them; v's rows likewise
template <int N>
__device__ __forceinline__ void pv_rows(float (&acc)[N][4], const PF32& P,
                                        const float* vs, int ld, int pairs,
                                        int c0, int valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int kG = 4;  // n8 tiles a product group (registers)
  static_assert(N % kG == 0, "column groups");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= 2 * pairs) break;
    uint32_t ab[4], as[4];
    split_tf32(P.p[kk][0], ab[0], as[0]);
    split_tf32(P.p[kk][2], ab[1], as[1]);
    split_tf32(P.p[kk][1], ab[2], as[2]);
    split_tf32(P.p[kk][3], ab[3], as[3]);
    const float* vr = vs + (8 * kk + 2 * t) * ld + 8 * c0 + g;
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += kG) {
      if (n0 >= valid) break;
      uint32_t bb[kG][2] = {}, bs[kG][2] = {};
#pragma unroll
      for (int n = 0; n < kG; ++n) {
        if (n0 + n >= valid) break;
        split_tf32(vr[8 * (n0 + n)], bb[n][0], bs[n][0]);
        split_tf32(vr[ld + 8 * (n0 + n)], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<kG, N>(acc, n0, ab, as, bb, bs, valid - n0);
    }
  }
}

// o' = o corr + pv on the staged o rows g, g + 8 (os, row stride ldo),
// n8 column tiles c0 + nd for nd < valid, written back over them
template <int N>
__device__ __forceinline__ void carry_rows(float* os, int ldo,
                                           const float (&acc)[N][4], int c0,
                                           int valid, const float (&corr)[2],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < N; ++nd) {
    if (nd >= valid) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* p = reinterpret_cast<float2*>(os + (g + 8 * h) * ldo +
                                            8 * (c0 + nd) + 2 * t);
      float2 x = *p;
      x.x = __fadd_rn(__fmul_rn(x.x, corr[h]), acc[nd][2 * h]);
      x.y = __fadd_rn(__fmul_rn(x.y, corr[h]), acc[nd][2 * h + 1]);
      *p = x;
    }
  }
}

// m', corr and the rows' old m from the block's max (quad-reduced)
__device__ __forceinline__ void new_max(float (&m_new)[2], float (&corr)[2],
                                        const float (&m_old)[2],
                                        const float (&mx)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = fmaxf(m_old[h], mx[h]);
    corr[h] = exp_fast(m_old[h] - m_new[h]);
  }
}

// m and l of rows r0 + g, r0 + g + 8 of item ``item``, by the quad's lane 0
__device__ __forceinline__ void store_ml(float* m, float* l, size_t item,
                                        int Tq, int r0,
                                        const float (&m_new)[2],
                                        const float (&l_old)[2],
                                        const float (&corr)[2],
                                        const float (&sum)[2], int lane) {
  if (lane & 3) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + (lane >> 2) + 8 * h;
    if (row >= Tq) continue;
    m[item * Tq + row] = m_new[h];
    l[item * Tq + row] = __fadd_rn(__fmul_rn(l_old[h], corr[h]), sum[h]);
  }
}

// the rows' old m, l (plain loads, issued ahead of the products)
__device__ __forceinline__ void load_ml(float (&m_old)[2], float (&l_old)[2],
                                       const float* m, const float* l,
                                       size_t item, int Tq, int r0,
                                       int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + (lane >> 2) + 8 * h;
    const bool in = row < Tq;
    m_old[h] = in ? m[item * Tq + row] : 0.f;
    l_old[h] = in ? l[item * Tq + row] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpCap, 1)
e1_warp_kernel(const Args<T> a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const int ld = ld_of((int)sizeof(T), D), ldo = ldo_of(D), nd = D / 8;
  const int mt = (Tq + 15) / 16, kt = (Tk + 15) / 16;
  const int rq = 16 * mt, rk = 16 * kt;
  const int slot = warp_slot((int)sizeof(T), D, Tq, Tk);
  uint8_t* base = smem + (size_t)warp * 2 * slot;
  for (int st = 0; st < 2; ++st)
    zero_pad(reinterpret_cast<T*>(base + st * slot), ld, rq + 2 * rk, D,
             lane, 32);
  __syncwarp();
  auto q_of = [&](int st) { return reinterpret_cast<T*>(base + st * slot); };
  auto o_of = [&](int st) {
    return reinterpret_cast<float*>(base + st * slot +
                                    (rq + 2 * rk) * ld * (int)sizeof(T));
  };
  // q, k, v and o of item ``it`` into slot ``st``; one cp.async group a call
  auto fetch = [&](int it, int st) {
    if (it < a.G) {
      const int b = it / a.H;
      const long long head = (long long)(it - b * a.H) * a.sh;
      T* qs = q_of(st);
      load_rows(qs, ld, a.q + b * a.qsb + head, a.qst, Tq, rq, D, lane, 32);
      load_rows(qs + rq * ld, ld, a.k + b * a.kvsb + head, a.kvst, Tk, rk, D,
                lane, 32);
      load_rows(qs + (rq + rk) * ld, ld, a.v + b * a.kvsb + head, a.kvst, Tk,
                rk, D, lane, 32);
      load_rows(o_of(st), ldo, a.o + (size_t)it * Tq * D, D, Tq, rq, D, lane,
                32);
    }
    vdn::cp_async_commit();
  };
  const int stride = gridDim.x * nw;
  int item = blockIdx.x * nw + warp;
  fetch(item, 0);
#pragma unroll 1
  for (int n = 0; item < a.G; ++n, item += stride) {
    fetch(item + stride, (n + 1) & 1);
    float m_old[2][2], l_old[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      load_ml(m_old[mi], l_old[mi], a.m, a.l, item, mi < mt ? Tq : 0,
              16 * mi, lane);
    vdn::cp_async_wait<1>();
    __syncwarp();
    const T* qs = q_of(n & 1);
    const T* ks = qs + rq * ld;
    const T* vs = ks + rk * ld;
    float* os = o_of(n & 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi >= mt) break;
      float s[4][4];
      s_rows(s, qs + 16 * mi * ld, ks, ld, D, kt, lane);
      scale_mask(s, a.scale, 0, Tk, lane);
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
      float m_new[2], corr[2];
      max_into(mx, s, 0, Tk, lane);
      quad_max(mx);
      new_max(m_new, corr, m_old[mi], mx);
      exp_into(s, m_new, sum);
      quad_sum(sum);
      PFrag<T> P;
      make_p(P, s);
      for (int c0 = 0; c0 < nd; c0 += 8) {
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
        pv_rows<8>(acc, P, vs, ld, kt, c0, nd - c0, lane);
        carry_rows<8>(os + 16 * mi * ldo, ldo, acc, c0, nd - c0, corr, lane);
      }
      store_ml(a.m, a.l, item, Tq, 16 * mi, m_new, l_old[mi], corr, sum,
               lane);
    }
    __syncwarp();
    store_rows(a.o + (size_t)item * Tq * D, os, ldo, Tq, D, lane, 32);
    __syncwarp();  // the slot's reads done before its next load
  }
  vdn::cp_async_wait<0>();
}

// all but the last ``n`` groups a thread committed are complete (n = the
// ring's depth less 2: 0, 1 or 2)
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: vdn::cp_async_wait<0>(); break;
    case 1: vdn::cp_async_wait<1>(); break;
    default: vdn::cp_async_wait<2>();
  }
}

// 16-key halves of 32-key group c with a key < Tk
__device__ __forceinline__ int pairs_of(int c, int Tk) {
  return min(2, (Tk - c * kGroup + 15) / 16);
}

template <typename T, int NDM, bool KEEP>
__global__ void __launch_bounds__(32 * kBlockWarps,
                                  min_blocks((int)sizeof(T), 8 * NDM))
e1_block_kernel(const Args<T> a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk, NS = a.stages, kc = a.kc;
  const int ld = ld_of((int)sizeof(T), D), ldo = ldo_of(D), nd = D / 8;
  const int gpt = kc / kGroup;  // 32-key groups a tile: 1 or 2
  const int nqt = (Tq + 16 * nw - 1) / (16 * nw);
  const int item = blockIdx.x / nqt;
  const int r0 = (blockIdx.x - item * nqt) * 16 * nw + 16 * warp;
  T* qs = reinterpret_cast<T*>(smem) + warp * 16 * ld;
  float* os = reinterpret_cast<float*>(smem + nw * 16 * ld * sizeof(T)) +
              warp * 16 * ldo;
  T* ring = reinterpret_cast<T*>(smem + nw * 16 * (ld * sizeof(T) + ldo * 4));
  zero_pad(reinterpret_cast<T*>(smem), ld, nw * 16, D, tid, nt);
  zero_pad(ring, ld, NS * kc, D, tid, nt);  // ordered by advance's barrier

  const int b = item / a.H;
  const long long head = (long long)(item - b * a.H) * a.sh;
  const T* kg = a.k + b * a.kvsb + head;
  const T* vg = a.v + b * a.kvsb + head;
  const int nc = (Tk + kc - 1) / kc;          // key tiles
  const int ng = (Tk + kGroup - 1) / kGroup;  // 32-key groups with a key
  const int ntiles = (KEEP ? 2 : 3) * nc;
  // tile j of the item's walk into ring slot j % NS: KEEP, K tiles then V
  // tiles; else the K tiles (the max), then K and V of each key tile
  auto issue = [&](int j) {
    if (j < ntiles) {
      bool isv;
      int c;
      if (KEEP) {
        isv = j >= nc;
        c = isv ? j - nc : j;
      } else if (j < nc) {
        isv = false;
        c = j;
      } else {
        isv = (j - nc) & 1;
        c = (j - nc) >> 1;
      }
      const int k0 = c * kc;
      load_rows(ring + (j % NS) * kc * ld, ld, (isv ? vg : kg) + k0 * a.kvst,
                a.kvst, min(kc, Tk - k0), kc, D, tid, nt);
    }
    vdn::cp_async_commit();
  };
  // the warp's q and o rows go with the first tile
  const int rows = max(0, min(16, Tq - r0));
  const bool active = rows > 0;
  load_rows(qs, ld, a.q + b * a.qsb + head + (active ? r0 * a.qst : 0),
            a.qst, rows, 16, D, lane, 32);
  load_rows(os, ldo, a.o + ((size_t)item * Tq + (active ? r0 : 0)) * D, D,
            rows, 16, D, lane, 32);
  for (int j = 0; j < NS - 1; ++j) issue(j);
  int j = 0;
  // tile j is in its slot, every warp is done with tile j - 1, whose slot
  // takes tile j + NS - 1
  auto advance = [&]() -> const T* {
    wait_pending(NS - 2);
    __syncthreads();
    issue(j + NS - 1);
    return ring + (j++ % NS) * kc * ld;
  };

  float m_old[2], l_old[2];
  load_ml(m_old, l_old, a.m, a.l, item, Tq, r0, lane);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float m_new[2], corr[2];
  float acc[NDM][4];
  if constexpr (KEEP) {
    // group c of tile c / gpt; a tile's groups are independent work
    float s[kKeepGroups][4][4];
    const T* ks = nullptr;
#pragma unroll
    for (int c = 0; c < kKeepGroups; ++c) {
      if (c >= ng) break;
      if (c % gpt == 0) ks = advance();
      if (active) {
        s_rows(s[c], qs, ks + (c % gpt) * kGroup * ld, ld, D,
               pairs_of(c, Tk), lane);
        scale_mask(s[c], a.scale, c * kGroup, Tk, lane);
        max_into(mx, s[c], c * kGroup, Tk, lane);
      }
    }
    quad_max(mx);
    new_max(m_new, corr, m_old, mx);
    PFrag<T> P[kKeepGroups];
#pragma unroll
    for (int c = 0; c < kKeepGroups; ++c) {
      if (c >= ng) break;
      exp_into(s[c], m_new, sum);
      make_p(P[c], s[c]);
    }
#pragma unroll
    for (int c = 0; c < NDM; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
    const T* vs = nullptr;
#pragma unroll
    for (int c = 0; c < kKeepGroups; ++c) {
      if (c >= ng) break;
      if (c % gpt == 0) vs = advance();
      if (active)
        pv_rows<NDM>(acc, P[c], vs + (c % gpt) * kGroup * ld, ld,
                     pairs_of(c, Tk), 0, nd, lane);
    }
  } else {
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const T* ks = advance();
      if (!active) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grp = c * gpt + h;
        if (h >= gpt || grp >= ng) break;
        float s[4][4];
        s_rows(s, qs, ks + h * kGroup * ld, ld, D, pairs_of(grp, Tk), lane);
        max_into(mx, s, grp * kGroup, Tk, lane);  // unscaled
      }
    }
    quad_max(mx);
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = __fmul_rn(mx[h], a.scale);
    new_max(m_new, corr, m_old, mx);
#pragma unroll
    for (int c = 0; c < NDM; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const T* ks = advance();
      PFrag<T> P[2];
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int grp = c * gpt + h;
          if (h >= gpt || grp >= ng) break;
          float s[4][4];
          s_rows(s, qs, ks + h * kGroup * ld, ld, D, pairs_of(grp, Tk),
                 lane);
          scale_mask(s, a.scale, grp * kGroup, Tk, lane);
          exp_into(s, m_new, sum);
          make_p(P[h], s);
        }
      }
      const T* vs = advance();
      if (!active) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grp = c * gpt + h;
        if (h >= gpt || grp >= ng) break;
        pv_rows<NDM>(acc, P[h], vs + h * kGroup * ld, ld, pairs_of(grp, Tk),
                     0, nd, lane);
      }
    }
  }
  quad_sum(sum);
  vdn::cp_async_wait<0>();
  if (!active) return;
  carry_rows<NDM>(os, ldo, acc, 0, nd, corr, lane);
  __syncwarp();
  store_rows(a.o + ((size_t)item * Tq + r0) * D, os, ldo, rows, D, lane, 32);
  store_ml(a.m, a.l, item, Tq, r0, m_new, l_old, corr, sum, lane);
}

template <typename Kernel>
cudaError_t allow(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax);
}

template <typename T, int NDM, bool KEEP>
cudaError_t launch_block(const Args<T>& a, int warps, int grid, int smem,
                         cudaStream_t s) {
  static const cudaError_t attr = allow(e1_block_kernel<T, NDM, KEEP>);
  if (attr != cudaSuccess) return attr;
  e1_block_kernel<T, NDM, KEEP><<<grid, 32 * warps, smem, s>>>(a);
  return cudaGetLastError();
}

// the block mode's accumulators are held for the whole head: n8 tiles by
// width class (32, 64, 128, 192, 256)
template <typename T, bool KEEP>
cudaError_t launch_width(const Args<T>& a, int warps, int grid, int smem,
                         cudaStream_t s) {
  const int nd = a.D / 8;
  if (nd <= 4) return launch_block<T, 4, KEEP>(a, warps, grid, smem, s);
  if (nd <= 8) return launch_block<T, 8, KEEP>(a, warps, grid, smem, s);
  if (nd <= 16) return launch_block<T, 16, KEEP>(a, warps, grid, smem, s);
  if (nd <= 24) return launch_block<T, 24, KEEP>(a, warps, grid, smem, s);
  return launch_block<T, 32, KEEP>(a, warps, grid, smem, s);
}

template <typename T>
int launch(const Args<T>& a, int mode, int warps, int grid, cudaStream_t s) {
  int fits[4];
  fit((int)sizeof(T), mode, a.D, a.Tq, a.Tk, warps, a.stages, a.kc, fits);
  const int smem = fits[1];
  if (fits[0] == 0) return cudaErrorInvalidValue;
  if (mode == 0) {
    static const cudaError_t attr = allow(e1_warp_kernel<T>);
    if (attr != cudaSuccess) return attr;
    e1_warp_kernel<T><<<grid, 32 * warps, smem, s>>>(a);
    return cudaGetLastError();
  }
  if (grid != (long long)a.G * ((a.Tq + 16 * warps - 1) / (16 * warps)))
    return cudaErrorInvalidValue;
  return a.Tk <= kKeepKeys ? launch_width<T, true>(a, warps, grid, smem, s)
                           : launch_width<T, false>(a, warps, grid, smem, s);
}

}  // namespace

// q [G, Tq, D], k / v [G, Tk, D] in bf16 (bf16 = 1) or fp32 (bf16 = 0),
// read through the strides above (elements contiguous; k and v share
// theirs); o [G, Tq, D], m / l [G, Tq] fp32 contiguous, updated in place.
// Any Tq, Tk >= 1, D a multiple of 8 up to 256, scale > 0.  mode (0 warp,
// 1 block), warps, stages, kc (the block mode's keys a tile, 32 or 64) and
// grid: the host's plan (kernels/ring_attention.py e1_plan, chosen from
// vdn_ring_step_fit); the shared bytes follow from them (e1_layout.cuh).  A
// launch that e1_layout.cuh's fit does not take, or a block-mode grid
// other than one block a (row, q tile), returns cudaErrorInvalidValue.
extern "C" int vdn_ring_step(const void* q, const void* k, const void* v,
                             int bf16, int G, int Tq, int Tk, int D, int H,
                             long long qsb, long long qst, long long kvsb,
                             long long kvst, long long sh, float scale,
                             void* o, void* m, void* l, int mode, int warps,
                             int stages, int kc, int grid, void* stream) {
  if (G < 1 || Tq < 1 || Tk < 1 || D < 8 || D > kMaxD || D % 8 || H < 1 ||
      warps < 1 || grid < 1 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (bf16)
    return launch(Args<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(q),
                                      static_cast<const __nv_bfloat16*>(k),
                                      static_cast<const __nv_bfloat16*>(v),
                                      of, mf, lf, G, Tq, Tk, D, H, stages,
                                      kc, qsb, qst, kvsb, kvst, sh, scale},
                  mode, warps, grid, s);
  return launch(Args<float>{static_cast<const float*>(q),
                            static_cast<const float*>(k),
                            static_cast<const float*>(v), of, mf, lf, G, Tq,
                            Tk, D, H, stages, kc, qsb, qst, kvsb, kvst, sh,
                            scale},
                mode, warps, grid, s);
}
