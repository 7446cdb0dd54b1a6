// A6: the DPT output island, out = act(conv1x1(relu(conv3x3(resize(feat)))))
// with feat [N, h_in, w_in, C] bf16 and out [N, h_out, w_out] fp32: the
// align-corners bilinear resize to h_out x w_out, conv3x3 C -> 32 with zero
// padding 1, ReLU, conv1x1 32 -> 1, act ReLU or sigmoid * max_depth.
//
// Replaces vdn/ops/pallas/resize_island.py fused_resize_island (_kernel and
// the H pass before it, _padded_h_resize) at vitl 518: [32, 296, 296, 128]
// -> [32, 518, 518, 1], and at vitg 518 with C = 192.  Neither the resized
// C-channel feature nor its H-resized half is written to device memory.
//
// Bound on the H100 by the conv3x3 on the tensor cores: 2 * 32 * 518^2 * 9
// * 128 * 32 = 0.63 TFLOP at the window (0.64 ms at the bf16 peak) against
// 0.72 GB of feat read once (0.21 ms).  The TPU kernel took the H pass as a
// launch of its own, then lane-packed four output columns into the 128-lane
// MXU with bucketed weights; here it is an implicit GEMM on wgmma fed by
// producers that build the resized rows themselves:
//   - persistent blocks (the Python plan's grid, one per SM) walk the work
//     items (frame, run of output rows, strip of 64 output columns), strip
//     fastest (kernels/resize_island.py island_plan); the last strip of a
//     row is shifted to end at w_out and stores only the columns the strip
//     before it did not;
//   - the conv weights come in once per block by the bulk-copy engine (74
//     KB at C 128, 111 KB at C 192) and serve every item, laid out as
//     wgmma's K-major B operand per dx: [C / 8][96][8], the 96 rows the
//     three dy blocks of 32 outputs;
//   - two producer warpgroups build one resized row (66 columns: the strip
//     and a column of halo each side) per step, walking down the strip:
//     the H pass, two taps of feat's rows in fp32 rounded to bf16
//     (resize_rows' arithmetic on the rows_plan taps), into a staging row
//     of the strip's source columns in shared memory (two in turn, one
//     barrier a pass); then the W pass, the two bf16-rounded column taps
//     in fp32, rounded, into a ring of resized rows (columns and rows
//     outside the image are the conv's zero padding).  Each producer
//     thread takes the same H and W items in every pass (their offsets and
//     its W items' taps in registers), so it loads the next pass's source
//     chunks into registers before the W pass and their latency hides
//     under it, and keeps a source row the next output row reads again.
//     Above C 192 the channels go through the staging rows in groups;
//   - a ring row is laid out no-swizzle K-major, [C / 8][66][8] (16 bytes a
//     pixel per 8 channels), so the A operand read from column dx is the
//     descriptor at that column: the im2col is an address.  The producers
//     store with st.shared, fence to the async proxy and arrive on the
//     row's full mbarrier;
//   - one consumer warpgroup takes every ring row once: wgmma m64n96k16
//     over the three dx and C / 16 channel steps gives, in accumulator
//     block dy, that row's part of output row (row - dy); a thread holds
//     the same pixels in every block, so output row j is summed in
//     registers, (block 0 of row j + block 1 of row j + 1) + block 2 of
//     row j + 2, and the ring row is freed as soon as its products end;
//     a finished row's epilogue runs under the next row's products.
//     (One m64n32k16 a tap, 9 C / 16 of them an output row, ran the conv
//     1.6x slower on the card: PERF.md section 6, tools/a6_variants.py);
//   - epilogue in the accumulator layout (mma.sync's): + b1, ReLU, rounded
//     to bf16 (vdn's rounding point), the 32-wide dot with w2 in fp32
//     across the quad of lanes, + b2, act, one fp32 store a pixel.
// Each output pixel's sums run in the same order whatever the plan, so two
// launches give the same bits.
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace vdn::wg;

constexpr int kO = 32;             // conv3x3 output channels
constexpr int kN = 3 * kO;         // wgmma N: the three dy blocks of a dx
constexpr int kStrip = 64;         // output columns of an item: wgmma M
constexpr int kCols = kStrip + 2;  // resized columns a ring row holds
constexpr int kThreads = 384;      // consumer: warpgroup 0
constexpr int kProducers = 256;    // producers: warpgroups 1, 2
constexpr int kConsumers = 128;    // arrivals that free a ring row
constexpr int kHMax = 4;           // H items a producer thread takes a pass
constexpr int kWMax = 7;           // W items (66 x 24 chunks at C 192)
constexpr int kProd = 1;           // named barrier of the producers
constexpr int kMaxRing = 6;        // resized rows the ring holds at most
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use

struct Args {
  const __nv_bfloat16* feat;
  int n, h_in, w_in, c, h_out, w_out;
  // itab: H taps [h_out][2], W taps [w_out][2] (a zero-weight tap names
  // its row's first column), then per strip (x0, first source column);
  // ftab: H weights [h_out][2], W weights [w_out][2] (bf16 values)
  const int* itab;
  const float* ftab;
  int strips, runs, run_rows, src_cols, cg, ring;
  const __nv_bfloat16* wt;  // [3 dx][C / 8][3 dy * 32][8]
  const float* b1;
  const float* w2;
  const float* b2;
  int sigmoid;
  float max_depth;
  float* out;
};

// byte offsets (from the weights at 0) of the ring, the two staging rows
// and the barriers
struct Layout {
  uint32_t ring, hrow, bars, total;
};
__host__ __device__ inline Layout layout(int c, int src_cols, int cg,
                                         int ring) {
  Layout l;
  l.ring = 9u * c * kO * 2;
  l.hrow = l.ring + (uint32_t)ring * c * kCols * 2;
  l.bars = l.hrow + 2u * src_cols * (cg + 8) * 2;
  l.total = l.bars + (2 * ring + 1) * 8;
  return l;
}

// (ring rows, channels a staging pass) for C channels and src_cols source
// columns a strip: the fewest channel groups (a pass's H and W items
// within the producers' kHMax and kWMax a thread) that leave the block a
// ring of three resized rows, the ring then as deep as the shared memory
// allows (up to kMaxRing); a ring of two (one row being read, one being
// built) where three never fit.  One group keeps the source rows that the
// next output row reads again in the producers' registers.  False where
// not even two fit.
bool pick_ring(int c, int src_cols, int* ring, int* cg) {
  int best_ring = 0, best_cg = 0;
  for (int groups = 1; c % (8 * groups) == 0; groups *= 2) {
    const int g = c / groups;
    if (src_cols * (g / 8) > kHMax * kProducers ||
        kCols * (g / 8) > kWMax * kProducers)
      continue;
    const long room =
        (long)kMaxSmem - 128 - (long)layout(c, src_cols, g, 0).total;
    const long fit = room / ((long)c * kCols * 2 + 16);
    const int r = fit < kMaxRing ? (int)fit : kMaxRing;
    if (r >= 3) {
      *ring = r;
      *cg = g;
      return true;
    }
    if (r > best_ring) {
      best_ring = r;
      best_cg = g;
    }
  }
  *ring = best_ring;
  *cg = best_cg;
  return best_ring >= 2;
}

// no-swizzle wgmma descriptor: core matrices of 8 rows x 16 bytes, lbo
// bytes apart along K, sbo bytes apart along M / N
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

#define VDN_D16(d, o)                                                      \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),               \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),       \
      "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),     \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15])

// D (+)= A B, 64 x 96 x 16 bf16 -> fp32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : VDN_D16(d, 0), VDN_D16(d, 16), VDN_D16(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t at) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at));
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t at, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(at), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// (frame, first output row, rows, strip) of item ``it``
struct Item {
  int n, y0, rows, s;
};
__device__ __forceinline__ Item item_of(const Args& a, int it) {
  Item r;
  r.s = it % a.strips;
  const int run = (it / a.strips) % a.runs;
  r.n = it / (a.strips * a.runs);
  r.y0 = run * a.run_rows;
  r.rows = min(a.run_rows, a.h_out - r.y0);
  return r;
}

// Producers: one resized row after another into the ring (the rows of an
// item: its run's rows and one more above and below).  Each thread takes
// the same H items of every pass (a pass: one channel group of one row),
// so the next pass's source chunks are loaded into registers before this
// pass's W pass runs (their latency hides under it), and with one channel
// group a source row that the next output row reads again stays in its
// registers: rows (a, b) -> (a, b) loads nothing, (a, b) -> (b, b') only
// b' (the upsample's usual steps).
__device__ void produce(const Args& a, uint32_t ring_s, uint32_t hrow_s,
                        uint64_t* full, uint64_t* empty) {
  const int C = a.c, pt = threadIdx.x - (kThreads - kProducers);
  const uint32_t slot_bytes = (uint32_t)C * kCols * 2;
  const uint32_t hstride = (a.cg + 8) * 2;  // bytes a staged column
  const int nch = a.cg / 8;                 // 16-byte chunks of a group
  const int hitems = a.src_cols * nch;      // H items a pass
  const uint32_t hbytes = a.src_cols * hstride;  // a staging row
  int hpar = 0;                             // the staging row in use
  const int* wtab = a.itab + 2 * a.h_out;
  const float* wwt = a.ftab + 2 * a.h_out;
  const int items = a.n * a.strips * a.runs;
  uint4 va[kHMax], vb[kHMax];  // the next pass's two taps of each H item
  // this thread's H items, the same in every pass: item u is staged column
  // j = q / nch, chunk k = q % nch of q = pt + u * kProducers; its offset
  // in a source row (elements) and in the staging row (bytes), -1 past
  // the pass's items
  int h_src[kHMax], h_dst[kHMax];
#pragma unroll
  for (int u = 0; u < kHMax; ++u) {
    const int q = pt + u * kProducers;
    h_src[u] = q < hitems ? (q / nch) * C + 8 * (q % nch) : -1;
    h_dst[u] = (q / nch) * hstride + 16 * (q % nch);
  }
  // and its W items (q = pt + u * kProducers < 66 nch: pixel x = q % 66,
  // chunk k = q / 66): x | k << 8 (-1 past the pass's items); per item,
  // x's two column taps (staged columns ca + 1 | cb << 16, 0 outside the
  // image, and their weights, bf16 values, as a bf16 pair)
  int w_xk[kWMax], w_c[kWMax];
  uint32_t w_w[kWMax];
#pragma unroll
  for (int u = 0; u < kWMax; ++u) {
    const int q = pt + u * kProducers;
    w_xk[u] = q < kCols * nch ? (q % kCols) | (q / kCols) << 8 : -1;
  }
  // issue the loads of a pass's source rows (frame n, columns from s0,
  // channels from c0): ra into va where ``which`` & 1, rb into vb where & 2
  auto load = [&](int n, int s0, int ra, int rb, int c0, int which) {
    const size_t row = (size_t)a.w_in * C;
    const __nv_bfloat16* fa =
        a.feat + ((size_t)n * a.h_in + ra) * row + (size_t)s0 * C + c0;
    const __nv_bfloat16* fb =
        a.feat + ((size_t)n * a.h_in + rb) * row + (size_t)s0 * C + c0;
#pragma unroll
    for (int u = 0; u < kHMax; ++u) {
      if (h_src[u] >= 0) {
        if (which & 1)
          va[u] = __ldg(reinterpret_cast<const uint4*>(fa + h_src[u]));
        if (which & 2)
          vb[u] = __ldg(reinterpret_cast<const uint4*>(fb + h_src[u]));
      }
    }
  };
  uint32_t g = 0;  // the block's resized rows so far
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item m = item_of(a, it);
    const int x0 = wtab[2 * a.w_out + 2 * m.s];
    const int s0 = wtab[2 * a.w_out + 2 * m.s + 1];
    // this thread's W items' column taps in the strip (see w_c, w_w)
#pragma unroll
    for (int u = 0; u < kWMax; ++u) {
      const int xc = x0 - 1 + (w_xk[u] & 0xFF);
      const bool in = w_xk[u] >= 0 && xc >= 0 && xc < a.w_out;
      w_c[u] = in ? (wtab[2 * xc] - s0 + 1) | (wtab[2 * xc + 1] - s0) << 16
                  : 0;
      w_w[u] = in ? vdn::pack_bf16(wwt[2 * xc], wwt[2 * xc + 1]) : 0u;
    }
    // the item's first real pass
    int ra = a.itab[2 * max(m.y0 - 1, 0)], rb = a.itab[2 * max(m.y0 - 1, 0) + 1];
    load(m.n, s0, ra, rb, 0, 3);
    for (int i = 0; i < m.rows + 2; ++i, ++g) {
      const int slot = g % a.ring;
      mbar_wait(smem_u32(&empty[slot]), ((g / a.ring) & 1) ^ 1);
      const uint32_t sb = ring_s + slot * slot_bytes;
      const int ys = m.y0 - 1 + i;
      if (ys < 0 || ys >= a.h_out) {
        for (int q = pt; q < C / 8 * kCols; q += kProducers)
          st_shared_v4(sb + 16 * q, make_uint4(0, 0, 0, 0));
      } else {
        const float ha = a.ftab[2 * ys], hb = a.ftab[2 * ys + 1];
        for (int c0 = 0; c0 < C; c0 += a.cg) {
          // the staging row of this pass (two in turn: a thread may build
          // the next pass's while another still reads this one's; the
          // barrier between a pass's H and W passes orders both)
          const uint32_t hrow = hrow_s + hpar * hbytes;
          // H pass: the strip's source columns of this output row, taps in
          // order, zero-weight taps skipped (resize_rows' sums)
#pragma unroll
          for (int u = 0; u < kHMax; ++u) {
            if (h_src[u] < 0) break;
            // the first tap's product is the sum so far (as in the plain
            // version; a zero-weight first tap leaves zeros)
            float acc[8], f[8];
            unpack8(va[u], f);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[e] = ha != 0.f ? __fmul_rn(f[e], ha) : 0.f;
            if (hb != 0.f) {
              unpack8(vb[u], f);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[e] = __fadd_rn(acc[e], __fmul_rn(f[e], hb));
            }
            st_shared_v4(hrow + h_dst[u],
                         make_uint4(vdn::pack_bf16(acc[0], acc[1]),
                                    vdn::pack_bf16(acc[2], acc[3]),
                                    vdn::pack_bf16(acc[4], acc[5]),
                                    vdn::pack_bf16(acc[6], acc[7])));
          }
          named_sync(kProd, kProducers);
          // the next pass's loads, under this W pass
          if (c0 + a.cg < C) {
            load(m.n, s0, ra, rb, c0 + a.cg, 3);
          } else if (i < m.rows + 1 && ys + 1 < a.h_out) {
            const int na = a.itab[2 * ys + 2], nb = a.itab[2 * ys + 3];
            if (a.cg < C || (na != ra && na != rb)) {
              load(m.n, s0, na, nb, 0, 3);
            } else if (na == rb && nb != rb) {
#pragma unroll
              for (int u = 0; u < kHMax; ++u) va[u] = vb[u];
              load(m.n, s0, na, nb, 0, 2);
            } else if (na != ra || nb != rb) {
              load(m.n, s0, na, nb, 0, (na != ra) | (nb != rb) << 1);
            }
            ra = na;
            rb = nb;
          }
          // W pass: the two column taps, neighbouring threads on
          // neighbouring pixels of one 8-channel chunk
          const uint32_t ring_g = sb + c0 / 8 * kCols * 16;
#pragma unroll
          for (int u = 0; u < kWMax; ++u) {
            if (w_xk[u] < 0) break;
            const int x = w_xk[u] & 0xFF, k = w_xk[u] >> 8;
            const int ca = (w_c[u] & 0xFFFF) - 1, cb = w_c[u] >> 16;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (ca >= 0) {
              const float wa = __uint_as_float(w_w[u] << 16);
              const float wb = __uint_as_float(w_w[u] & 0xFFFF0000u);
              float fa8[8], fb8[8];
              unpack8(ld_shared_v4(hrow + ca * hstride + 16 * k), fa8);
              unpack8(ld_shared_v4(hrow + cb * hstride + 16 * k), fb8);
              // bf16 weights times bf16 values are exact in fp32, so one
              // FMA rounds as the sum of the two products does
              float r[8];
#pragma unroll
              for (int e = 0; e < 8; ++e)
                r[e] = __fmaf_rn(wa, fa8[e], __fmul_rn(wb, fb8[e]));
              v = make_uint4(vdn::pack_bf16(r[0], r[1]),
                             vdn::pack_bf16(r[2], r[3]),
                             vdn::pack_bf16(r[4], r[5]),
                             vdn::pack_bf16(r[6], r[7]));
            }
            st_shared_v4(ring_g + (k * kCols + x) * 16, v);
          }
          hpar ^= 1;
        }
      }
      fence_async_shared();
      mbar_arrive(smem_u32(&full[slot]));
    }
  }
}

// The consumer warpgroup: every resized row of the block in turn.  Step i
// of an item multiplies ring row i (resized image row y0 - 1 + i), read
// from column dx, by the dx block of the weights, [W(0, dx) | W(1, dx) |
// W(2, dx)] (N = 96), summed over dx and the channels: accumulator block
// dy holds that row's part of output row i - dy.  Output row j is
// (step j's block 0 + step j + 1's block 1) + step j + 2's block 2, all
// in the same registers of the same thread (the rows of an accumulator
// are pixels), folded into q1 / q2 / the finished row v after each step;
// v's epilogue then runs while the next step's products do.
struct Pending {  // a finished output row waiting for its epilogue
  int n, y, x0, x_lo;
};

__device__ __forceinline__ void epilogue(const Args& a, const float (&v)[16],
                                         const Pending& p,
                                         const float (&eb1)[4][2],
                                         const float (&ew2)[4][2], float b2,
                                         int warp, int lane) {
  const int q4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = vdn::bf16r(
            fmaxf(v[4 * nj + 2 * h + e] + eb1[nj][e], 0.f));
        s += x * ew2[nj][e];
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int x = p.x0 + 16 * warp + (lane >> 2) + 8 * h;
    if (q4 == 0 && x >= p.x_lo && x < a.w_out) {
      const float z = s + b2;
      a.out[((size_t)p.n * a.h_out + p.y) * a.w_out + x] =
          a.sigmoid ? a.max_depth / (1.f + expf(-z)) : fmaxf(z, 0.f);
    }
  }
}

__device__ void consume(const Args& a, uint32_t w_s, uint32_t ring_s,
                        uint64_t* full, uint64_t* empty, uint64_t* wbar) {
  const int C = a.c, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, q4 = lane & 3;
  const uint32_t slot_bytes = (uint32_t)C * kCols * 2;
  const uint32_t dx_bytes = (uint32_t)C / 8 * kN * 16;  // a dx block of B
  const int ksteps = C / 16;
  // this lane's epilogue channels: o = 8 * nj + 2 q4 + e
  float eb1[4][2], ew2[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      eb1[nj][e] = a.b1[8 * nj + 2 * q4 + e];
      ew2[nj][e] = vdn::bf16r(a.w2[8 * nj + 2 * q4 + e]);
    }
  const float b2 = *a.b2;
  const int items = a.n * a.strips * a.runs;
  const uint64_t db0 = desc_plain(w_s, kN * 16, 128);
  mbar_wait(smem_u32(wbar), 0);
  float acc[48], q1[16], q2[16], v[16];  // q1, q2: output rows i - 1, i - 2
#pragma unroll
  for (int k = 0; k < 48; ++k) acc[k] = 0.f;
  Pending pend;
  bool pending = false;
  uint32_t g = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item m = item_of(a, it);
    const int x0 = a.itab[2 * (a.h_out + a.w_out) + 2 * m.s];
    for (int i = 0; i < m.rows + 2; ++i, ++g) {
      const int slot = g % a.ring;
      mbar_wait(smem_u32(&full[slot]), (g / a.ring) & 1);
      const uint64_t da0 =
          desc_plain(ring_s + slot * slot_bytes, kCols * 16, 128);
      wgmma_fence();
#pragma unroll 1
      for (int ks = 0; ks < ksteps; ++ks) {
        uint64_t da[3], db[3];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          da[dx] = da0 + ((dx * 16 + ks * 2 * kCols * 16) >> 4);
          db[dx] = db0 + ((dx * dx_bytes + ks * 2 * kN * 16) >> 4);
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          wgmma_n96(acc, da[dx], db[dx], ks | dx);
        wgmma_commit();
      }
      // the previous row's epilogue under this row's products
      if (pending) {
        epilogue(a, v, pend, eb1, ew2, b2, warp, lane);
        pending = false;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(smem_u32(&empty[slot]));
      if (i >= 2) {  // output row i - 2 of the item is whole
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = q2[k] + acc[32 + k];
        pend = {m.n, m.y0 + i - 2, x0, m.s * kStrip};
        pending = true;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        q2[k] = q1[k] + acc[16 + k];
        q1[k] = acc[k];
      }
    }
  }
  if (pending) epilogue(a, v, pend, eb1, ew2, b2, warp, lane);
}

__global__ void __launch_bounds__(kThreads, 1) island_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  const Layout l = layout(a.c, a.src_cols, a.cg, a.ring);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem_raw + (base - raw) + l.bars);
  uint64_t* empty = full + a.ring;
  uint64_t* wbar = empty + a.ring;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ring; ++s) {
      mbar_init(smem_u32(&full[s]), kProducers);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_init(smem_u32(wbar), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kThreads - kProducers) {
    if (threadIdx.x == kThreads - kProducers) {
      // the weights, once per block
      const uint32_t bytes = l.ring;
      mbar_expect_tx(smem_u32(wbar), bytes);
      for (uint32_t off = 0; off < bytes; off += 16384)
        bulk_load(base + off, reinterpret_cast<const uint8_t*>(a.wt) + off,
                  min(16384u, bytes - off), smem_u32(wbar));
    }
    produce(a, base + l.ring, base + l.hrow, full, empty);
  } else {
    consume(a, base, base + l.ring, full, empty, wbar);
  }
}

}  // namespace

// feat [n, h_in, w_in, c] bf16; itab / ftab the plan's tables (see Args)
// for ``strips`` strips and ``runs`` runs of ``run_rows`` rows
// (kernels/resize_island.py island_plan), ``src_cols`` source columns a
// strip (the ring and the channel groups are chosen here, pick_ring); wt [3][c / 8][96][8] bf16
// with wt[dx][ci / 8][dy * 32 + o][ci % 8] = w1[dy, dx, ci, o]; b1 [32],
// w2 [32] (rounded to bf16 here), b2 [1] fp32; out
// [n, h_out, w_out] fp32; grid the persistent blocks.  c a multiple of 16.
extern "C" int vdn_resize_island(const void* feat, int n, int h_in, int w_in,
                                 int c, int h_out, int w_out,
                                 const void* itab, const void* ftab,
                                 int strips, int runs, int run_rows,
                                 int src_cols, const void* wt, const void* b1,
                                 const void* w2, const void* b2, int sigmoid,
                                 float max_depth, void* out, int grid,
                                 void* stream) {
  int ring, cg;
  if (c % 16 || grid < 1 || strips < 1 || runs < 1 || run_rows < 1 ||
      src_cols < 1 || src_cols > w_in || (runs - 1) * run_rows >= h_out ||
      !pick_ring(c, src_cols, &ring, &cg))
    return cudaErrorInvalidValue;
  const size_t smem = layout(c, src_cols, cg, ring).total + 128;
  static const cudaError_t attr = cudaFuncSetAttribute(
      island_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (attr != cudaSuccess) return attr;
  Args a;
  a.feat = static_cast<const __nv_bfloat16*>(feat);
  a.n = n;
  a.h_in = h_in;
  a.w_in = w_in;
  a.c = c;
  a.h_out = h_out;
  a.w_out = w_out;
  a.itab = static_cast<const int*>(itab);
  a.ftab = static_cast<const float*>(ftab);
  a.strips = strips;
  a.runs = runs;
  a.run_rows = run_rows;
  a.src_cols = src_cols;
  a.cg = cg;
  a.ring = ring;
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.sigmoid = sigmoid;
  a.max_depth = max_depth;
  a.out = static_cast<float*>(out);
  island_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}
