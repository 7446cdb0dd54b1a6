// A6: the DPT output island, out = act(conv1x1(relu(conv3x3(W-resize(xh)))))
// with xh the H-resized feature [N, hp, W_in, C] bf16 (resize_rows into a
// zero-padded plan: row 0 and rows h_out + 1 .. hp - 1 are zeros) and out
// [N, h_out, w_out] fp32.  conv3x3 is C -> 32 with zero padding 1, conv1x1
// 32 -> 1, act ReLU or sigmoid * max_depth.
//
// Replaces vdn/ops/pallas/resize_island.py fused_resize_island (_kernel) at
// vitl 518: [32, 296, 296, 128] -> [32, 518, 518, 1].  The full-resolution
// 128-channel feature is never written to device memory.
//
// Bound on the H100 by the conv3x3: 2 * 32 * 518^2 * 9 * 128 * 32 = 0.63 TFLOP
// (0.64 ms at the bf16 tensor-core peak) against 1.3 GB of xh read (0.4 ms).
// The TPU kernel lane-packed 4 output columns into the 128-lane MXU with
// bucketed weights; Hopper's tensor cores take N = 32 as it is, so this is an
// implicit GEMM: M = output pixels, N = 32, K = 9 * C.  A block (8 warps)
// owns a band of 8 output rows of one image and walks it in tiles of 32
// columns:
//   1. all conv weights [32][9C] bf16 are staged in shared memory once per
//      block (74 KB at C 128);
//   2. per tile, the W-resized rows the tile's 3x3 windows need --
//      (8 + 2) rows x (32 + 2) columns x C -- are built in shared memory from
//      xh with the two-tap column plan: bf16 weights, fp32 sum, rounded to
//      bf16 (vdn's rounding); out-of-range columns are the conv's zero
//      padding;
//   3. warp w computes output row w of the band, 32 pixels x 32 channels,
//      with mma.sync m16n8k16 over the 9 taps x C/16 K-slices, A fragments
//      read straight out of the resized tile (the im2col is an address
//      offset), fp32 accumulators;
//   4. epilogue: + b1, ReLU, rounded to bf16 (vdn's rounding point), the
//      32-wide dot with w2 in fp32 across the quad of lanes, + b2, act.
// One block per SM (166 KB of shared memory); no overlap of the tile build
// with the MMAs yet.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTH = 8;   // output rows per block (one per warp)
constexpr int kTW = 32;  // output columns per tile
constexpr int kO = 32;   // conv3x3 output channels
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 1)
resize_island_kernel(const __nv_bfloat16* __restrict__ xh, int hp, int w_in,
                     int C, int h_out, int w_out,
                     const int* __restrict__ cidx,
                     const float* __restrict__ cw,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2p, int sigmoid,
                     float max_depth, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldb = 9 * C + 8;  // odd multiple of 4 words: conflict-free frags
  const int ldu = C + 8;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);  // [32][ldb]
  __nv_bfloat16* Us = Bs + kO * ldb;  // [(kTH+2) * (kTW+2)][ldu]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int y0 = blockIdx.x * kTH;
  const int n = blockIdx.y;
  const __nv_bfloat16* xn = xh + (size_t)n * hp * w_in * C;

  const int kchunks = 9 * C / 8;
  for (int i = tid; i < kO * kchunks; i += kThreads) {
    const int r = i / kchunks, k = (i % kchunks) * 8;
    *reinterpret_cast<uint4*>(&Bs[r * ldb + k]) =
        *reinterpret_cast<const uint4*>(&wt[(size_t)r * 9 * C + k]);
  }
  // this lane's epilogue channels: o = 8 * nj + 2t + e
  float eb1[4][2], ew2[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      eb1[nj][e] = b1[8 * nj + 2 * t + e];
      ew2[nj][e] = w2[8 * nj + 2 * t + e];
    }

  const float b2 = *b2p;
  const int cch = C / 8;
  const int u_items = (kTH + 2) * (kTW + 2) * cch;
  const int y = y0 + warp;
  for (int x0 = 0; x0 < w_out; x0 += kTW) {
    __syncthreads();  // the previous tile's MMAs are done with Us
#pragma unroll 4
    for (int i = tid; i < u_items; i += kThreads) {
      const int c = (i % cch) * 8;
      const int j = (i / cch) % (kTW + 2);
      const int r = i / (cch * (kTW + 2));
      const int xc = x0 - 1 + j;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (xc >= 0 && xc < w_out) {
        const __nv_bfloat16* row = xn + (size_t)(y0 + r) * w_in * C + c;
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(
            row + (size_t)cidx[2 * xc] * C));
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(
            row + (size_t)cidx[2 * xc + 1] * C));
        const float wa = cw[2 * xc], wb = cw[2 * xc + 1];
        const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b);
        uint32_t* vo = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 fa = __bfloat1622float2(ah[q]);
          const float2 fb = __bfloat1622float2(bh[q]);
          vo[q] = vdn::pack_bf16(
              __fadd_rn(__fmul_rn(wa, fa.x), __fmul_rn(wb, fb.x)),
              __fadd_rn(__fmul_rn(wa, fa.y), __fmul_rn(wb, fb.y)));
        }
      }
      *reinterpret_cast<uint4*>(&Us[(r * (kTW + 2) + j) * ldu + c]) = v;
    }
    __syncthreads();

    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const __nv_bfloat16* ub =
          Us + ((warp + dy) * (kTW + 2) + g + dx) * ldu + 2 * t;
      const __nv_bfloat16* bb = Bs + g * ldb + tap * C + 2 * t;
      for (int c0 = 0; c0 < C; c0 += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* u = ub + mi * 16 * ldu + c0;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(u);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(u + 8 * ldu);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(u + 8);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(u + 8 * ldu + 8);
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const __nv_bfloat16* b = bb + nj * 8 * ldb + c0;
          bf[nj][0] = *reinterpret_cast<const uint32_t*>(b);
          bf[nj][1] = *reinterpret_cast<const uint32_t*>(b + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            vdn::mma_bf16_16816(acc[mi][nj], af[mi], bf[nj]);
      }
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v =
                vdn::bf16r(fmaxf(acc[mi][nj][2 * h + e] + eb1[nj][e], 0.f));
            s += v * ew2[nj][e];
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const int x = x0 + mi * 16 + g + 8 * h;
        if (t == 0 && x < w_out && y < h_out) {
          const float z = s + b2;
          out[((size_t)n * h_out + y) * w_out + x] =
              sigmoid ? max_depth / (1.f + expf(-z)) : fmaxf(z, 0.f);
        }
      }
  }
}

}  // namespace

// xh [n, hp, w_in, c] bf16 with hp >= ceil(h_out / 8) * 8 + 2; cidx [w_out, 2]
// int32 and cw [w_out, 2] fp32 (values rounded to bf16) the column plan;
// wt [32, 9c] bf16 with wt[o][(dy * 3 + dx) * c + ci] = w1[dy, dx, ci, o];
// b1 [32], w2 [32], b2 [1] fp32 (w2 values rounded to bf16); out
// [n, h_out, w_out] fp32.  c a multiple of 16, at most 176.
extern "C" int vdn_resize_island(const void* xh, int n, int hp, int w_in,
                                 int c, int h_out, int w_out, const void* cidx,
                                 const void* cw, const void* wt,
                                 const void* b1, const void* w2, const void* b2,
                                 int sigmoid, float max_depth, void* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (h_out + kTH - 1) / kTH;
  if (c % 16 || c > 176 || hp < tiles * kTH + 2 || n > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)kO * (9 * c + 8) * 2 +
                      (size_t)(kTH + 2) * (kTW + 2) * (c + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      resize_island_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  resize_island_kernel<<<dim3(tiles, n), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(xh), hp, w_in, c, h_out, w_out,
      static_cast<const int*>(cidx), static_cast<const float*>(cw),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), sigmoid,
      max_depth,
      static_cast<float*>(out));
  return cudaGetLastError();
}
