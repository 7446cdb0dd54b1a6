// One tiled int8 GEMM for the W8A8 serving kernels F1, F2, F3 and F5 (F4
// runs on the wgmma + TMA core, int8_wgmma.cuh, which these adopt in turn):
//   out = epi( sum_j (float(A_j @ W_j^T) * rs[m, j]) * cs[n] )
//
//   A   [M, K] int8, row stride lda bytes (rows quantized by a row kernel)
//   W   [N, K] int8, K contiguous (a quantized torch Linear weight); in the
//       dual mode [2N, K], rows [0, N) the SwiGLU gate half and [N, 2N) the
//       value half
//   rs  fp32 row scales [M, kChunks]; K splits into kChunks equal chunks j,
//       each summed exactly in int32 and dequantized on its own
//   cs  fp32 column scales [N] (dual mode [2N]: the weight's
//       per-output-channel scales)
//   epi epilogue functor, called with two adjacent fp32 values of one
//       output row (dual mode: the gate pair and the value pair of the same
//       two output columns)
//
// Replaces the int8 MXU dots of vdn/ops/pallas/int8.py (_int8_dot inside
// _ln_linear_kernel, _linear_kernel, _proj_residual_kernel and
// _ln_swiglu_int8_kernel).  The TPU kernels keep the whole int8 weight in
// VMEM;
// a Hopper block has 227 KB, so the product is tiled as the bf16 template
// (gemm_tile.cuh) tiles it: 128 x 128 output tiles, K in 64-byte slices,
// eight warps of 64 x 32, mma.sync m16n8k32 s8 x s8 -> s32, the next slice
// loaded into registers while the current one is multiplied.  In bytes the
// shared tiles and fragments are the bf16 template's: a 32-bit register
// holds four int8 values of consecutive K where it held two bf16.  The
// int32 sums are exact, so the order of the K loop changes nothing; the
// dequantization keeps vdn's order, (acc * rs) * cs per chunk and the
// chunks added in order in fp32 (F5's w3: pj0 + pj1).
// Bound by tensor-core issue at the window's shapes (int8_wgmma.cuh is the
// wgmma + TMA form).
#pragma once

#include "common.cuh"

namespace vdn {

constexpr int kIBM = 128;
constexpr int kIBN = 128;
constexpr int kIBK = 64;          // bytes (int8 values) of K per slice
constexpr int kILds = kIBK + 16;  // 80-byte rows: conflict-free fragment loads
constexpr int kIGemmThreads = 256;

// D += A B for A 16x32 (row), B 32x8 (col) int8, D 16x8 int32.  Fragments
// (PTX ISA, "mma.m16n8k32" for .s8), g = lane / 4, t = lane % 4, each
// register four int8 of consecutive k:
//   a0 = A[g][4t..4t+3]     a1 = A[g+8][4t..4t+3]
//   a2 = A[g][4t+16..+19]   a3 = A[g+8][4t+16..+19]
//   b0 = B[4t..4t+3][g]     b1 = B[4t+16..4t+19][g]
//   d0,d1 = D[g][2t..2t+1]  d2,d3 = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (float(acc) * rs) * cs, each product rounded on its own (no FMA)
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), rs), cs);
}

template <int kChunks, bool kDual, class Epi>
__global__ void __launch_bounds__(kIGemmThreads)
gemm_s8_kernel(int M, int N, int K, const int8_t* __restrict__ A, int lda,
               const int8_t* __restrict__ W, const float* __restrict__ rs,
               const float* __restrict__ cs, Epi epi) {
  static_assert(!(kDual && kChunks > 1), "the dual mode dequantizes once");
  __shared__ __align__(16) int8_t As[2][kIBM * kILds];
  __shared__ __align__(16) int8_t Ws[2][kIBN * kILds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int n0 = blockIdx.x * (kDual ? kIBN / 2 : kIBN);
  const int m0 = blockIdx.y * kIBM;
  const int KT = K / kIBK;
  const int KC = KT / kChunks;  // slices per chunk

  // tile row r of the W tile -> weight row (or -1 beyond N).  The dual mode
  // interleaves 8-row groups of the two halves (as gemm_tile.cuh's), so a
  // warp's n8 tiles 2p and 2p+1 hold the gate and value columns of the
  // same 8 outputs.
  auto w_row = [&](int r) -> int {
    if constexpr (!kDual) {
      return n0 + r < N ? n0 + r : -1;
    } else {
      const int grp = r >> 3;
      const int idx = n0 + (grp >> 1) * 8 + (r & 7);
      if (idx >= N) return -1;
      return (grp & 1) ? N + idx : idx;
    }
  };

  uint4 ra[2], rw[2];
  auto load = [&](int kt) {
    const int k0 = kt * kIBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kIGemmThreads;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int m = m0 + r, wr = w_row(r);
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(A + (size_t)m * lda + k0 + kc)
                    : make_uint4(0, 0, 0, 0);
      rw[i] = wr >= 0 ? *reinterpret_cast<const uint4*>(W + (size_t)wr * K + k0 + kc)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kIGemmThreads;
      const int r = c >> 2, kc = (c & 3) * 16;
      *reinterpret_cast<uint4*>(&As[buf][r * kILds + kc]) = ra[i];
      *reinterpret_cast<uint4*>(&Ws[buf][r * kILds + kc]) = rw[i];
    }
  };

  int acc[4][4][4];
  float sum[kChunks > 1 ? 4 : 1][4][4];  // dequantized chunks (kChunks > 1)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0;

  // the output row / column of accumulator (mi, nj, q)
  auto row_of = [&](int mi, int q) { return m0 + wm * 64 + mi * 16 + g + (q >> 1) * 8; };
  auto col_of = [&](int nj, int q) { return n0 + wn * 32 + nj * 8 + 2 * t + (q & 1); };

  load(0);
  store(0);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    const int8_t* as = As[buf];
    const int8_t* ws = Ws[buf];
#pragma unroll
    for (int kk = 0; kk < kIBK / 32; ++kk) {
      const int c = kk * 32 + 4 * t;
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&as[r * kILds + c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&as[(r + 8) * kILds + c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&as[r * kILds + c + 16]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&as[(r + 8) * kILds + c + 16]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int r = wn * 32 + nj * 8 + g;
        bf[nj][0] = *reinterpret_cast<const uint32_t*>(&ws[r * kILds + c]);
        bf[nj][1] = *reinterpret_cast<const uint32_t*>(&ws[r * kILds + c + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_s8_16832(acc[mi][nj], af[mi], bf[nj]);
    }
    if (kt + 1 < KT) store(buf ^ 1);
    __syncthreads();
    if constexpr (kChunks > 1) {
      if ((kt + 1) % KC == 0) {  // chunk j ends: dequantize, restart the sums
        const int j = (kt + 1) / KC - 1;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = row_of(mi, q), n = col_of(nj, q);
              const float pj = m < M && n < N
                                   ? dequant(acc[mi][nj][q], rs[(size_t)m * kChunks + j], cs[n])
                                   : 0.f;
              sum[mi][nj][q] = j == 0 ? pj : __fadd_rn(sum[mi][nj][q], pj);
              acc[mi][nj][q] = 0;
            }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row_of(mi, 2 * h);
      if (m >= M) continue;
      if constexpr (kDual) {
        const float r = rs[m];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int n = n0 + wn * 16 + p * 8 + 2 * t;
          if (n >= N) continue;
          const int* a = acc[mi][2 * p];
          const int* v = acc[mi][2 * p + 1];
          epi(m, n, dequant(a[2 * h], r, cs[n]),
              dequant(a[2 * h + 1], r, cs[n + 1]),
              dequant(v[2 * h], r, cs[N + n]),
              dequant(v[2 * h + 1], r, cs[N + n + 1]));
        }
      } else {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int n = col_of(nj, 0);
          if (n >= N) continue;
          if constexpr (kChunks > 1) {
            epi(m, n, sum[mi][nj][2 * h], sum[mi][nj][2 * h + 1]);
          } else {
            const float r = rs[m];
            epi(m, n, dequant(acc[mi][nj][2 * h], r, cs[n]),
                dequant(acc[mi][nj][2 * h + 1], r, cs[n + 1]));
          }
        }
      }
    }
  }
}

// Requires K % (64 * kChunks) == 0, N % 8 == 0, lda % 16 == 0 and 16-byte
// aligned pointers (checked by the Python wrappers).  N is the number of
// output columns; in the dual mode W and cs hold 2N rows.
template <int kChunks, bool kDual = false, class Epi>
cudaError_t launch_gemm_s8(int M, int N, int K, const int8_t* A, int lda,
                           const int8_t* W, const float* rs, const float* cs,
                           Epi epi, cudaStream_t stream) {
  const int ntile = kDual ? kIBN / 2 : kIBN;
  dim3 grid((N + ntile - 1) / ntile, (M + kIBM - 1) / kIBM);
  gemm_s8_kernel<kChunks, kDual, Epi><<<grid, kIGemmThreads, 0, stream>>>(
      M, N, K, A, lda, W, rs, cs, epi);
  return cudaGetLastError();
}

// res + bf16(((v + b) * gamma)) in bf16, the epilogue of F3, F4 and F5:
// LayerScale and the block residual (int8.py:201-215, :331-332).  res
// [M, ld] bf16 may not alias out.
struct EpiI8Residual {
  const float* b;
  const float* gamma;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const size_t i = (size_t)m * ld + n;
    const float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(res + i));
    const float o0 = __fmul_rn(__fadd_rn(v0, b[n]), gamma[n]);
    const float o1 = __fmul_rn(__fadd_rn(v1, b[n + 1]), gamma[n + 1]);
    *reinterpret_cast<uint32_t*>(out + i) =
        pack_bf16(r.x + bf16r(o0), r.y + bf16r(o1));
  }
};

// Eight consecutive elements of a bf16 or fp32 row, as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Row quantizer: per row of x [M, C], optionally vdn's fp32 LayerNorm
// ((x - mean) * rsqrt(var + eps)) * w + b (two-pass statistics), then per
// segment of C / nseg values: s = max(amax / 127, 1e-30) and
// q = round_half_even(y * (1 / s)), written as int8 q [M, C] and fp32
// s [M, nseg].  One warp per row, 8 values per lane per step; the row is
// read from device memory once and again from L1 / L2 by the later passes.
// Requires C % (8 * nseg) == 0 and 16-byte aligned rows.
template <typename T, bool kLn>
__global__ void quant_rows_kernel(const T* __restrict__ x, int M, int C,
                                  int nseg, const float* __restrict__ ln_w,
                                  const float* __restrict__ ln_b, float eps,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ s) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  float mu = 0.f, rstd = 1.f;
  if constexpr (kLn) {
    float acc = 0.f;
    for (int k = lane * 8; k < C; k += 256) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += v[j];
    }
    mu = warp_sum(acc) / C;
    acc = 0.f;
    for (int k = lane * 8; k < C; k += 256) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += (v[j] - mu) * (v[j] - mu);
    }
    rstd = 1.f / sqrtf(warp_sum(acc) / C + eps);
  }
  auto value = [&](int k, float (&v)[8]) {
    load8(xr + k, v);
    if constexpr (kLn) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[j] - mu, rstd), ln_w[k + j]),
                         ln_b[k + j]);
    }
  };
  const int L = C / nseg;
  for (int seg = 0; seg < nseg; ++seg) {
    const int k0 = seg * L;
    float amax = 0.f;
    for (int k = k0 + lane * 8; k < k0 + L; k += 256) {
      float v[8];
      value(k, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    const float sc = fmaxf(warp_max(amax) / 127.f, 1e-30f);
    const float inv = 1.f / sc;
    for (int k = k0 + lane * 8; k < k0 + L; k += 256) {
      float v[8];
      value(k, v);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = __float2int_rn(__fmul_rn(v[j], inv));
        w[j >> 2] |= (uint32_t)(qi & 0xff) << (8 * (j & 3));
      }
      *reinterpret_cast<uint2*>(q + (size_t)row * C + k) = make_uint2(w[0], w[1]);
    }
    if (lane == 0) s[(size_t)row * nseg + seg] = sc;
  }
}

template <typename T, bool kLn>
cudaError_t launch_quant_rows(const T* x, int M, int C, int nseg,
                              const float* ln_w, const float* ln_b, float eps,
                              int8_t* q, float* s, cudaStream_t stream) {
  const int rows_per_block = 8;
  quant_rows_kernel<T, kLn><<<(M + rows_per_block - 1) / rows_per_block,
                              32 * rows_per_block, 0, stream>>>(
      x, M, C, nseg, ln_w, ln_b, eps, q, s);
  return cudaGetLastError();
}

}  // namespace vdn
