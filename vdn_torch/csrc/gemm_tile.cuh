// One tiled bf16 GEMM for the port's fused blocks: out = epi(pro(A) @ W^T).
//
//   A   [M, K] bf16, row stride lda (a token matrix)
//   W   [N, K] bf16, K contiguous (a torch Linear weight)
//   pro A-operand prologue, applied to 8 consecutive elements of one row in
//       fp32 before they are rounded to bf16 into shared memory: identity
//       or + pe
//   epi epilogue functor, called with two adjacent fp32 accumulators of one
//       output row
//
// The products of A3 (temporal_attn.cu: vdn/ops/pallas/
// temporal_attention.py _kernel) and D4 (temporal_attn_bwd.cu: its
// backward, _fused_bwd_dx_impl); A2, D3 and A4 moved to the wgmma + TMA
// core (bf16_wgmma.cuh), which these are to follow.
// Bound on the H100 by tensor-core issue: the TPU kernels keep the whole
// weight matrix resident (8 MB for vitl's fc1), a Hopper block has 227 KB
// of shared memory, so the product is tiled instead -- 128x128 output
// tiles, K in 32-wide slices, eight warps of 64x32, mma.sync m16n8k16 with
// fp32 accumulators.  The next K slice is loaded into registers while the
// current one is multiplied (register double buffering over two shared
// tiles).  Consecutive blocks walk the N tiles of one row block, so A is
// read from device memory about once and W stays in the 50 MB L2.
// No wgmma/TMA yet: this is the simple, right version.
#pragma once

#include "common.cuh"

namespace vdn {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLds = kBK + 8;  // 80-byte rows: conflict-free fragment loads
constexpr int kGemmThreads = 256;

struct ProIdentity {
  static constexpr bool kIdentity = true;
  __device__ void operator()(int, int, float (&)[8]) const {}
};

// x + pe[t] for token-major rows m = token * T + t (the motion-module APE)
struct ProAddPe {
  static constexpr bool kIdentity = false;
  const __nv_bfloat16* pe;  // [T, K]
  int T;
  int K;
  __device__ void operator()(int m, int k, float (&v)[8]) const {
    const __nv_bfloat16* p = pe + (size_t)(m % T) * K + k;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += bf2f(p[i]);
  }
};

template <class Pro, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bf16_kernel(int M, int N, int K, const __nv_bfloat16* __restrict__ A,
                 int lda, const __nv_bfloat16* __restrict__ W, Pro pro,
                 Epi epi) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 Ws[2][kBN * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int nb = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int KT = K / kBK;

  // tile row r of the W tile -> weight row (or -1 beyond N)
  auto w_row = [&](int r) -> int { return nb + r < N ? nb + r : -1; };

  uint4 ra[2], rw[2];
  auto load = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int m = m0 + r;
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(A + (size_t)m * lda + k0 + kc)
                    : make_uint4(0, 0, 0, 0);
      const int wr = w_row(r);
      rw[i] = wr >= 0 ? *reinterpret_cast<const uint4*>(W + (size_t)wr * K + k0 + kc)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = c >> 2, kc = (c & 3) * 8;
      uint4 v = ra[i];
      if constexpr (!Pro::kIdentity) {
        if (m0 + r < M) {
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
          float f[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2 p = __bfloat1622float2(h[j]);
            f[2 * j] = p.x;
            f[2 * j + 1] = p.y;
          }
          pro(m0 + r, k0 + kc, f);
          uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) u[j] = pack_bf16(f[2 * j], f[2 * j + 1]);
        }
      }
      *reinterpret_cast<uint4*>(&As[buf][r * kLds + kc]) = v;
      *reinterpret_cast<uint4*>(&Ws[buf][r * kLds + kc]) = rw[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

  load(0);
  store(0, 0);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    const __nv_bfloat16* as = As[buf];
    const __nv_bfloat16* ws = Ws[buf];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&as[r * kLds + c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&as[(r + 8) * kLds + c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&as[r * kLds + c + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&as[(r + 8) * kLds + c + 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int r = wn * 32 + nj * 8 + g;
        bf[nj][0] = *reinterpret_cast<const uint32_t*>(&ws[r * kLds + c]);
        bf[nj][1] = *reinterpret_cast<const uint32_t*>(&ws[r * kLds + c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16_16816(acc[mi][nj], af[mi], bf[nj]);
    }
    if (kt + 1 < KT) store(buf ^ 1, kt + 1);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = nb + wn * 32 + nj * 8 + 2 * t;
        if (n < N) epi(m, n, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
  }
}

// Requires K % 32 == 0, N % 8 == 0, lda % 8 == 0 and 16-byte aligned
// pointers (checked by the Python wrappers).
template <class Pro, class Epi>
cudaError_t launch_gemm(int M, int N, int K, const __nv_bfloat16* A, int lda,
                        const __nv_bfloat16* W, Pro pro, Epi epi,
                        cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bf16_kernel<Pro, Epi><<<grid, kGemmThreads, 0, stream>>>(
      M, N, K, A, lda, W, pro, epi);
  return cudaGetLastError();
}

}  // namespace vdn
