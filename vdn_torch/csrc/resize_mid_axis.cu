// A5b and B1: row mixing along the middle axis, out[n, s, m] =
// sum_r W[s, r] * x[n, r, m], x [N, R, M] -> [N, S, M], W [S, R] in x's dtype.
//
// Replaces vdn/ops/pallas/resize.py _resize_kernel, reached through
// resize_mid_axis (A5b: the W axis of the DPT fusion upsamples at C 256 and of
// the pos-embed bicubic at C 1024 fp32, W a host-built interpolation matrix)
// and select_rows (B1: the streaming K/V window gather, W a runtime one-hot
// [31, 43] slab against rings [N, 43, M] with M 128 or 256).
//
// Bound on the H100 by device memory.  The TPU kernel ran W as a dense
// [128, R] slab on the MXU; the interpolation matrices have 2-4 nonzeros a
// row and the one-hot slab one, so the dense product would do 50-150 times
// the needed work.  Here each block first compacts the nonzeros of its TS
// rows of W into shared memory (one warp a row, ballot + popc), so the
// kernel still computes the general [S, R] product -- B1's slab is only
// known on the device -- but spends work only on nonzero weights.  The block
// then walks TN (<= 8) consecutive n: a thread covers 16 bytes of one output
// row (8 bf16 or 4 fp32), loads those 16 bytes of each source row, and sums
// in fp32 in ascending r, rounding once.  With bf16 operands every product is
// exact in fp32, so two-tap sums are bit-exact in any order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTN = 8;        // n per block, at most
constexpr int kWantBlocks = 1024;  // enough to fill 132 SMs several times

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mid_axis_kernel(const T* __restrict__ x, int N, int R, int M, int S, int TS,
                int TN, const T* __restrict__ wts, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* nnz = reinterpret_cast<int*>(smem);       // [TS]
  int* cols = nnz + TS;                          // [TS][R]
  float* vals = reinterpret_cast<float*>(cols + TS * R);  // [TS][R]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = blockIdx.y * TS;
  for (int i = warp; i < TS; i += kThreads / 32) {
    int count = 0;
    if (s0 + i < S) {
      const T* wrow = wts + (size_t)(s0 + i) * R;
      for (int r0 = 0; r0 < R; r0 += 32) {
        const int r = r0 + lane;
        const float v = r < R ? vdn::to_f(wrow[r]) : 0.f;
        const unsigned mask = __ballot_sync(0xffffffffu, v != 0.f);
        if (v != 0.f) {
          const int pos = count + __popc(mask & ((1u << lane) - 1u));
          cols[i * R + pos] = r;
          vals[i * R + pos] = v;
        }
        count += __popc(mask);
      }
    }
    if (lane == 0) nnz[i] = count;
  }
  __syncthreads();

  const int mv = M / VEC;  // 16-byte chunks of a row
  const int items = TS * mv;
  const int n0 = (int)blockIdx.x * TN;
  const int n_end = min(N, n0 + TN);
  for (int n = n0; n < n_end; ++n) {
    const T* xn = x + (size_t)n * R * M;
    T* on = out + (size_t)n * S * M;
    for (int it = tid; it < items; it += kThreads) {
      const int sl = it / mv, m = (it % mv) * VEC;
      if (s0 + sl >= S) continue;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      const int cnt = nnz[sl];
      for (int j = 0; j < cnt; ++j) {
        const float wv = vals[sl * R + j];
        float v[VEC];
        vdn::load_vec<T, VEC>(xn + (size_t)cols[sl * R + j] * M + m, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += wv * v[i];
      }
      vdn::store_vec<T, VEC>(on + (size_t)(s0 + sl) * M + m, acc);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_mid(const void* x, int n, int r, int m, int s,
                       const void* w, void* out, cudaStream_t st) {
  // rows of W per block: as many as fit 48 KB of compacted (col, val) pairs
  const int budget = 48 * 1024;
  int ts = (budget - 16 * (int)sizeof(int)) / (r * 8);
  ts = ts > 16 ? 16 : ts;
  if (ts < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)ts * sizeof(int) + (size_t)ts * r * 8;
  // n per block: amortize the compaction over up to kMaxTN images while
  // keeping about kWantBlocks blocks (the pos-embed pass has only N 37)
  const int s_tiles = (s + ts - 1) / ts;
  int tn = (int)(((long long)n * s_tiles) / kWantBlocks);
  tn = tn < 1 ? 1 : (tn > kMaxTN ? kMaxTN : tn);
  dim3 grid((n + tn - 1) / tn, s_tiles);
  mid_axis_kernel<T, VEC><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), n, r, m, s, ts, tn, static_cast<const T*>(w),
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// x [n, r, m], w [s, r], out [n, s, m], all bf16 (is_bf16) or all fp32.
// vec is 16 / sizeof(element) where m and pointers allow 16-byte accesses,
// else 1.  r up to about 6000 (the compacted rows of one block fit 48 KB).
extern "C" int vdn_resize_mid_axis(const void* x, int n, int r, int m, int s,
                                   const void* w, void* out, int is_bf16,
                                   int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s > 65535 * 16) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (vec == 8)
      return launch_mid<__nv_bfloat16, 8>(x, n, r, m, s, w, out, st);
    return launch_mid<__nv_bfloat16, 1>(x, n, r, m, s, w, out, st);
  }
  if (vec == 4) return launch_mid<float, 4>(x, n, r, m, s, w, out, st);
  return launch_mid<float, 1>(x, n, r, m, s, w, out, st);
}
