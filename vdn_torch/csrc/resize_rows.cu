// A5a: the H axis of an NHWC resize, out[n, o] = sum_t w[o, t] *
// x[n, idx[o, t]] over whole rows of W * C elements, x [N, R_in, W, C] ->
// [N, out, W, C].
//
// Replaces vdn/ops/pallas/resize.py resize_rows (_rows_kernel): DPT fusion
// upsamples (19^2 -> 37^2 ... 148^2 -> 296^2 at C 256, N 32), the ViT
// pos-embed bicubic (37 -> 37 at C 1024, fp32) and the output island's H pass
// into its zero-padded plan (296 -> padded 518 rows, W 296, C 128).
//
// Bound on the H100 by device memory: a few multiply-adds per output
// element (at most 4 forward, up to 8 in a backward's transposed plan), so
// each input row read and output row written once is the whole cost (an
// input row feeds about two output rows; the second read comes from the
// 50 MB L2, as blocks of neighbouring output rows run together).  The
// TPU kernel unrolled the plan into immediates; here the plan is a small
// device table [out, taps] (taps <= 8) that every block reads, and one
// thread covers 16 bytes of a row (8 bf16 or 4 fp32), so each warp moves
// 512 contiguous bytes.  Weights and sums stay fp32 and the result is
// rounded once; products and sums use __fmul_rn / __fadd_rn in tap order,
// so the plain version's elementwise torch ops give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// One thread: VEC consecutive elements of one output row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
resize_rows_kernel(const T* __restrict__ x, int r_in, int row, int out_size,
                   int taps, const int* __restrict__ idx,
                   const float* __restrict__ w, T* __restrict__ out) {
  const int e = (blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (e >= row) return;
  const int o = blockIdx.y;
  const size_t n = blockIdx.z;
  const T* xn = x + n * r_in * row + e;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int t = 0; t < taps; ++t) {
    const float wt = __ldg(w + o * taps + t);
    if (wt == 0.f) continue;  // zero-weight taps add exact zeros
    float v[VEC];
    vdn::load_vec<T, VEC>(xn + (size_t)__ldg(idx + o * taps + t) * row, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], wt));
  }
  vdn::store_vec<T, VEC>(out + (n * out_size + o) * row + e, acc);
}

template <typename T, int VEC>
cudaError_t launch_rows(const void* x, int n, int r_in, int row, int out_size,
                        int taps, const int* idx, const float* w, void* out,
                        cudaStream_t s) {
  const int per_block = kThreads * VEC;
  dim3 grid((row + per_block - 1) / per_block, out_size, n);
  resize_rows_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), r_in, row, out_size, taps, idx, w,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// x [n, r_in, row], out [n, out_size, row] (row = W * C) in bf16 (is_bf16)
// or fp32; idx [out_size, taps] int32 and w [out_size, taps] fp32 with
// taps <= 8.  vec is 16 / sizeof(element) where row and pointers allow
// 16-byte accesses, else 1.
extern "C" int vdn_resize_rows(const void* x, int n, int r_in, int row,
                               int out_size, int taps, const void* idx,
                               const void* w, void* out, int is_bf16, int vec,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps < 1 || taps > 8 || n > 65535 || out_size > 65535)
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  if (is_bf16) {
    if (vec == 8)
      return launch_rows<__nv_bfloat16, 8>(x, n, r_in, row, out_size, taps,
                                           ip, wp, out, s);
    return launch_rows<__nv_bfloat16, 1>(x, n, r_in, row, out_size, taps, ip,
                                         wp, out, s);
  }
  if (vec == 4)
    return launch_rows<float, 4>(x, n, r_in, row, out_size, taps, ip, wp, out,
                                 s);
  return launch_rows<float, 1>(x, n, r_in, row, out_size, taps, ip, wp, out,
                               s);
}
