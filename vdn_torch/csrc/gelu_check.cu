// A check, not a kernel of any path: vdn::gelu_tanh and
// vdn::gelu_dgelu_tanh (common.cuh; A2's fc1 and D3's paired epilogues,
// A4's GEGLU and F4's fc1) against the same formulas in IEEE arithmetic,
// exp2f and a correctly rounded 2 / (e + 1) (vdn/ops/pallas/mlp.py
// _tanh_u_f32), over every fp32 bit pattern: the branch-free reciprocal
// of tanh_gelu must give the same bits for every input (NaN matching any
// NaN).  chip_smoke.py runs it once; it takes milliseconds on the card.
#include <math.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void ieee_pair(float x, float& g, float& dg) {
  const float kA = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kB = 0.044715f;
  const float u = kA * (x + kB * x * x * x);
  const float th = 1.0f - 2.0f / (exp2f(u * (2.0f * 1.4426950408889634f)) +
                                  1.0f);
  g = 0.5f * x * (1.0f + th);
  dg = 0.5f * (1.0f + th) +
       0.5f * x * (1.0f - th * th) * kA * (1.0f + 3.0f * kB * x * x);
}

__device__ __forceinline__ bool differ(float a, float b) {
  return !(isnan(a) && isnan(b)) && __float_as_uint(a) != __float_as_uint(b);
}

// bad[0] / bad[1]: inputs whose gelu / gelu' differ; first[0] / first[1]:
// the lowest such bit pattern (0xffffffff if none)
__global__ void gelu_check_kernel(unsigned long long* bad, unsigned* first) {
  const unsigned long long n = 1ull << 32;
  for (unsigned long long i =
           blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
           threadIdx.x;
       i < n; i += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    float g, dg, g2, dg2;
    ieee_pair(x, g, dg);
    vdn::gelu_dgelu_tanh(x, g2, dg2);
    if (differ(g, vdn::gelu_tanh(x)) || differ(g, g2)) {
      atomicAdd(bad, 1ull);
      atomicMin(first, static_cast<unsigned>(i));
    }
    if (differ(dg, dg2)) {
      atomicAdd(bad + 1, 1ull);
      atomicMin(first + 1, static_cast<unsigned>(i));
    }
  }
}

}  // namespace

// bad: 2 uint64 zeroed, first: 2 uint32 set to 0xffffffff, by the caller
extern "C" int vdn_gelu_check(void* bad, void* first, void* stream) {
  gelu_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad), static_cast<unsigned*>(first));
  return cudaGetLastError();
}
