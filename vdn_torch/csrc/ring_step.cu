// E1: one online-softmax update of the ring-attention carry (o, m, l) with
// one K / V block, in place.
//
// Replaces vdn/ops/pallas/ring_attention.py ring_step (_ring_step_kernel):
// s = (q k^T) * scale with fp32 sums of compute-dtype operands, m' =
// max(m, rowmax s), p = exp(s - m'), corr = exp(m - m'), l' = l corr +
// rowsum(p), o' = o corr + (p rounded to v's dtype) v with fp32 sums.  The
// context-parallel temporal attention runs it once per ring step
// (vdn/parallel/context.py cp_attention, "ring_pallas"): q [G, Tq, D]
// against a block k, v [G, Tk, D], G = tokens x heads (10952 to 43808 at
// vitl 518), Tq, Tk = 32 / p frames, D = 32 or 128.
//
// Bound on the H100 by its bytes: q, k, v read once in bf16 and the fp32
// carry read and written (0.63 GB per call at G 10952, T 32, D 128: 0.19
// ms at 3.35 TB/s); its 4 G Tq Tk D FLOP are ~3% of that at the tensor
// cores' rate.  The TPU kernel kept a block of 8 rows' logits in VMEM and
// took both products on the MXU.  Here one block of 128 threads takes one
// row g and a 32-row q tile: q in shared memory as fp32, K then V streamed
// through shared memory in 32-key chunks (16-byte global loads; rows
// padded to D + 1 floats, so the strided reads below hit distinct banks),
// the tile's logits [32, Tk] kept whole in shared memory so that the row
// max is the block's before any exp (no in-kernel rescale: the same
// rounding points as the plain version), one warp per row for the
// statistics.  Both products are register-tiled fp32 FMAs, each sum in
// the order of its index (d, then the key): a thread takes a 2 x 4 tile
// of the logits (6 shared loads per 8 FMAs) and 2 rows x D / 8 columns of
// the value product.  No tensor cores and no copy / compute overlap: a
// simple kernel first (mma / wgmma and TMA are later work).  Shared memory
// grows with D and Tk, to 80.5 KB at D 256, Tk 128 (opted in above 48 KB).
//
// q, k, v are read through strides: element (g, t, d) at
// (g / H) * sb + t * st + (g % H) * sh + d, which covers [G, T, D]
// (H = 1) and [B, T, H, D] (G = B * H) without a transpose; bases and
// strides are 16-byte aligned.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQT = 32;          // q rows per block
constexpr int kKC = 32;          // keys per K / V chunk
constexpr int kMaxTk = 128;
constexpr int kMaxD = 256;
constexpr int kCG = 8;           // column groups of the value product
constexpr int kRG = kThreads / kCG;              // its row groups: 16
constexpr int kRows = kQT / kRG;                 // rows per thread: 2
constexpr int kMaxCols = kMaxD / kCG;            // columns per thread

int smem_bytes(int D, int Tk) {
  return (kQT * (D + 1) + kKC * (D + 1) + kQT * (Tk + 1) + kQT) *
         (int)sizeof(float);
}

// rows [t0, t0 + rows) of a strided operand into dst [rows][ld] as fp32
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long st, int t0, int rows,
                                          int D) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = D / V;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * V;
    float f[V];
    vdn::load_vec<T, V>(src + (long long)(t0 + r) * st + c, f);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * ld + c + i] = f[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, int Tq, int Tk, int D, int H,
                 long long qsb, long long qst, long long kvsb,
                 long long kvst, long long sh, float scale,
                 float* __restrict__ o, float* __restrict__ m,
                 float* __restrict__ l) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1, lds = Tk + 1;
  float* Qs = smem;                // [kQT][D + 1]
  float* KVs = Qs + kQT * ld;      // [kKC][D + 1]
  float* Ss = KVs + kKC * ld;      // [kQT][Tk + 1]: logits, then rounded p
  float* Cs = Ss + kQT * lds;      // [kQT]: corr

  const int g = blockIdx.x, q0 = blockIdx.y * kQT, tid = threadIdx.x;
  const int rows = min(kQT, Tq - q0);
  const long long head = (long long)(g % H) * sh;
  const T* qg = q + (long long)(g / H) * qsb + head;
  const T* kg = k + (long long)(g / H) * kvsb + head;
  const T* vg = v + (long long)(g / H) * kvsb + head;

  load_rows(Qs, ld, qg, qst, q0, rows, D);

  // logits: thread (tid / 8, tid % 8) takes rows 2 (tid / 8) + {0, 1} and
  // keys tid % 8 + 8 j of each chunk; rows >= rows and keys >= the chunk
  // compute on stale shared memory and are never stored
  const int qr = 2 * (tid >> 3), kc0 = tid & 7;
  for (int k0 = 0; k0 < Tk; k0 += kKC) {
    const int kc = min(kKC, Tk - k0);
    __syncthreads();  // Qs written / the previous chunk's readers done
    load_rows(KVs, ld, kg, kvst, k0, kc, D);
    __syncthreads();
    float s[2][4] = {};
    const float* qa = Qs + qr * ld;
    const float* kb = KVs + kc0 * ld;
    for (int d = 0; d < D; ++d) {
      const float a0 = qa[d], a1 = qa[ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = kb[8 * j * ld + d];
        s[0][j] = fmaf(a0, b, s[0][j]);
        s[1][j] = fmaf(a1, b, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (qr + i < rows && kc0 + 8 * j < kc)
          Ss[(qr + i) * lds + k0 + kc0 + 8 * j] = s[i][j] * scale;
  }
  __syncthreads();

  // softmax statistics and the carry's m, l: one warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* sr = Ss + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < Tk; c += 32) mx = fmaxf(mx, sr[c]);
    mx = vdn::warp_max(mx);
    const long long row = (long long)g * Tq + q0 + r;
    const float m_old = m[row];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = lane; c < Tk; c += 32) {
      const float p = expf(sr[c] - m_new);
      sum += p;
      sr[c] = vdn::to_f(vdn::from_f<T>(p));  // p in v's dtype
    }
    sum = vdn::warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      Cs[r] = corr;
      m[row] = m_new;
      l[row] = l[row] * corr + sum;
    }
  }

  // value product: thread (rg, cg) takes rows rg + 16 i and columns
  // cg + 8 j of the [rows, D] tile
  const int rg = tid / kCG, cg = tid % kCG, cols = D / kCG;
  float acc[kRows][kMaxCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += kKC) {
    const int kc = min(kKC, Tk - k0);
    __syncthreads();  // p and corr written / the previous chunk's readers
    load_rows(KVs, ld, vg, kvst, k0, kc, D);
    __syncthreads();
    const float* p0 = Ss + rg * lds + k0;
    for (int c = 0; c < kc; ++c) {
      const float pa = p0[c], pb = p0[kRG * lds + c];
      const float* vr = KVs + c * ld + cg;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < cols) {
          const float b = vr[kCG * j];
          acc[0][j] = fmaf(pa, b, acc[0][j]);
          acc[1][j] = fmaf(pb, b, acc[1][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg + kRG * i;
    if (r >= rows) continue;
    float* dst = o + ((long long)g * Tq + q0 + r) * D + cg;
    const float corr = Cs[r];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < cols) dst[kCG * j] = dst[kCG * j] * corr + acc[i][j];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int G, int Tq,
           int Tk, int D, int H, long long qsb, long long qst,
           long long kvsb, long long kvst, long long sh, float scale,
           void* o, void* m, void* l, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxD, kMaxTk));
  if (attr != cudaSuccess) return attr;
  dim3 grid(G, (Tq + kQT - 1) / kQT);
  ring_step_kernel<T><<<grid, kThreads, smem_bytes(D, Tk), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Tq, Tk, D, H, qsb, qst, kvsb, kvst, sh,
      scale, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l));
  return cudaGetLastError();
}

}  // namespace

// q [G, Tq, D], k / v [G, Tk, D] in bf16 (bf16 = 1) or fp32 (bf16 = 0),
// read through the strides above (elements contiguous; k and v share
// theirs); o [G, Tq, D], m / l [G, Tq] fp32 contiguous, updated in place.
// D a multiple of 8 up to 256, Tk up to 128.
extern "C" int vdn_ring_step(const void* q, const void* k, const void* v,
                             int bf16, int G, int Tq, int Tk, int D, int H,
                             long long qsb, long long qst, long long kvsb,
                             long long kvst, long long sh, float scale,
                             void* o, void* m, void* l, void* stream) {
  if (G < 1 || Tq < 1 || Tk < 1 || Tk > kMaxTk || D < 8 || D > kMaxD ||
      D % 8 || H < 1 || (Tq + kQT - 1) / kQT > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, G, Tq, Tk, D, H, qsb, qst, kvsb,
                                 kvst, sh, scale, o, m, l, s);
  return launch<float>(q, k, v, G, Tq, Tk, D, H, qsb, qst, kvsb, kvst, sh,
                       scale, o, m, l, s);
}
