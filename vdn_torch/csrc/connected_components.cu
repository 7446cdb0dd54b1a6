// Connected components (8-connectivity) of N binary masks: labels and
// per-pixel component areas, in one host call.
//
// The same function as vdn's host union-find (native/connected_components.cc
// through vdn/ops/connected_components.py), bit for bit: a component's
// root is its smallest raster index; labels are 1-based over the
// foreground, numbered in the raster order of each component's first
// pixel (its root), 0 on the background; areas hold the component's size
// at each of its pixels and 0 on the background.  vdn computes them on the
// host; the reference computed them with its one CUDA kernel.  Here the
// AMG's masks stay on the card.
//
// Mask [N, H, W] uint8 (nonzero = foreground), labels / areas [N, H, W]
// int32.  Six launches:
//   1. local: a block unions its 32 x 32 tile in shared memory (atomicMin
//      on the parents: every root links to the smaller index) and writes
//      each pixel's tile root, as a raster index of the image, into
//      labels, which serve as the parents from here on; areas zeroed;
//   2. border: each pixel with a neighbour (W, NW, N, NE) in another tile
//      unions across the border in global memory (the same atomicMin
//      union, with path halving by atomicMin, so a parent only ever moves
//      to a smaller index of the same component);
//   3. flatten: every foreground pixel's parent becomes its root (the
//      path it walked is compressed to the root on the way); the root's
//      area counter (areas[root], one atomic for a warp's pixels of one
//      root) and its 1024-pixel chunk's root count go up by integer
//      atomics (the same sums in any order);
//   4. scan: the chunks' root counts of each image, exclusive prefix;
//   5. rank: each root's rank in raster order among its image's roots
//      (its chunk's offset and a block scan of the chunk's root flags);
//      the root's label, rank + 1, goes into its own parent slot with the
//      sign bit set (a root's slot is never read as a parent index again);
//   6. gather: each foreground pixel takes its root's label and area.
// The root (the smallest index) and the integer sums do not depend on the
// order the atomics land in, so every launch gives the same bits.
//
// Bound on the H100 by memory: the mask read once, labels and areas
// written once, 9 bytes a pixel; the passes re-read labels and areas
// (about 30 bytes a pixel in all) and the unions chase parents.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;          // tile side of the local pass
constexpr int kLocalThreads = 256; // 32 x 8: each thread 4 rows
constexpr int kChunk = 1024;       // pixels of a rank chunk
constexpr int kChunkThreads = 256; // 4 pixels a thread
constexpr int kFlat = 256;
constexpr int kSign = -2147483647 - 1;  // the sign bit

// -- shared-memory union-find over a tile's local indices
__device__ __forceinline__ int find_s(const int* p, int x) {
  int y = p[x];
  while (y != x) {
    x = y;
    y = p[x];
  }
  return x;
}

__device__ void union_s(int* p, int a, int b) {
  bool done;
  do {
    a = find_s(p, a);
    b = find_s(p, b);
    if (a < b) {
      const int old = atomicMin(&p[b], a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(&p[a], b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

// -- global union-find over an image's raster indices (parents at p)
__device__ __forceinline__ int find_g(int* p, int x) {
  int y = __ldcg(p + x);
  while (y != x) {
    const int z = __ldcg(p + y);
    if (z < y) atomicMin(p + x, z);  // halving: z is an ancestor of x
    x = y;
    y = z;
  }
  return x;
}

__device__ void union_g(int* p, int a, int b) {
  bool done;
  do {
    a = find_g(p, a);
    b = find_g(p, b);
    if (a < b) {
      const int old = atomicMin(p + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(p + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void __launch_bounds__(kLocalThreads)
cc_local_kernel(const uint8_t* __restrict__ mask, int H, int W,
                int* __restrict__ labels, int* __restrict__ areas) {
  __shared__ int par[kTile * kTile];
  __shared__ uint8_t fg[kTile * kTile];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const size_t base = (size_t)blockIdx.z * H * W;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int x = x0 + tx;
#pragma unroll
  for (int r = ty; r < kTile; r += 8) {
    const int y = y0 + r, i = r * kTile + tx;
    const bool in = x < W && y < H;
    fg[i] = in && mask[base + (size_t)y * W + x] != 0;
    par[i] = i;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < kTile; r += 8) {
    const int i = r * kTile + tx;
    if (!fg[i]) continue;
    if (tx > 0 && fg[i - 1]) union_s(par, i, i - 1);
    if (r > 0) {
      if (fg[i - kTile]) union_s(par, i, i - kTile);
      if (tx > 0 && fg[i - kTile - 1]) union_s(par, i, i - kTile - 1);
      if (tx + 1 < kTile && fg[i - kTile + 1])
        union_s(par, i, i - kTile + 1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < kTile; r += 8) {
    const int y = y0 + r, i = r * kTile + tx;
    if (x >= W || y >= H) continue;
    const size_t at = base + (size_t)y * W + x;
    int v = 0;
    if (fg[i]) {
      const int root = find_s(par, i);
      v = (y0 + root / kTile) * W + x0 + root % kTile;
    }
    labels[at] = v;
    areas[at] = 0;
  }
}

__global__ void __launch_bounds__(kFlat)
cc_border_kernel(const uint8_t* __restrict__ mask, int H, int W,
                 int* __restrict__ labels) {
  const int x = blockIdx.x * kFlat + threadIdx.x, y = blockIdx.y;
  if (x >= W) return;
  const size_t base = (size_t)blockIdx.z * H * W;
  const uint8_t* m = mask + base;
  int* p = labels + base;
  const int i = y * W + x;
  if (!m[i]) return;
  const bool left = x % kTile == 0, top = y % kTile == 0;
  const bool right = x % kTile == kTile - 1;
  if (left && x > 0 && m[i - 1]) union_g(p, i, i - 1);
  if (y == 0) return;
  const int up = i - W;
  if (top && m[up]) union_g(p, i, up);
  if ((top || left) && x > 0 && m[up - 1]) union_g(p, i, up - 1);
  if ((top || right) && x + 1 < W && m[up + 1]) union_g(p, i, up + 1);
}

__global__ void __launch_bounds__(kFlat)
cc_flatten_kernel(const uint8_t* __restrict__ mask, int HW, int chunks,
                  int* __restrict__ labels, int* __restrict__ areas,
                  int* __restrict__ chunk_roots) {
  const int i = blockIdx.x * kFlat + threadIdx.x;
  if (i >= HW) return;
  const size_t base = (size_t)blockIdx.y * HW;
  if (!mask[base + i]) return;
  int* p = labels + base;
  const int first = p[i];
  int root = first;
  while (true) {
    const int up = __ldcg(p + root);
    if (up == root) break;
    root = up;
  }
  // compress the walked path for the pixels that walk it later: every
  // node on it gets the root (the roots are final here, so a reader sees
  // its old parent or the root, both ancestors)
  for (int x = first; x != root;) {
    const int up = __ldcg(p + x);
    __stcg(p + x, root);
    x = up;
  }
  p[i] = root;
  // one atomic for the warp's lanes of each root: a component spanning
  // the image would otherwise serialize ~10^5 adds on one counter
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, root);
  if ((threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(areas + base + root, __popc(peers));
  if (root == i) atomicAdd(chunk_roots + (size_t)blockIdx.y * chunks +
                           i / kChunk, 1);
}

// the chunks' root counts of one image -> their exclusive prefix, in place
__global__ void __launch_bounds__(1024)
cc_scan_kernel(int* __restrict__ chunk_roots, int chunks) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  int* c = chunk_roots + (size_t)blockIdx.x * chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int c0 = 0; c0 < chunks; c0 += 1024) {
    const int i = c0 + threadIdx.x;
    const int v = i < chunks ? c[i] : 0;
    int s = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane == 31) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += n;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < chunks) c[i] = before + s - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[31];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kChunkThreads)
cc_rank_kernel(const uint8_t* __restrict__ mask, int HW, int chunks,
               int* __restrict__ labels,
               const int* __restrict__ chunk_offsets) {
  __shared__ int warp_sums[kChunkThreads / 32];
  const size_t base = (size_t)blockIdx.y * HW;
  const int i0 = blockIdx.x * kChunk + 4 * threadIdx.x;
  int* p = labels + base;
  bool root[4];
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + k;
    root[k] = i < HW && mask[base + i] && p[i] == i;
    n += root[k];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  if (lane == 31) warp_sums[warp] = s;
  __syncthreads();
  int rank = chunk_offsets[(size_t)blockIdx.y * chunks + blockIdx.x] + s - n;
  for (int w = 0; w < warp; ++w) rank += warp_sums[w];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (root[k]) p[i0 + k] = (rank++ + 1) | kSign;
}

__global__ void __launch_bounds__(kFlat)
cc_gather_kernel(const uint8_t* __restrict__ mask, int HW,
                 int* __restrict__ labels, int* __restrict__ areas) {
  const int i = blockIdx.x * kFlat + threadIdx.x;
  if (i >= HW) return;
  const size_t base = (size_t)blockIdx.y * HW;
  if (!mask[base + i]) return;
  int* p = labels + base;
  const int v = p[i];
  if (v < 0) {  // a root: its own label, its own area
    p[i] = v & ~kSign;
    return;
  }
  // v is the root: its slot holds the label, flagged or already taken
  const int l = __ldcg(p + v);
  p[i] = l & ~kSign;
  areas[base + i] = areas[base + v];
}

}  // namespace

// mask [N, H, W] uint8, labels / areas [N, H, W] int32 (out), chunk_roots
// [N, ceil(H W / 1024)] int32 zeroed scratch.  H * W < 2^31.
extern "C" int vdn_connected_components(const void* mask, int N, int H,
                                        int W, void* labels, void* areas,
                                        void* chunk_roots, void* stream) {
  if (N < 1 || H < 1 || W < 1 || N > 65535 || H > 65535 ||
      (long long)H * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* lab = static_cast<int*>(labels);
  auto* area = static_cast<int*>(areas);
  auto* roots = static_cast<int*>(chunk_roots);
  const int HW = H * W;
  const int chunks = (HW + kChunk - 1) / kChunk;
  cc_local_kernel<<<dim3((W + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                         N), kLocalThreads, 0, s>>>(m, H, W, lab, area);
  cc_border_kernel<<<dim3((W + kFlat - 1) / kFlat, H, N), kFlat, 0, s>>>(
      m, H, W, lab);
  const dim3 flat((HW + kFlat - 1) / kFlat, N);
  cc_flatten_kernel<<<flat, kFlat, 0, s>>>(m, HW, chunks, lab, area, roots);
  cc_scan_kernel<<<N, 1024, 0, s>>>(roots, chunks);
  cc_rank_kernel<<<dim3(chunks, N), kChunkThreads, 0, s>>>(m, HW, chunks,
                                                           lab, roots);
  cc_gather_kernel<<<flat, kFlat, 0, s>>>(m, HW, lab, area);
  return cudaGetLastError();
}
