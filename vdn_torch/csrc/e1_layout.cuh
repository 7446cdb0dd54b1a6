// E1's shared-memory layout and what a launch of it holds on an SM: the one
// source for the kernel (ring_step.cu) and for the host's plan
// (kernels/ring_attention.py e1_plan, through vdn_ring_step_fit).  Plain
// C++ apart from the qualifiers, so a host compiler builds it alone:
//
//     g++ -std=c++17 -shared -fPIC -x c++ e1_layout.cuh -o e1_layout.so
//
// exports vdn_ring_step_fit there as ring_step.cu does in the kernels'
// library.
#ifndef VDN_E1_LAYOUT_CUH_
#define VDN_E1_LAYOUT_CUH_

#ifdef __CUDACC__
#define VDN_E1_HD __host__ __device__
#else
#define VDN_E1_HD
#endif

namespace vdn {
namespace e1 {

constexpr int kSmemMax = 232448;  // an H100 block's dynamic shared memory
// an H100 SM: shared memory for its blocks (kBlockReserve of it a block),
// registers, warps, blocks
constexpr int kSmSmem = 233472, kBlockReserve = 1024;
constexpr int kSmRegs = 65536, kSmWarps = 64, kSmBlocks = 32;
constexpr int kMaxD = 256;
constexpr int kWarpT = 32;        // the warp mode's longest Tq, Tk
constexpr int kWarpCap = 16;      // the warp mode's warps a block
constexpr int kBlockWarps = 8;    // the block mode's warps (q tiles) a block
constexpr int kGroup = 32;        // keys a group: 4 n8 tiles of logits
constexpr int kKeepKeys = 128;    // the block mode's logits in registers
constexpr int kMaxStages = 4;     // the block mode's deepest ring

// row strides in elements: operands (bf16: a multiple of 16 columns + 8;
// fp32: D + 4, so A / B fragment reads hit 32 banks), the carry's o
VDN_E1_HD constexpr int ld_of(int esize, int D) {
  return esize == 2 ? (D + 15) / 16 * 16 + 8 : D + 4;
}
VDN_E1_HD constexpr int ldo_of(int D) { return D + 8; }

// the warp mode: one slot (q, k, v, o of one item) in bytes
VDN_E1_HD constexpr int warp_slot(int esize, int D, int Tq, int Tk) {
  return (16 * ((Tq + 15) / 16) + 32 * ((Tk + 15) / 16)) * ld_of(esize, D) *
             esize +
         16 * ((Tq + 15) / 16) * ldo_of(D) * 4;
}
// the block mode: each warp's q and o rows, then the ring of tiles of kc
// keys
VDN_E1_HD constexpr int block_smem(int esize, int D, int warps, int stages,
                                   int kc) {
  return warps * 16 * (ld_of(esize, D) * esize + ldo_of(D) * 4) +
         stages * kc * ld_of(esize, D) * esize;
}
// the block mode's tiles in one block's walk: one pass (up to kKeepKeys
// keys), the K tiles then the V tiles; two, the K tiles (the max), then K
// and V of each key tile
VDN_E1_HD constexpr int passes_of(int Tk) { return Tk <= kKeepKeys ? 1 : 2; }
VDN_E1_HD constexpr int walk_of(int Tk, int kc) {
  return (passes_of(Tk) + 1) * ((Tk + kc - 1) / kc);
}
// the block kernel's __launch_bounds__ blocks an SM: two (128 registers a
// thread) for bf16 up to D 128, else one (up to 255)
VDN_E1_HD constexpr int min_blocks(int esize, int D) {
  return esize == 2 && D <= 128 ? 2 : 1;
}

// a plan exists at every shape: the block mode's least block fits at the
// widest head, and a bf16 warp's two slots fit at T 32
static_assert(block_smem(2, kMaxD, 1, 2, kGroup) <= kSmemMax, "block mode");
static_assert(block_smem(4, kMaxD, 1, 2, kGroup) <= kSmemMax, "block mode");
static_assert(2 * warp_slot(2, kMaxD, kWarpT, kWarpT) <= kSmemMax,
              "warp mode");

// What a launch in ``mode`` (0 warp, 1 block) of ``warps`` warps holds:
// out[0] its warps resident on an SM (0 where the kernel does not take it),
// out[1] its shared bytes, out[2] the tiles of a block's walk (the block
// mode), out[3] its passes over the K tiles.  Returns 0.
inline int fit(int esize, int mode, int D, int Tq, int Tk, int warps,
               int stages, int kc, int* out) {
  out[0] = out[1] = out[2] = 0;
  out[3] = passes_of(Tk);
  if ((esize != 2 && esize != 4) || D < 8 || D > kMaxD || D % 8 || Tq < 1 ||
      Tk < 1 || warps < 1)
    return 0;
  if (mode == 0) {
    out[1] = warps * 2 * warp_slot(esize, D, Tq, Tk);
    // persistent: one block an SM
    if (Tq <= kWarpT && Tk <= kWarpT && warps <= kWarpCap &&
        out[1] <= kSmemMax)
      out[0] = warps;
    return 0;
  }
  if (mode != 1 || warps > kBlockWarps || (kc != kGroup && kc != 2 * kGroup))
    return 0;
  out[1] = block_smem(esize, D, warps, stages, kc);
  out[2] = walk_of(Tk, kc);
  if (stages < 2 || stages > kMaxStages || out[1] > kSmemMax) return 0;
  const int regs = kSmRegs / (32 * kBlockWarps * min_blocks(esize, D));
  int blocks = kSmSmem / (out[1] + kBlockReserve);
  if (blocks > kSmRegs / (32 * warps * regs))
    blocks = kSmRegs / (32 * warps * regs);
  if (blocks > kSmWarps / warps) blocks = kSmWarps / warps;
  if (blocks > kSmBlocks) blocks = kSmBlocks;
  out[0] = blocks * warps;
  return 0;
}

}  // namespace e1
}  // namespace vdn

// esize 2 (bf16) or 4 (fp32); the rest as vdn::e1::fit
extern "C" int vdn_ring_step_fit(int esize, int mode, int D, int Tq, int Tk,
                                 int warps, int stages, int kc, int* out) {
  return vdn::e1::fit(esize, mode, D, Tq, Tk, warps, stages, kc, out);
}

#endif  // VDN_E1_LAYOUT_CUH_
