"""D2's variants on the card: copies of csrc/flash_attn_bthd_bwd.cu with
one part of the design changed, each built by nvcc into a library of its
own and timed beside the unchanged kernels, and C2's grid at one frame.

    python3 tools/d2_variants.py [VARIANT | FILE.cu ...]

Variants (``no_split`` computes wrong outputs; it exists to be timed):

- ``base``: the kernels as they stand;
- ``kg6``: the head-wide products (dV, dK, dQ) 6 n8 tiles at a time in
  place of 4;
- ``one_block``: launch bounds of one block an SM (up to 255 registers a
  thread) in place of two;
- ``two_streams``: the dQ kernel on a second stream, forked after the
  delta launch, so that its blocks fill the SMs that the dK / dV kernel's
  last wave leaves idle (events order it after the delta launch and the
  caller's stream after it);
- ``five_warps``: blocks of 80 keys or q rows, five consumer warps (TMA
  boxes of 16 rows), so that T 324 takes 4 full blocks a (frame, head) in
  place of 5: ptxas gives the same 168 registers, two blocks still fit an
  SM, but the SM's four sub-partitions then hold 3, 2, 3, 2 consumer
  warps in place of 2 each;
- ``no_split``: every product a single TF32 mma (big operands only).

Each variant also reports the blocks an SM holds of the dK / dV and the dQ
kernel (the runtime's occupancy calculator).

Each is timed by CUDA events over 20 back-to-back calls of the C entry
point (the three launches, device time; median of 5) at v1's shapes
([16, T, 3, 4, 96] fp32, q, k, v read in place, T 256 and 324), two
rounds in turn, beside SDPA's backward alone on the same q, k, v.  Then
C2 (``vdn_flash_attention_bthd``, A1's kernel in its kBthd form) at the
memory block's two shapes (B 1, 16 heads, T 1369 and 1813) with the
plan's grid and with others, device time, and its host time a call by
piece (``host_pieces``).  Prints the card's name and power limit first.
Imports nothing of JAX; needs nvcc (/usr/local/cuda) and a CUDA device.
"""

from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "vdn_torch" / "csrc"
OUT = ROOT / "build" / "d2_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", "-Xptxas=-v"]
V1 = (16, 4, 96)          # frames, heads, head width of v1's global blocks
TOKENS = (256, 324)
C2_SHAPES = (1369, 1813)  # the memory block's tokens, B 1, 16 heads


def _sub(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"d2_variants: source changed, not found: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


TWO_STREAMS = [
    ("""  d2_dkdv_kernel<<<dim3((Tk + kBlockRows - 1) / kBlockRows, H, B), kThreads,
                   kSmem, s>>>(""", """  static cudaStream_t s2 = [] {
    cudaStream_t x;
    cudaStreamCreateWithFlags(&x, cudaStreamNonBlocking);
    return x;
  }();
  static cudaEvent_t e0 = [] {
    cudaEvent_t x;
    cudaEventCreateWithFlags(&x, cudaEventDisableTiming);
    return x;
  }();
  static cudaEvent_t e1 = [] {
    cudaEvent_t x;
    cudaEventCreateWithFlags(&x, cudaEventDisableTiming);
    return x;
  }();
  cudaEventRecord(e0, s);
  cudaStreamWaitEvent(s2, e0, 0);
  d2_dkdv_kernel<<<dim3((Tk + kBlockRows - 1) / kBlockRows, H, B), kThreads,
                   kSmem, s>>>("""),
    ("""  d2_dq_kernel<<<dim3((Tq + kBlockRows - 1) / kBlockRows, H, B), kThreads,
                 kSmem, s>>>(""", """  d2_dq_kernel<<<dim3((Tq + kBlockRows - 1) / kBlockRows, H, B), kThreads,
                 kSmem, s2>>>("""),
    ("""                             qscale, scale, static_cast<float*>(dq));
  return cudaGetLastError();""", """                             qscale, scale, static_cast<float*>(dq));
  cudaEventRecord(e1, s2);
  cudaStreamWaitEvent(s, e1, 0);
  return cudaGetLastError();"""),
]

NO_SPLIT = """
template <int kJ, int kDd>
__device__ __forceinline__ void mma_1x(float (&d)[kDd][4], int off,
                                       const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (&bb)[kJ][2],
                                       const uint32_t (&bs)[kJ][2],
                                       int valid = kJ) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    if (j < valid) mma_tf32_1688(d[off + j], ab, bb[j]);
}
"""


# appended to every variant: the blocks an SM holds of each kernel, as the
# runtime computes them with the kernels' shared memory opted in
PROBE = """
extern "C" int d2_occupancy(int* out) {
  allow_smem(d2_dkdv_kernel, kSmem);
  allow_smem(d2_dq_kernel, kSmem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], d2_dkdv_kernel,
                                                kThreads, kSmem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], d2_dq_kernel,
                                                       kThreads, kSmem);
}
"""

FIVE_WARPS = [
    ('constexpr int kK8 = kD / 8;            // 8-deep steps along the head\nconstexpr int kBlockRows = 64;         // keys (dK / dV) or q rows (dQ)\n',
     'constexpr int kK8 = kD / 8;            // 8-deep steps along the head\nconstexpr int kWarps = 5;              // consumer warps of 16 block rows\nconstexpr int kBlockRows = 16 * kWarps;  // keys (dK / dV) or q rows (dQ)\n'),
    ('constexpr int kStages = 2;\nconstexpr int kConsumers = 128;        // four warps of 16 block rows\n',
     'constexpr int kStages = 2;\nconstexpr int kConsumers = 32 * kWarps;\n'),
    ('constexpr int kThreads = kConsumers + 32;  // and a producer warp\nconstexpr int kBox = 32;               // a TMA box: 32 floats x 32 rows\nconstexpr int kBlockTile = kBlockRows * kD * 4;  // 24 KB\n',
     'constexpr int kThreads = kConsumers + 32;  // and a producer warp\nconstexpr int kBox = 32;               // a TMA box: 32 floats (128 bytes)\nconstexpr int kBoxRows = 16;           // by 16 rows\nconstexpr int kBlockTile = kBlockRows * kD * 4;  // 30 KB\n'),
    ('constexpr int kStageTile = kStage * kD * 4;      // 12 KB\nconstexpr int kStatBytes = 2 * kStage * 4;       // lse, then delta\n',
     "constexpr int kStageTile = kStage * kD * 4;      // 12 KB\n// stats as TMA lands them: per 16 rows, their 16 lse then their 16 delta\nconstexpr int kStatBytes = 2 * kStage * 4;       // a stage's\nconstexpr int kTileStatBytes = 2 * kBlockRows * 4;  // a dQ tile's\n"),
    ('constexpr int kStatOff = kRingOff + kStages * 2 * kStageTile;\nconstexpr int kBarOff = kStatOff + kStages * kStatBytes;\n',
     'constexpr int kStatOff = kRingOff + kStages * 2 * kStageTile;\nconstexpr int kBarOff =\n    kStatOff + (kStages * kStatBytes > kTileStatBytes ? kStages * kStatBytes\n                                                       : kTileStatBytes);\n'),
    ('static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");\nstatic_assert(kStages * kStatBytes >= 2 * kBlockRows * 4,\n              "the dQ tile\'s stats fit the stats area");\n',
     'static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");\nstatic_assert(kBlockTile % 1024 == 0 && kStageTile % 1024 == 0,\n              "tiles stay on the swizzle\'s 1024-byte period");\n'),
    ('#pragma unroll\n    for (int r = 0; r < kR / kBox; ++r)\n      tma_load_3d(dst + a * kR * 128 + r * kBox * 128, map, bar,\n                  h * kD + a * kBox, row0 + r * kBox, b);\n',
     '#pragma unroll\n    for (int r = 0; r < kR / kBoxRows; ++r)\n      tma_load_3d(dst + a * kR * 128 + r * kBoxRows * 128, map, bar,\n                  h * kD + a * kBox, row0 + r * kBoxRows, b);\n}\n\n// the stats of rows [row0, row0 + kR) of (b, h) into dst\ntemplate <int kR>\n__device__ __forceinline__ void load_stats(uint32_t dst, const CUtensorMap* map,\n                                           uint32_t bar, int row0, int bh) {\n#pragma unroll\n  for (int r = 0; r < kR / kBoxRows; ++r)\n    tma_load_3d(dst + r * 2 * kBoxRows * 4, map, bar, row0 + r * kBoxRows,\n                bh, 0);\n'),
    ('        load_rows<kStage>(dst + kStageTile, &map_do, bar, h, i * kStage, b);\n        tma_load_3d(base + kStatOff + stage * kStatBytes, &map_st, bar,\n                    i * kStage, b * H + h, 0);\n',
     '        load_rows<kStage>(dst + kStageTile, &map_do, bar, h, i * kStage, b);\n        load_stats<kStage>(base + kStatOff + stage * kStatBytes, &map_st,\n                           bar, i * kStage, b * H + h);\n'),
    ('      for (int j = 0; j < kStage / 8; ++j) {\n        const float2 l = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);\n        const float2 d =\n            *reinterpret_cast<const float2*>(st + kStage + 8 * j + 2 * t);\n',
     '      for (int j = 0; j < kStage / 8; ++j) {\n        const float* sj = st + 2 * kBoxRows * (j >> 1) + 8 * (j & 1) + 2 * t;\n        const float2 l = *reinterpret_cast<const float2*>(sj);\n        const float2 d = *reinterpret_cast<const float2*>(sj + kBoxRows);\n'),
    ('      const uint32_t qb = smem_u32(q_full);\n      mbar_expect_tx(qb, 2 * kBlockTile + 2 * kStatBytes);\n',
     '      const uint32_t qb = smem_u32(q_full);\n      mbar_expect_tx(qb, 2 * kBlockTile + kTileStatBytes);\n'),
    ('      load_rows<kBlockRows>(base + kBlockTile, &map_do, qb, h, q0, b);\n      for (int r = 0; r < kBlockRows / kStage; ++r)\n        tma_load_3d(base + kStatOff + r * kStatBytes, &map_st, qb,\n                    q0 + r * kStage, b * H + h, 0);\n',
     '      load_rows<kBlockRows>(base + kBlockTile, &map_do, qb, h, q0, b);\n      load_stats<kBlockRows>(base + kStatOff, &map_st, qb, q0, b * H + h);\n'),
    ('    const int row = r_q + g + 8 * r;\n    const float* st = reinterpret_cast<const float*>(\n        sm + kStatOff + (row / kStage) * kStatBytes);\n    lr[r] = st[row % kStage];\n    dr[r] = st[kStage + row % kStage];\n',
     '    const int row = r_q + g + 8 * r;\n    const float* st = reinterpret_cast<const float*>(sm + kStatOff) +\n                      2 * kBoxRows * (row / kBoxRows) + row % kBoxRows;\n    lr[r] = st[0];\n    dr[r] = st[kBoxRows];\n'),
    ('// [B, T, H * 96] fp32 rows with their own row and batch strides (elements),\n// moved as boxes of 32 floats (128 bytes) by 32 rows of one frame in the\n',
     '// [B, T, H * 96] fp32 rows with their own row and batch strides (elements),\n// moved as boxes of 32 floats (128 bytes) by 16 rows of one frame in the\n'),
    ('  const cuuint64_t strides[2] = {(cuuint64_t)row * 4, (cuuint64_t)batch * 4};\n  const cuuint32_t box[3] = {kBox, kBox, 1};\n',
     '  const cuuint64_t strides[2] = {(cuuint64_t)row * 4, (cuuint64_t)batch * 4};\n  const cuuint32_t box[3] = {kBox, kBoxRows, 1};\n'),
    ('\n// stats [2, BH, Tp] fp32 moved as 32 rows of lse and the same 32 of delta\n',
     "\n// stats [2, BH, Tp] fp32 moved as 16 rows of lse and the same 16 of delta\n// (rows >= Tp load as zeros: a dQ tile's rows past Tq, never stored)\n"),
    ('  const cuuint64_t strides[2] = {(cuuint64_t)Tp * 4, (cuuint64_t)BH * Tp * 4};\n  const cuuint32_t box[3] = {kStage, 1, 2};\n',
     '  const cuuint64_t strides[2] = {(cuuint64_t)Tp * 4, (cuuint64_t)BH * Tp * 4};\n  const cuuint32_t box[3] = {kBoxRows, 1, 2};\n'),
]

def variants(src: str) -> dict:
    lb = ("__global__ void __launch_bounds__(kThreads, 2)",
          "__global__ void __launch_bounds__(kThreads, 1)")
    return {
        "base": src,
        "kg6": _sub(src, [("constexpr int kG = 4;", "constexpr int kG = 6;")]),
        "one_block": src.replace(*lb),
        "two_streams": _sub(src, TWO_STREAMS),
        "five_warps": _sub(src, FIVE_WARPS),
        "no_split": _sub(src, [
            ("using namespace vdn::wg;\n",
             "using namespace vdn::wg;\n" + NO_SPLIT)]).replace(
                "mma_3xtf32(", "mma_1x("),
    }


def build(names) -> dict:
    """name -> the C entry point of its library (built in parallel); a
    name ending in .cu is a source file of its own (another version of the
    kernels), named by its stem."""
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = variants((CSRC / "flash_attn_bthd_bwd.cu").read_text())
    for path in [n for n in names if n.endswith(".cu")]:
        srcs[Path(path).stem] = Path(path).read_text()
    names = [Path(n).stem if n.endswith(".cu") else n for n in names]
    procs = {}
    for name in names:
        cu = OUT / f"d2_{name}.cu"
        cu.write_text(srcs[name] + PROBE)
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, str(cu), "-o", str(OUT / f"d2_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"d2_variants: nvcc failed for {name}:\n"
                             f"{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs} spill stores {spills}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"d2_{name}.so"))
        occ = (ctypes.c_int * 2)()
        lib.d2_occupancy(occ)
        print(f"{name}: blocks an SM: dK / dV {occ[0]}, dQ {occ[1]}",
              flush=True)
        fn = lib.vdn_flash_attention_bthd_bwd
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        fn.argtypes = [P] * 6 + [I] * 5 + [L] * 6 + [F, F] + [P] * 5
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(call, launches: int = 20, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def d2_inputs(t: int, gen):
    from vdn_torch.kernels import flash_attention as fa
    b, h, d = V1
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = fa._launch_f32(q, k, v, d ** -0.5, True)
    g = torch.randn((b, t, h, d), generator=gen, device="cuda")
    tp = -(-t // fa.D2_ROWS) * fa.D2_ROWS
    bufs = [torch.empty((2, b, h, tp), device="cuda"),
            torch.empty((b, t, h, d), device="cuda"),
            torch.empty((b, t, h, d), device="cuda"),
            torch.empty((b, t, h, d), device="cuda")]
    strides = [s for x in (q, k, v) for s in x.stride()[:2]]
    return q, k, v, o, lse, g, bufs, strides


def main(names) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("d2_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from chip_smoke import sdpa_backward
    from vdn_torch import kernels
    from vdn_torch.kernels import flash_attention as fa
    fns = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b, h, d = V1
    scale = d ** -0.5
    qscale = fa._kernel_qscale(scale, torch.float32)
    for t in TOKENS:
        q, k, v, o, lse, g, bufs, strides = d2_inputs(t, gen)
        want = fa.flash_attention_bwd(q, k, v, o, lse, g)
        runs = {name: [] for name in fns}
        sdpa = sdpa_backward(*(x.transpose(1, 2) for x in (q, k, v)),
                             g.transpose(1, 2))
        runs["sdpa_backward"] = []
        for _ in range(2):
            for name, fn in fns.items():
                call = lambda fn=fn: fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    g.data_ptr(), lse.data_ptr(), b, t, t, h, d, *strides,
                    qscale, scale, *(x.data_ptr() for x in bufs), stream)
                if call() != 0:
                    raise SystemExit(f"d2_variants: {name} launch failed")
                torch.cuda.synchronize()
                err = max((x - y).abs().max().item() / y.abs().max().item()
                          for x, y in zip(bufs[1:], want))
                runs[name].append(device_ms(call))
                if _ == 0:
                    print(f"T{t} {name}: max rel err {err:.3e}", flush=True)
            runs["sdpa_backward"].append(device_ms(sdpa))
        for name, ms in runs.items():
            print(f"D2 B{b} T{t} H{h} {name}: device ms "
                  + " ".join(f"{m:.4f}" for m in ms), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = kernels.build()
    for t in C2_SHAPES:
        q, k, v = (torch.randn((1, t, 16, 64), generator=gen,
                               device="cuda").bfloat16() for _ in "qkv")
        out = torch.empty_like(q)
        items = fa.a1_plan(1, t, 16, sms)["items"]
        qs = fa._kernel_qscale(64 ** -0.5)
        for grid in sorted({min(items, sms), math.ceil(items / 2),
                            math.ceil(items / 3), items}):
            call = lambda grid=grid: lib.vdn_flash_attention_bthd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, t, t, 16, qs,
                out.data_ptr(), grid, stream)
            ms = [device_ms(call) for _ in range(2)]
            print(f"C2 T{t} items {items} grid {grid}: device ms "
                  + " ".join(f"{m:.4f}" for m in ms), flush=True)
    host_pieces(q, k, v, out, lib)


def host_pieces(q, k, v, out, lib) -> None:
    """C2's host time a call at the last shape, by piece: the entry point,
    the wrapper below its dispatch, ``kernels.launch`` (the stream and
    the C call), the C entry alone (four tensor maps encoded, one launch),
    and the two ways to read the current stream (host_us, three runs)."""
    from chip_smoke import host_us
    from vdn_torch import kernels
    from vdn_torch.kernels import flash_attention as fa
    b, t, h, _ = q.shape
    qs = fa._kernel_qscale(64 ** -0.5)
    grid = fa.a1_plan(b, t, h, kernels.sm_count(0))["grid"]
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), b, t, t, h, qs,
            out.data_ptr(), grid)
    pieces = {
        "flash_attention": lambda: fa.flash_attention(q, k, v),
        "_launch_bthd": lambda: fa._launch_bthd("flash_attention", q, k, v,
                                                None, None),
        "kernels.launch": lambda: kernels.launch(
            "vdn_flash_attention_bthd", *args),
        "C entry": lambda: lib.vdn_flash_attention_bthd(*args, stream),
        "torch.cuda.current_stream()":
            lambda: torch.cuda.current_stream().cuda_stream,
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice()),
    }
    with torch.no_grad():
        for name, fn in pieces.items():
            print(f"C2 T{t} host_us {name}: "
                  + " ".join(f"{host_us(fn):.2f}" for _ in range(3)),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(variants(
        (CSRC / "flash_attn_bthd_bwd.cu").read_text())))
