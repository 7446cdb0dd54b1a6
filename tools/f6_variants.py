"""F6's ablations on the card: copies of csrc/flash_attn_int8.cu with one
part of the attention kernel's design taken out, each built by nvcc into
a library of its own and timed beside the unchanged kernel.

    python3 tools/f6_variants.py [--mode all|qk|pv] [--build-only]
                                 [VARIANT ...]

Variants (all but ``base`` compute wrong outputs; they exist to be timed):

- ``base``: the kernels as they stand; ``base_l1``: with l = 1 in the
  epilogue, as every other variant has (where O stays 0, a division by
  l = 0 would take the slow path and time that instead);
- ``no_pass1`` / ``pass1_only``: the row-max pass, or the sums pass, left
  out (the producer loads only the other pass's tiles);
- ``no_softmax``: pass 2's P = S's bits packed straight into the A
  fragments (no logit, no exp2, no rounding);
- ``no_exp2``: pass 2's p without the MUFU's exp2;
- ``no_pv`` / ``no_s2``: pass 2's P V, or its S, left out;
- ``no_pingpong``: the warpgroups issue without taking turns;
- ``skeleton``: no products and no softmax in either pass: the ring, the
  turns, the per-item work and the epilogue alone;
- ``ffma``: pass 2's logit and its shift in one FFMA (s * rs - shift
  rounded once);
- ``fdiv_epilogue``: the epilogue divides by IEEE division (__fdiv_rn)
  in place of div_rn;
- ``fence_once``: pass 2 fences once and issues its products under
  conditions (ptxas then serializes every wgmma of the kernel);
- ``pv_split2`` / ``pv_split3``: the s8 P V's 80 columns as two (48 |
  32) or three (32 | 32 | 16) independent accumulator chains;
- ``timeline``: the kernel as it stands, with clock64() stamps of the
  first 32 items of every block at the item's start, after its q tile
  arrived, after pass 1, after pass 2 and after the epilogue (one thread
  of warpgroup 0); prints each phase's mean clocks an item.

``--build-only`` compiles them and reports, for each, ptxas's registers,
spills and the kernels whose wgmma it serialized.  Each is timed by CUDA
events over 20 back-to-back calls of the C entry
point (the pre-pass and the attention, device time, median of 5), at
vitl's cached window (B 22, T 1370, 16 heads) and a streamed frame (B 1),
two rounds in turn; ``prepass`` times the pre-pass alone (the attention
launch returns at once).  Prints the card's name and power limit first.
Imports nothing of JAX; needs nvcc (/usr/local/cuda) and a CUDA device.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "vdn_torch" / "csrc"
OUT = ROOT / "build" / "f6_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", "-Xptxas=-v"]
SHAPES = ((22, 1370, 16), (1, 1370, 16))
MODES = {"qk": 1, "pv": 2, "all": 3}


def _sub(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"f6_variants: source changed, not found: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    loads1 = "        for (int j = 0; j < n_t; ++j) load_stage(j, false);\n"
    loads2 = "        for (int j = 0; j < n_t; ++j) load_stage(j, true);\n"
    pass1_loop = ("    for (int j = 0; j < n_t; ++j) {\n"
                  "      const uint32_t k_s")
    pass2_loop = "#pragma unroll 1\n    for (int j = 0; j <= n_t; ++j) {"
    p_calls = ("      if ((j + 1) * kRows > T)\n"
               "        tile_p<true, kQK, kPV>(s, pa, rs, shift, j * kRows "
               "+ c2, T);\n      else\n"
               "        tile_p<false, kQK, kPV>(s, pa, rs, shift, j * kRows "
               "+ c2, T);")
    raw_p = ("#pragma unroll\n      for (int kk = 0; kk < F::kSlices; ++kk)\n"
             "#pragma unroll\n        for (int q = 0; q < 4; ++q)\n"
             "          pa[kk][q] = __float_as_uint(\n"
             "              static_cast<float>(s[4 * kk + q]));")
    pv2 = "    product_pv<kPV>(o, pa, v_s, ones_s);\n    wgmma_commit();\n"
    s2 = "    product_s<kQK>(s, qw, k_s);\n    wgmma_commit();\n"
    s1 = "      product_s<kQK>(s, qw, k_s);\n      wgmma_commit();\n"
    l1 = ("    const float l[2] = {static_cast<float>(o[32]), "
          "static_cast<float>(o[34])};", "    const float l[2] = {1.f, 1.f};")
    src_l1 = _sub(src, [l1])
    base = src
    src = src_l1
    no_softmax = _sub(src, [(p_calls, raw_p)])
    pv_n80 = "      wgmma_s8_rs_n80(o, pa[kk], desc_sw128(v_s + 32 * kk));"

    def pv_split(groups: int) -> str:
        """The P V step as independent accumulator chains over column
        groups of 8-column units (48 | 32, or 32 | 32 | 16), each B from
        its first row (1024 bytes an 8-row group) by m64nNk32 inline."""
        units = {2: (6, 4), 3: (4, 4, 2)}[groups]
        out, c0 = [], 0
        for g in units:
            n = 4 * g
            regs = ", ".join(f"%{i}" for i in range(n))
            outs = ", ".join(f'"+r"(o[{4 * c0 + i}])' for i in range(n))
            out.append(
                f'      asm volatile("{{\\n.reg .pred p;\\n'
                f'setp.ne.b32 p, %{n + 5}, 0;\\n"\n'
                f'          "wgmma.mma_async.sync.aligned.m64n{8 * g}k32'
                f'.s32.s8.s8 {{{regs}}}, {{%{n}, %{n + 1}, %{n + 2}, '
                f'%{n + 3}}}, %{n + 4}, p;\\n}}\\n"\n'
                f'          : {outs}\n'
                f'          : "r"(pa[kk][0]), "r"(pa[kk][1]), '
                f'"r"(pa[kk][2]), "r"(pa[kk][3]),\n'
                f'            "l"(desc_sw128(v_s + {1024 * c0} + 32 * kk)), '
                f'"r"(1));')
            c0 += g
        return "{\n" + "\n".join(out) + "\n      }"

    return {
        "base": base,
        "base_l1": src,
        "no_pass1": _sub(src, [
            (loads1, ""), (pass1_loop, pass1_loop.replace("j < n_t", "j < 0"))]),
        "pass1_only": _sub(src, [
            (loads2, ""),
            (pass2_loop, pass2_loop.replace("j <= n_t", "j < 0"))]),
        "no_softmax": no_softmax,
        "no_exp2": _sub(src, [("    return ex2(__fsub_rn(x, shift[e >> 1]));",
                               "    return __fsub_rn(x, shift[e >> 1]);")]),
        "no_pv": _sub(src, [(pv2, "")]),
        "no_s2": _sub(src, [(s2, "")]),
        "no_pingpong": _sub(src, [
            ("      named_sync(kTurn + wgi, kConsumers);\n", ""),
            ("      named_arrive(kTurn + (wgi ^ 1), kConsumers);\n", ""),
            ("  if (wgi == 1) named_arrive(kTurn, kConsumers);", ""),
            ("  if (wgi == 0) named_sync(kTurn, kConsumers);", "")]),
        "skeleton": _sub(no_softmax, [(pv2, ""), (s2, ""), (s1, "")]),
        "ffma": _sub(src, [(
            "    float x = logit<kQK>(s[4 * i + e], rs[e >> 1]);\n"
            "    if (kMask && key0 + 8 * i + (e & 1) >= T) x = -INFINITY;\n"
            "    return ex2(__fsub_rn(x, shift[e >> 1]));",
            "    const float f = kQK ? __fsub_rn(__int_as_float(\n"
            "        static_cast<int>(s[4 * i + e]) + kMagicBits), kMagic)\n"
            "        : static_cast<float>(s[4 * i + e]);\n"
            "    float x = fmaf(f, kQK ? rs[e >> 1] : 1.f, -shift[e >> 1]);\n"
            "    if (kMask && key0 + 8 * i + (e & 1) >= T) x = -INFINITY;\n"
            "    return ex2(x);")]),

        "fdiv_epilogue": _sub(src, [
            ("            y[e] = __fadd_rn(div_rn(__fmul_rn(__int2float_rn(x),\n"
             "                                              e ? a2.y : a2.x),\n"
             "                                    l[r], rl[r]),",
             "            y[e] = __fadd_rn(__fdiv_rn(__fmul_rn(__int2float_rn("
             "x),\n e ? a2.y : a2.x), l[r]),")]),
        "timeline": _sub(base, [
            ("// wgmma descriptor of a K-major tile of 64-byte rows",
             "__device__ long long g_tl[132][32][5];\n"
             "// wgmma descriptor of a K-major tile of 64-byte rows"),
            ("    const int qb = i & 1;\n    const uint32_t qw",
             "    const long long ts = clock64();\n"
             "    const int qb = i & 1;\n    const uint32_t qw"),
            ("    mbar_wait(smem_u32(&q_full[qb]), (i >> 1) & 1);\n"
             "    float rs[2]",
             "    mbar_wait(smem_u32(&q_full[qb]), (i >> 1) & 1);\n"
             "    const long long tq = clock64();\n    float rs[2]"),
            ("    float shift[2];\n",
             "    const long long t1 = clock64();\n    float shift[2];\n"),
            ("    mbar_arrive(smem_u32(&q_empty[qb]));\n",
             "    const long long t2 = clock64();\n"
             "    mbar_arrive(smem_u32(&q_empty[qb]));\n"),
            ("      tma_store_3d(&map_out, stage_o, h * kD, row0, b);\n"
             "      bulk_commit();\n    }\n",
             "      tma_store_3d(&map_out, stage_o, h * kD, row0, b);\n"
             "      bulk_commit();\n    }\n"
             "    if (t == 0 && i < 32 && blockIdx.x < 132) {\n"
             "      long long* g = g_tl[blockIdx.x][i];\n"
             "      g[0] = ts; g[1] = tq; g[2] = t1; g[3] = t2;"
             " g[4] = clock64();\n    }\n"),
            ("extern \"C\" int vdn_flash_attention_int8(",
             "extern \"C\" int f6_timeline(void* dst) {\n"
             "  return cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl));\n}\n"
             "extern \"C\" int vdn_flash_attention_int8(")]),
        "fence_once": _sub(src, [(
            "      if (j == 0)\n"
            "        issue<true, false, kQK, kPV>(s, o, pa, qw, k_s, v_s, "
            "ones_s);\n      else if (j < n_t)\n"
            "        issue<true, true, kQK, kPV>(s, o, pa, qw, k_s, v_s, "
            "ones_s);\n      else\n"
            "        issue<false, true, kQK, kPV>(s, o, pa, qw, k_s, v_s, "
            "ones_s);",
            "      wgmma_fence();\n"
            "      if (j < n_t) {\n        product_s<kQK>(s, qw, k_s);\n"
            "        wgmma_commit();\n      }\n"
            "      if (j > 0) {\n"
            "        product_pv<kPV>(o, pa, v_s, ones_s);\n"
            "        wgmma_commit();\n      }")]),
        "pv_split2": _sub(src, [(pv_n80, pv_split(2))]),
        "pv_split3": _sub(src, [(pv_n80, pv_split(3))]),
        "prepass": _sub(src, [("  f6_flash_kernel<kQK, kPV><<<grid",
                               "  if (grid < 0) f6_flash_kernel<kQK, kPV>"
                               "<<<grid")]),
    }


def build(names) -> dict:
    """name -> the C entry point of its library (built in parallel)."""
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = variants((CSRC / "flash_attn_int8.cu").read_text())
    procs = {}
    for name in names:
        cu = OUT / f"f6_{name}.cu"
        cu.write_text(srcs[name])
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, str(cu), "-o", str(OUT / f"f6_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"f6_variants: nvcc failed for {name}:\n"
                             f"{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        serial = len(re.findall(r"wgmma.mma_async instructions are "
                                r"serialized", log))
        print(f"{name}: registers {regs} spill stores {spills} "
              f"wgmma serialized in {serial} kernels", flush=True)
        fn = ctypes.CDLL(str(OUT / f"f6_{name}.so")).vdn_flash_attention_int8
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def print_timeline(items: int, grid: int, label: str) -> None:
    """Mean clocks an item of each phase, from the timeline variant's
    stamps of its last launch."""
    get = ctypes.CDLL(str(OUT / "f6_timeline.so")).f6_timeline
    get.restype = ctypes.c_int
    stamps = torch.zeros((132, 32, 5), dtype=torch.int64)
    if get(ctypes.c_void_p(stamps.data_ptr())) != 0:
        raise SystemExit("f6_variants: timeline copy failed")
    per_block = -(-items // grid)
    n = min(32, per_block)
    blocks = min(grid, 132)
    s = stamps[:blocks, :n].double()
    names = ("q wait", "pass 1", "pass 2", "epilogue")
    parts = {nm: float((s[..., k + 1] - s[..., k]).mean())
             for k, nm in enumerate(names)}
    if n > 1:
        parts["item"] = float((s[:, 1:, 0] - s[:, :-1, 0]).mean())
    print(f"{label} timeline clocks an item: "
          + " ".join(f"{k}={v:.0f}" for k, v in parts.items()), flush=True)


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


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("f6_variants: no CUDA device")
    mode, build_only = "all", False
    if argv[:1] == ["--mode"]:
        mode, argv = argv[1], argv[2:]
    if argv[:1] == ["--build-only"]:
        build_only, argv = True, argv[1:]
    names = argv or list(variants((CSRC / "flash_attn_int8.cu").read_text()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fns = build(names)
    if build_only:
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bits = MODES[mode]
    for b, t, h in SHAPES:
        qkv = torch.randn((b, t, 3, h, 64), generator=gen,
                          device="cuda").bfloat16()
        out = torch.empty((b, t, h, 64), dtype=torch.bfloat16, device="cuda")
        tp = -(-t // 128) * 128
        # the scratch (the entry point's): qi, aq, ki, ak, vt, av, mu
        shapes = ((b, h, tp, 64), (b, h, tp), (b, h, tp, 64), (b, h),
                  (b, h, 64, tp), (b, h, 64), (b, h, 64))
        dtypes = (torch.int8, torch.float32) * 2 + (torch.int8,) + (
            torch.float32,) * 2
        bufs = [torch.empty(sh, dtype=dt, device="cuda")
                for sh, dt in zip(shapes, dtypes)]
        ptrs = [x.data_ptr() for x in bufs]
        grid = min(b * h * -(-t // 128), sms)
        runs = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                # c2f fp32(64 ** -0.5 * log2 e), qscale its bf16
                call = lambda fn=fn: fn(qkv.data_ptr(), b, t, h, bits,
                                        0.18033688, 0.1803, *ptrs,
                                        out.data_ptr(), grid, stream)
                if call() != 0:
                    raise SystemExit(f"f6_variants: {name} launch failed")
                torch.cuda.synchronize()
                runs[name].append(device_ms(call))
        for name, ms in runs.items():
            print(f"{mode} B{b} T{t} H{h} {name}: device ms "
                  + " ".join(f"{m:.4f}" for m in ms), flush=True)
        if "timeline" in fns:
            print_timeline(b * h * -(-t // 128), grid,
                           f"{mode} B{b} T{t} H{h}")


if __name__ == "__main__":
    main(sys.argv[1:])
