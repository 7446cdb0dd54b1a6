"""A1's ablations on the card: copies of csrc/flash_attn_qkv.cu with one
part of the design taken out, each built by nvcc into a library of its
own and timed beside the unchanged kernel.

    python3 tools/a1_variants.py [VARIANT ...]

Variants (all but ``base`` compute wrong outputs; they exist to be timed):

- ``base``: the kernel as it stands;
- ``register_sums``: each row's sum of the rounded p also taken in
  registers (unpack and add, the form the tensor cores' ones column
  replaced) and used in the epilogue;
- ``no_pingpong``: the warpgroups issue without taking turns;
- ``no_exp2``: p = bf16(S - m), no MUFU;
- ``no_softmax``: P = bf16(S) packed straight into the A fragments;
- ``s_only`` / ``pv_only``: one of the two products left out;
- ``skeleton``: no products and no softmax: the ring, the turns, the
  per-item q scaling and epilogue alone.

Each is timed by CUDA events over 20 back-to-back launches of the C entry
point (device time of the kernel alone, median of 5), at vitl's cached
window (B 22, T 1370, 16 heads) and a streamed frame (B 1), two rounds in
turn.  Prints the card's name and power limit first.  Imports nothing of
JAX; needs nvcc (/usr/local/cuda) and a CUDA device.
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
OUT = ROOT / "build" / "a1_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", "-Xptxas=-v"]
SHAPES = ((22, 1370, 16), (1, 1370, 16))


def _sub(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"a1_variants: source changed, not found: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def _softmax_calls(new: str):
    return [("""      } else if ((j + 1) * kRows > Tk) {
        softmax_tile<true>(s, pa, o, m_run, j * kRows + c2, Tk);
      } else {
        softmax_tile<false>(s, pa, o, m_run, j * kRows + c2, Tk);
      }""", "      } else {\n" + new + "\n      }")]


def variants(src: str) -> dict:
    pv = "issue<true, true>(o, s, pa, v_s, ones_s, qw, k_s);"
    last = "issue<true, false>(o, s, pa, v_s, ones_s, qw, k_s);"
    first = "issue<false, true>(o, s, pa, v_s, ones_s, qw, k_s);"
    none = "issue<false, false>(o, s, pa, v_s, ones_s, qw, k_s);"
    no_softmax = _sub(src, _softmax_calls(
        "      for (int kk = 0; kk < 8; ++kk)\n"
        "        for (int q = 0; q < 4; ++q)\n"
        "          pa[kk][q] = vdn::pack_bf16(s[8 * kk + 2 * q],\n"
        "                                     s[8 * kk + 2 * q + 1]);"))
    return {
        "base": src,
        "register_sums": _sub(src, [
            ("float (&m_run)[2], int key0,",
             "float (&m_run)[2], float (&lreg)[2], int key0,"),
            ("    alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile\n"
             "    m_run[r] = m_new;\n",
             "    alpha[r] = ex2(m_run[r] - m_new);\n"
             "    m_run[r] = m_new;\n    lreg[r] *= alpha[r];\n"),
            ("      pa[kk][q] = *reinterpret_cast<const uint32_t*>(&p);",
             "      pa[kk][q] = *reinterpret_cast<const uint32_t*>(&p);\n"
             "      const float2 f = __bfloat1622float2(p);\n"
             "      lreg[r] += f.x + f.y;"),
            ("    float m_run[2] = {-INFINITY, -INFINITY};",
             "    float m_run[2] = {-INFINITY, -INFINITY};\n"
             "    float lreg[2] = {0.f, 0.f};"),
            ("m_run, j * kRows + c2, Tk);\n      } else {",
             "m_run, lreg, j * kRows + c2, Tk);\n      } else {"),
            ("m_run, j * kRows + c2, Tk);\n      }\n      prev",
             "m_run, lreg, j * kRows + c2, Tk);\n      }\n      prev"),
            ("      l[0] = o[32];\n      l[1] = o[34];",
             "      for (int r = 0; r < 2; ++r) {\n"
             "        lreg[r] += __shfl_xor_sync(0xffffffffu, lreg[r], 1);\n"
             "        lreg[r] += __shfl_xor_sync(0xffffffffu, lreg[r], 2);\n"
             "        l[r] = lreg[r];\n"
             "      }")]),
        "no_pingpong": _sub(src, [
            ("      named_sync(kTurn + wgi, kConsumers);\n", ""),
            ("      named_arrive(kTurn + (wgi ^ 1), kConsumers);\n", ""),
            ("  if (wgi == 1) named_arrive(kTurn, kConsumers);", ""),
            ("  if (wgi == 0) named_sync(kTurn, kConsumers);", "")]),
        "no_exp2": _sub(src, [
            ("ex2(s[8 * kk + 2 * q] - m_run[r])",
             "(s[8 * kk + 2 * q] - m_run[r])"),
            ("ex2(s[8 * kk + 2 * q + 1] - m_run[r])",
             "(s[8 * kk + 2 * q + 1] - m_run[r])")]),
        "no_softmax": no_softmax,
        "skeleton": _sub(no_softmax, [(pv, none), (last, none),
                                      (first, none)]),
        "s_only": _sub(src, [(pv, pv.replace("<true, true>",
                                             "<false, true>")),
                             (last, last.replace("<true, false>",
                                                 "<false, false>"))]),
        "pv_only": _sub(src, [(pv, pv.replace("<true, true>",
                                              "<true, false>")),
                              (first, first.replace("<false, true>",
                                                    "<false, false>"))]),
    }


def build(names) -> dict:
    """name -> the C entry point of its library (built in parallel)."""
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = variants((CSRC / "flash_attn_qkv.cu").read_text())
    procs = {}
    for name in names:
        cu = OUT / f"a1_{name}.cu"
        cu.write_text(srcs[name])
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, str(cu), "-o", str(OUT / f"a1_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"a1_variants: nvcc failed for {name}:\n"
                             f"{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs} spill stores {spills}", flush=True)
        fn = ctypes.CDLL(str(OUT / f"a1_{name}.so")).vdn_flash_attention_qkv
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
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


def main(names) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("a1_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fns = build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, t, h in SHAPES:
        qkv = torch.randn((b, t, 3, h, 64), generator=gen,
                          device="cuda").bfloat16()
        out = torch.empty((b, t, h, 64), dtype=torch.bfloat16, device="cuda")
        grid = min(b * h * -(-t // 128), sms)
        runs = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                # qscale: bf16(64 ** -0.5 * log2 e)
                call = lambda fn=fn: fn(qkv.data_ptr(), b, t, h, 0.1803,
                                        out.data_ptr(), grid, stream)
                if call() != 0:
                    raise SystemExit(f"a1_variants: {name} launch failed")
                torch.cuda.synchronize()
                runs[name].append(device_ms(call))
        for name, ms in runs.items():
            print(f"B{b} T{t} H{h} {name}: device ms "
                  + " ".join(f"{m:.4f}" for m in ms), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(variants(
        (CSRC / "flash_attn_qkv.cu").read_text())))
