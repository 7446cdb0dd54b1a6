"""A6's ablations on the card: copies of csrc/resize_island.cu with one
part of the design taken out or resized, each built by nvcc into a
library of its own and timed beside the unchanged kernel.

    python3 tools/a6_variants.py [VARIANT ...]

Variants (``no_*`` compute wrong outputs; they exist to be timed):

- ``base``: the kernel as it stands;
- ``no_mma``: the consumer issues no wgmma (it still waits for the ring
  rows, releases them and runs the epilogue): the producers' pace;
- ``no_produce``: the producers only zero-fill each ring row (no loads, no
  H or W pass): the consumers' pace;
- ``no_hpass``: the producers skip the H pass (the W pass reads a stale
  staging row);
- ``no_wpass`` / ``no_loads`` / ``no_fence``: the producers skip the W
  pass, the source loads (the H pass reads stale registers), or the
  proxy fence before a ring row's arrival;
- ``p384``: three producer warpgroups in place of two (at 512 threads
  ptxas holds each to 128 registers and spills).

Each is timed by CUDA events over 10 back-to-back launches of the C entry
point (device time of the kernel alone, median of 5) at vitl's window
([32, 296, 296, 128] -> 518 x 518), one frame of it, and vitg's window (C
192), two rounds in turn.  Prints the card's name and power limit first
and each variant's registers and spills.  Imports nothing of JAX; needs
nvcc (/usr/local/cuda) and a CUDA device.
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
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "vdn_torch" / "csrc"
OUT = ROOT / "build" / "a6_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", "-Xptxas=-v"]
SHAPES = ((32, 296, 296, 128), (1, 296, 296, 128), (32, 296, 296, 192))


def _sub(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"a6_variants: source changed, not found: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    threads = "constexpr int kThreads = 384;"
    producers = "constexpr int kProducers = 256;"
    return {
        "base": src,
        "no_mma": _sub(src, [(
            "          wgmma_n96(acc, da[dx], db[dx], ks | dx);", "")]),
        "no_produce": _sub(src, [(
            "      if (ys < 0 || ys >= a.h_out) {", "      if (true) {")]),
        "no_hpass": _sub(src, [(
            "            if (h_src[u] < 0) break;",
            "            if (true) break;")]),
        "no_wpass": _sub(src, [(
            "            if (w_xk[u] < 0) break;",
            "            if (true) break;")]),
        "no_loads": _sub(src, [(
            "      if (h_src[u] >= 0) {\n        if (which & 1)",
            "      if (false) {\n        if (which & 1)")]),
        "no_fence": _sub(src, [(
            "      fence_async_shared();\n      mbar_arrive(smem_u32(&full[slot]));",
            "      mbar_arrive(smem_u32(&full[slot]));")]),
        "p384": _sub(src, [(threads, "constexpr int kThreads = 512;"),
                           (producers, "constexpr int kProducers = 384;")]),
    }


def build(names) -> dict:
    """name -> the C entry point of its library (built in parallel)."""
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = variants((CSRC / "resize_island.cu").read_text())
    procs = {}
    for name in names:
        cu = OUT / f"a6_{name}.cu"
        cu.write_text(srcs[name])
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, str(cu), "-o", str(OUT / f"a6_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    from vdn_torch.kernels import _SIGNATURES
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"a6_variants: nvcc failed for {name}:\n"
                             f"{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        serial = re.findall(r"\(C75\d\d\)[^']*serialized", log)
        print(f"{name}: registers {regs} spill stores {spills} "
              f"serialized {len(serial)}", flush=True)
        fn = ctypes.CDLL(str(OUT / f"a6_{name}.so")).vdn_resize_island
        fn.argtypes = _SIGNATURES["vdn_resize_island"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(call, launches: int = 10, reps: int = 5) -> float:
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
    from vdn_torch.kernels import resize_island as ri
    if not torch.cuda.is_available():
        raise SystemExit("a6_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fns = build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, h, w, c in SHAPES:
        h_out, w_out = 14 * h // 8, 14 * w // 8
        feat = torch.randn((n, h, w, c), generator=gen,
                           device="cuda").bfloat16()
        w1 = torch.randn((3, 3, c, 32), generator=gen, device="cuda") * 0.05
        b1 = torch.randn(32, generator=gen, device="cuda") * 0.1
        w2 = torch.randn(32, generator=gen, device="cuda") * 0.2
        b2 = torch.zeros(1, device="cuda")
        itab, ftab, src_cols = ri.island_tables(h, w, h_out, w_out, "cuda")
        plan = ri.island_plan(n, h_out, w_out, sms)
        wt, b1f, w2f = ri.island_weights(w1, b1, w2)
        out = torch.empty((n, h_out, w_out), device="cuda")
        runs = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                call = lambda fn=fn: fn(
                    feat.data_ptr(), n, h, w, c, h_out, w_out,
                    itab.data_ptr(), ftab.data_ptr(), plan["strips"],
                    plan["runs"], plan["run_rows"], src_cols,
                    wt.data_ptr(), b1f.data_ptr(),
                    w2f.data_ptr(), b2.data_ptr(), 0, 1.0, out.data_ptr(),
                    plan["grid"], stream)
                if call() != 0:
                    raise SystemExit(f"a6_variants: {name} launch failed")
                torch.cuda.synchronize()
                runs[name].append(device_ms(call))
        for name, ms in runs.items():
            print(f"[{n}, {h}, {w}, {c}] -> {h_out}x{w_out} {name}: device ms "
                  + " ".join(f"{m:.4f}" for m in ms), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(variants(
        (CSRC / "resize_island.cu").read_text())))
