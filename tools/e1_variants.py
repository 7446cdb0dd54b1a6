"""E1's ablations on the card: copies of csrc/ring_step.cu with one part
of the design changed, each built by nvcc into a library of its own and
timed beside the unchanged kernel.

    python3 tools/e1_variants.py [VARIANT ...]

Variants:

- ``base``: the kernel as it stands;
- ``carry_at_epilogue``: the carry's o rows are not copied ahead with the
  operands; each warp loads its rows (16 bytes a lane, waited on) just
  before the update o corr + pv (the same outputs);
- ``no_exp``: p = s - m', no exp (wrong outputs: the softmax's MUFU and
  its FMUL left out);
- ``cheap_mma``: every mma.sync replaced by one add of its fragments'
  bits (wrong outputs: the tensor cores' share; the fragment loads stay).

Each is timed by CUDA events around 20 back-to-back launches of the C
entry point with this tree's plan (kernels.ring_attention.e1_plan, the
layout read from the variant's own library; the kernel alone, no
wrapper), median of 5, at vitl's first and last
context-parallel shapes (G 10952 at D 128, 43808 at D 32) for local T 8,
32, 128 and 256, bf16, the variants in turn, two rounds (the lesser
median printed).  The variants build in parallel, one nvcc each.  Prints
the card's name and power limit first.  Imports nothing of JAX; needs
nvcc (/usr/local/cuda) and a CUDA device.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "vdn_torch" / "csrc"
OUT = ROOT / "build" / "e1_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", "-Xptxas=-v"]
SHAPES = ((10952, 128), (43808, 32))
TS = (8, 32, 128, 256)

from vdn_torch.kernels import _SIGNATURES  # noqa: E402
from vdn_torch.kernels import ring_attention as ra  # noqa: E402


def _sub(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"e1_variants: source changed, not found: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def _copy_in(dst: str, src: str, rows: str) -> str:
    """A warp's blocking copy of ``rows`` rows of the carry into its
    staged rows."""
    return f"""{{
    const float* og_ = {src};
    for (Chunks w(lane, 32, D / 4); w.r < {rows}; w.next())
      *reinterpret_cast<float4*>({dst} + w.r * ldo + w.c * 4) =
          *reinterpret_cast<const float4*>(og_ + (size_t)w.r * D + w.c * 4);
    __syncwarp();
  }}
"""


def variants(src: str) -> dict:
    block_load = ("  load_rows(os, ldo, a.o + ((size_t)item * Tq + (active ? r0 : "
                  "0)) * D, D,\n            rows, 16, D, lane, 32);\n")
    block_carry = "  carry_rows<NDM>(os, ldo, acc, 0, nd, corr, lane);\n"
    warp_load = ("      load_rows(o_of(st), ldo, a.o + (size_t)it * Tq * D, D, Tq, "
                 "rq, D, lane,\n                32);\n")
    warp_items = """    float* os = o_of(n & 1);
"""
    return {
        "base": src,
        "carry_at_epilogue": _sub(src, [
            (block_load, ""),
            (block_carry, "  " + _copy_in(
                "os", "a.o + ((size_t)item * Tq + r0) * D", "rows")
             + block_carry),
            (warp_load, ""),
            (warp_items, warp_items + "    " + _copy_in(
                "os", "a.o + (size_t)item * Tq * D", "Tq"))]),
        "no_exp": _sub(src, [
            ("      s[n][i] = exp_fast(s[n][i] - m[i >> 1]);",
             "      s[n][i] = s[n][i] - m[i >> 1];")]),
        "cheap_mma": _sub(src, [
            ("      mm::mma(s[2 * p], a, b[0], b[1]);\n"
             "      mm::mma(s[2 * p + 1], a, b[2], b[3]);",
             "      s[2 * p][0] += __int_as_float(a[0] ^ b[0] ^ b[1]);\n"
             "      s[2 * p + 1][0] += __int_as_float(a[1] ^ b[2] ^ b[3]);"),
            ("      mm::mma(acc[nd], P.a[kk], b[0], b[1]);\n"
             "      mm::mma(acc[nd + 1], P.a[kk], b[2], b[3]);",
             "      acc[nd][0] += __int_as_float(P.a[kk][0] ^ b[0] ^ b[1]);\n"
             "      acc[nd + 1][0] += __int_as_float(P.a[kk][1] ^ b[2] ^ "
             "b[3]);")]),
    }


def build(table: dict) -> dict:
    """Each variant's library, one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in table.items():
        cu = OUT / f"ring_step_{name}.cu"
        cu.write_text(src)
        so = OUT / f"libe1_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [NVCC, *FLAGS, str(cu), "-o", str(so)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        (OUT / f"{name}.log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"e1_variants: {name} failed to build:\n"
                             f"{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.vdn_ring_step.argtypes = _SIGNATURES["vdn_ring_step"]
        lib.vdn_ring_step.restype = ctypes.c_int
        libs[name] = lib
    return libs


def timer(lib, g: int, t: int, d: int):
    gen = torch.Generator(device="cuda").manual_seed(g + t + d)
    q, k, v = (torch.randn((g, t, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o = torch.zeros((g, t, d), device="cuda")
    m = torch.full((g, t), -1e30, device="cuda")
    l = torch.zeros((g, t), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ra.e1_plan(g, t, t, d, torch.bfloat16, sms, lib)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.vdn_ring_step(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, g, t, t, d, 1,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), 0,
            d ** -0.5, o.data_ptr(), m.data_ptr(), l.data_ptr(),
            ra.MODES[plan["mode"]], plan["warps"], plan["stages"],
            plan["kc"], plan["grid"], stream)
        if err:
            raise SystemExit(f"e1_variants: cudaError_t {err}")

    def ms() -> float:
        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 20)
        return statistics.median(times)

    return ms, plan


def main(names) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    src = (CSRC / "ring_step.cu").read_text()
    table = variants(src)
    names = names or list(table)
    libs = build({n: table[n] for n in names})
    for g, d in SHAPES:
        for t in TS:
            runs = {n: [] for n in names}
            for _ in range(2):
                for n in names:
                    ms, plan = timer(libs[n], g, t, d)
                    runs[n].append(ms())
                    torch.cuda.empty_cache()
            plan_s = f"{plan['mode']}:{plan['warps']}x{plan['stages']}"
            print(f"[e1_variant] shape=G{g}_T{t}_D{d} plan={plan_s} "
                  + " ".join(f"{n}={min(r):.4f}" for n, r in runs.items()),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
