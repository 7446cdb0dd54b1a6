"""A1's kernel forms in this checkout and another, on the card: their
SASS side by side, then A1 and A1-train timed in turn.

    python3 tools/a1_ab.py OTHER_TREE

Compiles csrc/flash_attn_qkv.cu of both checkouts to cubins with
``kernels.NVCC_FLAGS``, dumps their SASS (cuobjdump) and, for each
``a1_flash_kernel<k>`` form, prints its instruction count in each and the
lines that differ (a unified diff, once with the parameters' constant-bank
offsets set aside and once with every immediate set aside); the diffs go
to build/a1_ab/a1_sass_<k>.diff.  Then A1 at the cached window and
A1-train at the v4 step's shape (each checkout's own
``chip_smoke.a1_case``: three timings each of ms with the host and of
device ms) in four processes, OTHER_TREE, this, this, OTHER_TREE.
Imports nothing of JAX; needs nvcc (/usr/local/cuda) and a CUDA device.
"""

import difflib
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "a1_ab"
CUDA = Path("/usr/local/cuda/bin")


def sass(tree: Path, tag: str) -> dict:
    """form -> its SASS instructions (``a1_flash_kernel<form>``)."""
    sys.path.insert(0, str(ROOT))
    from vdn_torch.kernels import NVCC_FLAGS
    csrc = tree / "vdn_torch" / "csrc"
    cubin = OUT / f"{tag}.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([str(CUDA / "nvcc"), *flags, "-cubin", f"-I{csrc}",
                    str(csrc / "flash_attn_qkv.cu"), "-o", str(cubin)],
                   check=True, capture_output=True)
    dump = subprocess.run([str(CUDA / "cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    forms, cur = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : \S*a1_flash_kernelILi(\d)E", line)
        if m:
            cur = forms.setdefault(int(m.group(1)), [])
            continue
        if "Function :" in line:
            cur = None
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return forms


def changed(a, b) -> int:
    return sum(1 for line in difflib.unified_diff(a, b, lineterm="", n=0)
               if line[:1] in "+-" and line[:3] not in ("+++", "---"))


def compare(other: Path) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    old, new = sass(other, "other"), sass(ROOT, "this")
    params = lambda ins: [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", i)
                          for i in ins]
    imms = lambda ins: [re.sub(r"0x[0-9a-f]+", "X", i) for i in ins]
    for k in sorted(set(old) | set(new)):
        if k not in old or k not in new:
            print(f"[a1_sass] form {k}: in {other} {k in old}, here "
                  f"{k in new}", flush=True)
            continue
        a, b = params(old[k]), params(new[k])
        print(f"[a1_sass] form {k}: instructions {len(a)} -> {len(b)}, "
              f"identical {old[k] == new[k]}, lines differing "
              f"{changed(a, b)} (parameter offsets aside), "
              f"{changed(imms(a), imms(b))} (every immediate aside)",
              flush=True)
        (OUT / f"a1_sass_{k}.diff").write_text("\n".join(
            difflib.unified_diff(a, b, str(other), "this", lineterm="")))


def time_tree(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import chip_smoke as cs
    cs.environment()
    cs.build_kernels()
    rng = np.random.default_rng(cs.SEED)
    for key, args in (("a1_cached_window", (cs.CACHED_FRAMES,)),
                      ("a1_train_v4", (cs.TRAIN_FRAMES, cs.VIT_TOKENS, 16,
                                       True))):
        c = cs.a1_case(rng, "ab", *args)
        ms = [cs.time_ms(c["kern"], reps=20) for _ in range(3)]
        dev = [sum(cs.kernel_ms(c["kern"], {}).values()) for _ in range(3)]
        print(f"[a1_ab] tree={tree} {key} ms="
              + ",".join(f"{m:.4f}" for m in ms) + " device_ms="
              + ",".join(f"{m:.4f}" for m in dev), flush=True)
        del c
        torch.cuda.empty_cache()


def main() -> None:
    if sys.argv[1:2] == ["--time"]:
        time_tree(sys.argv[2])
        return
    other = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    compare(other)
    for tree in (other, ROOT, ROOT, other):
        subprocess.run([sys.executable, __file__, "--time", str(tree)],
                       check=True)


if __name__ == "__main__":
    main()
