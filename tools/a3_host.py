"""Host microseconds a call of A3's wrapper, by piece, on the card.

    python3 tools/a3_host.py

At three of the motion modules' shapes (a streamed frame's T 1 at C 1024,
T 32 at C 1024 and C 256), each piece of
``kernels.temporal_attention.temporal_attention_block`` is run back to
back: the wrapper with the fp32 weights the model stores, the wrapper
with bf16 weights, the C entry point alone on prepared arguments, the
weights' stack and casts, the scratch allocations, and the argument
checks with ``temporal_plan``.  Each prints its host microseconds a call
(``chip_smoke.host_us``, three runs of 200 calls), its ms with the host
(CUDA events, ``chip_smoke.time_ms``) and its device ms (profiler).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from vdn_torch import kernels  # noqa: E402
from vdn_torch.kernels import temporal_attention as ta  # noqa: E402

SHAPES = ((1369, 1, 1024), (361, 32, 1024), (1369, 32, 256))
HEADS = 8


def pieces(rng, bn, t, c) -> dict:
    """name -> a call of one piece of the wrapper at [bn, t, c]."""
    bf = torch.bfloat16
    x = cs._rand(rng, (bn, t, c)).to(bf)
    pe = cs._rand(rng, (t, c))
    w = [cs._rand(rng, (c, c), c ** -0.5) for _ in range(4)]
    bo = cs._rand(rng, (c,), 0.1)
    wb, peb, bob = [a.to(bf) for a in w], pe.to(bf), bo.to(bf)
    scale = (c // HEADS) ** -0.5
    wqkv = torch.cat(wb[:3]).contiguous()
    qkv = torch.empty(bn * t, 3 * c, dtype=bf, device=x.device)
    pv = torch.empty(bn * t, c, dtype=bf, device=x.device)
    out = torch.empty_like(x)
    plan = ta.temporal_plan(bn * t, c, kernels.sm_count(x.device.index), t,
                            HEADS)
    args = (x.data_ptr(), bn, t, c, HEADS, peb.data_ptr(), wqkv.data_ptr(),
            wb[3].data_ptr(), bob.data_ptr(), float(scale), qkv.data_ptr(),
            pv.data_ptr(), out.data_ptr(), plan["grid_qkv"], plan["grid_c"],
            plan["grid_core"])
    return {
        "wrapper_fp32_weights": lambda: ta.temporal_attention_block(
            x, pe, *w, bo, HEADS, scale),
        "wrapper_bf16_weights": lambda: ta.temporal_attention_block(
            x, peb, *wb, bob, HEADS, scale),
        "launch_only": lambda: kernels.launch("vdn_temporal_attention",
                                              *args),
        "stack_and_casts": lambda: (torch.cat(w[:3]).to(bf), w[3].to(bf),
                                    bo.to(bf), pe.to(bf)),
        "scratch": lambda: (torch.empty_like(qkv), torch.empty_like(pv),
                            torch.empty_like(x)),
        "checks_and_plan": lambda: (
            kernels.check_kernel_args("a3", x, peb, wqkv, wb[3], bob, qkv,
                                      pv, out),
            ta.temporal_plan(bn * t, c, kernels.sm_count(x.device.index), t,
                             HEADS)),
    }


def main() -> None:
    cs.environment()
    cs.build_kernels()
    rng = np.random.default_rng(cs.SEED)
    for bn, t, c in SHAPES:
        for name, fn in pieces(rng, bn, t, c).items():
            us = [cs.host_us(fn) for _ in range(3)]
            ms = cs.time_ms(fn, reps=20)
            dev = sum(cs.kernel_ms(fn, {}).values())
            print(f"[a3_host] BN{bn} T{t} C{c} {name}: host_us="
                  f"{[round(u, 1) for u in us]} ms={ms:.4f} "
                  f"device_ms={dev:.4f}", flush=True)


if __name__ == "__main__":
    main()
