"""E1 (the ring-attention step, csrc/ring_step.cu) under other launch plans.

    python3 tools/e1_plans.py [T ...]

On the card: builds the kernels, then at vitl's four context-parallel
shapes (G = tokens x 8 heads, D 128 / 32) and vitg's D 192 / 48, local
T 8, 32, 128 and 256 by default, bf16 from a zero carry, times E1 under
``kernels.ring_attention.e1_plan``'s plan and under each other plan that
fits (the warp mode with fewer warps; the block mode at 8, 4, 2 and 1
warps, rings of 2, 3 and 4 tiles and tiles of 32 and 64 keys, each as
csrc/e1_layout.cuh takes it), CUDA
events around the call (ms with the host's time, median of 10).  Each
plan's output is held to the plain version first (chip_smoke's
KERNEL_ULPS).  Prints one line per (shape, plan) and, per shape, the
plan's time beside the fastest's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from vdn_torch.kernels import ring_attention as ra  # noqa: E402


def candidates(lib, g, t, d, esize, sms):
    """The plans worth timing at one shape: each warp-mode block size that
    the layout takes, then the block-mode (warps, tile, stages) it takes."""
    out = []
    top = max((w for w in range(1, 33)
               if ra.fit(lib, esize, "warp", d, t, t, w, 2, 32)["resident"]),
              default=0)
    for w in sorted({top, max(1, top // 2), 1} if top else ()):
        out.append({"mode": "warp", "warps": w, "stages": 2, "kc": 32,
                    "grid": min(-(-g // w), sms), "passes": 1})
    for w in (8, 4, 2, 1):
        if w > -(-t // 16):
            continue
        for kc in (32, 64):
            for st in (2, 3, 4):
                f = ra.fit(lib, esize, "block", d, t, t, w, st, kc)
                if f["resident"]:
                    out.append({"mode": "block", "warps": w, "stages": st,
                                "kc": kc, "grid": g * -(-t // (16 * w)),
                                "passes": f["passes"]})
    return out


def main(ts) -> None:
    cs.environment()
    cs.build_kernels()
    from vdn_torch.kernels import build, sm_count
    lib = build()
    sms = sm_count(0)
    rng = np.random.default_rng(cs.SEED)
    default = ra.e1_plan
    shapes = cs.e1_shapes() + [(bn * 8, c // 8)
                               for bn, c in cs.VITG_MOTION_SHAPES[::2]]
    try:
        for t in ts:
            for g, d in shapes:
                q, k, v = (cs._rand(rng, (g, t, d)).to("cuda", torch.bfloat16)
                           for _ in range(3))
                o, m, l = cs._zero_carry(g, t, d)
                want = ra.ring_step_plain(q, k, v, o, m, l, d ** -0.5)
                torch.cuda.synchronize()
                base = default(g, t, t, d, torch.bfloat16, sms)
                times = {}
                for plan in candidates(lib, g, t, d, 2, sms):
                    ra.e1_plan = lambda *_, p=plan: p
                    work = [a.clone() for a in (o, m, l)]
                    ra.ring_step(q, k, v, *work, d ** -0.5)
                    err, tol, _, fin = cs._compare(tuple(work), want, "bf16")
                    work = [a.clone() for a in (o, m, l)]
                    ms = cs.time_ms(lambda: ra.ring_step(q, k, v, *work,
                                                         d ** -0.5))
                    key = (f"{plan['mode']}:{plan['warps']}x{plan['stages']}"
                           f"k{plan['kc']}")
                    times[key] = ms
                    cs.log("e1_plan", shape=f"G{g}_T{t}_D{d}", plan=key,
                           ms=f"{ms:.4f}", ok=bool(err <= tol and fin),
                           default=plan == base)
                    if not (err <= tol and fin):
                        cs.fail(f"e1 plan {key} at G{g} T{t} D{d}: err {err}")
                best = min(times, key=times.get)
                key = (f"{base['mode']}:{base['warps']}x{base['stages']}"
                       f"k{base['kc']}")
                cs.log("e1_best", shape=f"G{g}_T{t}_D{d}", plan=key,
                       ms=f"{times.get(key, float('nan')):.4f}", best=best,
                       best_ms=f"{times[best]:.4f}")
                ra.e1_plan = default
                del q, k, v, o, m, l, want
                torch.cuda.empty_cache()
    finally:
        ra.e1_plan = default


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [8, 32, 128, 256])
