"""Where the device time goes in the PyTorch / CUDA port on one GPU.

    python3 tools/profile_torch.py [--out build/profile] [--units ...]

Builds the models of chip_smoke.py (vitl at 518, bf16, seeded random
weights), warms up, then traces each unit with ``torch.profiler``.
VideoDepthAnything:

- ``cached``: three cached clip windows (22 new frames + 10 reused);
- ``stream_k1``: four per-frame streaming steps after 12 warm frames
  (past the gap-41 eviction);
- ``stream_k8``: two chunks of 8 streaming frames after a warm chunk;
- ``cp_window``: three full 32-frame windows of the same weights built
  with ``seq_axis="seq"`` through ``make_context_parallel_forward`` on a
  world of one rank (NCCL, a (1, 1, 1) mesh) in ``ring_pallas`` mode: the
  motion modules' attention is E1 (8 launches per window) instead of A3;
- ``cp_rope``: one 256-frame clip at 266 x 266 of chip_smoke.py's RoPE
  model (vitl width, temporal RoPE, context parallel on a world of one
  rank) under ``auto``, after a warm-up clip: E1 at 256 keys, 8 launches.

- ``int8``: three cached clip windows of the same weights in the int8
  serving mode (``quantize="int8_static"``, calibrated on one full
  window); its split names F1-F4 and the int8 convs (``torch._int_mm``
  apart from their quantize, im2col and dequantize passes, which are told
  by the ``int8_conv`` range each call is traced in), beside the
  ``cached`` unit's bf16 split;
- ``int8_all``: the ``int8`` unit with ``VDN_FLASH_INT8="all"``: F6 (its
  pre-pass and its two-pass attention) in A1's place.

vitg (chip_smoke.py's vitg model, full width):

- ``vitg_cached`` and ``vitg_int8``: the ``cached`` and ``int8`` units on
  VideoDepthAnything vitg (F5 in place of F4).

DepthAnythingV2 with its memory bank:

- ``image``: four ``infer_image`` calls after 8 warm frames (the six-slot
  bank is full and shifting).

RefineVideoDepth v4 (chip_smoke.py's training phase):

- ``train``: two RefineTrainer steps (b2 t8, frozen temporal head) after a
  warm-up step.

The v1 research model (chip_smoke.py's v1 phase: hiera_base, 256 x 256,
fp32):

- ``v1_train``: two V1Trainer steps (b2 x s8) after a warm-up step.

For each, device time is summed from the exported chrome trace (events of
category "kernel"), grouped by kernel name, and printed per unit (window,
frame) beside the span of host wall time and the union of kernel intervals
(busy time; idle share = 1 - busy / span).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# kernel-name patterns -> readable group (the first match wins)
GROUPS = [
    (r"quantize_qkv_kernel", "F6 pre-pass (q / k / v codes and scales)"),
    (r"f6_flash_kernel", "F6 int8 flash attention (wgmma)"),
    (r"e1_(warp|block)_kernel|ring_step_kernel",
     "E1 ring-attention step (CP motion modules)"),
    (r"flash_bthd_f32_kernel", "C2 fp32 attention (hieradet global blocks)"),
    (r"d2_dkdv", "D2 dK / dV (3xTF32 mma.sync, TMA)"),
    (r"d2_dq", "D2 dQ (3xTF32 mma.sync, TMA)"),
    (r"d2_delta", "D2 delta (+ padded lse)"),
    # F1-F5 on the wgmma core (csrc/int8_tail.cuh, int8_linear.cu,
    # ln_mlp_int8.cu, ln_swiglu_int8.cu): F1's rows by their caller tag,
    # F2's and F3's skip the LayerNorm; F1 / F2's product by its bias
    # epilogue, F3's takes one K chunk; F4's fc2 and F5's w3 (two chunks)
    # are one instantiation
    (r"ln_quant_rows_kernel<.*F1Rows", "F1 LayerNorm + quantize rows"),
    (r"ln_quant_rows_kernel<\d+, (false|\(bool\)0),",
     "F2 / F3 quantize rows"),
    (r"EpiI8Linear", "F1 qkv / F2 int8 wgmma (+ b)"),
    (r"gemm_s8_wgmma_kernel<\d+, 1, .*EpiI8Residual",
     "F3 proj int8 wgmma (+ b, x gamma, + residual)"),
    (r"ln_quant_rows_kernel", "F4 / F5 LayerNorm + quantize rows"),
    (r"quant_hidden_kernel", "F4 / F5 hidden quantize (per row and F / 2)"),
    (r"EpiHidden", "F4 fc1 int8 wgmma (GELU epilogue)"),
    (r"EpiSwigluHidden", "F5 w12 int8 wgmma (paired, SwiGLU epilogue)"),
    (r"gemm_s8_wgmma_kernel.*EpiI8Residual",
     "F4 fc2 / F5 w3 int8 wgmma (two chunks, + b, x gamma, + x)"),
    # A1's kernel by its form (csrc/flash_attn_qkv.cu: kA1 0, kA1Lse 1,
    # kC3 2, kBthd 3, kC1 4)
    (r"a1_flash_kernel<1>", "A1-train flash attention (+ log-sum-exp)"),
    (r"a1_flash_kernel<2>", "C3 head-major fused-qkv attention"),
    (r"a1_flash_kernel<3>", "C2 memory self-attention"),
    (r"a1_flash_kernel<4>", "C1 memory cross-attention (column bias)"),
    (r"a1_flash_kernel", "A1 flash attention"),
    (r"d1_prepass", "D1 pre-pass (qs, delta, padded lse)"),
    (r"d1_dkdv", "D1 dK / dV (wgmma)"),
    (r"d1_dq", "D1 dQ (wgmma)"),
    # A2, D3 and A4 on the bf16 wgmma core (csrc/bf16_wgmma.cuh,
    # ln_mlp.cu, ln_mlp_bwd.cu, ln_geglu.cu), by kernel or epilogue name;
    # A2 and A4 share the row kernel, told apart by its caller tag
    (r"ln_rows_kernel<.*A2Rows", "A2 LayerNorm rows"),
    (r"ln_rows_kernel<.*A4Rows", "A4 LayerNorm rows"),
    (r"EpiFc1Gelu", "A2 fc1 bf16 wgmma (GELU epilogue)"),
    (r"EpiFc2Residual", "A2 fc2 bf16 wgmma (+ b2, x gamma, + x)"),
    (r"d3_rows", "D3 rows (y, g gamma, LayerNorm statistics)"),
    (r"EpiHDhpre", "D3 paired bf16 wgmma y W1^T, (g gamma) W2 (h, dhpre)"),
    (r"EpiDy", "D3 bf16 wgmma dhpre W1 (dy)"),
    (r"EpiGeglu", "A4 fc1 bf16 wgmma (hidden / gate halves, GEGLU)"),
    (r"EpiResidualBias", "A4 fc2 bf16 wgmma (x + o, + b2)"),
    (r"ln_bwd_rows|ln_colsum|colsum_reduce",
     "D3 LayerNorm backward rows and column sums"),
    # A3 and D4 (csrc/temporal_attn.cu, temporal_attn_bwd.cu): the + pe
    # rows by their caller tag, each product by its epilogue's tag, the
    # cores by name
    (r"pe_rows_kernel<.*A3Rows", "A3 + pe rows"),
    (r"EpiStore<.*A3Qkv", "A3 qkv bf16 wgmma"),
    (r"a3_core_kernel", "A3 T x T core (mma.sync)"),
    (r"EpiOutBias", "A3 out bf16 wgmma (+ bo)"),
    (r"pe_rows_kernel<.*D4Rows", "D4 + pe rows"),
    (r"EpiStore<.*D4Qkv", "D4 qkv recompute bf16 wgmma"),
    (r"EpiStore<.*D4Doh", "D4 doh = g Wo bf16 wgmma"),
    (r"d4_core_kernel", "D4 T x T core (mma.sync)"),
    (r"EpiStore<.*D4Dx", "D4 dx bf16 wgmma"),
    (r"island_kernel", "A6 fused resize island"),
    (r"resize_rows", "A5a resize_rows"),
    (r"mid_axis", "A5b resize_mid_axis and B1 select_rows"),
    (r"multi_tensor|[Aa]dam", "AdamW (multi-tensor)"),
    (r"[Ss]ort|radix|kthvalue|TopK|bitonic",
     "sorts and order statistics (losses, medians)"),
    (r"conv|Conv|cudnn|implicit|winograd|fprop|dgrad|wgrad",
     "cuDNN convs"),
    (r"nvjet|cutlass|cublas|gemm|Gemm|sm90_xmma|sm80_xmma",
     "cuBLAS GEMMs (ViT qkv / proj, DPT, cached attention)"),
    (r"elementwise|vectorized|unrolled|Reduce|reduce|copy|Copy|cat|"
     r"index|fill|softmax|Softmax|norm|where|arange",
     "elementwise, copies, reductions"),
]


def group_of(name: str) -> str:
    for pat, label in GROUPS:
        if re.search(pat, name):
            return label
    return "other: " + name[:60]


INT8_CONV = "int8_conv"
GEMM = r"nvjet|cutlass|cublas|gemm|Gemm|xmma|imma"


def int8_conv_group(name: str) -> str:
    return ("int8 convs: torch._int_mm products" if re.search(GEMM, name)
            else "int8 convs: quantize, im2col and dequantize passes")


def trace(fn, steps: int, path: str) -> dict:
    """Run fn() ``steps`` times under the profiler; sum kernel time.  A
    kernel launched inside a ``record_function(INT8_CONV)`` range (its
    launch's correlation id on the host's clock) counts as the int8 conv's;
    there is one only where the caller wraps int8_conv (``int8`` unit)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") == INT8_CONV)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def in_int8_conv(e) -> bool:
        t = launched.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(ranges, (t, float("inf"))) - 1 \
            if t is not None else -1
        return i >= 0 and ranges[i][0] <= t <= ranges[i][1]

    by = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in kernels:
        label = (int8_conv_group(e["name"]) if ranges and in_int8_conv(e)
                 else group_of(e["name"]))
        by[label][0] += e["dur"] / 1e3
        by[label][1] += 1
        spans.append((e["ts"], e["ts"] + e["dur"]))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "groups": {k: v for k, v in sorted(by.items(),
                                               key=lambda kv: -kv[1][0])}}


def report(name: str, res: dict, units: int, unit: str) -> None:
    span, busy = res["wall_ms"] / units, res["busy_ms"] / units
    print(f"[{name}] per {unit}: span_ms={span:.3f} busy_ms={busy:.3f} "
          f"idle_share={1 - busy / span:.4f}", flush=True)
    for label, (ms, n) in res["groups"].items():
        print(f"[{name}]   {ms / units:9.3f} ms  {n / units:7.1f} launches  "
              f"{label}", flush=True)


UNITS = ("cached", "int8", "int8_all", "stream_k1", "stream_k8", "cp_window",
         "cp_rope", "image",
         "train", "vitg_cached", "vitg_int8", "v1_train")


def profile_cached(model, frames, out: str, name: str) -> None:
    """Three cached windows of ``model`` after a full one and a warm-up."""
    from vdn_torch.pipelines.infer_video import (KEYFRAMES, OVERLAP,
                                                 gather_seed_features)
    x = cs.window_input(frames)
    with torch.no_grad():
        _, feats = model.forward_window(x)
        seed = gather_seed_features(
            feats, torch.tensor(KEYFRAMES, device=cs.DEVICE))
        x_new = x[:, OVERLAP:]
        model.forward_window_cached(x_new, seed)
        res = trace(lambda: model.forward_window_cached(x_new, seed), 3,
                    os.path.join(out, f"{name}.json"))
    report(name, res, 3, "window")


def profile_video(units, out: str, encoder: str = "vitl") -> None:
    from vdn_torch.pipelines.stream import VideoDepthStreamPipeline
    model = cs.build_model(encoder)
    frames = cs.synthetic_clip()
    prefix = "" if encoder == "vitl" else f"{encoder}_"
    if f"{prefix}cached" in units:
        profile_cached(model, frames, out, f"{prefix}cached")

    if f"{prefix}int8" in units:
        profile_int8(model, frames, out, f"{prefix}int8", encoder)

    if encoder == "vitl" and "int8_all" in units:
        with cs.flash_int8("all"):
            profile_int8(model, frames, out, "int8_all")

    if f"{prefix}stream_k1" in units:
        pipe = VideoDepthStreamPipeline(model, input_size=cs.SIZE)
        for f in frames[:12]:
            pipe.infer_video_depth_one(f)
        it = iter(frames[12:16])
        res = trace(lambda: pipe.infer_video_depth_one(next(it)), 4,
                    os.path.join(out, "stream_k1.json"))
        report("stream_k1", res, 4, "frame")

    if f"{prefix}stream_k8" in units:
        pipe = VideoDepthStreamPipeline(model, input_size=cs.SIZE)
        pipe.infer_video_depth_chunk(list(frames[:8]))
        chunks = iter([list(frames[8:16]), list(frames[16:24])])
        res = trace(lambda: pipe.infer_video_depth_chunk(next(chunks)), 2,
                    os.path.join(out, "stream_k8.json"))
        report("stream_k8", res, 16, "frame")

    if f"{prefix}cp_window" in units:
        profile_cp_window(model, frames, out)


def profile_cp_window(model, frames, out: str) -> None:
    """Three full windows of the context-parallel model (``ring_pallas``)
    on a world of one rank, after a warm-up window."""
    import torch.distributed as dist
    from vdn_torch.parallel.context import (make_context_parallel_forward,
                                            set_cp_mode)
    from vdn_torch.parallel.launch import initialize_distributed
    from vdn_torch.parallel.mesh import make_mesh
    initialize_distributed()
    fwd = make_context_parallel_forward(cs.build_cp_model(model),
                                        make_mesh(seq=1))
    x = cs.window_input(frames)
    set_cp_mode("ring_pallas")
    fwd(x)
    res = trace(lambda: fwd(x), 3, os.path.join(out, "cp_window.json"))
    report("cp_window", res, 3, "window")
    dist.destroy_process_group()


def profile_cp_rope(out: str) -> None:
    """One RoPE clip of chip_smoke.py's ``rope_clip`` under ``auto`` on a
    world of one rank, after a warm-up clip."""
    import torch.distributed as dist
    from vdn_torch.parallel.context import (make_context_parallel_forward,
                                            set_cp_mode)
    from vdn_torch.parallel.launch import initialize_distributed
    from vdn_torch.parallel.mesh import make_mesh
    initialize_distributed()
    model, x = cs.rope_clip()
    fwd = make_context_parallel_forward(model, make_mesh(seq=1))
    set_cp_mode("auto")
    with torch.no_grad():
        fwd(x)
        res = trace(lambda: fwd(x), 1, os.path.join(out, "cp_rope.json"))
    report("cp_rope", res, 1, "clip")
    dist.destroy_process_group()


def profile_int8(model, frames, out: str, name: str = "int8",
                 encoder: str = "vitl") -> None:
    """The cached window of ``model``'s weights in int8_static, calibrated
    on one full window; each int8 conv call inside an INT8_CONV range."""
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    from vdn_torch.nn import layers
    from vdn_torch.pipelines.infer_video import (KEYFRAMES, OVERLAP,
                                                 gather_seed_features)
    q = cs.quantized_model(build_video_depth_anything, model, "int8_static",
                           encoder)
    x = cs.window_input(frames)
    conv = layers.int8_conv

    def traced_conv(*args, **kw):
        with torch.profiler.record_function(INT8_CONV):
            return conv(*args, **kw)

    layers.int8_conv = traced_conv
    try:
        with torch.no_grad():
            with layers.quant_calibration(q):
                _, feats = q.forward_window(x)
            seed = gather_seed_features(
                feats, torch.tensor(KEYFRAMES, device=cs.DEVICE))
            x_new = x[:, OVERLAP:]
            q.forward_window_cached(x_new, seed)
            res = trace(lambda: q.forward_window_cached(x_new, seed), 3,
                        os.path.join(out, f"{name}.json"))
    finally:
        layers.int8_conv = conv
    report(name, res, 3, "window")


def profile_image(out: str) -> None:
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    model = cs.build_image_model()
    images = [f[..., ::-1].copy() for f in cs.synthetic_clip()[:12]]
    pipe = DepthAnythingV2Pipeline(model, capacity=cs.MEM_CAPACITY)
    for img in images[:8]:
        pipe.infer_image(img, cs.SIZE)
    it = iter(images[8:])
    res = trace(lambda: pipe.infer_image(next(it), cs.SIZE), 4,
                os.path.join(out, "image.json"))
    report("image", res, 4, "frame")


def profile_train(out: str) -> None:
    import numpy as np
    from vdn_torch.train.trainer import RefineTrainer
    batch = cs.train_batch(np.random.default_rng(cs.SEED))
    model = cs.build_refine_model(batch)[0]
    trainer = RefineTrainer(model, initial_lr=cs.TRAIN_LR)
    trainer.train_step(batch)
    res = trace(lambda: trainer.train_step(batch), 2,
                os.path.join(out, "train.json"))
    report("train", res, 2, "step")


def profile_v1_train(out: str) -> None:
    import numpy as np
    from vdn_torch.train.trainer import V1Trainer
    with cs.exact_fp32():
        batch = cs.v1_batch(np.random.default_rng(cs.SEED + 7))
        trainer = V1Trainer(cs.build_v1_model(), initial_lr=cs.V1_LR,
                            weight_decay=cs.V1_WEIGHT_DECAY)
        trainer.train_step(batch)
        res = trace(lambda: trainer.train_step(batch), 2,
                    os.path.join(out, "v1_train.json"))
    report("v1_train", res, 2, "step")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile",
                    help="directory for the chrome traces")
    ap.add_argument("--units", nargs="+", choices=UNITS, default=UNITS,
                    help="what to trace (default: everything)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    cs.environment()
    cs.build_kernels()
    if set(args.units) & {"cached", "int8", "int8_all", "stream_k1",
                          "stream_k8", "cp_window"}:
        profile_video(args.units, args.out)
    if set(args.units) & {"vitg_cached", "vitg_int8"}:
        torch.cuda.empty_cache()
        profile_video(args.units, args.out, "vitg")
    if "cp_rope" in args.units:
        torch.cuda.empty_cache()
        profile_cp_rope(args.out)
    if "image" in args.units:
        profile_image(args.out)
    if "train" in args.units:
        profile_train(args.out)
    if "v1_train" in args.units:
        torch.cuda.empty_cache()
        profile_v1_train(args.out)


if __name__ == "__main__":
    main()
