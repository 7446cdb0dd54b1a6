"""Smoke run of the PyTorch / CUDA port (vdn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from vdn_torch/csrc, holds each one
against its plain PyTorch version at the clip-depth path's own shapes,
then drives the main path -- VideoDepthAnything vitl at 518 x 518, bf16,
seeded random weights, ``infer_video_depth`` over a 54-frame synthetic
clip (three 32-frame windows: one full, two with the cross-window encoder
cache) -- and checks that every kernel of the path ran, that the depth is
finite and not degenerate, and that it matches the same run through the
plain versions.  Prints one line per phase; the line before the last is
a JSON summary of the kernels, and the last line is
``{"ok": true, "device": {...}}``.  Any failure exits nonzero and prints
no last line.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_FRAMES = 54
SIZE = 518
# (BN spatial tokens, C) of the four motion modules at vitl 518
MOTION_SHAPES = [(1369, 1024), (361, 1024), (1369, 256), (5476, 256)]
CACHED_FRAMES = 22   # new frames encoded per cached window
VIT_TOKENS = 1370
KERNEL_ULPS = 4      # kernel vs plain: bf16 ulps at the output's scale
E2E_DRIFT_FACTOR = 2.0


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


# ---------------------------------------------------------------- phase 1
def environment() -> dict:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    log("env", device=repr(dev["kind"]), count=dev["count"],
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    print(smi, flush=True)
    return dev


# ---------------------------------------------------------------- phase 2
def build_kernels() -> None:
    from vdn_torch import kernels
    t0 = time.perf_counter()
    kernels.build()
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        dir=kernels.BUILD_DIR)


# ---------------------------------------------------------------- phase 3
def _rand(rng, shape, scale=1.0, offset=0.0):
    return torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32) * scale + offset)


def kernel_cases(rng):
    """(kernel name, shape label, kernel fn, plain fn) at the path's shapes;
    inputs bf16 on the card, parameters fp32 as the model stores them."""
    from vdn_torch.kernels import flash_attention as fa, geglu, mlp
    from vdn_torch.kernels import temporal_attention as ta
    from vdn_torch.nn.motion import sinusoidal_positional_encoding
    dev, bf = "cuda", torch.bfloat16
    cases = []

    qkv = _rand(rng, (CACHED_FRAMES, VIT_TOKENS, 3, 16, 64)).to(dev, bf)
    cases.append(("flash_attention_fused_qkv", "B22 T1370 H16 D64",
                  lambda qkv=qkv: fa.flash_attention_fused_qkv(qkv),
                  lambda qkv=qkv: fa.flash_attention_fused_qkv_plain(qkv)))

    c, f = 1024, 4096
    x = _rand(rng, (CACHED_FRAMES, VIT_TOKENS, c)).to(dev, bf)
    p = [t.to(dev) for t in (
        _rand(rng, (c,), 0.1, 1.0), _rand(rng, (c,), 0.1),
        _rand(rng, (f, c), c ** -0.5), _rand(rng, (f,), 0.1),
        _rand(rng, (c, f), f ** -0.5), _rand(rng, (c,), 0.1),
        _rand(rng, (c,), 0.5))]
    cases.append(("fused_ln_mlp_residual", f"rows {CACHED_FRAMES}x1370 C1024",
                  lambda x=x, p=p: mlp.fused_ln_mlp_residual(x, *p),
                  lambda x=x, p=p: mlp.fused_ln_mlp_residual_plain(x, *p)))

    for bn, c in MOTION_SHAPES:
        x = _rand(rng, (bn, 32, c)).to(dev, bf)
        pe = torch.from_numpy(sinusoidal_positional_encoding(c, 32)).to(dev)
        w = [_rand(rng, (c, c), c ** -0.5).to(dev) for _ in range(4)]
        bo = _rand(rng, (c,), 0.1).to(dev)
        scale = (c // 8) ** -0.5
        cases.append((
            "temporal_attention_block", f"BN{bn} T32 C{c}",
            lambda x=x, pe=pe, w=w, bo=bo, s=scale:
                ta.temporal_attention_block(x, pe, *w, bo, 8, s),
            lambda x=x, pe=pe, w=w, bo=bo, s=scale:
                ta.temporal_attention_block_plain(x, pe, *w, bo, 8, s)))

    for bn, c in MOTION_SHAPES:
        f = 4 * c
        x = _rand(rng, (bn, 32, c)).to(dev, bf)
        p = [t.to(dev) for t in (
            _rand(rng, (c,), 0.1, 1.0), _rand(rng, (c,), 0.1),
            _rand(rng, (2 * f, c), c ** -0.5), _rand(rng, (2 * f,), 0.1),
            _rand(rng, (c, f), f ** -0.5), _rand(rng, (c,), 0.1))]
        cases.append(("fused_ln_geglu_residual", f"BN{bn} T32 C{c}",
                      lambda x=x, p=p: geglu.fused_ln_geglu_residual(x, *p),
                      lambda x=x, p=p:
                          geglu.fused_ln_geglu_residual_plain(x, *p)))
    return cases


def check_kernels() -> dict:
    """Kernel vs plain on the card.  Tolerance: KERNEL_ULPS bf16 ulps at
    the scale of the plain output.  Both versions round at the same points;
    they differ in the order of the fp32 sums (and, for A1, in the online
    softmax rounding p against the running max), which can move a rounded
    intermediate by one ulp and the output by a few."""
    rng = np.random.default_rng(SEED)
    summary = {}
    for name, label, kern, plain in kernel_cases(rng):
        got = kern().float()
        want = plain().float()
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        tol = KERNEL_ULPS * bf16_ulp(scale)
        finite = bool(torch.isfinite(got).all())
        ms, plain_ms = time_ms(kern), time_ms(plain)
        log("kernel", name=name, shape=repr(label),
            max_abs_err=f"{err:.3e}", max_rel_err=f"{err / scale:.3e}",
            tol=f"{tol:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
        if not finite or not err <= tol:
            fail(f"{name} {label}: max abs err {err} > tol {tol}")
        s = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                      "plain_ms": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        del got, want
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------- phase 4
def build_model():
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    gen = torch.Generator().manual_seed(SEED)
    model = build_video_depth_anything(
        "vitl", compute_dtype=torch.bfloat16, device="cpu", generator=gen)
    with torch.no_grad():
        # proj_out is zero-initialized (the mixer starts as identity); give
        # it small random weights so A3 and A4 reach the depth
        for mm in model.head.motion_modules:
            w = mm.temporal_transformer.proj_out.weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.5 * w.shape[1] ** -0.5)
    return model.to("cuda")


def window_input(frames) -> torch.Tensor:
    from vdn_torch.pipelines.infer_video import INFER_LEN
    from vdn_torch.pipelines.transform import preprocess_frame
    return torch.from_numpy(np.stack([preprocess_frame(f, SIZE)
                                      for f in frames[:INFER_LEN]])[None]).cuda()


def calibrate_output_bias(model, frames) -> float:
    """Set the last conv's bias so that a quarter of the first window's
    pixels fall below zero: the final ReLU then neither zeroes the map nor
    lets a constant offset hide the relative error of the depth."""
    conv = model.head.scratch.output_conv2
    seen = []
    hook = conv.register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        with torch.no_grad():
            model.forward_window(window_input(frames))
    finally:
        hook.remove()
    z = seen[0].flatten()[::97].float()
    with torch.no_grad():
        conv[2].bias.sub_(torch.quantile(z, 0.25))
    return conv[2].bias.item()


def synthetic_clip() -> np.ndarray:
    """54 RGB frames 518 x 518 uint8: a drifting colour gradient + noise."""
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    frames = []
    for i in range(N_FRAMES):
        ph = 2 * np.pi * i / N_FRAMES
        base = np.stack([np.sin(3 * xx + ph), np.cos(2 * yy - ph),
                         np.sin(2 * (xx + yy) + 2 * ph)], -1)
        img = 127.5 * (1 + 0.8 * base) + rng.normal(0, 12, base.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)


def run_main_path(model, frames):
    from vdn_torch import kernels
    from vdn_torch.pipelines.infer_video import infer_video_depth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    depth, _ = infer_video_depth(model, frames, 30.0, input_size=SIZE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    if depth.shape != (N_FRAMES, SIZE, SIZE):
        fail(f"depth shape {depth.shape}")
    if not np.isfinite(depth).all():
        fail("non-finite depth")
    std, pos = float(depth.std()), float((depth > 0).mean())
    if not (std > 0 and pos > 0.01):
        fail(f"degenerate depth: std {std}, positive share {pos}")
    if min(counts.values()) < 1:
        fail(f"a kernel of the path never launched: {counts}")
    log("main", shape=list(depth.shape), mean=f"{depth.mean():.5g}",
        std=f"{std:.5g}", positive_share=f"{pos:.4f}",
        wall_s=f"{wall:.3f}", peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    return depth, counts


def time_windows(model, frames) -> None:
    """ms per full and per cached window (CUDA events, median of 5)."""
    from vdn_torch.pipelines.infer_video import (INFER_LEN, KEYFRAMES,
                                                 OVERLAP,
                                                 gather_seed_features)
    x = window_input(frames)
    with torch.no_grad():
        _, feats = model.forward_window(x)
        seed = gather_seed_features(
            feats, torch.tensor(KEYFRAMES, device="cuda"))
        x_new = x[:, OVERLAP:]
        full_ms = time_ms(lambda: model.forward_window(x), reps=5, warmup=1)
        cached_ms = time_ms(lambda: model.forward_window_cached(x_new, seed),
                            reps=5, warmup=1)
    log("windows", full_window_ms=f"{full_ms:.2f}",
        cached_window_ms=f"{cached_ms:.2f}",
        cached_fps_32_per_window=f"{INFER_LEN / cached_ms * 1e3:.3f}",
        new_frames_per_s=f"{(INFER_LEN - OVERLAP) / cached_ms * 1e3:.3f}")


# ---------------------------------------------------------------- phase 5
def drift(ref: np.ndarray, out: np.ndarray) -> dict:
    """PARITY.md's bf16 drift protocol: lstsq scale/shift of out onto ref,
    then delta1 and AbsRel over ref's pixels above its 5th percentile."""
    a, b = ref.reshape(-1).astype(np.float64), out.reshape(-1).astype(
        np.float64)
    s, t = np.linalg.lstsq(np.stack([b, np.ones_like(b)], 1), a,
                           rcond=None)[0]
    b_al = s * b + t
    pos = a > np.percentile(a, 5)
    eps = 1e-6
    ratio = np.maximum(a[pos] / np.maximum(b_al[pos], eps),
                       b_al[pos] / np.maximum(a[pos], eps))
    return {"delta1": float((ratio < 1.25).mean()),
            "absrel": float((np.abs(a[pos] - b_al[pos]) / a[pos]).mean()),
            "rel_l2": float(np.linalg.norm(a - b) / np.linalg.norm(a))}


def reference_runs(model, frames, depth) -> None:
    """The same clip and weights through the plain versions on the card,
    in bf16 and in fp32.  Gate: the kernels' run may sit no further from
    the plain bf16 run than E2E_DRIFT_FACTOR times bf16's own distance
    from fp32 -- two bf16 paths that round at the same points but sum in
    another order are two draws of the same rounding noise."""
    from vdn_torch import kernels
    from vdn_torch.pipelines.infer_video import infer_video_depth
    kernels.reset_launches()
    with kernels.plain_reference():
        plain_bf16, _ = infer_video_depth(model, frames, 30.0, SIZE)
        model.compute_dtype = torch.float32
        try:
            plain_fp32, _ = infer_video_depth(model, frames, 30.0, SIZE)
        finally:
            model.compute_dtype = torch.bfloat16
    if any(kernels.launches.values()):
        fail(f"kernels launched inside plain_reference: {kernels.launches}")
    vs_plain = drift(plain_bf16, depth)
    bf16_drift = drift(plain_fp32, plain_bf16)
    vs_fp32 = drift(plain_fp32, depth)
    tol = E2E_DRIFT_FACTOR * bf16_drift["rel_l2"]
    log("reference", kernels_vs_plain_bf16=json.dumps(vs_plain),
        plain_bf16_vs_fp32=json.dumps(bf16_drift),
        kernels_vs_fp32=json.dumps(vs_fp32), rel_l2_tol=f"{tol:.3e}")
    if not np.isfinite(plain_fp32).all() or not vs_plain["rel_l2"] <= tol:
        fail(f"kernels' depth vs plain bf16: rel_l2 {vs_plain['rel_l2']} "
             f"> {tol}")


# ---------------------------------------------------------------- main
SOURCES = {
    "flash_attention_fused_qkv": ("vdn_torch/csrc/flash_attn_qkv.cu",
                                  "vdn/ops/pallas/flash_attention.py:496"),
    "fused_ln_mlp_residual": ("vdn_torch/csrc/ln_mlp.cu",
                              "vdn/ops/pallas/mlp.py:489"),
    "temporal_attention_block": ("vdn_torch/csrc/temporal_attn.cu",
                                 "vdn/ops/pallas/temporal_attention.py:264"),
    "fused_ln_geglu_residual": ("vdn_torch/csrc/ln_geglu.cu",
                                "vdn/ops/pallas/geglu.py:122"),
}


def main() -> None:
    device = environment()
    build_kernels()
    summary = check_kernels()
    model = build_model()
    frames = synthetic_clip()
    log("model", output_bias=f"{calibrate_output_bias(model, frames):.6g}")
    depth, counts = run_main_path(model, frames)
    time_windows(model, frames)
    reference_runs(model, frames, depth)
    # ms / plain_ms: summed over the kernel's shapes in check_kernels
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": counts[name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (src, tpu) in SOURCES.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
