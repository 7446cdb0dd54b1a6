"""Smoke run of the PyTorch / CUDA port (vdn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT   # F4, C2 fp32 and the paths that
                                        # run them: a parent checkout
                                        # against this one (ab_tree)

Builds the hand-written CUDA kernels from vdn_torch/csrc, holds each one
against its plain PyTorch version at the main paths' own shapes (and times
it beside its bound and, where one exists, a single PyTorch call that
computes the same function), then drives the main paths at vitl, 518 x
518, bf16, seeded random weights.  VideoDepthAnything:

- the clip path, ``infer_video_depth`` over a 54-frame synthetic clip
  (three 32-frame windows: one full, two with the cross-window encoder
  cache);
- the streaming path, ``VideoDepthStreamPipeline`` over 24 frames of the
  same clip per frame (k = 1, past the gap-41 eviction at frame 11) and in
  chunks of 8.

DepthAnythingV2 with its six-slot memory bank and MetricDepthAnythingV2:

- the single-image path, ``DepthAnythingV2Pipeline.infer_image`` over 10
  frames of the clip (the bank fills at frame 6 and shifts from frame 7),
  then ``clear_memory()`` and 3 frames of a 480 x 640 image (a 37 x 49
  token grid and a final resize to the image's size); the bank must change
  the depth;
- metric depth, one 518 x 518 batch through the sigmoid head.

The int8 serving mode, ``quantize="int8_static"`` and ``"int8"``, on the
same weights: the clip (54 frames; ms per cached and full window), 12
streamed frames at k = 1 and k = 8, and 8 images through the bank, each
with the launches per encoder pass (F1, F3, F4 and A1, no A2 and no float
encoder Linear) and the int8 convs the gate predicts; int8_static's
recalibration after ``clear_memory()`` must keep the running max.
Then F6, the int8 flash attention, under ``VDN_FLASH_INT8="all"``:
int8_static's clip (54 frames), one uncached window
(``cache_encoder=False``), 12 frames streamed at k = 1 and 8 images,
vitg's int8 clip; and one cached vitl window each in "qk" and "pv"; each
with F6 in place of A1 in the launches per encoder pass, the clip, stream
and images held to the plain int8 runs in the same mode.

vitg (DINOv2 ViT-g/14 with its SwiGLU FFN, Depth Anything V2 Giant) at
full width: the clip in bf16, int8_static and int8 (F5 carries the int8
FFN), 12 frames streamed at k = 1, and 8 images through the bank, then
``clear_memory()`` and the 480 x 640 images, on the kernels at its widths
(A3 at dh 192 / 48, A6 at C 192, B1 on 384-lane rings).

Context parallel over the frame axis, on a world of one rank (NCCL) and a
(1, 1, 1) mesh: E1, the ring-attention step, over a ring of 4 K / V blocks
in one process against the plain ring and SDPA (local T 8, 32, 128); the
32-frame vitl window through ``make_context_parallel_forward`` with
``seq_axis="seq"`` on the main model's weights (``ring_pallas``: E1 8
times, A3 never; ``auto``: no E1), against the plain model's window and
its own plain run; the two CP streaming decodes (``_cached_cp`` for one
frame, one chunk window of 8 frames) against the local ones; one backward
through the ring of E1.

The v1 research model (dual hieradet encoders at hiera_base's width and
the sangyu head), fp32 as vdn trains it, at 256 x 256 and b2 x s8:
V1Trainer for 1 + 5 steps (C2 at fp32 / D 96 and its backward D2 at the
six global blocks, A5a / A5b forward and backward; the head's unused
parameters move by the weight decay alone), the gradient fidelity at b1 x
s4 against the plain fp32 run, the model under no_grad on one clip, and
the MAE Hiera's published hiera_base_224 at 224 x 224 (no kernel there).

Each path runs with the launch counts set to 0 just before it and read
just after, and fails if a kernel of the path never launched.  Depth must
be finite and not degenerate, and sit no further from the same run through
the plain versions in bf16 than twice bf16's own distance from fp32; the
k = 8 stream is held to the k = 1 stream by the same gate; an int8 run
sits no further from the plain int8 bf16 run than twice plain bf16's
distance from fp32, measured both on the float path and on the int8 path.
F1-F6 are held to their plain versions with a gate of their own
(int8_check: operands equal but at ties), F6 in each mode at the cached
and full windows, a frame, the 480 x 640 image and vitg's window; C3, the
head-major fused-qkv attention that no path calls, at the window.  Prints one line
per phase; the line before the last is a JSON summary of the kernels, and
the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
nonzero and prints no last line.  Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
SEED = 0
N_FRAMES = 54
N_STREAM = 24        # frames of the streaming phase (eviction from frame 11)
STREAM_CHUNK = 8     # the CLI's default chunk size
SIZE = 518
# (BN spatial tokens, C) of the four motion modules at vitl 518
MOTION_SHAPES = [(1369, 1024), (361, 1024), (1369, 256), (5476, 256)]
CACHED_FRAMES = 22   # new frames encoded per cached window
VIT_TOKENS = 1370
VIT_GRID = 37        # the pos-embed table's patch grid
# the streaming rings at vitl 518 (h * tokens, lane width): motion modules
# 0 and 1 (C 1024, dh 128) and 2 and 3 (C 256, dh 32)
RING_SHAPES = [(10952, 256), (2888, 256), (10952, 128), (43808, 128)]
# the output island's input: [32 frames, 8 x the token grid, C 128]
ISLAND_FRAMES, ISLAND_C = 32, 128
# the single-image path: frames through the memory bank, then a raw image
# that is not square (480 x 640 -> 518 x 686: a 37 x 49 token grid)
N_IMAGE = 10
N_NONSQUARE = 3
NONSQUARE_HW = (480, 640)
NONSQUARE_GRID = (37, 49)
MEM_CAPACITY = 6
MEM_HEADS = 16
# launches per frame at vitl: steady state (a state is carried), and what
# differs on the first frame (no state: both attentions of a layer are C2)
# and at the non-square image (pos-embed bicubic and the final resize)
IMAGE_LAUNCHES = {"flash_attention_colbias": 4, "flash_attention": 4,
                  "flash_attention_fused_qkv": 24,
                  "fused_ln_mlp_residual": 24, "fused_resize_island": 1,
                  "resize_rows": 5, "resize_mid_axis": 4}
IMAGE_FIRST = {"flash_attention_colbias": 0, "flash_attention": 8}
IMAGE_NONSQUARE = {"resize_rows": 7, "resize_mid_axis": 6}
METRIC_LAUNCHES = {**IMAGE_LAUNCHES, "flash_attention_colbias": 0,
                   "flash_attention": 0}
MEMORY_PROBE = 7     # the 8th frame: the bank is full and has shifted once
KERNEL_ULPS = 4      # kernel vs plain: bf16 ulps at the output's scale
FP32_RTOL = 1e-5     # kernel vs plain for the fp32 cases, at the output's scale
E2E_DRIFT_FACTOR = 2.0
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
FP32_FLOPS = 67e12   # fp32 outside the tensor cores
TF32_TENSOR_FLOPS = 495e12
# vitg (DINOv2 ViT-g/14, SwiGLU FFN) at full width: embed 1536, 40 blocks
# of 24 heads, DPT features 384; its motion modules at C 1536 / 384 (dh 192
# / 48), its rings 384 / 128 lanes wide, its output island at C 192
VITG_HEADS = 24
VITG_MOTION_SHAPES = [(1369, 1536), (361, 1536), (1369, 384), (5476, 384)]
VITG_RING_SHAPES = [(10952, 384), (2888, 384), (10952, 128), (43808, 128)]
VITG_ISLAND_C = 192
VITG_FEATURES = 384
N_VITG_STREAM = 12
N_VITG_IMAGE = 8
# the int8 kernels (F1-F6): int8 operands may differ from the plain
# version's at quantization ties only, on at most this share, by one; the
# output within KERNEL_ULPS outside the rows with a tie and INT8_REL_L2 of
# the plain output overall
INT8_TIE_SHARE = 1e-3
INT8_REL_L2 = 1e-3
# F4's four kernels by their names in the profiler's trace: the LN + quantize
# row kernel, fc1 (GELU epilogue: the fp32 hidden and its absmax), the
# hidden's quantizer, fc2 (csrc/ln_mlp_int8.cu)
F4_STAGES = {"row": r"ln_quant_rows", "fc1": r"EpiHidden",
             "hidden": r"quant_hidden", "fc2": r"EpiI8Residual"}
# F6's modes (VDN_FLASH_INT8): int8 QK^T, int8 P V, both
F6_MODES = ("qk", "pv", "all")
# context parallel: the ring of K / V blocks E1 is held over in one process
# (the order rank 0 of a seq group of CP_RANKS sees them)
CP_RANKS = 4


START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One line per phase, with the seconds since the script started."""
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items())
          + f" elapsed_s={time.perf_counter() - START:.1f}", flush=True)


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


def kernel_ms(fn, patterns: dict, reps: int = 10) -> dict:
    """Device ms per call of fn()'s kernels, grouped by the regular
    expressions of ``patterns`` ({group: pattern}; a kernel in the first
    group whose pattern its name matches, else in "other"), from
    torch.profiler's trace of ``reps`` calls after a warm-up call."""
    import re
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {k: 0.0 for k in patterns}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        group = next((k for k, p in patterns.items()
                      if re.search(p, e["name"])), "other")
        out[group] = out.get(group, 0.0) + e["dur"] / 1e3 / reps
    return out


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
def _rand(rng, shape, scale=1.0, offset=0.0, device=None):
    """fp32 normal draws * scale + offset, made on ``device`` (DEVICE by
    default) by a torch generator seeded from ``rng``: numpy's generator
    takes seconds for each window-sized input on the host."""
    dev = torch.device(device or DEVICE)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 62)))
    return torch.randn(tuple(shape), generator=g, device=dev) * scale + offset


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(work) -> tuple:
    """(least ms, "bytes" or "operations"): the bytes the function must
    move (each input read once, each output written once) over the memory
    rate, against its operations over the peak rate for their type.  The
    tensor cores and the fp32 FMA units run side by side, so the
    operations take as long as the busiest of the two; int8, bf16 and
    TF32 products share the tensor cores, so their times add (F6's
    modes)."""
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S
    per_unit = {}
    for flops, peak in ops:
        unit = "tensor" if peak in (BF16_TENSOR_FLOPS, INT8_TENSOR_OPS,
                                    TF32_TENSOR_FLOPS) else peak
        per_unit[unit] = per_unit.get(unit, 0.0) + flops / peak
    t_ops = max(per_unit.values(), default=0.0)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def case(name, label, kern, plain, work, path, library=None, tol="bf16",
         library_base=None, check=None, bf16=None, stages=None):
    """One kernel at one shape.  ``kern`` and ``plain`` return a tensor or a
    tuple of tensors (each held to the tolerance at its own scale); the
    library time is ``library``'s, less ``library_base``'s where given (a
    backward timed as forward + backward minus forward).  ``check``, where
    given, replaces that comparison (the int8 kernels' gate, int8_check);
    ``bf16`` is the bf16 counterpart timed beside an int8 kernel;
    ``stages``, where given, {stage: kernel name pattern}: the device time
    of each stage's kernels, from the profiler (kernel_ms)."""
    return dict(name=name, label=label, kern=kern, plain=plain, work=work,
                path=path, library=library, tol=tol,
                library_base=library_base, check=check, bf16=bf16,
                stages=stages)


def encoder_cases(rng, path, b, t=VIT_TOKENS, h=16, with_a2=True):
    """A1 over h heads and (unless with_a2 is False: vitg's FFN is SwiGLU)
    A2 at b frames of t tokens; inputs bf16 on the card, parameters fp32 as
    the model stores them."""
    import torch.nn.functional as F
    from vdn_torch.kernels import flash_attention as fa, mlp
    dev, bf = DEVICE, torch.bfloat16

    d = 64
    qkv = _rand(rng, (b, t, 3, h, d)).to(dev, bf)
    out = torch.empty((b, t, h * d), dtype=bf, device=dev)
    yield case(
        "flash_attention_fused_qkv", f"B{b} T{t} H{h} D64",
        lambda qkv=qkv: fa.flash_attention_fused_qkv(qkv),
        lambda qkv=qkv: fa.flash_attention_fused_qkv_plain(qkv),
        (_nbytes(qkv, out), [(4 * b * h * t * t * d, BF16_TENSOR_FLOPS)]),
        path, library=lambda qkv=qkv: F.scaled_dot_product_attention(
            *(qkv[:, :, i].transpose(1, 2) for i in range(3))))
    if not with_a2:
        return

    c, f = 1024, 4096
    x = _rand(rng, (b, t, c)).to(dev, bf)
    p = [a.to(dev) for a in (
        _rand(rng, (c,), 0.1, 1.0), _rand(rng, (c,), 0.1),
        _rand(rng, (f, c), c ** -0.5), _rand(rng, (f,), 0.1),
        _rand(rng, (c, f), f ** -0.5), _rand(rng, (c,), 0.1),
        _rand(rng, (c,), 0.5))]
    rows = x.numel() // c
    yield case(
        "fused_ln_mlp_residual", f"rows {b}x{t} C1024",
        lambda x=x, p=p: mlp.fused_ln_mlp_residual(x, *p),
        lambda x=x, p=p: mlp.fused_ln_mlp_residual_plain(x, *p),
        (2 * _nbytes(x) + _nbytes(*p), [(4 * rows * c * f,
                                         BF16_TENSOR_FLOPS)]), path)


def motion_cases(rng, path, t, with_a3=True, shapes=None):
    """A3 (unless with_a3 is False) and A4 at the four motion modules'
    shapes (MOTION_SHAPES, vitl's, by default) over t frames."""
    from vdn_torch.kernels import geglu
    from vdn_torch.kernels import temporal_attention as ta
    from vdn_torch.nn.motion import sinusoidal_positional_encoding
    dev, bf = DEVICE, torch.bfloat16
    shapes = shapes or MOTION_SHAPES

    for bn, c in shapes if with_a3 else ():
        x = _rand(rng, (bn, t, c)).to(dev, bf)
        pe = torch.from_numpy(sinusoidal_positional_encoding(c, 32)[:t]).to(
            dev)
        w = [_rand(rng, (c, c), c ** -0.5).to(dev) for _ in range(4)]
        bo = _rand(rng, (c,), 0.1).to(dev)
        scale = (c // 8) ** -0.5
        flops = 8 * bn * t * c * c + 4 * bn * t * t * c
        yield case(
            "temporal_attention_block", f"BN{bn} T{t} C{c}",
            lambda x=x, pe=pe, w=w, bo=bo, s=scale:
                ta.temporal_attention_block(x, pe, *w, bo, 8, s),
            lambda x=x, pe=pe, w=w, bo=bo, s=scale:
                ta.temporal_attention_block_plain(x, pe, *w, bo, 8, s),
            (2 * _nbytes(x) + _nbytes(pe, bo, *w),
             [(flops, BF16_TENSOR_FLOPS)]), path)

    for bn, c in shapes:
        f = 4 * c
        x = _rand(rng, (bn, t, c)).to(dev, bf)
        p = [a.to(dev) for a in (
            _rand(rng, (c,), 0.1, 1.0), _rand(rng, (c,), 0.1),
            _rand(rng, (2 * f, c), c ** -0.5), _rand(rng, (2 * f,), 0.1),
            _rand(rng, (c, f), f ** -0.5), _rand(rng, (c,), 0.1))]
        yield case(
            "fused_ln_geglu_residual", f"BN{bn} T{t} C{c}",
            lambda x=x, p=p: geglu.fused_ln_geglu_residual(x, *p),
            lambda x=x, p=p: geglu.fused_ln_geglu_residual_plain(x, *p),
            (2 * _nbytes(x) + _nbytes(*p),
             [(6 * bn * t * c * f, BF16_TENSOR_FLOPS)]), path)


def _taps(w) -> int:
    """Nonzero weights of a resize plan: the multiply-adds per row."""
    return int(np.count_nonzero(w))


def fusion_passes(n, grid=None, c=256):
    """The four DPT fusion upsamples (refinenet4, 3, 2, 1) over n frames of
    a ``grid`` of tokens (the square VIT_GRID by default), bf16, at the
    head's features c (vitl's 256 by default): from the stride-2 layer's
    half grid up to 8 x the grid.  A pass is (label, N, H in, H out, W in,
    W out, C, dtype, method, (H scale, W scale) or None)."""
    h, w = ([(g + 1) // 2, g, 2 * g, 4 * g, 8 * g]
            for g in grid or (VIT_GRID, VIT_GRID))
    return [(f"refinenet{4 - i} {h[i]}x{w[i]}->{h[i + 1]}x{w[i + 1]}", n,
             h[i], h[i + 1], w[i], w[i + 1], c, torch.bfloat16, "bilinear",
             None) for i in range(4)]


def pos_embed_pass(grid=None):
    """The ViT pos-embed bicubic (fp32) from the table's grid to ``grid``
    (the same grid by default), with the offset-0.1 scale factors."""
    gh, gw = grid or (VIT_GRID, VIT_GRID)
    return (f"pos-embed {VIT_GRID}x{VIT_GRID}->{gh}x{gw} bicubic", 1,
            VIT_GRID, gh, VIT_GRID, gw, 1024, torch.float32, "bicubic",
            ((gh + 0.1) / VIT_GRID, (gw + 0.1) / VIT_GRID))


# the single-image pipeline's resize of the depth to a 480 x 640 image
# (fp32, C = 1)
FINAL_RESIZE_PASS = (
    f"depth {14 * NONSQUARE_GRID[0]}x{14 * NONSQUARE_GRID[1]}->"
    f"{NONSQUARE_HW[0]}x{NONSQUARE_HW[1]}", 1, 14 * NONSQUARE_GRID[0],
    NONSQUARE_HW[0], 14 * NONSQUARE_GRID[1], NONSQUARE_HW[1], 1,
    torch.float32, "bilinear", None)


def upsample_cases(rng, path, passes):
    """A5a (H pass) and A5b (W pass) of each resize in ``passes``.  The H
    pass multiplies by fp32 weights (fp32 FMA units); the W pass by weights
    rounded to the data's dtype (bf16 tensor cores for bf16)."""
    import torch.nn.functional as F
    from vdn_torch.kernels import resize as rz
    from vdn_torch.ops.resize import plan_axis
    dev = DEVICE

    for label, n, r_in, r_out, wd, w_out, c, dt, method, scale in passes:
        ac = method == "bilinear"
        sh, sw = (None, None) if scale is None else scale
        idx, w = plan_axis(r_out, r_in, method, ac, sh)
        fp32 = dt == torch.float32
        tol = "fp32" if fp32 else "bf16"
        # H pass: [N, in, W, C] -> [N, out, W, C]
        x = _rand(rng, (n, r_in, wd, c)).to(dev, dt)
        y = torch.empty((n, r_out, wd, c), dtype=dt, device=dev)
        mode = dict(mode=method, align_corners=ac)
        size_h = dict(size=(r_out, wd)) if scale is None else dict(
            scale_factor=(sh, 1.0))
        pidx, pw = rz.rows_plan(idx, w, dev)
        yield case(
            "resize_rows", f"{label} N{n} C{c}",
            lambda x=x, idx=idx, w=w, o=r_out: rz.resize_rows(x, idx, w, o),
            lambda x=x, pidx=pidx, pw=pw: rz.resize_rows_plain(x, pidx, pw),
            (_nbytes(x, y), [(2 * n * wd * c * _taps(w), FP32_FLOPS)]),
            path, library=lambda x=x, kw={**size_h, **mode}: F.interpolate(
                x.permute(0, 3, 1, 2), **kw),
            tol=tol)
        # W pass: [N * out, W_in, C] -> [N * out, W_out, C]
        idx, w = plan_axis(w_out, wd, method, ac, sw)
        x = _rand(rng, (n * r_out, wd, c)).to(dev, dt)
        y = torch.empty((n * r_out, w_out, c), dtype=dt, device=dev)
        dense = rz.dense_plan(idx, w, wd, dt, dev)
        size_w = dict(size=(1, w_out)) if scale is None else dict(
            scale_factor=(1.0, sw))
        yield case(
            "resize_mid_axis", f"{label} N{n * r_out} C{c}",
            lambda x=x, idx=idx, w=w, o=w_out: rz.resize_mid_axis(x, idx, w,
                                                                  o),
            lambda x=x, dense=dense: rz.mix_rows_plain(x, dense),
            (_nbytes(x, y, dense), [(2 * x.shape[0] * c * _taps(w),
                                     FP32_FLOPS if fp32
                                     else BF16_TENSOR_FLOPS)]),
            path, library=lambda x=x, kw={**size_w, **mode}: F.interpolate(
                x[:, None].permute(0, 3, 1, 2), **kw),
            tol=tol)


def island_cases(rng, path, n, h_pass=True, sigmoid=False, grid=None,
                 c=None):
    """A6 over n frames of a ``grid`` of tokens (the square VIT_GRID by
    default) at c channels (ISLAND_C by default), 8 x the grid in and 14 x
    out (with sigmoid: the metric head's activation in place of the ReLU),
    and with h_pass its A5a H pass alone (the input's rows into A6's
    zero-padded plan)."""
    import torch.nn.functional as F
    from vdn_torch.kernels import resize as rz
    from vdn_torch.kernels import resize_island as ri
    from vdn_torch.ops.resize import plan_axis
    dev, bf = DEVICE, torch.bfloat16
    c = c or ISLAND_C
    grid = grid or (VIT_GRID, VIT_GRID)
    (h, wd), (h_out, w_out) = ([8 * g for g in grid], [14 * g for g in grid])
    hp = -(-h_out // ri.TILE_ROWS) * ri.TILE_ROWS + 2
    idx, w = ri.padded_h_plan(*plan_axis(h_out, h, "bilinear", True, None),
                               h_out, hp)
    if h_pass:
        pidx, pw = rz.rows_plan(idx, w, dev)
        x = _rand(rng, (n, h, wd, c)).to(dev, bf)
        y = torch.empty((n, hp, wd, c), dtype=bf, device=dev)
        yield case(
            "resize_rows",
            f"island H pass {h} -> {hp} padded rows W{wd} N{n} C{c}",
            lambda x=x, idx=idx, w=w, o=hp: rz.resize_rows(x, idx, w, o),
            lambda x=x, pidx=pidx, pw=pw: rz.resize_rows_plain(x, pidx, pw),
            (_nbytes(x, y), [(2 * n * wd * c * _taps(w), FP32_FLOPS)]), path,
            # the same rows without the padding
            library=lambda x=x: F.interpolate(x.permute(0, 3, 1, 2),
                                              size=(h_out, wd),
                                              mode="bilinear",
                                              align_corners=True))

    o = 32
    feat = _rand(rng, (n, h, wd, c)).to(dev, bf)
    w1 = _rand(rng, (3, 3, c, o), (9 * c) ** -0.5).to(dev)
    b1 = _rand(rng, (o,), 0.1).to(dev)
    w2 = _rand(rng, (o, 1), o ** -0.5).to(dev)
    b2 = _rand(rng, (1,), 0.1).to(dev)
    out = torch.empty((n, h_out, w_out), dtype=torch.float32, device=dev)
    # conv3x3 and 1x1 on bf16 operands, the W resize with bf16-rounded
    # weights (tensor cores); the H resize with fp32 weights (FMA units)
    px = n * h_out * w_out
    ops = [(2 * px * 9 * c * o + 2 * px * o + 2 * px * c * 2,
            BF16_TENSOR_FLOPS),
           (2 * n * h_out * wd * c * 2, FP32_FLOPS)]
    args = (feat, w1, b1, w2, b2, (h_out, w_out), sigmoid, 1.0)
    yield case(
        "fused_resize_island",
        f"[{n}, {h}, {wd}, {c}] -> [{n}, {h_out}, {w_out}, 1]"
        + (" sigmoid" if sigmoid else ""),
        lambda a=args: ri.fused_resize_island(*a),
        lambda a=args: ri.fused_resize_island_plain(*a),
        (_nbytes(feat, w1, b1, w2, b2, out), ops), path)


def memory_cases(rng, path, h=MEM_HEADS):
    """C2 and C1 over h heads at the memory attention's shapes: the square
    37 x 37 token grid with the bank's masks of 1, 3 and 6 written slots,
    and the 37 x 49 grid of the non-square image with 2.  The bound counts
    what the mask leaves: the live slots' keys and values, and their
    products."""
    import torch.nn.functional as F
    from vdn_torch.kernels import flash_attention as fa
    from vdn_torch.nn.memory import slot_bias
    dev, bf = DEVICE, torch.bfloat16
    d, cap = 64, MEM_CAPACITY
    grids = [(VIT_GRID * VIT_GRID, (1, 3, 6)),
             (NONSQUARE_GRID[0] * NONSQUARE_GRID[1], (2,))]
    for hw, counts in grids:
        q = _rand(rng, (1, hw, h, d)).to(dev, bf)
        k, v = (_rand(rng, (1, cap * hw, h, d)).to(dev, bf) for _ in "kv")
        ks, vs = k[:, :hw].contiguous(), v[:, :hw].contiguous()
        yield case(
            "flash_attention", f"Tq{hw} Tk{hw} H{h} D{d}",
            lambda a=(q, ks, vs): fa.flash_attention(*a),
            lambda a=(q, ks, vs): fa.flash_attention_plain(*a),
            (_nbytes(q, ks, vs, q), [(4 * h * hw * hw * d,
                                      BF16_TENSOR_FLOPS)]), path,
            library=lambda a=(q, ks, vs): F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in a)))
        for count in counts:
            bias = slot_bias(cap, hw, count, torch.device(dev)).reshape(-1)
            mask = bias.to(bf).reshape(1, 1, 1, -1)
            live = count * hw
            yield case(
                "flash_attention_colbias",
                f"Tq{hw} Tk{cap * hw} H{h} D{d} slots {count}/{cap}",
                lambda a=(q, k, v, bias): fa.flash_attention_colbias(*a),
                lambda a=(q, k, v, bias): fa.flash_attention_colbias_plain(
                    *a),
                (2 * _nbytes(q) + 2 * _nbytes(ks) * count + _nbytes(bias),
                 [(4 * h * hw * live * d, BF16_TENSOR_FLOPS)]), path,
                library=lambda a=(q, k, v), m=mask:
                    F.scaled_dot_product_attention(
                        *(t.transpose(1, 2) for t in a), attn_mask=m))


def ring_cases(rng, path, shapes=None):
    """B1 at the per-frame stream's rings (RING_SHAPES, vitl's, by
    default): 31 of 43 rows by a one-hot."""
    from vdn_torch.kernels import resize as rz
    dev, bf = DEVICE, torch.bfloat16
    for n_rows, m in shapes or RING_SHAPES:
        ring = _rand(rng, (n_rows, 43, m)).to(dev, bf)
        sel = torch.from_numpy(rng.permutation(43)[:31]).to(dev)
        onehot = torch.eye(43, dtype=bf, device=dev)[sel]
        y = torch.empty((n_rows, 31, m), dtype=bf, device=dev)
        yield case(
            "select_rows", f"ring [{n_rows}, 43, {m}] -> 31 rows",
            lambda ring=ring, oh=onehot: rz.select_rows(ring, oh),
            lambda ring=ring, oh=onehot: rz.mix_rows_plain(ring, oh),
            # the one-hot needs 31 of the 43 rows read and one bf16
            # multiply-add per output element
            (2 * _nbytes(y), [(2 * y.numel(), BF16_TENSOR_FLOPS)]), path,
            library=lambda ring=ring, sel=sel: ring.index_select(1, sel))


def int8_check(kern, plain, keys, row_view=None):
    """The int8 kernels' gate: ``kern(ops)`` and ``plain(ops)`` fill an
    operands dict each.  The int8 operands under ``keys`` may differ at
    quantization ties only (at most INT8_TIE_SHARE of them, by one); the
    output is held within KERNEL_ULPS bf16 ulps of the plain output's scale
    on the rows with no tie, and to INT8_REL_L2 overall.  ``row_view(key,
    d)`` gives an operand's differences as [output rows, ...], or None for
    an operand that every output row reads (F6's k and v codes: a tie there
    moves each row by a share of one key); by default every operand is
    [rows, K] in the output's row order."""
    def check():
        ko, po = {}, {}
        got, want = kern(ko), plain(po)
        torch.cuda.synchronize()
        rows = got.numel() // got.shape[-1]
        tie_rows = torch.zeros(rows, dtype=torch.bool, device=got.device)
        n_diff, n_all, worst = 0, 0, 0
        for k in keys:
            d = (ko[k].int() - po[k].int()).abs()
            worst = max(worst, int(d.max()))
            n_diff += int((d > 0).sum())
            n_all += d.numel()
            d = d if row_view is None else row_view(k, d)
            if d is not None:
                tie_rows |= (d > 0).any(1)
        g = got.reshape(rows, -1).float()
        w = want.reshape(rows, -1).float()
        scale = w.abs().max().item()
        keep = ~tie_rows
        err = (g[keep] - w[keep]).abs().max().item() if keep.any() else 0.0
        rel = ((g - w).norm() / w.norm()).item()
        tol = KERNEL_ULPS * bf16_ulp(scale)
        share = n_diff / n_all
        ok = (worst <= 1 and share <= INT8_TIE_SHARE and err <= tol
              and rel <= INT8_REL_L2)
        return err, tol, scale, bool(torch.isfinite(g).all()), ok, {
            "tie_share": f"{share:.3e}",
            "tie_rows": f"{float(tie_rows.float().mean()):.3e}",
            "rel_l2": f"{rel:.3e}"}
    return check


def int8_cases(rng, path, rows, encoder="vitl"):
    """The int8 encoder kernels over ``rows`` tokens, the weights
    pre-quantized as the model caches them: at vitl (C 1024; qkv F 3072,
    MLP F 4096) F1-F4, at vitg (C 1536; qkv F 4608, SwiGLU hidden 4096) F1,
    F3 and F5.  Library: one ``torch._int_mm`` on the same pre-quantized
    operands (the product alone; F4's and F5's two).  bf16 counterpart: the
    float path's cuBLAS qkv and proj GEMMs for F1 / F2 and F3, A2 for F4,
    and the float SwiGLU tail (LN, the two cuBLAS GEMMs, silu, LayerScale,
    residual) for F5."""
    import torch.nn.functional as F
    from vdn_torch.kernels import int8, layer_norm_f32, mlp
    dev, bf = DEVICE, torch.bfloat16
    vitg = encoder == "vitg"
    c, fq, fm = (1536, 4608, 4096) if vitg else (1024, 3072, 4096)
    x = _rand(rng, (1, rows, c)).to(dev, bf)
    att = _rand(rng, (1, rows, c)).to(dev, bf)
    ln = [_rand(rng, (c,), 0.1, 1.0).to(dev), _rand(rng, (c,), 0.1).to(dev)]

    def linear(f, k):
        return (_rand(rng, (f, k), k ** -0.5).to(dev),
                _rand(rng, (f,), 0.1).to(dev))

    (wqkv, bqkv), (wp, bp) = linear(fq, c), linear(c, c)
    (w1, b1), (w2, b2) = linear(2 * fm if vitg else fm, c), linear(c, fm)
    g1, g2 = (_rand(rng, (c,), 0.5).to(dev) for _ in range(2))
    qkv, proj, fc1, fc2 = (int8.quantize_weight_cols(w)
                           for w in (wqkv, wp, w1, w2))
    vec = lambda *v: _nbytes(*v)
    out_q = rows * fq * 2
    y16 = layer_norm_f32(x, *ln, 1e-6).to(bf)
    label = f"rows {rows} C{c}"
    specs = [
        ("int8_ln_linear", ["xq"],
         lambda o=None: int8.int8_ln_linear(x, *ln, qkv, bqkv, operands=o),
         lambda o=None: int8.int8_ln_linear_plain(x, *ln, qkv, bqkv,
                                                  operands=o),
         (_nbytes(x, qkv[0]) + vec(*ln, qkv[1], bqkv) + out_q,
          [(2 * rows * c * fq, INT8_TENSOR_OPS)]), [qkv],
         lambda: F.linear(y16, wqkv.to(bf))),
        ("int8_linear", ["xq"],
         lambda o=None: int8.int8_linear(x, qkv, bqkv, operands=o),
         lambda o=None: int8.int8_linear_plain(x, qkv, bqkv, operands=o),
         (_nbytes(x, qkv[0]) + vec(qkv[1], bqkv) + out_q,
          [(2 * rows * c * fq, INT8_TENSOR_OPS)]), [qkv],
         lambda: F.linear(x, wqkv.to(bf))),
        ("int8_proj_residual", ["xq"],
         lambda o=None: int8.int8_proj_residual(att, x, proj, bp, g1,
                                                operands=o),
         lambda o=None: int8.int8_proj_residual_plain(att, x, proj, bp, g1,
                                                      operands=o),
         (_nbytes(att, x, x, proj[0]) + vec(proj[1], bp, g1),
          [(2 * rows * c * c, INT8_TENSOR_OPS)]), [proj],
         lambda: F.linear(att, wp.to(bf))),
    ]
    if vitg:
        w12b, b12b, w3b, b3b, g2b = (a.to(bf) for a in (w1, b1, w2, b2, g2))

        def swiglu_bf16():
            x1, x2 = (F.linear(y16, w12b) + b12b).chunk(2, -1)
            return x + (F.linear(F.silu(x1) * x2, w3b) + b3b) * g2b

        specs[1:2] = []       # F2: no path of vitg calls it
        specs.append((
            "fused_ln_swiglu_residual_int8", ["yq", "hq"],
            lambda o=None: int8.fused_ln_swiglu_residual_int8(
                x, *ln, fc1, b1, fc2, b2, g2, operands=o),
            lambda o=None: int8.fused_ln_swiglu_residual_int8_plain(
                x, *ln, fc1, b1, fc2, b2, g2, operands=o),
            (_nbytes(x, x, fc1[0], fc2[0]) + vec(*ln, fc1[1], b1, fc2[1],
                                                  b2, g2),
             [(6 * rows * c * fm, INT8_TENSOR_OPS)]), [fc1, fc2],
            swiglu_bf16))
    else:
        specs.append((
            "fused_ln_mlp_residual_int8", ["yq", "hq"],
            lambda o=None: int8.fused_ln_mlp_residual_int8(
                x, *ln, fc1, b1, fc2, b2, g2, operands=o),
            lambda o=None: int8.fused_ln_mlp_residual_int8_plain(
                x, *ln, fc1, b1, fc2, b2, g2, operands=o),
            (_nbytes(x, x, fc1[0], fc2[0]) + vec(*ln, fc1[1], b1, fc2[1],
                                                  b2, g2),
             [(4 * rows * c * fm, INT8_TENSOR_OPS)]), [fc1, fc2],
            lambda: mlp.fused_ln_mlp_residual(x, *ln, w1, b1, w2, b2, g2)))
    for name, keys, kern, plain, work, weights, bf16 in specs:
        ops = {}
        plain(ops)
        acts = [ops[k] for k in keys]
        yield case(
            name, label, kern, plain, work, path,
            library=lambda a=acts, w=weights: [
                torch._int_mm(q, wq.t()) for q, (wq, _) in zip(a, w)],
            check=int8_check(kern, plain, keys), bf16=bf16,
            stages=F4_STAGES if name == "fused_ln_mlp_residual_int8"
            else None)


def f6_row_view(key, d):
    """F6's q codes [B, H, T, D] in the output's row order (b, t, h); its k
    and v codes are read by every row of their (frame, head)."""
    return d.permute(0, 2, 1, 3).reshape(-1, d.shape[-1]) if key == "qi" \
        else None


def f6_cases(rng, path, b, t=VIT_TOKENS, h=16, modes=F6_MODES):
    """F6 in each of ``modes`` over b frames of t tokens and h heads (path
    ``path`` for "all", ``<mode>_<path>`` for the others), held with
    int8_check on its q, k and v codes; bf16 counterpart: A1 at the same
    shape; library: SDPA.  The input carries vdn's channel-mean outliers on
    k and v (test_flash_attention.py:205-207), which the centring takes
    out of the codes' range.  Bound: each product once (F6 computes QK^T
    twice), int8 where quantized, bf16 where not, on the tensor cores."""
    import torch.nn.functional as F
    from vdn_torch.kernels import flash_attention as fa
    dev, bf, d = DEVICE, torch.bfloat16, 64
    qkv = _rand(rng, (b, t, 3, h, d))
    qkv[:, :, 1, :, 3] += 4.0
    qkv[:, :, 2, :, 5] += 3.0
    qkv = qkv.to(dev, bf)
    out = torch.empty((b, t, h, d), dtype=bf, device=dev)
    prod = 2 * b * h * t * t * d
    for mode in modes:
        keys = {"qk": ["qi", "ki"], "pv": ["vi"],
                "all": ["qi", "ki", "vi"]}[mode]
        rate = lambda quantized: (INT8_TENSOR_OPS if quantized
                                  else BF16_TENSOR_FLOPS)
        kern = lambda o=None, m=mode: fa.flash_attention_int8_fused_qkv(
            qkv, mode=m, operands=o)
        plain = lambda o=None, m=mode: \
            fa.flash_attention_int8_fused_qkv_plain(qkv, mode=m, operands=o)
        yield case(
            "flash_attention_int8_fused_qkv", f"{mode} B{b} T{t} H{h} D64",
            kern, plain,
            (_nbytes(qkv, out), [(prod, rate(mode != "pv")),
                                 (prod, rate(mode != "qk"))]),
            path if mode == "all" else f"{mode}_{path}",
            library=lambda: F.scaled_dot_product_attention(
                *(qkv[:, :, i].transpose(1, 2) for i in range(3))),
            check=int8_check(kern, plain, keys, f6_row_view),
            bf16=lambda: fa.flash_attention_fused_qkv(qkv))


def c3_cases(rng, path, b, t=VIT_TOKENS, h=16):
    """C3 over b frames of t tokens and h heads, [B, H, T, D] out; library:
    SDPA on the [B, H, T, D] views; bf16 counterpart: A1."""
    import torch.nn.functional as F
    from vdn_torch.kernels import flash_attention as fa
    dev, bf, d = DEVICE, torch.bfloat16, 64
    qkv = _rand(rng, (b, t, 3, h, d)).to(dev, bf)
    out = torch.empty((b, h, t, d), dtype=bf, device=dev)
    yield case(
        "flash_attention_qkv", f"B{b} T{t} H{h} D64 -> [B, H, T, D]",
        lambda: fa.flash_attention_qkv(qkv),
        lambda: fa.flash_attention_qkv_plain(qkv),
        (_nbytes(qkv, out), [(4 * b * h * t * t * d, BF16_TENSOR_FLOPS)]),
        path, library=lambda: F.scaled_dot_product_attention(
            *(qkv[:, :, i].transpose(1, 2) for i in range(3))),
        bf16=lambda: fa.flash_attention_fused_qkv(qkv))


def attention_int8_cases(rng):
    """F6 in its three modes at the int8 paths' shapes: the cached window
    (B 22), the full window (B 32), a streamed frame (B 1) and the 480 x
    640 image (T 1814) at vitl's 16 heads, and vitg's cached window (24
    heads); C3 at the vitl window, B 22 and 32."""
    image_t = NONSQUARE_GRID[0] * NONSQUARE_GRID[1] + 1
    for path, b, t, h in (("clip", CACHED_FRAMES, VIT_TOKENS, 16),
                          ("clip_full", 32, VIT_TOKENS, 16),
                          ("stream", 1, VIT_TOKENS, 16),
                          ("image", 1, image_t, 16),
                          ("vitg_clip", CACHED_FRAMES, VIT_TOKENS,
                           VITG_HEADS)):
        yield from f6_cases(rng, path, b, t, h)
    yield from c3_cases(rng, "clip", CACHED_FRAMES)
    yield from c3_cases(rng, "clip_full", 32)


def kernel_cases(rng):
    """Every kernel at the shapes its main paths give it.  "clip": one
    32-frame window (A1, A2 at the cached window's 22 frames); "stream":
    the per-frame step (k = 1, batch 1 and T = 1, A3 on the first frame
    only) and the chunk of STREAM_CHUNK frames; "image" and "metric": one
    image through DepthAnythingV2 and MetricDepthAnythingV2; "cp" (and
    "cp4", "cplong", "cpextra"): E1 on the context-parallel window."""
    yield from encoder_cases(rng, "clip", CACHED_FRAMES)
    yield from motion_cases(rng, "clip", 32)
    yield from upsample_cases(rng, "clip",
                              fusion_passes(32) + [pos_embed_pass()])
    yield from island_cases(rng, "clip", ISLAND_FRAMES)
    yield from ring_cases(rng, "stream")
    for k in (1, STREAM_CHUNK):
        yield from encoder_cases(rng, "stream", k)
        yield from motion_cases(rng, "stream", k, with_a3=k == 1)
    yield from upsample_cases(rng, "stream", fusion_passes(1))
    yield from island_cases(rng, "stream", 1, h_pass=False)
    # the single-image path: at 518 x 518 its encoder, upsamples and island
    # are the stream's batch-1 shapes above; new are the memory attention,
    # every shape of the non-square image (pos-embed, encoder, the fusion
    # upsamples, the island with its H pass, the final resize), and metric
    # depth's sigmoid island
    yield from memory_cases(rng, "image")
    yield from encoder_cases(rng, "image", 1,
                             NONSQUARE_GRID[0] * NONSQUARE_GRID[1] + 1)
    yield from upsample_cases(
        rng, "image", [pos_embed_pass(NONSQUARE_GRID)]
        + fusion_passes(1, NONSQUARE_GRID) + [FINAL_RESIZE_PASS])
    yield from island_cases(rng, "image", 1, grid=NONSQUARE_GRID)
    yield from island_cases(rng, "metric", 1, h_pass=False, sigmoid=True)
    # the int8 serving mode's encoder: the cached and the full window, one
    # streamed frame, the 480 x 640 image
    for path, rows in (("clip", CACHED_FRAMES * VIT_TOKENS),
                       ("clip_full", 32 * VIT_TOKENS), ("stream", VIT_TOKENS),
                       ("image", NONSQUARE_GRID[0] * NONSQUARE_GRID[1] + 1)):
        yield from int8_cases(rng, path, rows)
    yield from attention_int8_cases(rng)
    yield from vitg_cases(rng)
    yield from e1_cases(rng)


def vitg_cases(rng):
    """The kernels at vitg's widths on its paths ("vitg_clip": one window,
    A1 and the int8 encoder at the cached window's 22 frames; "vitg_stream":
    the per-frame step; "vitg_image": one image): A1 over 24 heads, A3 at dh
    192 / 48 and A4 at its motion modules, the fusion upsamples at C 384,
    A6 at C 192, B1 at its 384- and 128-lane rings, C1 / C2 over 24 heads,
    and F1, F3 and F5 at the cached window, the full window, one frame and
    the 480 x 640 image."""
    image_rows = NONSQUARE_GRID[0] * NONSQUARE_GRID[1] + 1
    yield from encoder_cases(rng, "vitg_clip", CACHED_FRAMES, h=VITG_HEADS,
                             with_a2=False)
    yield from motion_cases(rng, "vitg_clip", 32, shapes=VITG_MOTION_SHAPES)
    yield from upsample_cases(rng, "vitg_clip",
                              fusion_passes(32, c=VITG_FEATURES))
    yield from island_cases(rng, "vitg_clip", ISLAND_FRAMES,
                            c=VITG_ISLAND_C)
    yield from ring_cases(rng, "vitg_stream", VITG_RING_SHAPES)
    yield from encoder_cases(rng, "vitg_stream", 1, h=VITG_HEADS,
                             with_a2=False)
    yield from motion_cases(rng, "vitg_stream", 1, shapes=VITG_MOTION_SHAPES)
    yield from memory_cases(rng, "vitg_image", h=VITG_HEADS)
    yield from encoder_cases(rng, "vitg_image", 1, image_rows, h=VITG_HEADS,
                             with_a2=False)
    yield from island_cases(rng, "vitg_image", 1, grid=NONSQUARE_GRID,
                            c=VITG_ISLAND_C)
    for path, rows in (("vitg_clip", CACHED_FRAMES * VIT_TOKENS),
                       ("vitg_clip_full", 32 * VIT_TOKENS),
                       ("vitg_stream", VIT_TOKENS),
                       ("vitg_image", image_rows)):
        yield from int8_cases(rng, path, rows, "vitg")


TRAIN_B, TRAIN_T = 2, 8          # the v4 recipe's batch: 2 clips of 8 frames
TRAIN_FRAMES = TRAIN_B * TRAIN_T


def train_cases(rng, path="train"):
    """The training step's kernels at vitl 518, b2 t8 (16 frames of 1370
    tokens; the motion modules at 2 x their tokens, T = 8): A1's training
    forward (its log-sum-exp), D1, D3 (every output) and D4, inputs bf16,
    parameters fp32 as the model stores them.  D1's library call is SDPA's
    backward at the same shape, timed as forward + backward less forward."""
    import torch.nn.functional as F
    from vdn_torch.kernels import flash_attention as fa, mlp
    from vdn_torch.kernels import temporal_attention as ta
    from vdn_torch.nn.motion import sinusoidal_positional_encoding
    dev, bf = DEVICE, torch.bfloat16
    b, t, h, d = TRAIN_FRAMES, VIT_TOKENS, 16, 64
    qkv = _rand(rng, (b, t, 3, h, d)).to(dev, bf)
    out = torch.empty((b, t, h, d), dtype=bf, device=dev)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    yield case(
        "flash_attention_fused_qkv_train", f"B{b} T{t} H16 D64 (lse)",
        lambda qkv=qkv: fa._fused_qkv_forward(qkv, None, True),
        lambda qkv=qkv: fa.flash_attention_fused_qkv_lse_plain(qkv),
        (_nbytes(qkv, out, lse), [(4 * b * h * t * t * d,
                                   BF16_TENSOR_FLOPS)]), path,
        library=lambda qkv=qkv: F.scaled_dot_product_attention(
            *(qkv[:, :, i].transpose(1, 2) for i in range(3))))
    with torch.no_grad():
        o, lse = fa._fused_qkv_forward(qkv, None, True)
    dout = _rand(rng, (b, t, h, d)).to(dev, bf)
    sdpa_in = [qkv[:, :, i].transpose(1, 2).detach().requires_grad_()
               for i in range(3)]
    g_sdpa = dout.transpose(1, 2)

    def sdpa_fwd_bwd(a=sdpa_in, g=g_sdpa):
        torch.autograd.grad(F.scaled_dot_product_attention(*a), a, g)

    def sdpa_fwd(a=sdpa_in):
        with torch.no_grad():
            F.scaled_dot_product_attention(*a)

    yield case(
        "flash_attention_fused_qkv_bwd", f"B{b} T{t} H16 D64",
        lambda a=(qkv, o, lse, dout): fa.flash_attention_fused_qkv_bwd(*a),
        lambda a=(qkv, o, lse, dout):
            fa.flash_attention_fused_qkv_bwd_plain(*a),
        (_nbytes(qkv, o, lse, dout, qkv), [(10 * b * h * t * t * d,
                                            BF16_TENSOR_FLOPS)]), path,
        library=sdpa_fwd_bwd, library_base=sdpa_fwd)

    c, f = 1024, 4096
    x = _rand(rng, (b, t, c)).to(dev, bf)
    g = _rand(rng, (b, t, c)).to(dev, bf)
    p = [a.to(dev) for a in (
        _rand(rng, (c,), 0.1, 1.0), _rand(rng, (c,), 0.1),
        _rand(rng, (f, c), c ** -0.5), _rand(rng, (f,), 0.1),
        _rand(rng, (c, f), f ** -0.5), _rand(rng, (c,), 0.5))]
    rows = b * t
    # out: dx, y [rows, C]; h, dhpre [rows, F] bf16; dls, dlb, db1 fp32
    out_bytes = 2 * (2 * rows * c + 2 * rows * f) + 4 * (2 * c + f)
    yield case(
        "fused_ln_mlp_residual_bwd", f"rows {b}x{t} C1024 F4096",
        lambda a=(x, g, *p): mlp.fused_ln_mlp_residual_bwd(*a),
        lambda a=(x, g, *p): mlp.fused_ln_mlp_residual_bwd_plain(*a),
        (_nbytes(x, g, *p) + out_bytes, [(6 * rows * c * f,
                                          BF16_TENSOR_FLOPS)]), path)

    for bn, c in MOTION_SHAPES:
        bn *= TRAIN_B
        tt = TRAIN_T
        x = _rand(rng, (bn, tt, c)).to(dev, bf)
        g = _rand(rng, (bn, tt, c)).to(dev, bf)
        pe = torch.from_numpy(sinusoidal_positional_encoding(c, 32)[:tt]).to(
            dev)
        w = [_rand(rng, (c, c), c ** -0.5).to(dev) for _ in range(4)]
        scale = (c // 8) ** -0.5
        flops = bn * tt * c * (14 * c + 10 * tt)
        yield case(
            "temporal_attention_block_bwd", f"BN{bn} T{tt} C{c}",
            lambda a=(x, pe, g, *w), s=scale: ta.temporal_attention_bwd_dx(
                *a, 8, s),
            lambda a=(x, pe, g, *w), s=scale:
                ta.temporal_attention_bwd_dx_plain(*a, 8, s),
            (3 * _nbytes(x) + _nbytes(pe, *w), [(flops, BF16_TENSOR_FLOPS)]),
            path)


def _compare(got, want, kind: str):
    """(max abs error, tolerance, scale, finite) of one output, or of the
    worst (by error / tolerance) of a tuple's."""
    if isinstance(got, (tuple, list)):
        parts = [_compare(a, b, kind) for a, b in zip(got, want)]
        return max(parts, key=lambda r: (not r[3], r[0] / max(r[1], 1e-30)))
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    tol = (KERNEL_ULPS * bf16_ulp(scale) if kind == "bf16"
           else FP32_RTOL * scale)
    return err, tol, scale, bool(torch.isfinite(got).all())


def check_kernels(cases=None) -> dict:
    """Kernel vs plain on the card, over ``cases`` (all of kernel_cases
    by default).  Tolerance: KERNEL_ULPS bf16 ulps at
    the scale of the plain output for bf16 work (both versions round at
    the same points and differ in the order of the fp32 sums, which can
    move a rounded intermediate by one ulp and the output by a few; A1
    also rounds p against the running max), FP32_RTOL of that scale for
    the fp32 pos-embed resize.  Returns, per kernel, the largest error
    over all its shapes and the times summed over each path's shapes."""
    if cases is None:
        cases = kernel_cases(np.random.default_rng(SEED))
    summary = {}
    for c in cases:
        extra = {}
        if c["check"] is not None:
            err, tol, scale, finite, ok, extra = c["check"]()
        else:
            got = c["kern"]()
            want = c["plain"]()
            torch.cuda.synchronize()
            err, tol, scale, finite = _compare(got, want, c["tol"])
            ok = err <= tol
            del got, want
        ms, plain_ms = time_ms(c["kern"]), time_ms(c["plain"])
        lib_ms = time_ms(c["library"]) if c["library"] else None
        if lib_ms is not None and c["library_base"]:
            lib_ms -= time_ms(c["library_base"])
        bf16_ms = time_ms(c["bf16"]) if c["bf16"] else None
        stage_ms = kernel_ms(c["kern"], c["stages"]) if c["stages"] else {}
        bound_ms, bound_by = bound(c["work"])
        if bf16_ms is not None:
            extra["bf16_ms"] = f"{bf16_ms:.4f}"
        for k, v in stage_ms.items():
            extra[f"{k}_ms"] = f"{v:.4f}"
        log("kernel", name=c["name"], path=c["path"], shape=repr(c["label"]),
            max_abs_err=f"{err:.3e}", max_rel_err=f"{err / scale:.3e}",
            tol=f"{tol:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            bound_bytes=c["work"][0], **extra)
        if not finite or not ok:
            fail(f"{c['name']} {c['label']}: max abs err {err} (tol {tol}) "
                 f"{extra}")
        s = summary.setdefault(c["name"], {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        p = s.setdefault(c["path"], {"ms": 0.0, "plain_ms": 0.0,
                                     "bound_ms": 0.0, "library_ms": 0.0,
                                     "_by": {}})
        p["ms"] += ms
        p["plain_ms"] += plain_ms
        p["bound_ms"] += bound_ms
        p["_by"][bound_by] = p["_by"].get(bound_by, 0.0) + bound_ms
        p["library_ms"] = (None if lib_ms is None or p["library_ms"] is None
                           else p["library_ms"] + lib_ms)
        if bf16_ms is not None:
            p["bf16_ms"] = p.get("bf16_ms", 0.0) + bf16_ms
        for k, v in stage_ms.items():
            st = p.setdefault("stages_ms", {})
            st[k] = st.get(k, 0.0) + v
        del c
        torch.cuda.empty_cache()
    for s in summary.values():
        for k, p in s.items():
            if k != "max_abs_err":
                by = p.pop("_by")
                p["bound_by"] = max(by, key=by.get)
    return summary


# ---------------------------------------------------------------- phase 4
def build_model(encoder: str = "vitl"):
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    gen = torch.Generator().manual_seed(SEED)
    model = build_video_depth_anything(
        encoder, compute_dtype=torch.bfloat16, device="cpu", generator=gen)
    with torch.no_grad():
        # proj_out is zero-initialized (the mixer starts as identity); give
        # it small random weights so A3 and A4 reach the depth
        for mm in model.head.motion_modules:
            w = mm.temporal_transformer.proj_out.weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.5 * w.shape[1] ** -0.5)
    return model.to(DEVICE)


def window_input(frames) -> torch.Tensor:
    from vdn_torch.pipelines.infer_video import INFER_LEN
    from vdn_torch.pipelines.transform import preprocess_frame
    x = np.stack([preprocess_frame(f, SIZE) for f in frames[:INFER_LEN]])
    return torch.from_numpy(x[None]).to(DEVICE)


def calibrate_output_bias(scratch, run, quantile: float = 0.25,
                          unit_scale: bool = False) -> float:
    """Set the last conv's bias of the DPT head ``scratch`` so that
    ``quantile`` of the pixels of ``run()``'s forwards fall below zero: the
    final ReLU then neither zeroes the map nor lets a constant offset hide
    the relative error of the depth.  With ``unit_scale`` the last conv is
    first scaled so that the pre-activation has unit spread (the metric
    head: its sigmoid is then neither flat nor saturated).  The island (A6)
    never forms
    the pre-activation, so it is recomputed with the plain convs from
    output_conv1's output, on every 8th frame of each forward."""
    from vdn_torch.ops.resize import resize2d
    seen = []
    hook = scratch.output_conv1.register_forward_hook(
        lambda m, i, o: seen.append(o[::8]))
    try:
        with torch.no_grad():
            run()
    finally:
        hook.remove()
    conv = scratch.output_conv2
    with torch.no_grad():
        z = torch.cat([conv[2](conv[1](conv[0](resize2d(
            o, (SIZE, SIZE), "bilinear", align_corners=True)))).flatten()[
                ::97].float() for o in seen])
        if unit_scale:
            spread = z.std()
            conv[2].weight.div_(spread)
            conv[2].bias.div_(spread)
            z = z / spread
        conv[2].bias.sub_(torch.quantile(z, quantile))
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


def check_launches(path: str, counts: dict, names) -> None:
    missing = [n for n in names if counts.get(n, 0) < 1]
    if missing:
        fail(f"{path}: kernels of the path never launched: {missing} "
             f"({counts})")


def check_absent(path: str, counts: dict, names) -> None:
    launched = {n: counts[n] for n in names if counts.get(n, 0)}
    if launched:
        fail(f"{path}: kernels off the path launched: {launched}")


def run_main_path(model, frames, label="main", names=None, absent=()):
    """The clip path over ``frames``: the kernels ``names`` (CLIP_KERNELS
    by default) must launch, those in ``absent`` must not."""
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
    check_launches(label, counts, names or CLIP_KERNELS)
    check_absent(label, counts, absent)
    log(label, shape=list(depth.shape), mean=f"{depth.mean():.5g}",
        std=f"{std:.5g}", positive_share=f"{pos:.4f}",
        wall_s=f"{wall:.3f}", peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    return depth, counts


def time_windows(model, frames, label: str = "windows") -> tuple:
    """ms per full and per cached window (CUDA events, median of 5), and
    the peak device memory and host wall seconds of one of each; returns
    the two ms."""
    from vdn_torch.pipelines.infer_video import (INFER_LEN, KEYFRAMES,
                                                 OVERLAP,
                                                 gather_seed_features)
    x = window_input(frames)

    def once(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    with torch.no_grad():
        (_, feats), full_s, full_gib = once(lambda: model.forward_window(x))
        seed = gather_seed_features(
            feats, torch.tensor(KEYFRAMES, device=DEVICE))
        x_new = x[:, OVERLAP:]
        _, cached_s, cached_gib = once(
            lambda: model.forward_window_cached(x_new, seed))
        full_ms = time_ms(lambda: model.forward_window(x), reps=5, warmup=1)
        cached_ms = time_ms(lambda: model.forward_window_cached(x_new, seed),
                            reps=5, warmup=1)
    log(label, full_window_ms=f"{full_ms:.2f}",
        cached_window_ms=f"{cached_ms:.2f}",
        cached_fps_32_per_window=f"{INFER_LEN / cached_ms * 1e3:.3f}",
        new_frames_per_s=f"{(INFER_LEN - OVERLAP) / cached_ms * 1e3:.3f}",
        full_window_wall_s=f"{full_s:.3f}",
        cached_window_wall_s=f"{cached_s:.3f}",
        full_window_peak_gib=f"{full_gib:.3f}",
        cached_window_peak_gib=f"{cached_gib:.3f}")
    return full_ms, cached_ms


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


def reference_runs(model, frames, depth, label="reference"):
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
    log(label, kernels_vs_plain_bf16=json.dumps(vs_plain),
        plain_bf16_vs_fp32=json.dumps(bf16_drift),
        kernels_vs_fp32=json.dumps(vs_fp32), rel_l2_tol=f"{tol:.3e}")
    if not np.isfinite(plain_fp32).all() or not vs_plain["rel_l2"] <= tol:
        fail(f"{label}: kernels' depth vs plain bf16: rel_l2 "
             f"{vs_plain['rel_l2']} > {tol}")
    return plain_bf16, plain_fp32


# ---------------------------------------------------------------- phase 6
def run_stream(model, frames, chunk: int):
    """The streaming pipeline over ``frames`` in chunks of ``chunk`` (the
    first chunk holds the first-frame path).  Returns (depth [n, H, W],
    wall ms of each chunk, the pipeline); fetching the depth to the host
    ends each chunk's wall."""
    from vdn_torch.pipelines.stream import VideoDepthStreamPipeline
    pipe = VideoDepthStreamPipeline(model, input_size=SIZE)
    out, walls = [], []
    for i in range(0, len(frames), chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out += pipe.infer_video_depth_chunk(list(frames[i:i + chunk]))
        walls.append((time.perf_counter() - t0) * 1e3)
    return np.stack(out), walls, pipe


def check_depth(name: str, depth: np.ndarray, n: int, hw=None) -> None:
    hw = (SIZE, SIZE) if hw is None else hw
    if depth.shape != (n, *hw) or not np.isfinite(depth).all():
        fail(f"{name}: depth {depth.shape}, finite {np.isfinite(depth).all()}")
    if not (depth.std() > 0 and (depth > 0).mean() > 0.01):
        fail(f"{name}: degenerate depth")


def stream_phase(model, frames, n=N_STREAM, chunk=STREAM_CHUNK,
                 label="stream", absent=()) -> tuple:
    """The streaming main path over ``n`` frames per frame (k = 1) and,
    unless ``chunk`` is None, in chunks of ``chunk``, each with the launch
    counts set to 0 just before it and read just after (the kernels in
    ``absent`` must not launch); then the k = 1 stream through the plain
    versions in bf16 and fp32.  Gates, as the clip's: the kernels' k = 1
    stream and the chunked stream may each sit no further from the plain
    bf16 (resp. the k = 1) stream than E2E_DRIFT_FACTOR times bf16's own
    distance from fp32.  Returns (launches k = 1, launches chunked or None,
    (plain bf16, plain fp32))."""
    from vdn_torch import kernels
    frames = frames[:n]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    d1, walls1, pipe1 = run_stream(model, frames, 1)
    counts1 = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"{label} k=1", counts1,
                   [n for n in STREAM_KERNELS if n not in absent])
    check_absent(f"{label} k=1", counts1, absent)
    check_depth(f"{label} k=1", d1, n)
    if not len(pipe1.slots) < n + 32:
        fail(f"{label}: no eviction ({len(pipe1.slots)} logical entries)")
    counts_k, chunked = None, {}
    if chunk is not None:
        kernels.reset_launches()
        dk, walls_k, pipe_k = run_stream(model, frames, chunk)
        counts_k = dict(kernels.launches)
        check_launches(f"{label} k={chunk}", counts_k,
                       [n for n in CLIP_KERNELS if n not in absent])
        check_depth(f"{label} k={chunk}", dk, n)
        if (pipe_k.slots, pipe_k.free) != (pipe1.slots, pipe1.free):
            fail(f"{label}: chunked bookkeeping differs from per-frame")
        chunked = {f"ms_per_frame_k{chunk}":
                   f"{sum(walls_k[1:]) / (n - chunk):.3f}",
                   f"launches_k{chunk}": json.dumps(counts_k,
                                                    separators=(",", ":"))}
    log(label, frames=n, mean=f"{d1.mean():.5g}",
        std=f"{d1.std():.5g}", positive_share=f"{(d1 > 0).mean():.4f}",
        ms_per_frame_k1=f"{statistics.median(walls1[1:]):.3f}",
        first_frame_ms=f"{walls1[0]:.3f}",
        frame_ms=json.dumps([round(w, 2) for w in walls1]),
        peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        ring_gib=f"{sum(_nbytes(b) for b in pipe1.buffers) / 2 ** 30:.3f}",
        launches_k1=json.dumps(counts1, separators=(",", ":")), **chunked)
    kernels.reset_launches()
    with kernels.plain_reference():
        plain_bf16, _, _ = run_stream(model, frames, 1)
        model.compute_dtype = torch.float32
        try:
            plain_fp32, _, _ = run_stream(model, frames, 1)
        finally:
            model.compute_dtype = torch.bfloat16
    if any(kernels.launches.values()):
        fail(f"kernels launched inside plain_reference: {kernels.launches}")
    check_depth(f"{label} plain fp32", plain_fp32, n)
    vs_plain = drift(plain_bf16, d1)
    bf16_drift = drift(plain_fp32, plain_bf16)
    tol = E2E_DRIFT_FACTOR * bf16_drift["rel_l2"]
    k_vs_1 = drift(d1, dk) if chunk is not None else None
    log(f"{label}_reference", kernels_vs_plain_bf16=json.dumps(vs_plain),
        plain_bf16_vs_fp32=json.dumps(bf16_drift),
        kernels_vs_fp32=json.dumps(drift(plain_fp32, d1)),
        **({f"k{chunk}_vs_k1": json.dumps(k_vs_1)} if k_vs_1 else {}),
        rel_l2_tol=f"{tol:.3e}")
    if not vs_plain["rel_l2"] <= tol:
        fail(f"{label} k=1 vs plain bf16: rel_l2 {vs_plain['rel_l2']} > "
             f"{tol}")
    if k_vs_1 is not None and not k_vs_1["rel_l2"] <= tol:
        fail(f"{label} k={chunk} vs k=1: rel_l2 {k_vs_1['rel_l2']} > {tol}")
    return counts1, counts_k, (plain_bf16, plain_fp32)


# ------------------------------------------------------- phase 6b: CP
def e1_shapes():
    """E1's rows and head width at the four motion modules: (tokens x 8
    heads, C / 8)."""
    return [(bn * 8, c // 8) for bn, c in MOTION_SHAPES]


def _zero_carry(g, t, d):
    o = torch.zeros((g, t, d), device=DEVICE)
    l = torch.zeros((g, t), device=DEVICE)
    return o, torch.full_like(l, -1e30), l


def e1_cases(rng):
    """E1 at the motion modules' rows, Tq = Tk = 32 (path "cp": the
    context-parallel window at p = 1, one call per module of the window's
    two), 8 ("cp4": p = 4 over the window) and 128 ("cplong"), bf16 from the
    ring's first (zero) carry; and ("cpextra") one fp32 shape and one
    non-zero incoming carry, the second step of a ring.  The kernel updates
    a copy of the carry in place; library: SDPA over the same block (from a
    zero carry o / l is the attention)."""
    import torch.nn.functional as F
    from vdn_torch.kernels import ring_attention as ra
    bf = torch.bfloat16
    g0, d0 = e1_shapes()[0]
    specs = [(path, t, g, d, bf, False)
             for path, t in (("cp", 32), ("cp4", 8), ("cplong", 128))
             for g, d in e1_shapes()]
    specs += [("cpextra", 32, g0, d0, torch.float32, False),
              ("cpextra", 32, g0, d0, bf, True)]
    for path, t, g, d, dt, carry in specs:
        q, k, v = (_rand(rng, (g, t, d)).to(DEVICE, dt) for _ in range(3))
        if carry:
            o = _rand(rng, (g, t, d), 3.0)
            m = _rand(rng, (g, t), 1.0, 2.0)
            l = _rand(rng, (g, t)).abs() * 4 + 1
        else:
            o, m, l = _zero_carry(g, t, d)
        work = [a.clone() for a in (o, m, l)]
        scale = d ** -0.5
        peak = BF16_TENSOR_FLOPS if dt == bf else FP32_FLOPS
        yield case(
            "ring_step", f"G{g} T{t} D{d} {str(dt)[6:]}"
            + (" carry" if carry else ""),
            lambda a=(q, k, v, *work), s=scale: ra.ring_step(*a, s),
            lambda a=(q, k, v, o, m, l), s=scale: ra.ring_step_plain(*a, s),
            # q, k, v read once, the carry read and written
            (_nbytes(q, k, v) + 2 * _nbytes(o, m, l),
             [(4 * g * t * t * d, peak)]), path,
            library=None if carry else (
                lambda a=(q, k, v), s=scale:
                    F.scaled_dot_product_attention(*a, scale=s)),
            tol="bf16" if dt == bf else "fp32")


def e1_ring_phase(rng) -> dict:
    """E1 over a ring of CP_RANKS K / V blocks in one process, in the order
    rank 0 sees them (its own block, then the blocks of ranks 3, 2, 1), at
    [tokens, T_local, 8, D] (the layout the CP model hands E1, read through
    its strides) for the first and the last motion module and local T 8 /
    32 / 128.  Gates: o / l within KERNEL_ULPS of the chained plain E1
    steps, and no further from the plain fp32 ring (vdn's
    ring_attention recipe) than E2E_DRIFT_FACTOR times SDPA's bf16 distance
    from it (at least KERNEL_ULPS ulps): both round p to bf16.  Times the
    E1 ring against the plain ring: the card's numbers for vdn's gate at a
    local K / V length of 128."""
    import torch.nn.functional as F
    from vdn_torch.kernels import ring_attention as ra
    from vdn_torch.parallel.context import ring_update_plain
    bf = torch.bfloat16
    out = {}
    for bn, c in (MOTION_SHAPES[0], MOTION_SHAPES[-1]):
        h, d = 8, c // 8
        for t in (8, 32, 128):
            q = _rand(rng, (bn, t, h, d)).to(DEVICE, bf)
            kv = [_rand(rng, (bn, CP_RANKS * t, h, d)).to(DEVICE, bf)
                  for _ in range(2)]
            blocks = [tuple(a[:, j * t:(j + 1) * t].contiguous()
                            for a in kv)
                      for j in (0, *range(CP_RANKS - 1, 0, -1))]
            scale = d ** -0.5

            def e1_ring():
                o, m, l = _zero_carry(bn * h, t, d)
                for k, v in blocks:
                    ra.ring_step(q, k, v, o, m, l, scale)
                return (o / l[..., None]).to(bf)

            def e1_plain():
                o, m, l = _zero_carry(bn * h, t, d)
                for k, v in blocks:
                    o, m, l = ra.ring_step_plain(q, k, v, o, m, l, scale)
                return (o / l[..., None]).to(bf)

            def plain_ring():
                qf = q.float()
                o = torch.zeros((bn, h, t, d), device=DEVICE)
                l = torch.zeros((bn, h, t, 1), device=DEVICE)
                m = l - 1e30
                for k, v in blocks:
                    o, m, l = ring_update_plain(qf, k, v, o, m, l, scale)
                return (o / l).reshape(bn * h, t, d)

            def sdpa():
                return F.scaled_dot_product_attention(
                    *(a.transpose(1, 2) for a in (q, *kv)), scale=scale)

            got, want = e1_ring(), e1_plain()
            exact = plain_ring()
            lib = sdpa().reshape(bn * h, t, d)
            err, tol, scale_, _ = _compare(got, want, "bf16")
            err32 = (got.float() - exact).abs().max().item()
            lib32 = (lib.float() - exact).abs().max().item()
            tol32 = max(E2E_DRIFT_FACTOR * lib32, tol)
            ms, plain_ms = time_ms(e1_ring), time_ms(plain_ring)
            lib_ms = time_ms(sdpa)
            label = f"N{bn} T{t}x{CP_RANKS} D{d}"
            log("e1_ring", shape=repr(label), max_abs_err=f"{err:.3e}",
                tol=f"{tol:.3e}", vs_fp32_ring=f"{err32:.3e}",
                sdpa_vs_fp32_ring=f"{lib32:.3e}", tol_fp32=f"{tol32:.3e}",
                ms=f"{ms:.4f}", plain_ring_ms=f"{plain_ms:.4f}",
                ratio=f"{ms / plain_ms:.3f}", sdpa_ms=f"{lib_ms:.4f}")
            if not (err <= tol and err32 <= tol32
                    and bool(torch.isfinite(got).all())):
                fail(f"e1 ring {label}: err {err} (tol {tol}), vs the fp32 "
                     f"ring {err32} (tol {tol32})")
            out[label] = {"ms": ms, "plain_ring_ms": plain_ms,
                          "sdpa_ms": lib_ms}
            del q, kv, blocks, got, want, exact, lib
            torch.cuda.empty_cache()
    return out


def build_cp_model(model):
    """The clip model with ``seq_axis="seq"`` and the same weights."""
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    cp = build_video_depth_anything(
        "vitl", compute_dtype=torch.bfloat16, device="cpu", seq_axis="seq")
    cp.load_state_dict(model.state_dict())
    return cp.to(DEVICE)


def plain_fp32(model, fn):
    """fn() through the plain versions with the model in fp32."""
    from vdn_torch import kernels
    with kernels.plain_reference():
        model.compute_dtype = torch.float32
        try:
            return fn()
        finally:
            model.compute_dtype = torch.bfloat16


def cp_gate(label, got, want, noise) -> dict:
    """E2E drift gate: ``got`` no further from ``want`` than
    E2E_DRIFT_FACTOR times ``noise`` (bf16's own rel L2 from fp32)."""
    d = drift(want, got)
    tol = E2E_DRIFT_FACTOR * noise
    if not np.isfinite(got).all() or not d["rel_l2"] <= tol:
        fail(f"{label}: rel_l2 {d['rel_l2']} > {tol}")
    return d


def cp_clip_phase(model, cp, mesh, frames) -> dict:
    """The vitl 518 window (32 frames) through make_context_parallel_forward
    on the seq group of one rank: ``ring_pallas`` (E1, once per attention
    block: 8, and no A3), then ``auto`` (the plain ring at T 32: no E1);
    the other kernels as the plain model's window.  The depth within the
    drift gate of the plain model's window and of the CP model's plain
    bf16 run; the window timed against the plain model's."""
    from vdn_torch import kernels
    from vdn_torch.parallel.context import (make_context_parallel_forward,
                                            set_cp_mode)
    x = window_input(frames)
    fwd = make_context_parallel_forward(cp, mesh)
    with torch.no_grad():
        kernels.reset_launches()
        clip = model(x)
        torch.cuda.synchronize()
        want_counts = dict(kernels.launches)
        set_cp_mode("ring_pallas")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        depth = fwd(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        want_counts.update(ring_step=8, temporal_attention_block=0)
        check_frame_launches("cp_clip", counts, want_counts)
        cp_ms = time_ms(lambda: fwd(x), reps=5, warmup=1)
        clip_ms = time_ms(lambda: model(x), reps=5, warmup=1)
        set_cp_mode("auto")
        kernels.reset_launches()
        auto = fwd(x)
        torch.cuda.synchronize()
        counts_auto = dict(kernels.launches)
        check_frame_launches("cp_clip auto", counts_auto,
                             {**want_counts, "ring_step": 0})
        auto_ms = time_ms(lambda: fwd(x), reps=5, warmup=1)
        set_cp_mode("ring_pallas")
        with kernels.plain_reference():
            clip16 = model(x)
            cp16 = fwd(x)
        clip32 = plain_fp32(model, lambda: model(x))
    to_np = lambda a: a.float().cpu().numpy()
    depth, auto, clip = to_np(depth), to_np(auto), to_np(clip)
    check_depth("cp_clip", depth[0], 32)
    noise = drift(to_np(clip32), to_np(clip16))["rel_l2"]
    vs_clip = cp_gate("cp_clip vs the plain model's window", depth, clip,
                      noise)
    vs_plain = cp_gate("cp_clip vs its plain bf16 run", depth, to_np(cp16),
                       noise)
    vs_auto = cp_gate("cp_clip ring_pallas vs auto", depth, auto, noise)
    log("cp_clip", mode="ring_pallas", cp_window_ms=f"{cp_ms:.2f}",
        plain_model_window_ms=f"{clip_ms:.2f}",
        auto_window_ms=f"{auto_ms:.2f}", wall_s=f"{wall:.3f}",
        peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        vs_clip=json.dumps(vs_clip), vs_plain_bf16=json.dumps(vs_plain),
        vs_auto=json.dumps(vs_auto), bf16_vs_fp32=f"{noise:.3e}",
        launches=json.dumps(counts, separators=(",", ":")),
        launches_auto=json.dumps(counts_auto, separators=(",", ":")))
    return {"cp_clip": counts, "cp_clip_auto": counts_auto}


def cp_decode_phase(model, cp, mesh, frames) -> None:
    """The two context-parallel streaming decodes at p = 1 against the
    plain model's local ones, on the window of the clip's first 31 frames
    (the entries of one window pass): ``_cached_cp`` for frame 31 (cache_len
    31) against ``_cached_local``, and one chunk-window step of
    STREAM_CHUNK frames (frames 31-38; a 32-slot ring holding the 31
    entries) with ``seq_axis`` against the local chunk window.  Gate:
    the drift gate against bf16's own distance from fp32 of the local
    decode of frame 31."""
    from vdn_torch.parallel.mesh import use_mesh
    x = window_input(frames)
    xw, new = x[:, :31], x[:, 31:32]
    chunk = window_input(frames[31:])[:, :STREAM_CHUNK]
    kf = chunk.shape[1]

    def window_and_frame(m):
        feats = m.forward_features(xw)
        _, entries = m.forward_depth(feats, xw.shape, want_entries=True)
        f_new = m.forward_features(new)
        return entries, f_new, m.forward_depth(f_new, new.shape,
                                               caches=list(entries))

    def chunk_step(m, entries):
        cap = 32
        bufs = [torch.cat([e, e.new_zeros((e.shape[0], cap - 31,
                                           e.shape[2]))], 1)
                for e in entries]
        sel = [[f if f < 31 else cap + f - 31 for f in range(j, j + 32)]
               for j in range(kf)]
        onehot = torch.nn.functional.one_hot(
            torch.tensor(sel, device=DEVICE), cap + kf).float()
        ph, pw = SIZE // 14, SIZE // 14
        r1, r2, l3, l4 = m.head.decode_pre(m.forward_features(chunk), ph, pw)
        p3, ents = m.head.decode_temporal(
            l3, l4, tuple(r2.shape[-3:-1]), kf,
            caches=[(b, onehot) for b in bufs])
        return m.head.decode_post(p3, r1, r2, (SIZE, SIZE)), ents

    with torch.no_grad():
        entries, f_new, (local, local_e) = window_and_frame(model)
        with use_mesh(mesh):
            got, got_e = cp.forward_depth(f_new, new.shape,
                                          caches=list(entries), cache_len=31)
            got_k, got_k_e = chunk_step(cp, entries)
        local_k, local_k_e = chunk_step(model, entries)
        _, _, (local32, _) = plain_fp32(model,
                                        lambda: window_and_frame(model))
    to_np = lambda a: a.float().cpu().numpy()
    noise = drift(to_np(local32), to_np(local))["rel_l2"]
    cached = cp_gate("cp _cached_cp vs _cached_local", to_np(got),
                     to_np(local), noise)
    chunked = cp_gate("cp chunk window vs local", to_np(got_k),
                      to_np(local_k), noise)
    # an entry is the projection of its block's input, which the earlier
    # blocks' attention already moved by bf16 noise: logged, not gated
    entries = max(rel_l2(a.float(), b.float())
                  for a, b in zip(got_e + got_k_e, local_e + local_k_e))
    log("cp_decode", cached_cp_vs_local=json.dumps(cached),
        chunk_vs_local=json.dumps(chunked),
        chunk_equal=bool(torch.equal(got_k, local_k)),
        entries_max_rel_l2=f"{entries:.3e}", bf16_vs_fp32=f"{noise:.3e}")


def cp_backward_phase(rng, group) -> None:
    """One backward through ring_attention_kernel (the E1 ring forward, the
    plain ring under autograd backward) at the first motion module's E1
    shape on the seq group: its gradients against an fp32 autograd
    reference within E2E_DRIFT_FACTOR times SDPA's bf16 gradients' distance
    from it (at least KERNEL_ULPS ulps)."""
    import torch.nn.functional as F
    from vdn_torch import kernels
    from vdn_torch.kernels.ring_attention import ring_attention_kernel
    bn, c = MOTION_SHAPES[0]
    h, d, t = 8, c // 8, 32
    bf = torch.bfloat16
    q, k, v = (_rand(rng, (bn, t, h, d)).to(DEVICE, bf) for _ in range(3))
    g = _rand(rng, (bn, t, h, d)).to(DEVICE, bf)

    def grads(fn, dt):
        args = [a.to(dt).detach().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(fn(*args), args, g.to(dt))

    kernels.reset_launches()
    got = grads(lambda *a: ring_attention_kernel(*a, group), bf)
    torch.cuda.synchronize()
    if kernels.launches["ring_step"] != 1:
        fail(f"cp backward: ring_step launches {kernels.launches}")
    sdpa = lambda *a: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in a)).transpose(1, 2)
    lib = grads(sdpa, bf)
    ref = grads(sdpa, torch.float32)
    errs = {}
    for name, a, b, r in zip("qkv", got, lib, ref):
        err = (a.float() - r).abs().max().item()
        lib_err = (b.float() - r).abs().max().item()
        tol = max(E2E_DRIFT_FACTOR * lib_err,
                  KERNEL_ULPS * bf16_ulp(r.abs().max().item()))
        errs[f"d{name}"] = [f"{err:.3e}", f"{lib_err:.3e}", f"{tol:.3e}"]
        if not (err <= tol and bool(torch.isfinite(a).all())):
            fail(f"cp backward d{name}: {err} > {tol}")
    log("cp_backward", shape=repr(f"N{bn} T{t} H{h} D{d}"),
        err_sdpa_err_tol=json.dumps(errs))


def cp_phases(model, frames) -> dict:
    """Context parallel over the frame axis on one card: a world of one
    (NCCL), a (1, 1, 1) mesh, the seq_axis model on the main model's
    weights; the in-process E1 ring, the CP window, the two CP decodes and
    the ring's backward.  Returns (the CP window's launches in the modes
    ring_pallas and auto, the E1 ring's times by shape)."""
    import torch.distributed as dist
    from vdn_torch.parallel.launch import initialize_distributed
    from vdn_torch.parallel.mesh import SEQ_AXIS, make_mesh
    rng = np.random.default_rng(SEED + 8)
    initialize_distributed(device=DEVICE)
    mesh = make_mesh(seq=1, device=DEVICE)
    log("cp_mesh", backend=dist.get_backend(), world=dist.get_world_size(),
        mesh=repr(str(mesh)))
    ring = e1_ring_phase(rng)
    cp = build_cp_model(model)
    counts = cp_clip_phase(model, cp, mesh, frames)
    cp_decode_phase(model, cp, mesh, frames)
    cp_backward_phase(rng, mesh.get_group(SEQ_AXIS))
    del cp
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return counts, ring


# ---------------------------------------------------------------- phase 7
def build_image_model(encoder: str = "vitl"):
    """DepthAnythingV2 at ``encoder``, bf16.  With the stock initial values the
    memory hardly reaches the depth (CXBlock.gamma is 1e-6 and the three
    embeddings are 0.02-normal), so a broken bank could pass unnoticed:
    gamma is set to 1 and the embeddings to 0.5-normal.  The attention
    out-projections are lecun-normal, not zero, as initialized."""
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    gen = torch.Generator().manual_seed(SEED + 1)
    model = build_depth_anything_v2(encoder, compute_dtype=torch.bfloat16,
                                    device="cpu", generator=gen)
    block = model.memory_block
    with torch.no_grad():
        for layer in block.memory_encoder.fuser.layers:
            layer.gamma.fill_(1.0)
        for p in (block.curr_pos_enc, block.maskmem_tpos_enc,
                  block.no_mem_embed):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return model.to(DEVICE)


def nonsquare_images(frames) -> list:
    """N_NONSQUARE BGR images of NONSQUARE_HW cut from the clip's frames."""
    h, w = NONSQUARE_HW
    return [np.ascontiguousarray(
        np.concatenate([f, f[:, :w - SIZE]], axis=1)[:h, :, ::-1])
        for f in frames[:N_NONSQUARE]]


def run_images(pipe, images):
    """``infer_image`` over BGR images.  Returns (depths, wall ms of each
    call, the launches of each call); fetching the depth ends a call."""
    from vdn_torch import kernels
    out, walls, per_call = [], [], []
    before = dict(kernels.launches)
    for img in images:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(pipe.infer_image(img, SIZE))
        walls.append((time.perf_counter() - t0) * 1e3)
        after = dict(kernels.launches)
        per_call.append({k: after[k] - before[k] for k in after})
        before = after
    return np.stack(out), walls, per_call


def check_frame_launches(name: str, got: dict, want: dict) -> None:
    diff = {k: (got.get(k, 0), v) for k, v in want.items()
            if got.get(k, 0) != v}
    if diff:
        fail(f"{name}: launches (got, expected) {diff}")


def image_phase(model, frames, n_image=N_IMAGE, launches=None,
                label="image") -> tuple:
    """The single-image main path: ``n_image`` frames through the memory
    bank (``launches`` per steady frame, IMAGE_LAUNCHES by default),
    then clear_memory() and N_NONSQUARE images that are not square, with
    the launch counts set to 0 just before and read just after; then the
    same through the plain versions in bf16 and fp32.  Gates: the launches
    of every frame; the clip's drift gate on both sets of images; and the
    bank must matter: frame MEMORY_PROBE's depth with the bank differs from
    the same frame after clear_memory() by more than E2E_DRIFT_FACTOR times
    its distance to the plain bf16 run's (the bf16 noise between two
    runs)."""
    from vdn_torch import kernels
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    steady = launches or IMAGE_LAUNCHES
    images = [np.ascontiguousarray(f[..., ::-1]) for f in frames[:n_image]]
    wide = nonsquare_images(frames)
    probe = MEMORY_PROBE

    def run(pipe):
        square = run_images(pipe, images)
        pipe.clear_memory()
        alone = run_images(pipe, images[probe:probe + 1])
        pipe.clear_memory()
        return square, alone, run_images(pipe, wide)

    pipe = DepthAnythingV2Pipeline(model, capacity=MEM_CAPACITY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    (d, walls, per), (d_alone, _, _), (dw, walls_w, per_w) = run(pipe)
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    check_launches(label, counts, [n for n, v in steady.items() if v])
    check_depth(label, d, n_image)
    check_depth(f"{label} non-square", dw, N_NONSQUARE, NONSQUARE_HW)
    if pipe.state["count"] != N_NONSQUARE or any(
            t.shape[1:3] != (MEM_CAPACITY,
                             NONSQUARE_GRID[0] * NONSQUARE_GRID[1])
            for t in (pipe.state["features"], pipe.state["pos"])):
        fail(f"{label}: bank after the non-square images: count "
             f"{pipe.state['count']}, {pipe.state['features'].shape}")
    for i, c in enumerate(per):
        check_frame_launches(f"{label} frame {i}", c, {
            **steady, **(IMAGE_FIRST if i == 0 else {})})
    for i, c in enumerate(per_w):
        check_frame_launches(f"{label} non-square frame {i}", c, {
            **steady, **(IMAGE_FIRST if i == 0 else {}),
            **IMAGE_NONSQUARE})
    log(label, frames=n_image, mean=f"{d.mean():.5g}",
        std=f"{d.std():.5g}", positive_share=f"{(d > 0).mean():.4f}",
        first_frame_ms=f"{walls[0]:.3f}",
        steady_ms_per_frame=f"{statistics.median(walls[probe:]):.3f}",
        frame_ms=json.dumps([round(w, 2) for w in walls]),
        nonsquare_frame_ms=json.dumps([round(w, 2) for w in walls_w]),
        peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        launches_first=json.dumps(per[0], separators=(",", ":")),
        launches_steady=json.dumps(per[-1], separators=(",", ":")),
        launches_nonsquare=json.dumps(per_w[-1], separators=(",", ":")))

    kernels.reset_launches()
    with kernels.plain_reference():
        (p16, _, _), _, (p16w, _, _) = run(
            DepthAnythingV2Pipeline(model, capacity=MEM_CAPACITY))
        model.compute_dtype = torch.float32
        try:
            (p32, _, _), _, (p32w, _, _) = run(
                DepthAnythingV2Pipeline(model, capacity=MEM_CAPACITY))
        finally:
            model.compute_dtype = torch.bfloat16
    if any(kernels.launches.values()):
        fail(f"kernels launched inside plain_reference: {kernels.launches}")
    check_depth(f"{label} plain fp32", p32, n_image)
    for name, got, b16, f32 in ((label, d, p16, p32),
                                (f"{label} non-square", dw, p16w, p32w)):
        vs_plain, bf16_drift = drift(b16, got), drift(f32, b16)
        tol = E2E_DRIFT_FACTOR * bf16_drift["rel_l2"]
        log(f"{label}_reference", images=repr(name),
            kernels_vs_plain_bf16=json.dumps(vs_plain),
            plain_bf16_vs_fp32=json.dumps(bf16_drift),
            kernels_vs_fp32=json.dumps(drift(f32, got)),
            rel_l2_tol=f"{tol:.3e}")
        if not vs_plain["rel_l2"] <= tol:
            fail(f"{name} vs plain bf16: rel_l2 {vs_plain['rel_l2']} > {tol}")
    effect = drift(d[probe], d_alone[0])["rel_l2"]
    noise = drift(p16[probe], d[probe])["rel_l2"]
    log(f"{label}_memory", frame=probe,
        with_vs_without_bank=f"{effect:.4e}",
        kernels_vs_plain_bf16=f"{noise:.4e}")
    if not effect > E2E_DRIFT_FACTOR * noise:
        fail(f"{label}: the memory bank does not reach the depth: frame "
             f"{probe} moves {effect} without it, bf16 noise {noise}")
    return counts, (p16, p32)


# ---------------------------------------------------------------- phase 8
def metric_phase(frames) -> dict:
    """MetricDepthAnythingV2 vitl, bf16, one 518 x 518 image: A6 runs with
    the sigmoid; the depth lies in (0, max_depth]; gated as the others
    against the plain bf16 and fp32 runs."""
    from vdn_torch import kernels
    from vdn_torch.models.metric_depth import build_metric_depth_anything_v2
    from vdn_torch.pipelines.transform import preprocess_frame
    model = build_metric_depth_anything_v2(
        "vitl", compute_dtype=torch.bfloat16, device="cpu",
        generator=torch.Generator().manual_seed(SEED + 2)).to(DEVICE)
    x = torch.from_numpy(preprocess_frame(frames[0], SIZE)[None]).to(DEVICE)
    bias = calibrate_output_bias(model.depth_head.scratch, lambda: model(x),
                                 quantile=0.5, unit_scale=True)

    def run():
        with torch.no_grad():
            return model(x).cpu().numpy()

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    depth = run()
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.launches)
    check_frame_launches("metric", counts, METRIC_LAUNCHES)
    if (depth.shape != (1, SIZE, SIZE) or not np.isfinite(depth).all()
            or not (depth.min() > 0 and depth.max() <= model.max_depth
                    and depth.std() > 0)):
        fail(f"metric: depth {depth.shape} in [{depth.min()}, {depth.max()}]")
    kernels.reset_launches()
    with kernels.plain_reference():
        plain_bf16 = run()
        model.compute_dtype = torch.float32
        try:
            plain_fp32 = run()
        finally:
            model.compute_dtype = torch.bfloat16
    if any(kernels.launches.values()):
        fail(f"kernels launched inside plain_reference: {kernels.launches}")
    vs_plain, bf16_drift = drift(plain_bf16, depth), drift(plain_fp32,
                                                           plain_bf16)
    tol = E2E_DRIFT_FACTOR * bf16_drift["rel_l2"]
    log("metric", output_bias=f"{bias:.6g}", max_depth=model.max_depth,
        min=f"{depth.min():.5g}", mean=f"{depth.mean():.5g}",
        max=f"{depth.max():.5g}", std=f"{depth.std():.5g}",
        wall_ms=f"{wall:.3f}",
        kernels_vs_plain_bf16=json.dumps(vs_plain),
        plain_bf16_vs_fp32=json.dumps(bf16_drift), rel_l2_tol=f"{tol:.3e}",
        launches=json.dumps(counts, separators=(",", ":")))
    if not vs_plain["rel_l2"] <= tol:
        fail(f"metric vs plain bf16: rel_l2 {vs_plain['rel_l2']} > {tol}")
    return counts


# ---------------------------------------------------------------- phase 8b
# The int8 serving mode (quantize="int8_static" and "int8") on the clip,
# stream and image paths: the encoder's projections and MLP through F1, F3
# and F4 (A1 stays the attention, A2 and the cuBLAS qkv / proj GEMMs are
# not run), the DPT head's convs int8 where vdn's gate passes.
INT8_MODES = ("int8_static", "int8")
N_INT8_STREAM = 12
N_INT8_IMAGE = 8
# launches per encoder pass (one window, one streamed chunk, one image)
INT8_ENCODER = {"int8_ln_linear": 24, "int8_proj_residual": 24,
                "fused_ln_mlp_residual_int8": 24,
                "flash_attention_fused_qkv": 24, "fused_ln_mlp_residual": 0,
                "int8_linear": 0, "fused_ln_swiglu_residual_int8": 0,
                "flash_attention_int8_fused_qkv": 0}
INT8_IMAGE_LAUNCHES = {**IMAGE_LAUNCHES, **INT8_ENCODER}
# vitg: 40 blocks, F5 carries the SwiGLU tail (no A2, no F4)
VITG_INT8_ENCODER = {**{n: 40 for n, v in INT8_ENCODER.items() if v},
                     "fused_ln_mlp_residual_int8": 0,
                     "fused_ln_swiglu_residual_int8": 40,
                     "fused_ln_mlp_residual": 0, "int8_linear": 0,
                     "flash_attention_int8_fused_qkv": 0}
# under VDN_FLASH_INT8 ("qk", "pv", "all"): F6 takes A1's calls
F6_ENCODER = {**INT8_ENCODER, "flash_attention_fused_qkv": 0,
              "flash_attention_int8_fused_qkv": 24}
F6_IMAGE_LAUNCHES = {**IMAGE_LAUNCHES, **F6_ENCODER}
VITG_F6_ENCODER = {**VITG_INT8_ENCODER, "flash_attention_fused_qkv": 0,
                   "flash_attention_int8_fused_qkv": 40}
VITG_IMAGE_LAUNCHES = {**IMAGE_LAUNCHES, "flash_attention_fused_qkv": 40,
                       "fused_ln_mlp_residual": 0}


# the head's quantized convs at the clip window (N 32): (name, H = W, Cin,
# Cout, kernel, static); the gate sends each to int8 (output_conv1 only
# with calibrated scales)
INT8_CONVS = [("layer3_rn", 37, 1024, 256, 3, False),
              ("layer2_rn", 74, 512, 256, 3, False),
              ("refinenet2 RCU", 74, 256, 256, 3, False),
              ("refinenet1 RCU / layer1_rn", 148, 256, 256, 3, False),
              ("output_conv1", 296, 256, 128, 3, True),
              ("projects_2 / 3", 37, 1024, 1024, 1, False),
              ("projects_1", 37, 1024, 512, 1, False)]
# vitg's head (C 1536 into features 384): its largest gated conv, whose
# im2col rows (32 x 148^2 x 13,824 bytes, 9.7 GB whole) go in chunks of
# IM2COL_BYTES, and the 1536-channel projections
VITG_INT8_CONVS = [("vitg layer1_rn", 148, 1536, 384, 3, False),
                   ("vitg projects", 37, 1536, 1536, 1, False)]


def int8_conv_phase(frames: int = 32, convs=None) -> None:
    """The int8 conv (vdn's XLA-level op: ``torch._int_mm`` on im2col rows,
    not a kernel of the port) at the head's shapes: on two frames its
    output on the card equals the same function on the CPU (exact int32
    sums, the same fp32 dequantization); over ``frames`` frames its time
    beside the float conv's in bf16 (cuDNN, as the float path runs it),
    and its peak device memory above its input.  ``convs``: INT8_CONVS by
    default."""
    import torch.nn.functional as F
    from vdn_torch.nn.layers import Conv2d
    from vdn_torch.ops.int8_conv import int8_conv
    rng = np.random.default_rng(SEED)
    for name, hw, cin, cout, k, static in convs or INT8_CONVS:
        conv = Conv2d(cin, cout, k, padding=k // 2)
        with torch.no_grad():
            conv.weight.copy_(_rand(rng, conv.weight.shape,
                                    (cin * k * k) ** -0.5, device="cpu"))
        amax = torch.tensor(3.0) if static else None
        args = ((1, 1), (k // 2, k // 2))
        x2 = _rand(rng, (2, hw, hw, cin), device="cpu").to(torch.bfloat16)
        want = int8_conv(x2, conv.int8_weight(), *args, amax)
        conv = conv.to(DEVICE)
        amax = None if amax is None else amax.to(DEVICE)
        got = int8_conv(x2.to(DEVICE), conv.int8_weight(), *args, amax)
        if not torch.equal(got.cpu(), want):
            fail(f"int8 conv {name}: the card's output differs from the "
                 f"CPU's")
        x = _rand(rng, (frames, hw, hw, cin)).to(DEVICE, torch.bfloat16)
        w = conv.weight.to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        int8_conv(x, conv.int8_weight(), *args, amax)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ms = time_ms(lambda: int8_conv(x, conv.int8_weight(), *args, amax),
                     reps=5)
        float_ms = time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w, None,
                                            1, k // 2), reps=5)
        log("int8_conv", conv=repr(name), shape=f"N{frames} {hw}x{hw} "
            f"{cin}->{cout} {k}x{k}", static=static, equal_to_cpu=True,
            ms=f"{ms:.4f}", bf16_cudnn_ms=f"{float_ms:.4f}",
            peak_above_input_gib=f"{peak:.3f}")
        del x, got
        torch.cuda.empty_cache()


def quantized_model(build, model, mode, encoder="vitl"):
    """``build``'s ``encoder`` model in the int8 serving ``mode`` with
    ``model``'s weights (the calibrated output bias and the adjusted weights
    included): a state_dict loads with strict=True whatever the mode."""
    q = build(encoder, compute_dtype=torch.bfloat16, device="cpu",
              quantize=mode)
    q.load_state_dict(model.state_dict())
    return q.to(DEVICE)


def clear_quant_stats(model) -> None:
    """Drop every conv's calibrated scale: the next int8_static pass
    calibrates afresh (a pass keeps the running max over the scales it
    finds, as vdn's)."""
    from vdn_torch.nn.layers import Conv2d
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.act_amax = None


def quant_stats(model) -> dict:
    from vdn_torch.nn.layers import Conv2d
    return {n: float(m.act_amax) for n, m in model.named_modules()
            if isinstance(m, Conv2d) and m.act_amax is not None}


class Int8Watch:
    """Forward hooks on a quantized model: ``predicted`` counts the calls of
    its quantized convs that vdn's gate sends to int8 (outside calibration
    passes), ``encoder_linear`` the calls of the encoder's float Linears
    (qkv, proj and the FFN's: none on the int8 path)."""

    def __init__(self, model):
        from vdn_torch.nn.layers import Conv2d, Linear, calibrating
        from vdn_torch.ops.int8_conv import int8_conv_enabled
        self.predicted = self.encoder_linear = 0

        def conv_hook(m, args):
            static = m.quantize == "int8_static"
            if not (static and calibrating()) and m.groups == 1 \
                    and int8_conv_enabled(args[0], m.weight.shape, m.stride,
                                          static):
                self.predicted += 1

        def linear_hook(m, args):
            self.encoder_linear += 1

        self.handles = [m.register_forward_pre_hook(conv_hook)
                        for m in model.modules()
                        if isinstance(m, Conv2d) and m.quantize
                        and m.accum_dtype is None]
        for blk in model.pretrained.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, *(
                    m for m in blk.mlp.modules() if isinstance(m, Linear))):
                self.handles.append(lin.register_forward_pre_hook(
                    linear_hook))

    def reset(self):
        from vdn_torch.ops.int8_conv import reset_counts
        self.predicted = self.encoder_linear = 0
        reset_counts()

    def check(self, name: str, some: bool = True) -> int:
        """The int8 convs of the run: as many as the gate predicts, and
        with ``some`` at least one; no float encoder Linear."""
        from vdn_torch.ops.int8_conv import counts
        got = counts["int8_conv"]
        if got != self.predicted or (some and got < 1):
            fail(f"{name}: {got} int8 convs, the gate predicts "
                 f"{self.predicted}")
        if self.encoder_linear:
            fail(f"{name}: {self.encoder_linear} float encoder Linear calls")
        return got

    def remove(self):
        for h in self.handles:
            h.remove()


def int8_fidelity(name, run, model, got, refs):
    """The plain int8 runs (bf16 and fp32, no kernel launched) of
    ``run()``.  Gate: the kernels' int8 depth ``got`` sits no further from
    the plain int8 bf16 run than E2E_DRIFT_FACTOR times plain bf16's
    distance from fp32, both as the float path's plain runs ``refs`` =
    (bf16, fp32) of the same frames measure it and as the plain int8 runs
    do (two bf16 paths that round at the same points are two draws of one
    rounding noise, int8 ties included).  Printed: delta1 and AbsRel
    against the float fp32 run.  Returns the tolerance."""
    from vdn_torch import kernels
    kernels.reset_launches()
    with kernels.plain_reference():
        p16 = run()
        model.compute_dtype = torch.float32
        try:
            p32 = run()
        finally:
            model.compute_dtype = torch.bfloat16
    if any(kernels.launches.values()):
        fail(f"kernels launched inside plain_reference: {kernels.launches}")
    ref16, ref32 = refs
    vs_plain, noise = drift(p16, got), drift(p32, p16)
    tol = E2E_DRIFT_FACTOR * min(noise["rel_l2"],
                                 drift(ref32, ref16)["rel_l2"])
    log(f"{name}_reference", kernels_vs_plain_int8_bf16=json.dumps(vs_plain),
        plain_int8_bf16_vs_fp32=json.dumps(noise),
        int8_vs_float_fp32=json.dumps(drift(ref32, got)),
        plain_int8_fp32_vs_float_fp32=json.dumps(drift(ref32, p32)),
        rel_l2_tol=f"{tol:.3e}")
    if not np.isfinite(p32).all() or not vs_plain["rel_l2"] <= tol:
        fail(f"{name}: kernels' int8 depth vs plain int8 bf16: rel_l2 "
             f"{vs_plain['rel_l2']} > {tol}")
    return tol


def int8_clip_phase(q, frames, refs, mode, label="clip",
                    encoder=None) -> dict:
    """The clip path of ``q`` (quantized in ``mode``): infer_video_depth
    over the clip (for int8_static the first window calibrates), launches
    per window (``encoder``, INT8_ENCODER by default) and int8 convs
    asserted; ms per window; fidelity against the plain int8 runs."""
    from vdn_torch import kernels
    from vdn_torch.pipelines.infer_video import INFER_LEN, OVERLAP
    from vdn_torch.pipelines.infer_video import infer_video_depth
    watch = Int8Watch(q)
    run = lambda: infer_video_depth(q, frames, 30.0, SIZE)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    watch.reset()
    t0 = time.perf_counter()
    depth = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    encoder = encoder or INT8_ENCODER
    n_conv = watch.check(f"{label} {mode}")
    check_depth(f"{label} {mode}", depth, N_FRAMES)
    if q.quantize == "int8_static" and quant_stats(q):
        fail(f"{label} {mode}: the clip call left its scales on the model")
    windows = -(-N_FRAMES // (INFER_LEN - OVERLAP))
    check_launches(f"{label} {mode}", counts,
                   [n for n in CLIP_KERNELS if encoder.get(n, 1)])
    check_frame_launches(f"{label} {mode} per window",
                         {k: v / windows for k, v in counts.items()},
                         encoder)
    log(f"{label}_{mode}", windows=windows, wall_s=f"{wall:.3f}",
        peak_mem_gib=f"{peak / 2 ** 30:.3f}", int8_convs=n_conv,
        int8_convs_per_window=f"{n_conv / windows:.1f}",
        launches=json.dumps(counts, separators=(",", ":")))
    watch.remove()
    if mode == "int8_static":
        # the timed windows serve on the first window's scales, as the
        # clip's do (the clip call leaves the model's scales as it found
        # them)
        from vdn_torch.nn.layers import quant_calibration
        with torch.no_grad(), quant_calibration(q):
            q.forward_window(window_input(frames))
    time_windows(q, frames, f"windows_{label.replace('clip', '')}{mode}")
    clear_quant_stats(q)
    int8_fidelity(f"{label}_{mode}", run, q, depth, refs)
    return counts


def fresh_stream(q, frames, k):
    """run_stream on a model with no calibrated scales: an int8_static
    stream's first frame calibrates afresh."""
    clear_quant_stats(q)
    return run_stream(q, frames, k)


def int8_stream_phase(q, frames, refs, mode, encoder=None,
                      chunks=(1, STREAM_CHUNK), label="stream"):
    """The stream of ``q`` over N_INT8_STREAM frames per frame (k = 1;
    for int8_static the first frame calibrates) and, where ``chunks`` has
    it, in chunks of STREAM_CHUNK; launches per encoder pass (``encoder``,
    INT8_ENCODER by default) and int8 convs asserted for each; the k = 1
    stream held to the plain int8 runs and the chunked one to the k = 1
    stream.  Returns the launches at k = 1 and chunked (or None)."""
    from vdn_torch import kernels
    encoder = encoder or INT8_ENCODER
    frames = frames[:N_INT8_STREAM]
    watch = Int8Watch(q)
    out = {}
    for k in chunks:
        kernels.reset_launches()
        watch.reset()
        d, walls, _ = fresh_stream(q, frames, k)
        counts = dict(kernels.launches)
        # vdn's gate sends no conv of a single 518 x 518 frame to int8
        # with per-frame scales (N * oh * ow < 32768 below 296 x 296,
        # and 296 x 296 is excluded); the calibrated mode takes 296 x 296
        n_conv = watch.check(f"stream {mode} k={k}",
                             some=mode == "int8_static" or k > 1)
        check_depth(f"stream {mode} k={k}", d, N_INT8_STREAM)
        # encoder passes: one per frame at k = 1; per chunk, one for the
        # first frame and one for the rest of its chunk, then one a chunk
        passes = (N_INT8_STREAM if k == 1
                  else 1 + -(-(N_INT8_STREAM - 1) // k))
        check_frame_launches(f"{label} {mode} k={k} per encoder pass",
                             {n: counts.get(n, 0) / passes
                              for n in encoder}, encoder)
        log(f"{label}_{mode}_k{k}", frames=N_INT8_STREAM,
            ms_per_frame=f"{statistics.median(walls[1:]) / k:.3f}"
            if k == 1 else f"{sum(walls[1:]) / (N_INT8_STREAM - k):.3f}",
            first_frame_ms=f"{walls[0]:.3f}", int8_convs=n_conv,
            launches=json.dumps(counts, separators=(",", ":")))
        out[k] = (d, counts)
    watch.remove()
    d1 = out[1][0]
    tol = int8_fidelity(f"{label}_{mode}",
                        lambda: fresh_stream(q, frames, 1)[0],
                        q, d1, [r[:N_INT8_STREAM] for r in refs])
    if STREAM_CHUNK not in out:
        return out[1][1], None
    dk = out[STREAM_CHUNK][0]
    k_vs_1 = drift(d1, dk)
    log(f"stream_{mode}_chunked", **{f"k{STREAM_CHUNK}_vs_k1":
                                     json.dumps(k_vs_1)},
        rel_l2_tol=f"{tol:.3e}")
    if not k_vs_1["rel_l2"] <= tol:
        fail(f"stream {mode} k={STREAM_CHUNK} vs k=1: rel_l2 "
             f"{k_vs_1['rel_l2']} > {tol}")
    return out[1][1], out[STREAM_CHUNK][1]


def int8_video_phases(model, frames, clip_refs, stream_refs) -> dict:
    """For each mode, ``model``'s weights in a quantized VideoDepthAnything
    through the clip and the stream, held with the float path's plain runs
    (bf16, fp32) of each; returns the launches by path."""
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    out = {}
    for mode in INT8_MODES:
        q = quantized_model(build_video_depth_anything, model, mode)
        out[f"clip_{mode}"] = int8_clip_phase(q, frames, clip_refs, mode)
        k1, kc = int8_stream_phase(q, frames, stream_refs, mode)
        out[f"stream_{mode}_k1"] = k1
        out[f"stream_{mode}_k{STREAM_CHUNK}"] = kc
        del q
        torch.cuda.empty_cache()
    return out


def int8_image_phase(model, frames, refs, mode, launches=None,
                     label="image") -> dict:
    """The image pipeline in ``mode`` over N_INT8_IMAGE frames through the
    bank (for int8_static the first calibrates); launches per image
    (``launches``, INT8_IMAGE_LAUNCHES by default) and int8 convs
    asserted; for int8_static the recalibration after clear_memory()
    (``check_recalibration``); fidelity against the plain int8 runs."""
    from vdn_torch import kernels
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    q = quantized_model(build_depth_anything_v2, model, mode)
    images = [np.ascontiguousarray(f[..., ::-1])
              for f in frames[:N_INT8_IMAGE]]
    new_pipe = lambda: DepthAnythingV2Pipeline(q, capacity=MEM_CAPACITY)

    def run(pipe=None):
        clear_quant_stats(q)
        return run_images(pipe or new_pipe(), images)

    watch = Int8Watch(q)
    kernels.reset_launches()
    watch.reset()
    pipe = new_pipe()
    d, walls, per = run(pipe)
    counts = dict(kernels.launches)
    n_conv = watch.check(f"{label} {mode}", some=mode == "int8_static")
    watch.remove()
    check_depth(f"{label} {mode}", d, N_INT8_IMAGE)
    for i, c in enumerate(per):
        check_frame_launches(f"{label} {mode} frame {i}", c, {
            **(launches or INT8_IMAGE_LAUNCHES),
            **(IMAGE_FIRST if i == 0 else {})})
    log(f"{label}_{mode}", images=N_INT8_IMAGE,
        first_frame_ms=f"{walls[0]:.3f}",
        steady_ms_per_frame=f"{statistics.median(walls[MEMORY_PROBE - 1:]):.3f}",
        int8_convs=n_conv,
        launches_steady=json.dumps(per[-1], separators=(",", ":")))
    if mode == "int8_static":
        check_recalibration(q, pipe, new_pipe, frames[N_INT8_IMAGE])
    int8_fidelity(f"{label}_{mode}", lambda: run()[0], q, d,
                  [r[:N_INT8_IMAGE] for r in refs])
    return counts


def check_recalibration(q, pipe, new_pipe, frame) -> None:
    """clear_memory(), then an image of a smaller range (the frame's
    contrast cut to a quarter): its first pass calibrates on top of the
    scales the bank's first image left, as vdn's pipeline merges its stats
    into its params.  Fails if any scale shrank, or differs from the max of
    the two images' own; logs how many the new image alone would have
    lowered."""
    before = quant_stats(q)
    dim = (128 + (frame.astype(np.int16) - 128) // 4).astype(np.uint8)
    dim = np.ascontiguousarray(dim[..., ::-1])
    pipe.clear_memory()
    run_images(pipe, [dim])
    after = quant_stats(q)
    clear_quant_stats(q)
    run_images(new_pipe(), [dim])
    alone = quant_stats(q)
    if set(after) != set(before) or set(alone) != set(before) or any(
            after[n] != max(before[n], alone[n]) for n in before):
        fail(f"image int8_static: recalibration after clear_memory() kept "
             f"{after}, not the max of {before} and {alone}")
    log("image_int8_static_recalibration", convs=len(before),
        shrunk=sum(after[n] < before[n] for n in before),
        lower_alone=sum(alone[n] < before[n] for n in before))


# ---------------------------------------------------------------- phase 8c
# F6 on the int8 paths: VDN_FLASH_INT8 set around a phase, as a user sets
# it for the process (the wrapper reads it at each call)
@contextlib.contextmanager
def flash_int8(mode: str):
    before = os.environ.get("VDN_FLASH_INT8")
    os.environ["VDN_FLASH_INT8"] = mode
    try:
        yield
    finally:
        if before is None:
            del os.environ["VDN_FLASH_INT8"]
        else:
            os.environ["VDN_FLASH_INT8"] = before


def uncached_window_phase(q, frames) -> dict:
    """One window of infer_video_depth(cache_encoder=False) over 22 frames
    (32 inputs: the encoder over all 32 frames, F6 at B 32, no calibration
    pass, so an int8_static model without scales quantizes its convs per
    frame): one encoder pass's launches, a finite and not degenerate depth;
    its wall seconds."""
    from vdn_torch import kernels
    from vdn_torch.pipelines.infer_video import (INFER_LEN, OVERLAP,
                                                 infer_video_depth)
    n, label = INFER_LEN - OVERLAP, "all_uncached"
    clear_quant_stats(q)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    depth, _ = infer_video_depth(q, frames[:n], 30.0, SIZE,
                                 cache_encoder=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    check_depth(label, depth, n)
    check_frame_launches(f"{label} per window", counts, F6_ENCODER)
    log(label, frames=n, windows=1, wall_s=f"{wall:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    return counts


def f6_window_phase(q, frames, mode) -> dict:
    """One cached vitl window with F6 in ``mode`` (the seed features from a
    calibrating full window): its launches, its depth finite and not
    degenerate, its ms (CUDA events, median of 5), and its distance from
    the same window through the plain versions (logged)."""
    from vdn_torch import kernels
    from vdn_torch.nn.layers import quant_calibration
    from vdn_torch.pipelines.infer_video import (KEYFRAMES, OVERLAP,
                                                 gather_seed_features)
    label = f"window_int8_static_{mode}"
    x = window_input(frames)
    clear_quant_stats(q)
    with torch.no_grad():
        with quant_calibration(q):
            _, feats = q.forward_window(x)
        seed = gather_seed_features(feats,
                                    torch.tensor(KEYFRAMES, device=DEVICE))
        x_new = x[:, OVERLAP:]
        torch.cuda.synchronize()
        kernels.reset_launches()
        depth = q.forward_window_cached(x_new, seed)[0]
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        ms = time_ms(lambda: q.forward_window_cached(x_new, seed), reps=5,
                     warmup=1)
        with kernels.plain_reference():
            plain = q.forward_window_cached(x_new, seed)[0]
    clear_quant_stats(q)
    d = depth.float().cpu().numpy()[0]
    check_depth(label, d, d.shape[0])
    check_frame_launches(label, counts, F6_ENCODER)
    log(label, cached_window_ms=f"{ms:.2f}",
        kernels_vs_plain_bf16=json.dumps(drift(
            plain.float().cpu().numpy()[0], d)),
        launches=json.dumps(counts, separators=(",", ":")))
    return counts


def f6_video_phases(model, frames, clip_refs, stream_refs) -> dict:
    """F6 on the vitl int8_static paths, ``model``'s weights: under "all"
    the 54-frame clip (launches per window F6_ENCODER, the windows timed,
    fidelity against the plain int8 runs with F6's plain version in the
    same mode), one uncached window, and N_INT8_STREAM frames streamed at
    k = 1; then one cached window each in "qk" and "pv".  Returns the
    launches by path."""
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    q = quantized_model(build_video_depth_anything, model, "int8_static")
    out = {}
    with flash_int8("all"):
        out["clip_int8_static_all"] = int8_clip_phase(
            q, frames, clip_refs, "int8_static", "all_clip", F6_ENCODER)
        out["clip_uncached_int8_static_all"] = uncached_window_phase(q,
                                                                     frames)
        out["stream_int8_static_all_k1"], _ = int8_stream_phase(
            q, frames, stream_refs, "int8_static", F6_ENCODER, chunks=(1,),
            label="all_stream")
    for mode in ("qk", "pv"):
        with flash_int8(mode):
            out[f"window_int8_static_{mode}"] = f6_window_phase(q, frames,
                                                                mode)
    del q
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 9
# launches per training step (v4, vitl 518, b2 t8): the encoder's 24
# layers through A1's training forward, D1, A2 and D3; the four motion
# modules' A3, D4 (two attention blocks each) and A4 (recompute backward);
# A6 (composite-recompute backward); A5a / A5b forward at the four fusion
# upsamples and A6's H pass (5 / 4), again in A6's recomputed composite
# (1 / 1), and backward on the transposed plans there (1 / 1) and at the
# four upsamples (4 / 4)
TRAIN_LAUNCHES = {"flash_attention_fused_qkv_train": 24,
                  "flash_attention_fused_qkv_bwd": 24,
                  "fused_ln_mlp_residual": 24,
                  "fused_ln_mlp_residual_bwd": 24,
                  "temporal_attention_block": 8,
                  "temporal_attention_block_bwd": 8,
                  "fused_ln_geglu_residual": 4, "fused_resize_island": 1,
                  "resize_rows": 11, "resize_mid_axis": 10,
                  "flash_attention_fused_qkv": 0, "flash_attention": 0,
                  "flash_attention_colbias": 0, "select_rows": 0}
METRIC_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES, "temporal_attention_block": 0,
                         "temporal_attention_block_bwd": 0,
                         "fused_ln_geglu_residual": 0}
TRAIN_WARMUP, TRAIN_STEPS = 1, 5
# The v4 recipe's initial LR is 1e-5.  On random weights its first AdamW
# step learns to silence the frozen head's noise: the head's ReLU output
# goes from two thirds positive to none (a CPU run of this phase at 42 px),
# and no gradient reaches the encoder after it.  At 1e-7 the output stays
# alive over the steps; the step's work does not depend on the LR.
TRAIN_LR = 1e-7
METRIC_TRAIN_STEPS = 3
GRAD_FRAMES = 4      # clip length of the gradient-fidelity step (b1)


def smooth_field(rng, n, hw=None, waves=4) -> np.ndarray:
    """n smooth random maps in [0, 1] (SIZE x SIZE by default): a few
    low-frequency waves each."""
    hw = hw or (SIZE, SIZE)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32) / max(hw)
    out = np.zeros((n, *hw), np.float32)
    for i in range(n):
        for _ in range(waves):
            fy, fx, ph = rng.uniform(0.5, 3.0, 3)
            out[i] += np.sin(2 * np.pi * (fy * yy + fx * xx) + 6 * ph)
    out -= out.min(axis=(1, 2), keepdims=True)
    return out / out.max(axis=(1, 2), keepdims=True)


def train_batch(rng) -> dict:
    """The refinement batch contract, synthetic: input depths in 0-65,535
    (smooth, drifting over the clip), GT depths in 0.5-10.5 that follow
    them with their own smooth error, masks with 5% invalid pixels and an
    invalid band per clip."""
    b, t = TRAIN_B, TRAIN_T
    base = smooth_field(rng, b).repeat(t, 0).reshape(b, t, SIZE, SIZE)
    drift = smooth_field(rng, b * t).reshape(b, t, SIZE, SIZE)
    da = 65535.0 * np.clip(0.8 * base + 0.2 * drift, 0, 1)
    gt = 0.5 + 10.0 * (1.0 - base) * (0.9 + 0.2 * smooth_field(
        rng, b * t).reshape(b, t, SIZE, SIZE))
    mask = (rng.random((b, t, SIZE, SIZE)) > 0.05).astype(np.float32)
    mask[:, :, :, :20] = 0.0
    return {"depth_anything_v2": da.astype(np.float32),
            "depth": gt.astype(np.float32), "mask": mask}


def positive_share(model, head, clips) -> list:
    """The share of positive outputs of ``head`` in ``model``'s forward
    of each clip: 0 would leave the ReLU nothing to pass back."""
    shares = []
    hook = head.register_forward_hook(
        lambda m, i, o: shares.append(round(float((o > 0).float().mean()),
                                            4)))
    try:
        with torch.no_grad():
            for clip in clips:
                model(clip)
    finally:
        hook.remove()
    return shares


def build_refine_model(batch):
    """RefineVideoDepth v4 vitl, bf16: (model, output bias, the head's
    positive share on each calibration clip).  The zero convs start at
    zero (shift_head, scale_head.feat.1: the cotangent to everything before
    them would be exactly 0) and so do the motion modules' proj_out (A3
    and A4 would not reach the output): all get small random weights.  The
    output bias is calibrated on one clip of ``batch`` at the step's length
    and at the gradient check's shorter one: with fewer frames the motion
    modules shift the head's pre-activation by more than its spread on
    random weights."""
    from vdn_torch.models.refine import build_refine_video_depth
    gen = torch.Generator().manual_seed(SEED + 3)
    model = build_refine_video_depth(4, "vitl", compute_dtype=torch.bfloat16,
                                     device="cpu", generator=gen)
    with torch.no_grad():
        for conv in (model.shift_head[0], model.scale_head.feat[1]):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * 0.5)
        for mm in model.temporal_head.motion_modules:
            w = mm.temporal_transformer.proj_out.weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.5
                    * w.shape[1] ** -0.5)
    model = model.to(DEVICE)
    clips = [torch.from_numpy(batch["depth_anything_v2"][:1, :t]).to(DEVICE)
             for t in (TRAIN_T, GRAD_FRAMES)]
    bias = calibrate_output_bias(model.temporal_head.scratch,
                                 lambda: [model(c) for c in clips])
    return model, bias, positive_share(model, model.temporal_head, clips)


def grad_vector(params) -> torch.Tensor:
    return torch.cat([p.grad.float().reshape(-1) for p in params])


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def gradient_fidelity(name, model, params, loss_fn) -> dict:
    """One step's gradients (every tensor that gets one, concatenated) with
    the kernels, then through the plain versions in bf16 and in fp32.
    Gates: the kernels' gradient sits no further from the plain bf16 one,
    and no further from the fp32 one, than E2E_DRIFT_FACTOR times plain
    bf16's own distance from fp32, and that distance is not 0 (a gradient
    that depends on no compute path compares nothing)."""
    from vdn_torch import kernels

    def grads():
        model.zero_grad(set_to_none=True)
        loss_fn().backward()
        with_grad = [p for p in params if p.grad is not None]
        g = grad_vector(with_grad)
        model.zero_grad(set_to_none=True)
        return g, len(with_grad)

    kernels.reset_launches()
    g_kern, n_kern = grads()
    if not kernels.launches["flash_attention_fused_qkv_bwd"]:
        fail(f"{name}: the kernels' gradient step launched no D1")
    kernels.reset_launches()
    with kernels.plain_reference():
        g16, n16 = grads()
        model.compute_dtype = torch.float32
        try:
            g32, n32 = grads()
        finally:
            model.compute_dtype = torch.bfloat16
    if any(kernels.launches.values()):
        fail(f"kernels launched inside plain_reference: {kernels.launches}")
    if not n_kern == n16 == n32 or not bool(torch.isfinite(g32).all()):
        fail(f"{name}: gradient tensors {n_kern}, {n16}, {n32}")
    res = {"kernels_vs_plain_bf16": rel_l2(g_kern, g16),
           "kernels_vs_fp32": rel_l2(g_kern, g32),
           "plain_bf16_vs_fp32": rel_l2(g16, g32), "tensors": n_kern,
           "grad_norm_fp32": float(g32.norm())}
    tol = E2E_DRIFT_FACTOR * res["plain_bf16_vs_fp32"]
    log(f"{name}_grads", **{k: (f"{v:.4e}" if isinstance(v, float) else v)
                            for k, v in res.items()}, rel_l2_tol=f"{tol:.4e}")
    if not tol > 0:
        fail(f"{name}: the plain bf16 and fp32 gradients are identical: no "
             f"gradient passes through the compute dtype")
    if not (res["kernels_vs_plain_bf16"] <= tol
            and res["kernels_vs_fp32"] <= tol):
        fail(f"{name}: kernels' gradient vs plain bf16 "
             f"{res['kernels_vs_plain_bf16']}, vs fp32 "
             f"{res['kernels_vs_fp32']}, tolerance {tol}")
    return res


def timed_steps(step, n: int):
    """n steps of ``step()``, each ended by a synchronize: (results, wall
    ms per step, peak device memory in bytes, launches of the n steps)."""
    from vdn_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out.append(step())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = dict(kernels.launches)
    return out, walls, torch.cuda.max_memory_allocated(), counts


def check_updates(name: str, named, before) -> list:
    """Every trainable tensor that got a gradient in the last step got a
    nonzero one and changed over the steps, and only those: the rest
    (tensors no forward reads, as the ViT's mask_token) are returned."""
    no_grad = sorted(n for n, p in named if p.grad is None)
    zero = sorted(n for n, p in named
                  if p.grad is not None and not bool(p.grad.any()))
    if zero:
        fail(f"{name}: zero gradient in the last step: {zero[:6]}")
    stuck = sorted(n for (n, p), b in zip(named, before)
                   if torch.equal(p.detach(), b))
    if stuck != no_grad:
        fail(f"{name}: unchanged {stuck[:6]}, without gradient "
             f"{no_grad[:6]}")
    return no_grad


def check_no_backward_raises() -> None:
    """B1, C1, C2's bf16 kernel (D2 is fp32), C3, F1-F6 and the single E1
    step (the ring's backward is a recompute) have no backward: on
    the card each raises when an input requires grad, rather than return an output that cuts the
    graph (the training phases show that the wrappers with a backward keep
    it: every trainable tensor upstream of them gets a nonzero gradient)."""
    from vdn_torch.kernels import flash_attention as fa, int8, resize
    from vdn_torch.kernels import ring_attention as ra
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=DEVICE,
                    requires_grad=True)
    x = torch.zeros((2, 4, 8), dtype=torch.bfloat16, device=DEVICE,
                    requires_grad=True)
    t = torch.zeros((1, 32, 64), dtype=torch.bfloat16, device=DEVICE,
                    requires_grad=True)
    qkv = torch.zeros((1, 64, 3, 2, 64), dtype=torch.bfloat16, device=DEVICE,
                      requires_grad=True)
    v64 = torch.zeros(64, device=DEVICE)
    w = lambda f, k: (torch.zeros((f, k), dtype=torch.int8, device=DEVICE),
                      torch.ones(f, device=DEVICE))
    calls = {"select_rows": lambda: resize.select_rows(
                 x, torch.eye(4, device=DEVICE)),
             "flash_attention": lambda: fa.flash_attention(q, q, q),
             "flash_attention_colbias": lambda: fa.flash_attention_colbias(
                 q, q, q, torch.zeros(64, device=DEVICE)),
             "int8_ln_linear": lambda: int8.int8_ln_linear(
                 t, v64, v64, w(64, 64), v64),
             "int8_linear": lambda: int8.int8_linear(t, w(64, 64), v64),
             "int8_proj_residual": lambda: int8.int8_proj_residual(
                 t, t, w(64, 64), v64, v64),
             "fused_ln_mlp_residual_int8":
                 lambda: int8.fused_ln_mlp_residual_int8(
                     t, v64, v64, w(128, 64), torch.zeros(128, device=DEVICE),
                     w(64, 128), v64, v64),
             "fused_ln_swiglu_residual_int8":
                 lambda: int8.fused_ln_swiglu_residual_int8(
                     t, v64, v64, w(256, 64), torch.zeros(256, device=DEVICE),
                     w(64, 128), v64, v64),
             "ring_step": lambda: ra.ring_step(
                 t, t, t, *_zero_carry(1, 32, 64), 0.125),
             "flash_attention_int8_fused_qkv":
                 lambda: fa.flash_attention_int8_fused_qkv(qkv, mode="all"),
             "flash_attention_qkv": lambda: fa.flash_attention_qkv(qkv)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError:
            continue
        fail(f"{name} returned an output for an input that requires grad")
    log("no_backward", raised=json.dumps(sorted(calls)))


def check_step_launches(name: str, counts: dict, steps: int,
                        want: dict) -> dict:
    check_launches(name, counts, [k for k, v in want.items() if v])
    per_step = {k: v / steps for k, v in counts.items()}
    check_frame_launches(f"{name} per step", per_step, want)
    return {k: int(v) for k, v in per_step.items()}


def train_phase() -> dict:
    """RefineTrainer (v4, vitl 518, b2 t8, bf16, frozen temporal head):
    TRAIN_WARMUP + TRAIN_STEPS steps on a synthetic batch, the launch
    counts set to 0 just before the timed steps and read just after.
    First the gradient fidelity at b1 t GRAD_FRAMES, of the loss and of
    the model under a fixed output cotangent.  Gates: those, the per-step
    launches, finite losses, the frozen head bit-identical, every tensor
    that gets a gradient gets a nonzero one and changes."""
    from vdn_torch.train.trainer import RefineTrainer
    rng = np.random.default_rng(SEED)
    batch = train_batch(rng)
    model, bias, alive = build_refine_model(batch)
    trainer = RefineTrainer(model, initial_lr=TRAIN_LR)
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith("temporal_head.")}
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    x1, gt1, mask1 = trainer._batch(
        {k: v[:1, :GRAD_FRAMES] for k, v in batch.items()})
    params = [p for _, p in named]
    gradient_fidelity("train", model, params,
                      lambda: trainer.loss(x1, gt1, mask1)["total_loss"])
    # The loss sends each frame's median and MAD cotangent to the one pixel
    # that holds the value, and rounding moves that pixel, so the loss's
    # gradient is dominated by where the medians fall.  A fixed smooth
    # cotangent on the output holds the model's backward alone.
    cot = torch.from_numpy(smooth_field(rng, GRAD_FRAMES) - 0.5)[None].to(
        DEVICE)
    gradient_fidelity("train_vjp", model, params,
                      lambda: (model(x1) * cot).sum())
    del x1, gt1, mask1, cot
    before = [p.detach().clone() for _, p in named]
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(batch)
    losses, walls, peak, counts = timed_steps(
        lambda: trainer.train_step(batch), TRAIN_STEPS)
    per_step = check_step_launches("train", counts, TRAIN_STEPS,
                                   TRAIN_LAUNCHES)
    total = [float(l["total_loss"]) for l in losses]
    if not np.isfinite(total).all():
        fail(f"train: losses {total}")
    changed_head = [k for k, v in model.state_dict().items()
                    if k in frozen and not torch.equal(v, frozen[k])]
    if changed_head:
        fail(f"train: the frozen head changed: {changed_head[:5]}")
    no_grad = check_updates("train", named, before)
    del before
    log("train", batch=f"b{TRAIN_B}xt{TRAIN_T}", steps=TRAIN_STEPS,
        output_bias=f"{bias:.6g}", head_positive_share=json.dumps(alive),
        ms_per_step=f"{statistics.median(walls):.3f}",
        step_ms=json.dumps([round(w, 2) for w in walls]),
        peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        losses=json.dumps([float(f"{x:.9g}") for x in total]),
        trainable_tensors=len(trainer.params),
        without_gradient=json.dumps(no_grad),
        launches_per_step=json.dumps(per_step, separators=(",", ":")))
    return counts


def metric_train_phase(frames) -> dict:
    """MetricDepthTrainer (vitl 518, b2, bf16): METRIC_TRAIN_STEPS steps
    after one warm-up, the launch counts set to 0 just before and read just
    after; the per-step launches, finite losses and changed weights are
    gated, then the gradient fidelity of one b1 step."""
    from vdn_torch.models.metric_depth import build_metric_depth_anything_v2
    from vdn_torch.pipelines.transform import preprocess_frame
    from vdn_torch.train.metric_depth import MetricDepthTrainer
    model = build_metric_depth_anything_v2(
        "vitl", compute_dtype=torch.bfloat16, device="cpu",
        generator=torch.Generator().manual_seed(SEED + 4)).to(DEVICE)
    rng = np.random.default_rng(SEED + 1)
    img = np.stack([preprocess_frame(f, SIZE) for f in frames[:TRAIN_B]])
    depth = 0.5 + 15.0 * smooth_field(rng, TRAIN_B)
    mask = (rng.random(depth.shape) > 0.05).astype(np.float32)
    batch = {"image": img, "depth": depth.astype(np.float32),
             "valid_mask": mask}
    x = torch.from_numpy(img[:1]).to(DEVICE)
    bias = calibrate_output_bias(model.depth_head.scratch, lambda: model(x),
                                 quantile=0.5, unit_scale=True)
    trainer = MetricDepthTrainer(model)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    before = [p.detach().clone() for _, p in named]
    flips = np.random.default_rng(SEED)
    trainer.train_step(batch, flips)
    losses, walls, peak, counts = timed_steps(
        lambda: trainer.train_step(batch, flips), METRIC_TRAIN_STEPS)
    per_step = check_step_launches("metric_train", counts,
                                   METRIC_TRAIN_STEPS, METRIC_TRAIN_LAUNCHES)
    if not np.isfinite(losses).all():
        fail(f"metric_train: losses {losses}")
    no_grad = check_updates("metric_train", named, before)
    del before
    log("metric_train", batch=f"b{TRAIN_B}", steps=METRIC_TRAIN_STEPS,
        output_bias=f"{bias:.6g}",
        ms_per_step=f"{statistics.median(walls):.3f}",
        step_ms=json.dumps([round(w, 2) for w in walls]),
        peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        losses=json.dumps([round(x, 6) for x in losses]),
        without_gradient=json.dumps(no_grad),
        launches_per_step=json.dumps(per_step, separators=(",", ":")))
    small = [torch.from_numpy(a[:1]).to(DEVICE)
             for a in (img, batch["depth"], mask)]
    gradient_fidelity("metric_train", model, [p for _, p in named],
                      lambda: trainer.loss(*small))
    return counts


# ---------------------------------------------------------------- v1
# The v1 research model (dual hieradet encoders + the sangyu head) at
# hiera_base's full width, fp32 as vdn trains it: b2 x s8 clips of
# 256 x 256 (hieradet's stage 2 at 16 x 16 = 256 tokens, so its global
# blocks 12, 16 and 20 take C2; 2 encoders x 3 blocks = 6 per forward).
V1_ENCODER = "hiera_base"
V1_LEVELS = (2, 3)
V1_SIZE = 256
V1_B, V1_S = 2, 8
V1_FRAMES = V1_B * V1_S
V1_HEADS, V1_DH = 4, 96
V1_TOKENS = (256, 324)   # stage 2 at 256 px, and at 288 px (ragged)
V1_GRAD_S = 4            # clip length of the gradient-fidelity step (b1)
V1_WARMUP, V1_STEPS = 1, 5
# The recipe's LR (vdn's V1Trainer default).  On random weights the head's
# ReLUs stay alive over the steps at it (``v1_train`` logs the positive
# share of the last hidden conv before and after); the step's work does
# not depend on the LR.
V1_LR = 1e-5
V1_WEIGHT_DECAY = 0.01
# the hub MAE Hiera's published configuration: hiera_base_224 at 224 x 224
V1_MAE_ENCODER, V1_MAE_SIZE, V1_MAE_STEPS = "hiera_base_224", 224, 2
# kernels vs plain fp32 on the card, rel L2 (both fp32; sums in another
# order, C2 / D2's online softmax against the exact one): the model's
# outputs, and its VJP under a fixed cotangent within E2E_DRIFT_FACTOR
# times the plain run's own VJP distance when an input moves by 1e-6 (on
# random weights that moves every gradient by ~1e-3, as v1_fidelity
# logs), and never above V1_VJP_REL_L2 short of it
V1_VJP_REL_L2 = 1e-4
V1_INFER_REL_L2 = 1e-5
# launches per training step: C2 and D2 at the six global blocks; A5a / A5b
# forward at the five 2x upsamples of the head and the two encoders'
# pos-embed bicubic (14 -> 64), and backward on the transposed plans: the
# pos-embed's H plan (19 taps) runs dense through A5b.  Inference: the
# forwards alone.  Every other kernel launches 0.
V1_TRAIN_LAUNCHES = {"flash_attention": 6, "flash_attention_bwd": 6,
                     "resize_rows": 12, "resize_mid_axis": 16}
V1_INFER_LAUNCHES = {"flash_attention": 6, "resize_rows": 7,
                     "resize_mid_axis": 7}
# the head's parameters no forward reads: the stacks and pos-embeds of the
# levels outside V1_LEVELS, the fusion layers
V1_UNUSED = tuple(f"head.{s}.{lvl}." for s in (
    "temporal_layers_first", "temporal_layers_second",
    "spatial_layers_first", "spatial_layers_second")
    for lvl in range(4) if lvl not in V1_LEVELS) + tuple(
    f"head.pos_embeds.{lvl}" for lvl in range(4) if lvl not in V1_LEVELS) + (
    "head.fusion_layer.",)


def all_launches(want: dict) -> dict:
    """``want`` over every kernel, the others at 0."""
    from vdn_torch import kernels
    return {**{n: 0 for n in kernels.launches}, **want}


def v1_attention_cases(rng, path="v1"):
    """C2 at fp32 / D 96 and D2 on hieradet's global blocks: q, k, v read
    in place off the fused qkv [16, T, 3, 4, 96] fp32, at T = 256 (256 px)
    and 324 (288 px: ragged tiles).  Library calls: SDPA's forward, and
    its backward timed as forward + backward less forward, in fp32.
    Bounds: three times the products' operations at the TF32 tensor-core
    rate, the least work that keeps fp32 accuracy on the tensor cores
    (3xTF32, which C2 runs)."""
    import torch.nn.functional as F
    from vdn_torch.kernels import flash_attention as fa
    b, h, d = V1_FRAMES, V1_HEADS, V1_DH
    for t in V1_TOKENS:
        qkv = _rand(rng, (b, t, 3, h, d))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o, lse = fa._attention_lse_plain(q, k, v, None, d ** -0.5)
        sdpa_in = [x.transpose(1, 2).detach().requires_grad_()
                   for x in (q, k, v)]
        yield case(
            "flash_attention", f"B{b} T{t} H{h} D{d} fp32",
            lambda a=(q, k, v): fa.flash_attention(*a),
            lambda a=(q, k, v): fa.flash_attention_plain(*a),
            (_nbytes(q, k, v, o), [(3 * 4 * b * h * t * t * d,
                                    TF32_TENSOR_FLOPS)]),
            path, tol="fp32",
            library=lambda a=sdpa_in: F.scaled_dot_product_attention(
                *(x.detach() for x in a)))
        # the training forward: out and the log-sum-exp D2 reads
        yield case(
            "flash_attention", f"B{b} T{t} H{h} D{d} fp32 (lse)",
            lambda a=(q, k, v): fa._launch_f32(*a, d ** -0.5, True)
            if a[0].is_cuda else fa._attention_lse_plain(*a, None, d ** -0.5),
            lambda a=(q, k, v): fa._attention_lse_plain(*a, None, d ** -0.5),
            (_nbytes(q, k, v, o, lse), [(3 * 4 * b * h * t * t * d,
                                         TF32_TENSOR_FLOPS)]), path + "_lse",
            tol="fp32")
        dout = _rand(rng, (b, t, h, d))

        def sdpa_fwd_bwd(a=sdpa_in, g=dout.transpose(1, 2)):
            torch.autograd.grad(F.scaled_dot_product_attention(*a), a, g)

        def sdpa_fwd(a=sdpa_in):
            with torch.no_grad():
                F.scaled_dot_product_attention(*a)

        yield case(
            "flash_attention_bwd", f"B{b} T{t} H{h} D{d} fp32",
            lambda a=(q, k, v, o, lse, dout): fa.flash_attention_bwd(*a),
            lambda a=(q, k, v, o, dout): fa.flash_attention_bwd_plain(*a),
            (_nbytes(q, k, v, o, lse, dout) + 3 * _nbytes(o),
             [(3 * 10 * b * h * t * t * d, TF32_TENSOR_FLOPS)]), path,
            tol="fp32",
            library=sdpa_fwd_bwd, library_base=sdpa_fwd)


def v1_resize_passes():
    """The v1 step's resizes (fp32): the head's five 2x align-corners
    upsamples over 16 frames (8 -> 256 rows at C 768 ... 96) and each
    encoder's pos-embed bicubic, 14 -> 64 at C 96."""
    n, c = V1_FRAMES, (768, 384, 192, 96, 96)
    sizes = (8, 16, 32, 64, 128, 256)
    passes = [(f"head up {a}->{z}", n, a, z, a, z, ch, torch.float32,
               "bilinear", None) for a, z, ch in zip(sizes, sizes[1:], c)]
    g = V1_SIZE // 4
    passes.append((f"pos-embed 14->{g} bicubic", 1, 14, g, 14, g, 96,
                   torch.float32, "bicubic", None))
    return passes


def resize_backward_cases(rng, path, passes):
    """The backward of each resize in ``passes``: the W pass on its
    transposed plan (A5b, dense), then the H pass on its transposed plan
    (A5a, or A5b's dense form where the plan has more than MAX_TAPS
    taps: the pos-embed's 64 -> 14)."""
    from vdn_torch.kernels import resize as rz
    from vdn_torch.ops.resize import plan_axis
    dev = DEVICE
    for label, n, r_in, r_out, wd, w_out, c, dt, method, _ in passes:
        ac = method == "bilinear"
        idx_t, w_t = rz.transpose_plan(*plan_axis(w_out, wd, method, ac,
                                                  None), wd)
        g = _rand(rng, (n * r_out, w_out, c)).to(dev, dt)
        y = torch.empty((n * r_out, wd, c), dtype=dt, device=dev)
        dense = rz.dense_plan(idx_t, w_t, w_out, dt, dev)
        yield case(
            "resize_mid_axis", f"{label} W bwd N{n * r_out} C{c}",
            lambda g=g, i=idx_t, w=w_t, o=wd: rz.resize_mid_axis(g, i, w, o),
            lambda g=g, dense=dense: rz.mix_rows_plain(g, dense),
            (_nbytes(g, y, dense), [(2 * g.shape[0] * c * _taps(w_t),
                                     FP32_FLOPS)]), path, tol="fp32")
        idx_t, w_t = rz.transpose_plan(*plan_axis(r_out, r_in, method, ac,
                                                  None), r_in)
        g = _rand(rng, (n, r_out, wd, c)).to(dev, dt)
        y = torch.empty((n, r_in, wd, c), dtype=dt, device=dev)
        pidx, pw = rz.rows_plan(idx_t, w_t, dev)
        flops = [(2 * n * wd * c * _taps(w_t), FP32_FLOPS)]
        if pidx.shape[1] > rz.MAX_TAPS:
            dense = rz.dense_plan(idx_t, w_t, r_out, dt, dev)
            name, extra = "resize_mid_axis", _nbytes(dense)
            plain = lambda g=g, dense=dense, s=(n, r_in, wd, c): \
                rz.mix_rows_plain(g.reshape(n, r_out, -1), dense).reshape(s)
        else:
            name, extra = "resize_rows", 0
            plain = lambda g=g, pidx=pidx, pw=pw: rz.resize_rows_plain(
                g, pidx, pw)
        yield case(
            name, f"{label} H bwd N{n} C{c}"
            + (" (dense)" if extra else ""),
            lambda g=g, i=idx_t, w=w_t, o=r_in: rz.resize_rows(g, i, w, o),
            plain, (_nbytes(g, y) + extra, flops), path, tol="fp32")


def v1_cases(rng):
    """The v1 step's kernels at their shapes: C2 / D2 at the global blocks
    and A5a / A5b forward and backward at the head's upsamples and the
    pos-embed (its wide transposed plan among them)."""
    yield from v1_attention_cases(rng)
    passes = v1_resize_passes()
    yield from upsample_cases(rng, "v1", passes)
    yield from resize_backward_cases(rng, "v1", passes)


class exact_fp32:
    """vdn's v1 is fp32: matmuls and cuDNN convs in full fp32, not TF32,
    for the block (environment() already turns TF32 off for the whole
    script; this states it for the v1 phases and restores what it
    found)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def v1_batch(rng, size=None) -> dict:
    """The v1 batch contract at V1_B x V1_S clips of size x size (V1_SIZE
    by default), synthetic: RGB frames in 0-1, input depths in 0-65,535
    and GT depths in 0.5-10.5 (smooth, drifting over the clip), masks with
    5% invalid pixels and an invalid band."""
    b, s, hw = V1_B, V1_S, (size or V1_SIZE,) * 2
    base = smooth_field(rng, b, hw).repeat(s, 0).reshape(b, s, *hw)
    drift = smooth_field(rng, b * s, hw).reshape(b, s, *hw)
    da = 65535.0 * np.clip(0.8 * base + 0.2 * drift, 0, 1)
    gt = 0.5 + 10.0 * (1.0 - base) * (0.9 + 0.2 * smooth_field(
        rng, b * s, hw).reshape(b, s, *hw))
    rgb = np.stack([smooth_field(rng, b * s, hw) for _ in range(3)],
                   -1).reshape(b, s, *hw, 3)
    mask = (rng.random((b, s, *hw)) > 0.05).astype(np.float32)
    mask[..., :, :8] = 0.0
    return {"rgb": rgb.astype(np.float32),
            "depth_anything_v2": da.astype(np.float32),
            "depth": gt.astype(np.float32), "mask": mask}


def build_v1_model(encoder=V1_ENCODER, seed=SEED + 7):
    """VideoDepthEstimationModel at ``encoder``'s full width, seeded random
    weights (fp32), on the card.  hieradet's pos-embed tables start at zero
    in vdn; they get small random values so the bicubic resize reaches the
    features."""
    from vdn_torch.models.video_depth_v1 import build_video_depth_v1
    gen = torch.Generator().manual_seed(seed)
    model = build_video_depth_v1(encoder, device="cpu", generator=gen,
                                 sequence_length=V1_S,
                                 attention_feature_levels=V1_LEVELS)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("pos_embed", "pos_embed_window")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.to(DEVICE)


def head_positive_share(model, inputs) -> float:
    """The share of positive pre-activations of the head's last hidden
    conv (final_upscale_layer.8, before its ReLU) on ``inputs``."""
    seen = []
    hook = model.head.final_upscale_layer[8].register_forward_hook(
        lambda m, i, o: seen.append(float((o > 0).float().mean())))
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        hook.remove()
    return round(seen[0], 4)


def v1_fidelity(model, trainer, small, cot) -> dict:
    """One b1 x s4 step's gradients with the kernels (C2 / D2 must launch)
    and through the plain versions, both fp32, rel L2 over every tensor
    that gets one.  Gated: the model's outputs (V1_INFER_REL_L2) and its
    VJP under the fixed cotangent ``cot`` (see V1_VJP_REL_L2), which hold
    C2, D2 and A5a / A5b.  Logged: the loss's gradient against the plain
    one, beside the plain one's own distances when the input depths or
    frames move by 1e-6 (the trimmed and median terms send their
    cotangent to the pixels that hold the selected values, and a rounding
    can move those pixels)."""
    from vdn_torch import kernels
    inputs = small[:2]

    def vjp(x=inputs):
        d, n = model(*x)
        return (d * cot[0]).sum() + (n * cot[1]).sum()

    def loss(x=inputs):
        return trainer.loss(*x, *small[2:])["total_loss"]

    def grads(fn):
        model.zero_grad(set_to_none=True)
        fn().backward()
        have = [p for p in model.parameters() if p.grad is not None]
        tensors[0] = len(have)
        g = grad_vector(have)
        model.zero_grad(set_to_none=True)
        return g

    tensors = [0]

    kernels.reset_launches()
    with torch.no_grad():
        out_k = model(*inputs)
    g_vjp, g_loss = grads(vjp), grads(loss)
    if not kernels.launches["flash_attention_bwd"]:
        fail("v1_train: the kernels' gradient step launched no D2")
    kernels.reset_launches()
    floor = {}
    with kernels.plain_reference():
        with torch.no_grad():
            out_p = model(*inputs)
        p_vjp, p_loss = grads(vjp), grads(loss)
        # the plain run's own distance when one input moves by 1e-6
        for i, name in enumerate(("depth", "rgb")):
            nudged = list(inputs)
            nudged[i] = nudged[i] * (1 + 1e-6)
            with torch.no_grad():
                out_n = model(*nudged)
            floor[name] = (
                max(rel_l2(a, b) for a, b in zip(out_n, out_p)),
                rel_l2(grads(lambda: vjp(nudged)), p_vjp),
                rel_l2(grads(lambda: loss(nudged)), p_loss))
    if any(kernels.launches.values()):
        fail(f"kernels launched inside plain_reference: {kernels.launches}")
    res = {"outputs": max(rel_l2(a, b) for a, b in zip(out_k, out_p)),
           "vjp": rel_l2(g_vjp, p_vjp), "loss_grad": rel_l2(g_loss, p_loss),
           **{f"plain_nudged_{k}_{what}": v[i] for k, v in floor.items()
              for i, what in enumerate(("outputs", "vjp", "loss_grad"))}}
    vjp_tol = max(V1_VJP_REL_L2, E2E_DRIFT_FACTOR * max(
        v[1] for v in floor.values()))
    log("v1_train_grads", **{k: f"{v:.4e}" for k, v in res.items()},
        tensors=tensors[0], vjp_norm=f"{float(p_vjp.norm()):.6g}",
        outputs_tol=f"{V1_INFER_REL_L2:.0e}", vjp_tol=f"{vjp_tol:.4e}")
    if not (bool(torch.isfinite(p_vjp).all()) and float(p_vjp.norm()) > 0):
        fail("v1_train: the plain VJP is zero or not finite")
    if res["outputs"] > V1_INFER_REL_L2 or res["vjp"] > vjp_tol:
        fail(f"v1_train: kernels vs plain fp32 {res}, VJP tolerance "
             f"{vjp_tol}")
    return res


def check_decay_only(name, trainer, before: dict, lrs) -> list:
    """The parameters with an all-zero gradient in the last step are
    exactly the head's unused ones (V1_UNUSED), and each changed over the
    steps by the weight decay alone: x prod(1 - lr_t wd)."""
    named = list(trainer.model.named_parameters())
    zero = sorted(n for n, p in named if not bool(p.grad.any()))
    want = sorted(n for n, _ in named if n.startswith(V1_UNUSED))
    if zero != want:
        fail(f"{name}: zero-gradient tensors {zero[:6]} ... vs unused "
             f"{want[:6]} ...")
    factor = float(np.prod([1.0 - lr * V1_WEIGHT_DECAY for lr in lrs]))
    worst = 0.0
    for n, p in named:
        if n in want:
            err = float(((p.detach() - before[n] * factor).abs()
                         / before[n].abs().clamp_min(1e-30)).max())
            worst = max(worst, err)
    if not worst <= 1e-6:
        fail(f"{name}: unused parameters off their decay by {worst}")
    stuck = [n for n, p in named
             if n not in want and torch.equal(p.detach(), before[n])]
    if stuck:
        fail(f"{name}: parameters with a gradient unchanged: {stuck[:6]}")
    return want


def v1_train_phase() -> dict:
    """V1Trainer on the v1 model (hiera_base, levels 2 and 3, 256 x 256,
    b2 x s8, fp32): the gradient fidelity at b1 x s4 (v1_fidelity), then
    V1_WARMUP + V1_STEPS steps with the
    launch counts set to 0 just before the timed steps and read just
    after.  Gates: the fidelity, the per-step launches (C2 6, D2 6, A5a /
    A5b as counted, every other kernel 0), finite losses, every parameter
    with a gradient changed and the unused ones by the decay alone."""
    from vdn_torch.train.trainer import V1Trainer
    rng = np.random.default_rng(SEED + 7)
    batch = v1_batch(rng)
    model = build_v1_model()
    trainer = V1Trainer(model, initial_lr=V1_LR,
                        weight_decay=V1_WEIGHT_DECAY)
    small = trainer._batch({k: v[:1, :V1_GRAD_S] for k, v in batch.items()})
    alive = [head_positive_share(model, small[:2])]
    v1_fidelity(model, trainer, small,
                [_rand(rng, (1, V1_GRAD_S, V1_SIZE, V1_SIZE)),
                 _rand(rng, (1, V1_GRAD_S, V1_SIZE, V1_SIZE, 3))])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lrs = []
    for _ in range(V1_WARMUP):
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        trainer.train_step(batch)

    def step():
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        return trainer.train_step(batch)

    losses, walls, peak, counts = timed_steps(step, V1_STEPS)
    per_step = check_step_launches("v1_train", counts, V1_STEPS,
                                   all_launches(V1_TRAIN_LAUNCHES))
    total = [float(l["total_loss"]) for l in losses]
    if not np.isfinite(total).all():
        fail(f"v1_train: losses {total}")
    unused = check_decay_only("v1_train", trainer, before, lrs)
    del before
    alive.append(head_positive_share(model, small[:2]))
    if min(alive) <= 0.0:
        fail(f"v1_train: the head's ReLU went silent: {alive}")
    log("v1_train", batch=f"b{V1_B}xs{V1_S}", size=V1_SIZE,
        encoder=V1_ENCODER, lr=V1_LR, steps=V1_STEPS,
        ms_per_step=f"{statistics.median(walls):.3f}",
        step_ms=json.dumps([round(w, 2) for w in walls]),
        peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        losses=json.dumps([float(f"{x:.9g}") for x in total]),
        normal_loss=json.dumps([round(float(l["normal_loss"]), 6)
                                for l in losses]),
        head_positive_share=json.dumps(alive),
        params=sum(p.numel() for p in model.parameters()),
        decay_only_tensors=len(unused),
        launches_per_step=json.dumps(per_step, separators=(",", ":")))
    return counts, model, batch


def v1_clip(batch) -> tuple:
    """The v1 model's inputs for one 8-frame clip, the first of ``batch``:
    (depth prior, rgb)."""
    from vdn_torch.train.trainer import (preprocess_depth_sequences,
                                         preprocess_rgb_sequences)
    depth = preprocess_depth_sequences(
        torch.from_numpy(batch["depth_anything_v2"][:1]).to(DEVICE), None,
        norm=False) / 65535.0
    rgb = preprocess_rgb_sequences(
        torch.from_numpy(batch["rgb"][:1]).to(DEVICE))
    return depth, rgb


def v1_infer_phase(model, batch) -> dict:
    """The v1 model under no_grad on one 8-frame clip (the first of
    ``batch``): C2 6 and the forward resizes, the launch counts set to 0
    just before and read just after; depth and normal against the plain
    fp32 run within V1_INFER_REL_L2."""
    from vdn_torch import kernels
    depth, rgb = v1_clip(batch)
    with torch.no_grad():
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        d, n = model(depth, rgb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(kernels.launches)
        ms = time_ms(lambda: model(depth, rgb), reps=5, warmup=1)
        with kernels.plain_reference():
            d32, n32 = model(depth, rgb)
    check_frame_launches("v1_infer", counts, all_launches(V1_INFER_LAUNCHES))
    if d.shape != (1, V1_S, V1_SIZE, V1_SIZE) or n.shape != (
            1, V1_S, V1_SIZE, V1_SIZE, 3):
        fail(f"v1_infer: shapes {tuple(d.shape)}, {tuple(n.shape)}")
    if not (bool(torch.isfinite(d).all()) and bool(torch.isfinite(n).all())
            and float(d.std()) > 0):
        fail("v1_infer: non-finite or constant output")
    err = {"depth": rel_l2(d.float(), d32.float()),
           "normal": rel_l2(n.float(), n32.float())}
    log("v1_infer", frames=V1_S, ms=f"{ms:.3f}", first_wall_ms=f"{wall:.3f}",
        depth_rel_l2=f"{err['depth']:.3e}",
        normal_rel_l2=f"{err['normal']:.3e}", tol=f"{V1_INFER_REL_L2:.0e}",
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    if max(err.values()) > V1_INFER_REL_L2:
        fail(f"v1_infer: kernels vs plain fp32 {err}")
    return counts


def v1_mae_phase() -> dict:
    """The published configuration: the MAE Hiera (hiera_base_224) at
    224 x 224, b2 x s8, 1 + V1_MAE_STEPS V1Trainer steps.  Its mask-unit
    attention is plain (as in vdn, no kernel at this configuration): C2
    and D2 never launch; the pos-embed needs no resize at 224."""
    from vdn_torch.train.trainer import V1Trainer
    rng = np.random.default_rng(SEED + 8)
    batch = v1_batch(rng, size=V1_MAE_SIZE)
    model = build_v1_model(V1_MAE_ENCODER, SEED + 8)
    trainer = V1Trainer(model, initial_lr=V1_LR,
                        weight_decay=V1_WEIGHT_DECAY)
    trainer.train_step(batch)
    losses, walls, peak, counts = timed_steps(
        lambda: trainer.train_step(batch), V1_MAE_STEPS)
    check_absent("v1_mae", counts, ["flash_attention", "flash_attention_bwd"])
    total = [float(l["total_loss"]) for l in losses]
    if not np.isfinite(total).all():
        fail(f"v1_mae: losses {total}")
    log("v1_mae", encoder=V1_MAE_ENCODER, size=V1_MAE_SIZE,
        batch=f"b{V1_B}xs{V1_S}", steps=V1_MAE_STEPS,
        ms_per_step=f"{statistics.median(walls):.3f}",
        step_ms=json.dumps([round(w, 2) for w in walls]),
        peak_mem_gib=f"{peak / 2 ** 30:.3f}",
        losses=json.dumps([float(f"{x:.9g}") for x in total]),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    return counts


def v1_phases() -> dict:
    """The v1 phases, fp32 throughout: the training run, inference on its
    model, the MAE configuration.  Returns the launches by path."""
    with exact_fp32():
        train, model, batch = v1_train_phase()
        infer = v1_infer_phase(model, batch)
        del model
        torch.cuda.empty_cache()
        mae = v1_mae_phase()
        torch.cuda.empty_cache()
    return {"v1_train": train, "v1_infer": infer, "v1_mae": mae}


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
    "resize_rows": ("vdn_torch/csrc/resize_rows.cu",
                    "vdn/ops/pallas/resize.py:182"),
    "resize_mid_axis": ("vdn_torch/csrc/resize_mid_axis.cu",
                        "vdn/ops/pallas/resize.py:120"),
    "select_rows": ("vdn_torch/csrc/resize_mid_axis.cu",
                    "vdn/ops/pallas/resize.py:218"),
    "fused_resize_island": ("vdn_torch/csrc/resize_island.cu",
                            "vdn/ops/pallas/resize_island.py:244"),
    "flash_attention": ("vdn_torch/csrc/flash_attn_bthd.cu",
                        "vdn/ops/pallas/flash_attention.py:270"),
    "flash_attention_colbias": ("vdn_torch/csrc/flash_attn_bthd.cu",
                                "vdn/ops/pallas/flash_attention.py:157"),
    "flash_attention_bwd": ("vdn_torch/csrc/flash_attn_bthd_bwd.cu",
                            "vdn/ops/pallas/flash_attention.py:366"),
    "flash_attention_fused_qkv_train": (
        "vdn_torch/csrc/flash_attn_qkv.cu",
        "vdn/ops/pallas/flash_attention.py:528"),
    "flash_attention_fused_qkv_bwd": ("vdn_torch/csrc/flash_attn_qkv_bwd.cu",
                                      "vdn/ops/pallas/flash_attention.py:668"),
    "fused_ln_mlp_residual_bwd": ("vdn_torch/csrc/ln_mlp_bwd.cu",
                                  "vdn/ops/pallas/mlp.py:339"),
    "temporal_attention_block_bwd": (
        "vdn_torch/csrc/temporal_attn_bwd.cu",
        "vdn/ops/pallas/temporal_attention.py:209"),
    "int8_ln_linear": ("vdn_torch/csrc/int8_linear.cu",
                       "vdn/ops/pallas/int8.py:259"),
    "int8_linear": ("vdn_torch/csrc/int8_linear.cu",
                    "vdn/ops/pallas/int8.py:274"),
    "int8_proj_residual": ("vdn_torch/csrc/int8_linear.cu",
                           "vdn/ops/pallas/int8.py:293"),
    "fused_ln_mlp_residual_int8": ("vdn_torch/csrc/ln_mlp_int8.cu",
                                   "vdn/ops/pallas/int8.py:357"),
    "fused_ln_swiglu_residual_int8": ("vdn_torch/csrc/ln_swiglu_int8.cu",
                                      "vdn/ops/pallas/int8.py:339"),
    "ring_step": ("vdn_torch/csrc/ring_step.cu",
                  "vdn/ops/pallas/ring_attention.py:65"),
    "flash_attention_int8_fused_qkv": (
        "vdn_torch/csrc/flash_attn_int8.cu",
        "vdn/ops/pallas/flash_attention.py:920"),
    "flash_attention_qkv": ("vdn_torch/csrc/flash_attn_bthd.cu",
                            "vdn/ops/pallas/flash_attention.py:964"),
}
INT8_KERNELS = ["int8_ln_linear", "int8_linear", "int8_proj_residual",
                "fused_ln_mlp_residual_int8", "fused_ln_swiglu_residual_int8",
                "flash_attention_int8_fused_qkv"]
# kernels that no path of vdn or of the port calls (C3): a headline path
# for their times, and 0 launches on every path
NO_PATH = ["flash_attention_qkv"]
# each kernel's headline path: the one whose run gives its ``launches`` and
# whose shapes its times are summed over
HEADLINE = {"select_rows": "stream_k1", "flash_attention": "image",
            "flash_attention_colbias": "image",
            "flash_attention_bwd": "v1_train",
            "flash_attention_fused_qkv_train": "train",
            "flash_attention_fused_qkv_bwd": "train",
            "fused_ln_mlp_residual_bwd": "train",
            "temporal_attention_block_bwd": "train",
            **{n: "clip_int8_static" for n in INT8_KERNELS},
            "fused_ln_swiglu_residual_int8": "vitg_clip_int8_static",
            "flash_attention_int8_fused_qkv": "clip_int8_static_all",
            "ring_step": "cp_clip"}
# the kernels of each main path: the clip path (and the chunked stream)
# never gathers a window; the per-frame stream does; the image path's are
# the keys of IMAGE_LAUNCHES, the training paths' those of TRAIN_LAUNCHES
# and METRIC_TRAIN_LAUNCHES
STREAM_KERNELS = [n for n in SOURCES if n not in NO_PATH
                  and HEADLINE.get(n, "clip") in ("clip", "stream_k1")]
# (the int8 paths' kernels: the clip's less A2, with F1, F3 and F4 at vitl
# and F5 at vitg; INT8_ENCODER and VITG_INT8_ENCODER give their launches)
CLIP_KERNELS = [n for n in STREAM_KERNELS if n != "select_rows"]
# vitg's float paths: A2 and every int8 kernel must stay off them
VITG_CLIP_KERNELS = [n for n in CLIP_KERNELS if n != "fused_ln_mlp_residual"]
VITG_ABSENT = ["fused_ln_mlp_residual", *INT8_KERNELS]


def case_path(path: str) -> str:
    """The kernel cases' path (kernel_cases) of a run's path: its first
    word, after the model's prefix ("vitg_clip_int8_static" -> "vitg_clip",
    "stream_k1" -> "stream")."""
    words = path.split("_")
    return "_".join(words[:2] if words[0] == "vitg" else words[:1])


def vitg_phases(frames) -> dict:
    """vitg at full width, bf16 and seeded random weights: the clip (three
    windows: one full, two cached) in bf16, int8_static and int8, 12 frames
    streamed at k = 1, and N_VITG_IMAGE images through DepthAnythingV2's
    bank, then clear_memory() and the non-square images; each path's
    launches and fidelity gated as vitl's.  Returns the launches by path."""
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    model = build_model("vitg")
    bias = calibrate_output_bias(
        model.head.scratch, lambda: model.forward_window(window_input(frames)))
    log("vitg_model", output_bias=f"{bias:.6g}",
        params=sum(p.numel() for p in model.parameters()))
    depth, counts = run_main_path(model, frames, "vitg_main",
                                  VITG_CLIP_KERNELS, VITG_ABSENT)
    time_windows(model, frames, "vitg_windows")
    clip_plain = reference_runs(model, frames, depth, "vitg_reference")
    int8_conv_phase(convs=VITG_INT8_CONVS)
    k1, _, _ = stream_phase(model, frames, N_VITG_STREAM, None,
                            "vitg_stream", VITG_ABSENT)
    out = {"vitg_clip": counts, "vitg_stream_k1": k1}
    for mode in INT8_MODES:
        q = quantized_model(build_video_depth_anything, model, mode, "vitg")
        out[f"vitg_clip_{mode}"] = int8_clip_phase(
            q, frames, clip_plain, mode, "vitg_clip", VITG_INT8_ENCODER)
        if mode == "int8":
            with flash_int8("all"):
                out["vitg_clip_int8_all"] = int8_clip_phase(
                    q, frames, clip_plain, mode, "vitg_all_clip",
                    VITG_F6_ENCODER)
        del q
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    image_model = build_image_model("vitg")
    x0 = window_input(frames[:1])[0]
    bias = calibrate_output_bias(image_model.depth_head.scratch,
                                 lambda: image_model(x0))
    log("vitg_image_model", output_bias=f"{bias:.6g}")
    out["vitg_image"], _ = image_phase(image_model, frames, N_VITG_IMAGE,
                                       VITG_IMAGE_LAUNCHES, "vitg_image")
    del image_model
    torch.cuda.empty_cache()
    return out


def main() -> None:
    device = environment()
    build_kernels()
    summary = check_kernels()
    summary.update(check_kernels(train_cases(np.random.default_rng(SEED))))
    with exact_fp32():
        for name, s in check_kernels(
                v1_cases(np.random.default_rng(SEED + 7))).items():
            merged = summary.setdefault(name, {"max_abs_err": 0.0})
            merged["max_abs_err"] = max(merged["max_abs_err"],
                                        s.pop("max_abs_err"))
            merged.update(s)
    check_no_backward_raises()
    model = build_model()
    frames = synthetic_clip()
    bias = calibrate_output_bias(
        model.head.scratch, lambda: model.forward_window(window_input(frames)))
    log("model", output_bias=f"{bias:.6g}")
    depth, counts = run_main_path(model, frames)
    time_windows(model, frames)
    clip_plain = reference_runs(model, frames, depth)
    counts_k1, counts_k8, stream_plain = stream_phase(model, frames)
    launches_cp, cp_ring = cp_phases(model, frames)
    int8_conv_phase()
    launches_int8 = int8_video_phases(model, frames, clip_plain,
                                      stream_plain)
    launches_int8.update(f6_video_phases(model, frames, clip_plain,
                                         stream_plain))
    del model
    torch.cuda.empty_cache()
    image_model = build_image_model()
    x0 = window_input(frames[:1])[0]
    bias = calibrate_output_bias(image_model.depth_head.scratch,
                                 lambda: image_model(x0))
    log("image_model", output_bias=f"{bias:.6g}")
    counts_image, image_plain = image_phase(image_model, frames)
    for mode in INT8_MODES:
        launches_int8[f"image_{mode}"] = int8_image_phase(
            image_model, frames, image_plain, mode)
        torch.cuda.empty_cache()
    with flash_int8("all"):
        launches_int8["image_int8_static_all"] = int8_image_phase(
            image_model, frames, image_plain, "int8_static",
            F6_IMAGE_LAUNCHES, "all_image")
    torch.cuda.empty_cache()
    del image_model
    torch.cuda.empty_cache()
    counts_metric = metric_phase(frames)
    torch.cuda.empty_cache()
    counts_train = train_phase()
    torch.cuda.empty_cache()
    counts_metric_train = metric_train_phase(frames)
    torch.cuda.empty_cache()
    launches_vitg = vitg_phases(frames)
    torch.cuda.empty_cache()
    launches_v1 = v1_phases()
    launches = {"clip": counts, "stream_k1": counts_k1,
                f"stream_k{STREAM_CHUNK}": counts_k8, "image": counts_image,
                "metric": counts_metric, "train": counts_train,
                "metric_train": counts_metric_train, **launches_int8,
                **launches_vitg, **launches_v1, **launches_cp}
    # Per kernel: max_abs_err over all its shapes in check_kernels; ms,
    # plain_ms, library_ms and bound_ms summed over the shapes of its
    # headline path (one clip window; B1: one streamed frame's rings; C1 and
    # C2: the memory attention's shapes at both token grids; the training
    # kernels: one b2 t8 step's shapes, D4 at the four motion modules;
    # F1-F6: the cached window's rows, F5 vitg's, F6's in "all", their
    # bf16 counterpart's time in bf16_ms (F6's and C3's: A1), every shape's
    # numbers in by_shape, F6's other modes at "qk_<path>" / "pv_<path>";
    # C3: the cached window), launches over the training phase's
    # TRAIN_STEPS steps (F1-F5: the int8_static clip's three windows, F6:
    # the same under "all"; C3: 0, no path calls it), and stream_ms /
    # stream_bound_ms over the stream's shapes; launches from the run of the headline path, and from every
    # path's run; ``vitg``: the numbers at vitg's widths, by path; ``v1``:
    # C2's and A5a / A5b's at the v1 step's shapes (D2's own row: the
    # global blocks at T 256 and the ragged 324, launches over V1_STEPS;
    # E1: the CP window's four shapes at T 32, one call of a module's two,
    # ``by_t`` at local T 8 / 128 and the fp32 / carry cases, ``ring_of_4``
    # the in-process ring against the plain ring).
    rows = []
    for name, (src, tpu) in SOURCES.items():
        path = HEADLINE.get(name, "clip")
        head = summary[name][case_path(path)]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[path].get(name, 0), "path": path,
            "max_abs_err": summary[name]["max_abs_err"],
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            **({"stream_ms": summary[name]["stream"]["ms"],
                "stream_bound_ms": summary[name]["stream"]["bound_ms"]}
               if case_path(path) == "clip" and "stream" in summary[name]
               else {}),
            **({"bf16_ms": head["bf16_ms"]} if "bf16_ms" in head else {}),
            **({"by_shape": {p: v for p, v in summary[name].items()
                             if p != "max_abs_err"}}
               if name in INT8_KERNELS + NO_PATH else {}),
            **({"vitg": {p: v for p, v in summary[name].items()
                         if p.startswith("vitg")}}
               if any(p.startswith("vitg") for p in summary[name])
               and name not in INT8_KERNELS else {}),
            **({"v1": summary[name]["v1"]}
               if "v1" in summary[name] and path != "v1_train" else {}),
            **({"by_t": {p: summary[name][p]
                         for p in ("cp4", "cplong", "cpextra")},
                "ring_of_4": cp_ring}
               if name == "ring_step" else {}),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in launches.items()}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


# ------------------------------------------------- parent against change
def ab_tree(tree: str) -> dict:
    """The checkout at ``tree`` (its vdn_torch ahead of this one's on
    sys.path, its kernels built from its own sources) through this
    script's own cases and phases on the same seeds and timers: F4 at a
    streamed frame and the cached and full windows (int8_cases), C2 fp32
    at v1's shapes with and without the log-sum-exp (v1_attention_cases),
    the int8_static windows (time_windows, on the first window's scales)
    and a streamed int8_static frame at k = 1 (run_stream, median of the
    frames after the first), and the v1 model's step (b2 x s8, median of
    V1_STEPS after V1_WARMUP) and clip (median of 5), fp32."""
    sys.path.insert(0, os.path.abspath(tree))
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    from vdn_torch.nn.layers import quant_calibration
    from vdn_torch.train.trainer import V1Trainer
    environment()
    build_kernels()
    out = {"tree": tree}
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for rows in (VIT_TOKENS, CACHED_FRAMES * VIT_TOKENS,
                     32 * VIT_TOKENS):
            for c in int8_cases(rng, "ab", rows):
                if c["name"] == "fused_ln_mlp_residual_int8":
                    out[f"f4_rows{rows}_ms"] = time_ms(c["kern"], reps=20)
            torch.cuda.empty_cache()
        with exact_fp32():
            for c in v1_attention_cases(rng):
                if c["name"] == "flash_attention":
                    key = f"c2_{c['path']}_{c['label'].split()[1]}_ms"
                    out[key] = time_ms(c["kern"], reps=20)
        frames = synthetic_clip()
        q = quantized_model(build_video_depth_anything, build_model(),
                            "int8_static")
        with quant_calibration(q):
            q.forward_window(window_input(frames))
        out["int8_static_full_window_ms"], \
            out["int8_static_cached_window_ms"] = time_windows(
                q, frames, "ab_windows_int8_static")
    walls = fresh_stream(q, frames[:N_STREAM], 1)[1]
    out["int8_static_stream_k1_ms_per_frame"] = statistics.median(walls[1:])
    del q
    torch.cuda.empty_cache()
    with exact_fp32():
        batch = v1_batch(np.random.default_rng(SEED + 7))
        model = build_v1_model()
        trainer = V1Trainer(model, initial_lr=V1_LR,
                            weight_decay=V1_WEIGHT_DECAY)
        for _ in range(V1_WARMUP):
            trainer.train_step(batch)
        walls = timed_steps(lambda: trainer.train_step(batch), V1_STEPS)[1]
        out["v1_step_ms"] = statistics.median(walls)
        depth, rgb = v1_clip(batch)
        with torch.no_grad():
            out["v1_clip_ms"] = time_ms(lambda: model(depth, rgb), reps=5,
                                        warmup=1)
    return out


def ab(parent: str) -> None:
    """``python3 chip_smoke.py --ab PARENT``: ab_tree of a parent checkout
    (unpacked under a git-ignored directory) and of this one in turns,
    parent, change, change, parent, each in a process of its own; then
    each number's two runs per tree and their median."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    for who, tree in (("parent", parent), ("change", here),
                      ("change", here), ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ab-tree", tree], timeout=900,
                             capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr[-8000:], file=sys.stderr, flush=True)
            fail(f"--ab-tree {tree}: exit {res.returncode}")
        line = [l for l in res.stdout.splitlines() if l.startswith("AB ")]
        runs[who].append(json.loads(line[-1][3:]))
    summary = {k: {who: [r[k] for r in rs] + [statistics.median(
                   r[k] for r in rs)] for who, rs in runs.items()}
               for k in runs["change"][0] if k != "tree"}
    print("AB_SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        ab(sys.argv[2])
    elif sys.argv[1:2] == ["--ab-tree"]:
        print("AB " + json.dumps(ab_tree(sys.argv[2])), flush=True)
    else:
        main()
    sys.exit(0)
