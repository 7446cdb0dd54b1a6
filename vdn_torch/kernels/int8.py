"""F1-F5: the W8A8 int8 serving kernels of the ViT encoder.

Replace vdn/ops/pallas/int8.py ``int8_ln_linear`` (F1, the qkv projection
with LN1 inside), ``int8_linear`` (F2, any linear), ``int8_proj_residual``
(F3, the out-projection with LayerScale and the block residual),
``fused_ln_mlp_residual_int8`` (F4, the MLP tail) and
``fused_ln_swiglu_residual_int8`` (F5, vitg's SwiGLU tail); all five
reach the one ``pl.pallas_call`` of ``_call_3d``.  The scheme is vdn's,
symmetric with no zero points:

- weights per output channel, ``wq = round(w / s)``, ``s = amax / 127``
  over the input axis (a division; ``quantize_weight_cols``);
- activations per row, recomputed at every call, ``q = round(x * (1 / s))``
  (a reciprocal multiply; ``quantize_rows``), floor 1e-30 on both scales;
- int8 x int8 products summed exactly in int32, dequantized as
  ``(float(acc) * sx) * sw``, then + bias in fp32;
- F1, F4 and F5 quantize the fp32 LayerNorm output, F4 its fp32 GELU
  output and F5 its fp32 ``silu(x1) * x2`` without a round to the compute
  dtype; F4 and F5 quantize the hidden activations per (row, F / 2 chunk)
  and sum the two chunks' dequantized products in fp32 before + b2 (vdn's
  ``_F_CHUNKS``, which the numbers depend on).

On the H100 each kernel is a row kernel (LayerNorm or identity, row amax,
int8 rows and their scales) followed by int8 tile GEMMs with the
dequantization in their epilogues.  F1, F2 and F3 run their products on
mma.sync m16n8k32 (csrc/int8_gemm.cuh, csrc/int8_linear.cu).  F4 and F5
run on the warp-specialised wgmma + TMA core (csrc/int8_wgmma.cuh,
persistent blocks over 128-row tiles; see ``f4_plan`` and ``f5_plan``):
the row kernel, the first product with its epilogue (F4: GELU; F5: the
core's paired mode, a tile's 64 gate and 64 value columns of the same
outputs in one thread, SwiGLU), writing the fp32 hidden and its absmax
per (row, chunk), the hidden's quantizer, then the second product, whose
K loop dequantizes chunk 0 before chunk 1 accumulates
(csrc/int8_tail.cuh, csrc/ln_mlp_int8.cu, csrc/ln_swiglu_int8.cu).
Bound by the int8 products (2 * rows * C * F operations each at 1979
TOP/s) at the window's shapes, F3 by its bytes.

A weight argument is a float Linear weight [F, C] (torch layout) or a
pre-quantized ``(wq int8 [F, C], sw fp32 [F])`` pair, which the model
caches per weight version (``vdn_torch.nn.layers.Linear.int8_weight``).
Serving only: the kernels have no backward, and on the card an input that
requires grad raises.  The plain versions sum the int8 products exactly in
float64 (every sum here is below 2^53).  Every function takes an optional
``operands`` dict, which receives its int8 activation operands and their
scales (``xq``, ``sx``; F4 and F5 ``yq``, ``sy``, ``hq``, ``sh``) for
checks.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple, Union

import torch

from vdn_torch.kernels import (LOG2E, check_kernel_args, launch, launches,
                               layer_norm_f32, use_kernel, wants_grad)
from vdn_torch.kernels.mlp import gelu_f32

__all__ = ["quantize_weight_cols", "quantize_rows", "int8_serving_enabled",
           "int8_ln_linear", "int8_linear", "int8_proj_residual",
           "fused_ln_mlp_residual_int8", "fused_ln_swiglu_residual_int8",
           "int8_ln_linear_plain", "int8_linear_plain",
           "int8_proj_residual_plain", "fused_ln_mlp_residual_int8_plain",
           "fused_ln_swiglu_residual_int8_plain", "F_CHUNKS",
           "INT8_MIN_ROWS"]

F_CHUNKS = 2          # vdn's _F_CHUNKS: hidden scales per (row, F / 2)
INT8_MIN_ROWS = 1024  # one 518 x 518 image (1370 tokens) qualifies
K_TILE = 64           # csrc/int8_gemm.cuh: bytes of K per slice
# csrc/int8_wgmma.cuh: rows and bytes of K of a tile; F4's fc1 tile width
# (csrc/ln_mlp_int8.cu), F5's output columns of a paired w12 tile
# (csrc/ln_swiglu_int8.cu), and the widest C their row kernel holds in
# registers (csrc/int8_tail.cuh)
WG_ROWS, WG_K = 128, 128
F4_BN1 = 128
F5_BN1 = 64
F4_MAX_C = 2048

Weight = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device: CUDA's division by a
    Python scalar multiplies by its reciprocal, which differs from vdn's
    (and the kernels') quotient in the last bit."""
    return t / torch.tensor(127.0, device=t.device)


def quantize_weight_cols(w: torch.Tensor):
    """Linear weight [F, C] -> (int8 [F, C], fp32 scales [F]): per output
    channel, ``round(w / s)`` with ``s = max(amax_C |w| / 127, 1e-30)``."""
    wf = w.detach().float()
    s = torch.clamp_min(over_127(wf.abs().amax(1)), 1e-30)
    return torch.round(wf / s[:, None]).to(torch.int8), s


def quantize_rows(xf: torch.Tensor, chunks: int = 1):
    """fp32 [M, K] -> (int8 [M, K], fp32 scales [M, chunks]): per row, or
    per (row, K / chunks chunk), ``round(x * (1 / s))`` with
    ``s = max(amax |x| / 127, 1e-30)``."""
    m, k = xf.shape
    xc = xf.reshape(m, chunks, k // chunks)
    s = torch.clamp_min(over_127(xc.abs().amax(-1, keepdim=True)), 1e-30)
    q = torch.round(xc * torch.reciprocal(s))
    return q.to(torch.int8).reshape(m, k), s[..., 0]


def int8_serving_enabled(rows: int, x: torch.Tensor) -> bool:
    """The model-level gate (vdn/ops/pallas/int8.py:379-390): encoder-scale
    token counts on the card.  ``VDN_DISABLE_INT8`` turns the path off and
    ``VDN_FORCE_INT8`` on at any size and device (the CPU tests drive both
    packages down it with the one variable)."""
    if os.environ.get("VDN_DISABLE_INT8"):
        return False
    if os.environ.get("VDN_FORCE_INT8"):
        return True
    return rows >= INT8_MIN_ROWS and x.is_cuda


def _quantized(w: Weight):
    return w if isinstance(w, tuple) else quantize_weight_cols(w)


def _dequant_dot(q, s, wq, sw) -> torch.Tensor:
    """sum_j (float(q_j @ wq_j^T) * s[:, j]) * sw over the K chunks j of
    ``s``'s columns, in fp32, the chunks added in order."""
    chunks = s.shape[1]
    kc = q.shape[1] // chunks
    o = None
    for j in range(chunks):
        sl = slice(j * kc, (j + 1) * kc)
        acc = torch.matmul(q[:, sl].double(), wq[:, sl].double().t())
        pj = acc.float() * s[:, j:j + 1] * sw
        o = pj if o is None else o + pj
    return o


def _record(operands: Optional[dict], **tensors) -> None:
    if operands is not None:
        operands.update(tensors)


def int8_ln_linear_plain(x, ln_w, ln_b, w: Weight, b, eps: float = 1e-6,
                         operands: Optional[dict] = None) -> torch.Tensor:
    """F1: x [..., C] -> LN(x) @ w^T + b [..., F] in x's dtype."""
    wq, sw = _quantized(w)
    c = x.shape[-1]
    q, sx = quantize_rows(layer_norm_f32(x.reshape(-1, c), ln_w, ln_b, eps))
    _record(operands, xq=q, sx=sx)
    o = _dequant_dot(q, sx, wq, sw) + b.float()
    return o.to(x.dtype).reshape(*x.shape[:-1], -1)


def int8_linear_plain(x, w: Weight, b=None,
                      operands: Optional[dict] = None) -> torch.Tensor:
    """F2: x [..., C] -> x @ w^T (+ b) [..., F] in x's dtype."""
    wq, sw = _quantized(w)
    c = x.shape[-1]
    q, sx = quantize_rows(x.reshape(-1, c).float())
    _record(operands, xq=q, sx=sx)
    o = _dequant_dot(q, sx, wq, sw)
    if b is not None:
        o = o + b.float()
    return o.to(x.dtype).reshape(*x.shape[:-1], -1)


def int8_proj_residual_plain(x, residual, w: Weight, b, gamma,
                             operands: Optional[dict] = None
                             ) -> torch.Tensor:
    """F3: residual + gamma * (x @ w^T + b), the product's term rounded to
    x's dtype before the add.  x, residual [..., C]."""
    wq, sw = _quantized(w)
    c = x.shape[-1]
    q, sx = quantize_rows(x.reshape(-1, c).float())
    _record(operands, xq=q, sx=sx)
    o = (_dequant_dot(q, sx, wq, sw) + b.float()) * gamma.float()
    return residual + o.to(x.dtype).reshape(residual.shape)


def fused_ln_mlp_residual_int8_plain(x, ln_w, ln_b, w1: Weight, b1,
                                     w2: Weight, b2, gamma,
                                     eps: float = 1e-6,
                                     operands: Optional[dict] = None
                                     ) -> torch.Tensor:
    """F4: x + gamma * (fc2(gelu(fc1(LN(x)))) + b2) with int8 products,
    the hidden activations quantized per (row, F / 2 chunk)."""
    w1q, s1 = _quantized(w1)
    w2q, s2 = _quantized(w2)
    dt = x.dtype
    c = x.shape[-1]
    f = w1q.shape[0]
    chunks = F_CHUNKS if f % F_CHUNKS == 0 else 1
    x2 = x.reshape(-1, c)
    q, sy = quantize_rows(layer_norm_f32(x2, ln_w, ln_b, eps))
    h = gelu_f32(_dequant_dot(q, sy, w1q, s1) + b1.float(), dt)
    hq, sh = quantize_rows(h, chunks)
    _record(operands, yq=q, sy=sy, hq=hq, sh=sh)
    o = _dequant_dot(hq, sh, w2q, s2) + b2.float()
    return (x2 + (o * gamma.float()).to(dt)).reshape(x.shape)


def _swiglu_f32(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """silu(x1) * x2 in fp32 as vdn's F5 forms it (int8.py:319-327):
    x1 * sig * x2 with sig = 1 / (1 + exp2(x1 * -log2(e))), a true
    division."""
    sig = torch.ones((), device=x1.device) / (1.0 + torch.exp2(
        x1 * -LOG2E))
    return x1 * sig * x2


def fused_ln_swiglu_residual_int8_plain(x, ln_w, ln_b, w12: Weight, b12,
                                        w3: Weight, b3, gamma,
                                        eps: float = 1e-6,
                                        operands: Optional[dict] = None
                                        ) -> torch.Tensor:
    """F5: x + gamma * (w3(silu(x1) * x2) + b3) with [x1 | x2] =
    w12(LN(x)) + b12, int8 products, the hidden activations quantized per
    (row, F / 2 chunk).  w12 [2F, C], w3 [C, F]."""
    w12q, s12 = _quantized(w12)
    w3q, s3 = _quantized(w3)
    dt = x.dtype
    c = x.shape[-1]
    f = w12q.shape[0] // 2
    chunks = F_CHUNKS if f % F_CHUNKS == 0 else 1
    x2 = x.reshape(-1, c)
    q, sy = quantize_rows(layer_norm_f32(x2, ln_w, ln_b, eps))
    x12 = _dequant_dot(q, sy, w12q, s12) + b12.float()
    hq, sh = quantize_rows(_swiglu_f32(x12[:, :f], x12[:, f:]), chunks)
    _record(operands, yq=q, sy=sy, hq=hq, sh=sh)
    o = _dequant_dot(hq, sh, w3q, s3) + b3.float()
    return (x2 + (o * gamma.float()).to(dt)).reshape(x.shape)


# ------------------------------------------------------------- wrappers
def _serving_only(name: str, *tensors) -> None:
    if wants_grad(*tensors):
        raise RuntimeError(f"{name}: the int8 kernels have no backward; run "
                           f"under torch.no_grad()")


def _check(name: str, x, *pairs) -> None:
    """bf16 x and int8 weights [F, K] whose K takes whole 64-byte slices."""
    for wq, k in pairs:
        if (x.dtype != torch.bfloat16 or wq.dtype != torch.int8
                or wq.shape[1] != k or k % K_TILE or wq.shape[0] % 8):
            raise ValueError(
                f"{name}: kernel takes bf16 x and int8 weights [F, K] with K "
                f"a multiple of {K_TILE} and F of 8, got x "
                f"{tuple(x.shape)} {x.dtype}, weight {tuple(wq.shape)} "
                f"{wq.dtype}")


def _f32(*tensors):
    return [t.float().contiguous() for t in tensors]


def _rows_scratch(m: int, k: int, device, chunks: int = 1):
    return (torch.empty((m, k), dtype=torch.int8, device=device),
            torch.empty((m, chunks), dtype=torch.float32, device=device))


def f4_plan(m: int, c: int, f: int, sms: int) -> dict:
    """What F4's launch takes for ``m`` rows on a card of ``sms`` SMs: fc2's
    tile width (N = C: 128, or 64 where 128-wide tiles would number fewer
    than the SMs, as a streamed frame's 1370 rows give 11 x 8) and the
    persistent blocks of each product, min(tiles, sms).  fc1 runs 128 x
    128 tiles.  fc2's chunked K loop (chunk 0 dequantized, then chunk 1
    added) is the same at either width."""
    mt = -(-m // WG_ROWS)
    bn2 = 128 if mt * (c // 128) >= sms else 64
    return {"bn2": bn2, "grid1": min(mt * (f // F4_BN1), sms),
            "grid2": min(mt * (c // bn2), sms)}


def f5_plan(m: int, c: int, f: int, sms: int) -> dict:
    """What F5's launch takes: F4's plan for w3 (N = C), and for w12 the
    persistent blocks over its paired tiles of 128 rows x F5_BN1 outputs
    (each tile's 128 accumulator columns are the gate and the value
    columns of those outputs)."""
    plan = f4_plan(m, c, f, sms)
    plan["grid1"] = min(-(-m // WG_ROWS) * (f // F5_BN1), sms)
    return plan


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _linear_launch(name, x, ln, w: Weight, b, eps,
                   operands: Optional[dict]) -> torch.Tensor:
    """F1 (``ln`` = (weight, bias)) or F2 (``ln`` None) on the card."""
    wq, sw = _quantized(w)
    c = x.shape[-1]
    f = wq.shape[0]
    _check(name, x, (wq, c))
    _serving_only(name, x, *(ln or ()), b)
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    if b is None:
        b = torch.zeros(f, device=x.device)
    args = [x2, wq.contiguous(), *_f32(sw, b)]
    lnw = _f32(*ln) if ln is not None else []
    xq, sx = _rows_scratch(m, c, x.device)
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    check_kernel_args(name, *args, *lnw, xq, sx, out)
    launch("vdn_int8_ln_linear", x2.data_ptr(), m, c, f,
           *(t.data_ptr() for t in lnw) if lnw else (None, None),
           float(eps), *(t.data_ptr() for t in args[1:]), xq.data_ptr(),
           sx.data_ptr(), out.data_ptr())
    launches[name] += 1
    _record(operands, xq=xq, sx=sx)
    return out.reshape(*x.shape[:-1], f)


def int8_ln_linear(x, ln_w, ln_b, w: Weight, b, eps: float = 1e-6,
                   operands: Optional[dict] = None) -> torch.Tensor:
    """F1: LN(x) @ w^T + b, x [..., C] -> [..., F] (the qkv projection)."""
    if not use_kernel(x):
        return int8_ln_linear_plain(x, ln_w, ln_b, w, b, eps, operands)
    return _linear_launch("int8_ln_linear", x, (ln_w, ln_b), w, b, eps,
                          operands)


def int8_linear(x, w: Weight, b=None,
                operands: Optional[dict] = None) -> torch.Tensor:
    """F2: x @ w^T (+ b), x [..., C] -> [..., F]."""
    if not use_kernel(x):
        return int8_linear_plain(x, w, b, operands)
    return _linear_launch("int8_linear", x, None, w, b, 0.0, operands)


def int8_proj_residual(x, residual, w: Weight, b, gamma,
                       operands: Optional[dict] = None) -> torch.Tensor:
    """F3: residual + gamma * (x @ w^T + b); x, residual [..., C]."""
    if not use_kernel(x):
        return int8_proj_residual_plain(x, residual, w, b, gamma, operands)
    name = "int8_proj_residual"
    wq, sw = _quantized(w)
    c = x.shape[-1]
    f = wq.shape[0]
    _check(name, x, (wq, c))
    _serving_only(name, x, residual, b, gamma)
    if residual.dtype != x.dtype or residual.shape[-1] != f:
        raise ValueError(f"{name}: residual {tuple(residual.shape)} "
                         f"{residual.dtype} does not match the output")
    x2 = x.reshape(-1, c).contiguous()
    r2 = residual.reshape(-1, f).contiguous()
    m = x2.shape[0]
    args = [x2, r2, wq.contiguous(), *_f32(sw, b, gamma)]
    xq, sx = _rows_scratch(m, c, x.device)
    out = torch.empty_like(r2)
    check_kernel_args(name, *args, xq, sx, out)
    launch("vdn_int8_proj_residual", x2.data_ptr(), r2.data_ptr(), m, c, f,
           *(t.data_ptr() for t in args[2:]), xq.data_ptr(), sx.data_ptr(),
           out.data_ptr())
    launches[name] += 1
    _record(operands, xq=xq, sx=sx)
    return out.reshape(residual.shape)


def fused_ln_mlp_residual_int8(x, ln_w, ln_b, w1: Weight, b1, w2: Weight,
                               b2, gamma, eps: float = 1e-6,
                               operands: Optional[dict] = None
                               ) -> torch.Tensor:
    """F4: x + gamma * (fc2(gelu(fc1(LN(x)))) + b2), x [..., C]; w1 [F, C],
    w2 [C, F] (float, or pre-quantized pairs)."""
    if not use_kernel(x):
        return fused_ln_mlp_residual_int8_plain(x, ln_w, ln_b, w1, b1, w2,
                                                b2, gamma, eps, operands)
    name = "fused_ln_mlp_residual_int8"
    _serving_only(name, x, ln_w, ln_b, b1, b2, gamma)
    (w1q, s1), (w2q, s2) = _quantized(w1), _quantized(w2)
    c = x.shape[-1]
    f = w1q.shape[0]
    _check(name, x, (w1q, c), (w2q, f))
    if (w2q.shape[0] != c or f % (F_CHUNKS * F4_BN1) or c % WG_K
            or c > F4_MAX_C):
        raise ValueError(f"{name}: w2 {tuple(w2q.shape)} with F {f}, C {c}: "
                         f"the kernel takes F a multiple of "
                         f"{F_CHUNKS * F4_BN1} and C of {WG_K} up to "
                         f"{F4_MAX_C}")
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    plan = f4_plan(m, c, f, _sm_count(x.device.index))
    args = [*_f32(ln_w, ln_b), w1q.contiguous(), *_f32(s1, b1),
            w2q.contiguous(), *_f32(s2, b2, gamma)]
    yq, sy = _rows_scratch(m, c, x.device)
    hq, sh = _rows_scratch(m, f, x.device, F_CHUNKS)
    h = torch.empty((m, f), dtype=torch.float32, device=x.device)
    amax = torch.empty((m, F_CHUNKS), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x2)
    check_kernel_args(name, x2, *args, yq, sy, h, amax, hq, sh, out)
    launch("vdn_ln_mlp_int8", x2.data_ptr(), m, c, f,
           *(t.data_ptr() for t in args[:2]), float(eps),
           *(t.data_ptr() for t in args[2:]),
           *(t.data_ptr() for t in (yq, sy, h, amax, hq, sh, out)),
           plan["bn2"], plan["grid1"], plan["grid2"])
    launches[name] += 1
    _record(operands, yq=yq, sy=sy, hq=hq, sh=sh)
    return out.reshape(x.shape)


def fused_ln_swiglu_residual_int8(x, ln_w, ln_b, w12: Weight, b12,
                                  w3: Weight, b3, gamma, eps: float = 1e-6,
                                  operands: Optional[dict] = None
                                  ) -> torch.Tensor:
    """F5: x + gamma * (w3(silu(x1) * x2) + b3), [x1 | x2] = w12(LN(x)) +
    b12, x [..., C]; w12 [2F, C] (the gate half, then the value half), w3
    [C, F] (float, or pre-quantized pairs)."""
    if not use_kernel(x):
        return fused_ln_swiglu_residual_int8_plain(
            x, ln_w, ln_b, w12, b12, w3, b3, gamma, eps, operands)
    name = "fused_ln_swiglu_residual_int8"
    _serving_only(name, x, ln_w, ln_b, b12, b3, gamma)
    (w12q, s12), (w3q, s3) = _quantized(w12), _quantized(w3)
    c = x.shape[-1]
    f = w12q.shape[0] // 2
    _check(name, x, (w12q, c), (w3q, f))
    if (w12q.shape[0] != 2 * f or w3q.shape[0] != c
            or f % (F_CHUNKS * WG_K) or c % WG_K or c > F4_MAX_C):
        raise ValueError(f"{name}: w12 {tuple(w12q.shape)}, w3 "
                         f"{tuple(w3q.shape)}: the kernel takes w12 [2F, C] "
                         f"and w3 [C, F] with F a multiple of "
                         f"{F_CHUNKS * WG_K} and C of {WG_K} up to "
                         f"{F4_MAX_C}")
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    plan = f5_plan(m, c, f, _sm_count(x.device.index))
    args = [*_f32(ln_w, ln_b), w12q.contiguous(), *_f32(s12, b12),
            w3q.contiguous(), *_f32(s3, b3, gamma)]
    yq, sy = _rows_scratch(m, c, x.device)
    h = torch.empty((m, f), dtype=torch.float32, device=x.device)
    amax = torch.empty((m, F_CHUNKS), dtype=torch.float32, device=x.device)
    hq, sh = _rows_scratch(m, f, x.device, F_CHUNKS)
    out = torch.empty_like(x2)
    check_kernel_args(name, x2, *args, yq, sy, h, amax, hq, sh, out)
    launch("vdn_ln_swiglu_int8", x2.data_ptr(), m, c, f,
           *(t.data_ptr() for t in args[:2]), float(eps),
           *(t.data_ptr() for t in args[2:]),
           *(t.data_ptr() for t in (yq, sy, h, amax, hq, sh, out)),
           plan["bn2"], plan["grid1"], plan["grid2"])
    launches[name] += 1
    _record(operands, yq=yq, sy=sy, hq=hq, sh=sh)
    return out.reshape(x.shape)
