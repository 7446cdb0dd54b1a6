"""A4: fused LayerNorm -> GEGLU feed-forward -> residual (motion modules).

Replaces vdn/ops/pallas/geglu.py ``fused_ln_geglu_residual``
(``_geglu_kernel``).  On the H100 the kernel (csrc/ln_geglu.cu) is bound by
its two products at C 1024 and above, by its bytes below; w0 and w2 are
tiled rather than VMEM-resident, as a LayerNorm row kernel and two
products on the bf16 wgmma + TMA core (csrc/bf16_wgmma.cuh, persistent
blocks, two consumer warpgroups in ping-pong; ``geglu_plan`` gives the
grids): fc1 in the core's kHalves mode, whose tiles take w0's hidden rows
and the matching gate rows (so the GEGLU gating is an epilogue), then fc2
with a residual epilogue.  Weights are torch Linear layout: w0 [2F, C]
(hidden rows first, then gate rows), w2 [C, F].

Training: vdn gives A4 no backward kernel (its vjp recomputes the plain
math, geglu.py:136-199).  With grad enabled and an input requiring it, A4
runs as an autograd Function whose backward is autograd of the plain
version, recomputed.
"""

from __future__ import annotations

import torch

from vdn_torch.kernels import (check_kernel_args, grads_of_plain, launch,
                               launches, layer_norm_f32, linear_f32acc,
                               same_dispatch, save_dispatch, sm_count,
                               use_kernel, wants_grad)
from vdn_torch.kernels.mlp import BN, MAX_C, WG_ROWS, gelu_f32

# fc1's output columns per tile: BN rows of w0's B stage, half hidden and
# half gate (csrc/bf16_wgmma.cuh's kHalves); fc2's tiles are BN wide
HALF_BN = BN // 2
WIDTH = 64  # C and F must be multiples of it (one TMA box of bf16)


def geglu_plan(m: int, c: int, f: int, sms: int) -> dict:
    """What A4's launches take for ``m`` rows on a card of ``sms`` SMs: each
    product's persistent grid, min(tiles, sms), ``grid_f`` over fc1's
    WG_ROWS x HALF_BN output tiles of [m, f], ``grid_c`` over fc2's WG_ROWS
    x BN tiles of [m, c] (the last one half empty where c % BN is 64)."""
    mt = -(-m // WG_ROWS)
    return {"grid_f": min(mt * (f // HALF_BN), sms),
            "grid_c": min(mt * -(-c // BN), sms)}


def fused_ln_geglu_residual_plain(x, ln_w, ln_b, w0, b0, w2, b2,
                                  eps: float = 1e-6) -> torch.Tensor:
    """x [..., C] -> x + net_2(hidden * gelu(gate)) + b2 with
    (hidden, gate) = split(net_0(LN(x))), rounding as geglu.py:49-65."""
    dt = x.dtype
    f = w2.shape[1]
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(dt)
    g = linear_f32acc(y, w0) + b0.to(dt)
    hid, gate = g[..., :f], g[..., f:]
    h = (hid.float() * gelu_f32(gate.float(), dt)).to(dt)
    return x + linear_f32acc(h, w2) + b2.to(dt)


class _FusedLnGeglu(torch.autograd.Function):
    """A4 forward; autograd of the recomputed plain version backward."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w0, b0, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w0, b0, w2, b2)
        ctx.eps = eps
        save_dispatch(ctx)
        return _forward(x, ln_w, ln_b, w0, b0, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        with same_dispatch(ctx):
            return (*grads_of_plain(
                lambda *a: fused_ln_geglu_residual_plain(*a, eps),
                ctx.saved_tensors, ctx.needs_input_grad[:7], g), None)


def fused_ln_geglu_residual(x, ln_w, ln_b, w0, b0, w2, b2,
                            eps: float = 1e-6) -> torch.Tensor:
    """Differentiable (plain recompute) where grad is enabled and an input
    requires it."""
    if wants_grad(x, ln_w, ln_b, w0, b0, w2, b2):
        return _FusedLnGeglu.apply(x, ln_w, ln_b, w0, b0, w2, b2, eps)
    return _forward(x, ln_w, ln_b, w0, b0, w2, b2, eps)


def _forward(x, ln_w, ln_b, w0, b0, w2, b2, eps) -> torch.Tensor:
    if not use_kernel(x):
        return fused_ln_geglu_residual_plain(x, ln_w, ln_b, w0, b0, w2, b2,
                                             eps)
    c = x.shape[-1]
    f = w2.shape[1]
    if (x.dtype != torch.bfloat16 or w0.shape != (2 * f, c)
            or w2.shape != (c, f) or c % WIDTH or f % WIDTH or c > MAX_C):
        raise ValueError(f"fused_ln_geglu_residual: kernel takes bf16 x with "
                         f"C, F multiples of {WIDTH} and C up to {MAX_C}, "
                         f"got x {tuple(x.shape)} {x.dtype}, w0 "
                         f"{tuple(w0.shape)}")
    bf = torch.bfloat16
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    plan = geglu_plan(m, c, f, sm_count(x.device.index))
    args = [x2, ln_w.float().contiguous(), ln_b.float().contiguous(),
            w0.to(bf).contiguous(), b0.to(bf).contiguous(),
            w2.to(bf).contiguous(), b2.to(bf).contiguous()]
    y = torch.empty_like(x2)
    h = torch.empty((m, f), dtype=bf, device=x.device)
    out = torch.empty_like(x2)
    check_kernel_args("fused_ln_geglu_residual", *args, y, h, out)
    ptr = [a.data_ptr() for a in args]
    launch("vdn_ln_geglu_residual", ptr[0], m, c, f, *ptr[1:], float(eps),
           y.data_ptr(), h.data_ptr(), out.data_ptr(), plan["grid_f"],
           plan["grid_c"])
    launches["fused_ln_geglu_residual"] += 1
    return out.reshape(x.shape)
