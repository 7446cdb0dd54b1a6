"""A2: fused LayerNorm -> MLP -> LayerScale -> residual (ViT block tail).

Replaces vdn/ops/pallas/mlp.py ``fused_ln_mlp_residual``
(``_ln_mlp_kernel``).  On the H100 the kernel (csrc/ln_mlp.cu) is bound by
its two products; W1/W2 (8 MB each) cannot stay resident in a block's
shared memory as they did in VMEM, so it runs as row statistics + two
tiled GEMMs with a LayerNorm prologue and fused epilogues (see the note
in the .cu file).  Weights are torch Linear layout: w1 [F, C], w2 [C, F].

Training: with grad enabled and an input requiring it, A2 runs as an
autograd Function whose backward is vdn's ``_bwd_via_kernel``
(mlp.py:596-637): D3 (csrc/ln_mlp_bwd.cu, ``_mlp_bwd_dx_pallas``) gives dx,
y = LN(x), h, dhpre and the column sums dls, dlb, db1; the weight grads
dW1 = dhpre^T y, S = h^T g, dW2 = (S * gamma)^T, dgamma = colsum(W2^T * S)
+ b2 * sum(g) and db2 = gamma * sum(g) are plain products (``torch.matmul``
on the working dtype, as vdn leaves them to XLA), taken only for the
weights that require grad.
"""

from __future__ import annotations

import math

import torch

from vdn_torch.kernels import (LOG2E, check_kernel_args, launch, launches,
                               layer_norm_f32, linear_f32acc, same_dispatch,
                               save_dispatch, use_kernel, wants_grad)

COLSUM_ROWS = 128  # csrc/ln_mlp_bwd.cu: rows per partial column sum

_GELU_A = math.sqrt(2.0 / math.pi)
_GELU_B = 0.044715


def gelu_f32(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """GELU of fp32 ``x`` in the TPU kernels' flavour for compute dtype
    ``dt``: the tanh form on bf16 (vdn/ops/pallas/mlp.py _gelu_fast_f32),
    exact erf otherwise."""
    if dt != torch.bfloat16:
        return torch.nn.functional.gelu(x)
    u = _GELU_A * (x + _GELU_B * x * x * x)
    e = torch.exp2(u * (2.0 * LOG2E))
    return 0.5 * x * (1.0 + (1.0 - 2.0 / (e + 1.0)))


def dgelu_f32(x: torch.Tensor, dt: torch.dtype):
    """(gelu(x), gelu'(x)) of fp32 ``x`` in the flavour of ``gelu_f32``
    (vdn/ops/pallas/mlp.py _dgelu_f32): the tanh form on bf16, whose
    derivative reuses the tanh; exact erf otherwise."""
    if dt != torch.bfloat16:
        phi = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
        cdf = 0.5 * (1.0 + torch.erf(x * 2.0 ** -0.5))
        return x * cdf, cdf + x * phi
    u = _GELU_A * (x + _GELU_B * x * x * x)
    th = 1.0 - 2.0 / (torch.exp2(u * (2.0 * LOG2E)) + 1.0)
    dg = 0.5 * (1.0 + th) + 0.5 * x * (1.0 - th * th) * _GELU_A * (
        1.0 + 3.0 * _GELU_B * x * x)
    return 0.5 * x * (1.0 + th), dg


def fused_ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                eps: float = 1e-6) -> torch.Tensor:
    """x [..., C] -> x + gamma * (fc2(gelu(fc1(LN(x)) + b1)) + b2), with
    the rounding points of mlp.py:137-149."""
    dt = x.dtype
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(dt)
    h = linear_f32acc(y, w1) + b1.to(dt)
    h = gelu_f32(h.float(), dt).to(dt)
    o = linear_f32acc(h, w2) + b2.to(dt)
    return x + o * gamma.to(dt)


def fused_ln_mlp_residual_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2, gamma,
                                    eps: float = 1e-6):
    """D3's function, with the rounding points of _mlp_bwd_dx_kernel
    (mlp.py:249-335): x, g [..., C] -> (dx [..., C], y [M, C], h [M, F],
    dhpre [M, F] in x's dtype; dls, dlb [C], db1 [F] fp32)."""
    dt = x.dtype
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    g2 = g.reshape(-1, c).to(dt)
    xf = x2.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xh = xc * inv
    ls = ln_w.float()
    y = (xh * ls + ln_b.float()).to(dt)
    go = g2 * gamma.to(dt)
    hpre = linear_f32acc(y, w1) + b1.to(dt)
    gelu_h, dgelu_h = dgelu_f32(hpre.float(), dt)
    h = gelu_h.to(dt)
    dh = linear_f32acc(go, w2.t()).float()
    dhpre = (dh * dgelu_h).to(dt)
    db1 = dhpre.float().sum(0)
    dyf = linear_f32acc(dhpre, w1.t()).float()          # one round to dt
    dls = (dyf * xh).sum(0)
    dlb = dyf.sum(0)
    dxh = dyf * ls
    dvar = (dxh * xc).sum(-1, keepdim=True) * -0.5 * inv * inv * inv
    dxc = dxh * inv + (2.0 / c) * xc * dvar
    dxf = dxc - dxc.mean(-1, keepdim=True)
    dx = g2 + dxf.to(dt)
    return dx.reshape(x.shape), y, h, dhpre, dls, dlb, db1


def fused_ln_mlp_residual_bwd(x, g, ln_w, ln_b, w1, b1, w2, gamma,
                              eps: float = 1e-6):
    """D3: (dx, y, h, dhpre, dls, dlb, db1) as the plain version; kernel
    for bf16 x with C, F multiples of 32."""
    if not use_kernel(x):
        return fused_ln_mlp_residual_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2,
                                               gamma, eps)
    name = "fused_ln_mlp_residual_bwd"
    c = x.shape[-1]
    f = w1.shape[0]
    _check_args(name, x, w1, w2)
    bf = torch.bfloat16
    x2 = x.reshape(-1, c).contiguous()
    g2 = g.reshape(-1, c).to(bf).contiguous()
    m = x2.shape[0]
    w1b = w1.to(bf).contiguous()
    args = [x2, g2, ln_w.float().contiguous(), ln_b.float().contiguous(),
            w1b, b1.to(bf).contiguous(), w1b.t().contiguous(),
            w2.to(bf).t().contiguous(), gamma.to(bf).contiguous()]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    mean, rstd = torch.empty(m, **f32), torch.empty(m, **f32)
    hpre = torch.empty((m, f), dtype=bf, device=dev)
    dy = torch.empty_like(x2)
    partial = torch.empty((-(-m // COLSUM_ROWS), max(c, f)), **f32)
    y, dx = torch.empty_like(x2), torch.empty_like(x2)
    h, dhpre = torch.empty_like(hpre), torch.empty_like(hpre)
    dls, dlb, db1 = (torch.empty(c, **f32), torch.empty(c, **f32),
                     torch.empty(f, **f32))
    outs = [mean, rstd, hpre, dy, partial, y, h, dhpre, dx, dls, dlb, db1]
    check_kernel_args(name, *args, *outs)
    ptr = [a.data_ptr() for a in args]
    launch("vdn_ln_mlp_residual_bwd", ptr[0], ptr[1], m, c, f, *ptr[2:],
           float(eps), *(o.data_ptr() for o in outs))
    launches[name] += 1
    return dx.reshape(x.shape), y, h, dhpre, dls, dlb, db1


def _check_args(name, x, w1, w2) -> None:
    c = x.shape[-1]
    f = w1.shape[0]
    if (x.dtype != torch.bfloat16 or w1.shape != (f, c)
            or w2.shape != (c, f) or c % 32 or f % 32):
        raise ValueError(f"{name}: kernel takes bf16 x with C, F multiples "
                         f"of 32, got x {tuple(x.shape)} {x.dtype}, w1 "
                         f"{tuple(w1.shape)}")


def mlp_weight_grads(g, y, h, dhpre, w2, b2, gamma, needs):
    """vdn's XLA-side weight grads of the block tail (mlp.py:622-630), for
    the flags ``needs`` = (w1, w2, b2, gamma): (dW1 [F, C], dW2 [C, F], db2,
    dgamma), None where not needed.  The products run on the working
    dtype with its rounding, as vdn's dots do."""
    c = g.shape[-1]
    g2 = g.reshape(-1, c).to(y.dtype)
    need_w1, need_w2, need_b2, need_gamma = needs
    dw1 = torch.matmul(dhpre.t(), y).float() if need_w1 else None
    dw2 = db2 = dgamma = None
    if need_w2 or need_b2 or need_gamma:
        gam = gamma.float()
        t = g2.float().sum(0)
        if need_w2 or need_gamma:
            s = torch.matmul(h.t(), g2).float()             # [F, C]
            dw2 = (s * gam).t() if need_w2 else None
            dgamma = ((w2.float().t() * s).sum(0) + b2.float() * t
                      if need_gamma else None)
        db2 = gam * t if need_b2 else None
    return dw1, dw2, db2, dgamma


class _FusedLnMlp(torch.autograd.Function):
    """A2 forward, D3 + the weight products as its backward."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2, gamma)
        ctx.eps = eps
        save_dispatch(ctx)
        return _forward(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2, gamma = ctx.saved_tensors
        with same_dispatch(ctx):
            dx, y, h, dhpre, dls, dlb, db1 = fused_ln_mlp_residual_bwd(
                x, g, ln_w, ln_b, w1, b1, w2, gamma, ctx.eps)
        need = ctx.needs_input_grad
        dw1, dw2, db2, dgamma = mlp_weight_grads(
            g, y, h, dhpre, w2, b2, gamma, (need[3], need[5], need[6],
                                            need[7]))
        cast = lambda d, p, n: d.to(p.dtype) if n else None
        return (dx if need[0] else None, cast(dls, ln_w, need[1]),
                cast(dlb, ln_b, need[2]), cast(dw1, w1, need[3]),
                cast(db1, b1, need[4]), cast(dw2, w2, need[5]),
                cast(db2, b2, need[6]), cast(dgamma, gamma, need[7]), None)


def fused_ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, gamma,
                          eps: float = 1e-6) -> torch.Tensor:
    """x [..., C] -> x + gamma * (fc2(gelu(fc1(LN(x)) + b1)) + b2).
    Differentiable (D3) where grad is enabled and an input requires it."""
    if wants_grad(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        return _FusedLnMlp.apply(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    return _forward(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)


def _forward(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps) -> torch.Tensor:
    if not use_kernel(x):
        return fused_ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2,
                                           gamma, eps)
    c = x.shape[-1]
    f = w1.shape[0]
    _check_args("fused_ln_mlp_residual", x, w1, w2)
    bf = torch.bfloat16
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    args = [x2, ln_w.float().contiguous(), ln_b.float().contiguous(),
            w1.to(bf).contiguous(), b1.to(bf).contiguous(),
            w2.to(bf).contiguous(), b2.to(bf).contiguous(),
            gamma.to(bf).contiguous()]
    mean = torch.empty(m, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    h = torch.empty((m, f), dtype=bf, device=x.device)
    out = torch.empty_like(x2)
    check_kernel_args("fused_ln_mlp_residual", *args, mean, rstd, h, out)
    ptr = [a.data_ptr() for a in args]
    launch("vdn_ln_mlp_residual", ptr[0], m, c, f, *ptr[1:], float(eps),
           mean.data_ptr(), rstd.data_ptr(), h.data_ptr(), out.data_ptr())
    launches["fused_ln_mlp_residual"] += 1
    return out.reshape(x.shape)
