"""A3: the motion-module temporal attention block.

Replaces vdn/ops/pallas/temporal_attention.py ``temporal_attention_block``
(``_kernel``): out = proj_o(attn_T(x + pe)) + bo over [BN, T, C] tokens,
no residual.  On the H100 the kernel (csrc/temporal_attn.cu) is bound by
the four C x C projections; the weights are tiled through the shared GEMM
(+pe prologue) instead of VMEM-resident, and the T x T attention core is
one small block per (token, head) with the logits in registers.  See the
note in the .cu file.  Weights are torch Linear layout [out, in].
"""

from __future__ import annotations

import torch

from vdn_torch.kernels import (check_kernel_args, grads_of_plain, launch,
                               launches, linear_f32acc, same_dispatch,
                               save_dispatch, use_kernel, wants_grad)


def temporal_attention_block_plain(x, pe, wq, wk, wv, wo, bo, heads: int,
                                   scale: float) -> torch.Tensor:
    """x [BN, T, C], pe [T, C] -> [BN, T, C] with the rounding points of
    temporal_attention.py:56-93 (q/k/v, probs and pv rounded to the input
    dtype; fp32 softmax; out-proj summed in fp32, rounded, + bo)."""
    bn, t, c = x.shape
    dt = x.dtype
    dh = c // heads
    xp = x + pe.to(dt)
    q, k, v = (linear_f32acc(xp, w).reshape(bn, t, heads, dh).float()
               for w in (wq, wk, wv))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(s, dim=-1).to(dt).float()
    pv = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(dt).reshape(bn, t, c)
    return linear_f32acc(pv, wo) + bo.to(dt)


def temporal_attention_bwd_dx_plain(x, pe, g, wq, wk, wv, wo, heads: int,
                                    scale: float) -> torch.Tensor:
    """D4's function, dx [BN, T, C], with the rounding points of vdn's
    _bwd_kernel (temporal_attention.py:140-206): q / k / v recomputed and
    rounded, fp32 softmax, doh = g Wo rounded, dv = bf16(probs)^T doh, ds
    = bf16(probs (dp - delta) scale), dq = ds k and dk = ds^T q rounded,
    the three unprojections summed in fp32 and rounded once."""
    bn, t, c = x.shape
    dt = x.dtype
    dh = c // heads
    xp = x + pe.to(dt)
    q, k, v = (linear_f32acc(xp, w).reshape(bn, t, heads, dh).float()
               for w in (wq, wk, wv))
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, -1)
    doh = linear_f32acc(g.to(dt), wo.t()).reshape(bn, t, heads, dh).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(dt).float(), doh).to(dt)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, v)
    delta = (dp * probs).sum(-1, keepdim=True)
    ds = (probs * (dp - delta) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k).to(dt)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q).to(dt)
    dx = sum(torch.matmul(d.reshape(bn, t, c).float(), w.to(dt).float())
             for d, w in ((dq, wq), (dk, wk), (dv, wv)))
    return dx.to(dt)


# head widths of the kernels: A3 takes vitl's motion modules (dh 128, 32)
# and vitg's (192, 48); D4, the training backward, keeps its widths: vitg is
# a serving path here
FORWARD_HEAD_DIMS = (32, 48, 64, 128, 192)
BACKWARD_HEAD_DIMS = (32, 64, 128)


def _check_args(name, x, heads, dims=FORWARD_HEAD_DIMS, why="") -> None:
    bn, t, c = x.shape
    dh = c // heads
    if (x.dtype != torch.bfloat16 or t > 32 or dh * heads != c
            or dh not in dims):
        raise ValueError(f"{name}: kernel takes bf16 [BN, T <= 32, C] with "
                         f"C / heads in {dims}, got {tuple(x.shape)} "
                         f"{x.dtype}, heads={heads}{why}")


def temporal_attention_bwd_dx(x, pe, g, wq, wk, wv, wo, heads: int,
                              scale: float) -> torch.Tensor:
    """D4: dx [BN, T, C] as the plain version; kernel for bf16."""
    if not use_kernel(x):
        return temporal_attention_bwd_dx_plain(x, pe, g, wq, wk, wv, wo,
                                               heads, scale)
    name = "temporal_attention_block_bwd"
    _check_args(name, x, heads, BACKWARD_HEAD_DIMS,
                " (the backward has the training paths' head widths; "
                "vitg's motion modules, dh 192 / 48, are served only)")
    bn, t, c = x.shape
    bf = torch.bfloat16
    x = x.contiguous()
    g = g.to(bf).contiguous()
    pe = pe[:t].to(bf).contiguous()
    wqkv = torch.cat([wq, wk, wv]).to(bf).contiguous()
    wqkv_t = wqkv.t().contiguous()
    wo_t = wo.to(bf).t().contiguous()
    qkv = torch.empty((bn * t, 3 * c), dtype=bf, device=x.device)
    doh = torch.empty((bn * t, c), dtype=bf, device=x.device)
    dqkv = torch.empty_like(qkv)
    dx = torch.empty_like(x)
    check_kernel_args(name, x, g, pe, wqkv, wo_t, wqkv_t, qkv, doh, dqkv, dx)
    launch("vdn_temporal_attention_bwd", x.data_ptr(), g.data_ptr(), bn, t,
           c, heads, pe.data_ptr(), wqkv.data_ptr(), wo_t.data_ptr(),
           wqkv_t.data_ptr(), float(scale), qkv.data_ptr(), doh.data_ptr(),
           dqkv.data_ptr(), dx.data_ptr())
    launches[name] += 1
    return dx


class _TemporalAttention(torch.autograd.Function):
    """A3 forward; D4 for dx and autograd of the plain version for the
    rest as its backward."""

    @staticmethod
    def forward(ctx, x, pe, wq, wk, wv, wo, bo, heads, scale):
        ctx.save_for_backward(x, pe, wq, wk, wv, wo, bo)
        ctx.heads, ctx.scale = heads, scale
        save_dispatch(ctx)
        return _forward(x, pe, wq, wk, wv, wo, bo, heads, scale)

    @staticmethod
    def backward(ctx, g):
        x, pe, wq, wk, wv, wo, bo = ctx.saved_tensors
        heads, scale = ctx.heads, ctx.scale
        need = ctx.needs_input_grad
        with same_dispatch(ctx):
            dx = (temporal_attention_bwd_dx(x, pe, g, wq, wk, wv, wo, heads,
                                            scale) if need[0] else None)
        xd = x.detach()
        rest = grads_of_plain(
            lambda *a: temporal_attention_block_plain(xd, *a, heads, scale),
            (pe, wq, wk, wv, wo, bo), need[1:7], g)
        return (dx, *rest, None, None)


def temporal_attention_block(x, pe, wq, wk, wv, wo, bo, heads: int,
                             scale: float) -> torch.Tensor:
    """Differentiable (dx by D4) where grad is enabled and an input
    requires it."""
    if wants_grad(x, pe, wq, wk, wv, wo, bo):
        return _TemporalAttention.apply(x, pe, wq, wk, wv, wo, bo, heads,
                                        scale)
    return _forward(x, pe, wq, wk, wv, wo, bo, heads, scale)


def _forward(x, pe, wq, wk, wv, wo, bo, heads, scale) -> torch.Tensor:
    if not use_kernel(x):
        return temporal_attention_block_plain(x, pe, wq, wk, wv, wo, bo,
                                              heads, scale)
    bn, t, c = x.shape
    _check_args("temporal_attention_block", x, heads)
    bf = torch.bfloat16
    x = x.contiguous()
    pe = pe[:t].to(bf).contiguous()
    wqkv = torch.cat([wq, wk, wv]).to(bf).contiguous()
    wo = wo.to(bf).contiguous()
    bo = bo.to(bf).contiguous()
    qkv = torch.empty((bn * t, 3 * c), dtype=bf, device=x.device)
    pv = torch.empty((bn * t, c), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    check_kernel_args("temporal_attention_block", x, pe, wqkv, wo, bo, qkv,
                      pv, out)
    launch("vdn_temporal_attention", x.data_ptr(), bn, t, c, heads,
           pe.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
           float(scale), qkv.data_ptr(), pv.data_ptr(), out.data_ptr())
    launches["temporal_attention_block"] += 1
    return out
