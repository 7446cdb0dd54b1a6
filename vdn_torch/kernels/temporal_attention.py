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

from vdn_torch.kernels import (check_kernel_args, launch, launches,
                               linear_f32acc, use_kernel)


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


def temporal_attention_block(x, pe, wq, wk, wv, wo, bo, heads: int,
                             scale: float) -> torch.Tensor:
    if not use_kernel(x):
        return temporal_attention_block_plain(x, pe, wq, wk, wv, wo, bo,
                                              heads, scale)
    bn, t, c = x.shape
    dh = c // heads
    if (x.dtype != torch.bfloat16 or t > 32 or dh * heads != c
            or dh not in (32, 64, 128)):
        raise ValueError(f"temporal_attention_block: kernel takes bf16 "
                         f"[BN, T <= 32, C] with C / heads in (32, 64, 128), "
                         f"got {tuple(x.shape)} {x.dtype}, heads={heads}")
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
