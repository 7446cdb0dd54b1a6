"""A1: ViT self-attention read off the fused qkv projection.

Replaces vdn/ops/pallas/flash_attention.py ``flash_attention_fused_qkv``
(the TPU's full-K ``_flash_cols_kernel``).  On the H100 the kernel
(csrc/flash_attn_qkv.cu) is bound by its two tensor-core products and the
exp2 of every logit; one head's K/V (350 KB at T = 1370) does not fit a
block's shared memory, so it streams 64-key tiles with an online softmax
and masks the ragged tail itself.  See the note in the .cu file.
"""

from __future__ import annotations

from typing import Optional

import torch

from vdn_torch.kernels import (LOG2E, check_kernel_args, launch, launches,
                               use_kernel)


def flash_attention_fused_qkv_plain(qkv: torch.Tensor,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """qkv [B, T, 3, H, D] -> [B, T, H, D], the TPU kernel's math: exact
    full-K softmax in fp32, base 2, scale * log2(e) folded into q in the
    input dtype, p rounded to the input dtype before P V, row sum taken
    from the rounded p."""
    d = qkv.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    dt = qkv.dtype
    c2 = torch.tensor(scale * LOG2E, dtype=dt, device=qkv.device)
    q = (qkv[:, :, 0] * c2).float()
    k, v = qkv[:, :, 1].float(), qkv[:, :, 2].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(s - s.amax(-1, keepdim=True)).to(dt).float()
    l = p.sum(-1).permute(0, 2, 1)[..., None]          # [B, T, H, 1]
    return (torch.einsum("bhqk,bkhd->bqhd", p, v) / l).to(dt)


def flash_attention_fused_qkv(qkv: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """qkv [B, T, 3, H, D] -> out [B, T, H, D]; kernel for bf16, D = 64."""
    if not use_kernel(qkv):
        return flash_attention_fused_qkv_plain(qkv, scale)
    b, t, three, h, d = qkv.shape
    if three != 3 or d != 64 or qkv.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_fused_qkv: kernel takes bf16 "
                         f"[B, T, 3, H, 64], got {tuple(qkv.shape)} "
                         f"{qkv.dtype}")
    check_kernel_args("flash_attention_fused_qkv", qkv)
    scale = d ** -0.5 if scale is None else scale
    # scale * log2(e) rounded to bf16, as the plain version folds it
    qscale = float(torch.tensor(scale * LOG2E, dtype=torch.bfloat16))
    out = torch.empty((b, t, h, d), dtype=qkv.dtype, device=qkv.device)
    launch("vdn_flash_attention_qkv", qkv.data_ptr(), b, t, h, qscale,
           out.data_ptr())
    launches["flash_attention_fused_qkv"] += 1
    return out
