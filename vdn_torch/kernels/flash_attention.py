"""A1, C1, C2: the long-sequence attention kernels.

A1 replaces vdn/ops/pallas/flash_attention.py ``flash_attention_fused_qkv``
(the TPU's full-K ``_flash_cols_kernel``): ViT self-attention read off the
fused qkv projection.  On the H100 the kernel (csrc/flash_attn_qkv.cu) is
bound by its two tensor-core products and the exp2 of every logit; one
head's K/V (350 KB at T = 1370) does not fit a block's shared memory, so it
streams 64-key tiles with an online softmax and masks the ragged tail
itself.  See the note in the .cu file.

C2 replaces ``flash_attention`` (``_flash_kernel``) and C1
``flash_attention_colbias`` (``_flash_colbias_kernel``): attention over
separate q, k, v in [B, T, H, D], C1 with an additive fp32 bias per key
column (natural-log units, -inf allowed: the memory bank's slot mask).
Both run csrc/flash_attn_bthd.cu, A1's arithmetic read through the
[B, T, H, D] strides, with whole -inf key tiles skipped.  They are
inference kernels: a tensor that requires grad raises (the backward kernels
are not ported yet).
"""

from __future__ import annotations

from typing import Optional

import torch

from vdn_torch.kernels import (LOG2E, check_kernel_args, launch, launches,
                               use_kernel)

MAX_KEY_TILES = 2560  # csrc/flash_attn_bthd.cu: live-tile flags in shared memory


def flash_attention_colbias_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  col_bias: Optional[torch.Tensor],
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """q [B, Tq, H, D], k / v [B, Tk, H, D], col_bias [Tk] or None ->
    [B, Tq, H, D], the TPU kernels' math step by step: an exact full-K
    softmax in fp32, base 2; q * (scale * log2 e) in the input dtype,
    logits summed in fp32, + bias * log2 e in fp32, p = exp2(s - rowmax)
    rounded to the value dtype, the row sum taken from the rounded p,
    o / l rounded to the output dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = v.dtype
    c2 = torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * c2).float(), k.float())
    if col_bias is not None:
        s = s + col_bias.reshape(-1).float() * LOG2E
    p = torch.exp2(s - s.amax(-1, keepdim=True)).to(dt).float()
    l = p.sum(-1).permute(0, 2, 1)[..., None]          # [B, Tq, H, 1]
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    return flash_attention_colbias_plain(q, k, v, None, scale)


def flash_attention_fused_qkv_plain(qkv: torch.Tensor,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """qkv [B, T, 3, H, D] -> [B, T, H, D], the same math off the fused
    projection."""
    return flash_attention_colbias_plain(qkv[:, :, 0], qkv[:, :, 1],
                                         qkv[:, :, 2], None, scale)


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


def _launch_bthd(name: str, q, k, v, col_bias, scale) -> torch.Tensor:
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if (d != 64 or q.dtype != torch.bfloat16 or k.dtype != q.dtype
            or v.dtype != q.dtype or k.shape != (b, tk, h, d)
            or v.shape != k.shape or tk > 64 * MAX_KEY_TILES):
        raise ValueError(
            f"{name}: kernel takes bf16 q [B, Tq, H, 64] and k, v "
            f"[B, Tk, H, 64] with Tk <= {64 * MAX_KEY_TILES}, got q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, v "
            f"{tuple(v.shape)} {v.dtype}")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise RuntimeError(f"{name}: the kernel has no backward; run under "
                           f"torch.no_grad()")
    scale = d ** -0.5 if scale is None else scale
    # scale * log2(e) rounded to bf16, as the plain version folds it
    qscale = float(torch.tensor(scale * LOG2E, dtype=torch.bfloat16))
    out = torch.empty_like(q)
    if col_bias is None:
        check_kernel_args(name, q, k, v, out)
        launch("vdn_flash_attention_bthd", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), b, tq, tk, h, qscale, out.data_ptr())
    else:
        if col_bias.shape != (tk,) or col_bias.dtype != torch.float32:
            raise ValueError(f"{name}: col_bias must be fp32 [{tk}], got "
                             f"{tuple(col_bias.shape)} {col_bias.dtype}")
        check_kernel_args(name, q, k, v, col_bias, out)
        launch("vdn_flash_attention_colbias", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), col_bias.data_ptr(), b, tq, tk, h, qscale,
               out.data_ptr())
    launches[name] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """C2: attention over [B, T, H, D]; kernel for bf16, D = 64."""
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, scale)
    return _launch_bthd("flash_attention", q, k, v, None, scale)


def flash_attention_colbias(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, col_bias: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """C1: attention over [B, T, H, D] with an additive logits bias [Tk]
    shared by every batch, head and query (at least one column finite);
    kernel for bf16, D = 64."""
    col_bias = col_bias.reshape(-1)
    if not use_kernel(q):
        return flash_attention_colbias_plain(q, k, v, col_bias, scale)
    return _launch_bthd("flash_attention_colbias", q, k, v, col_bias, scale)
