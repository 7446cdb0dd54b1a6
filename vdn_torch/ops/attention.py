"""Multi-head attention with an fp32 softmax (vdn/ops/attention.py).

One entry point, ``dot_product_attention``, routed as vdn's with "on a
CUDA tensor" in place of "on TPU":

- Tq, Tk >= ``FLASH_MIN_SEQ`` and no bias -> kernel C2
  (vdn_torch.kernels.flash_attention.flash_attention);
- the same sizes with a bias broadcastable to [1, 1, 1, Tk] (the memory
  bank's slot mask) -> kernel C1 (flash_attention_colbias);
- a general [B, H, Tq, Tk] bias or a short sequence -> the plain path
  below, as vdn sends them to XLA.

``use_flash`` overrides the size gate as vdn's does: False keeps the plain
path at any length (the v1 head's attention, vdn/nn/video_heads.py:63-66),
True takes the kernels at any length (a general bias still goes plain).

On a CPU tensor the kernels' wrappers take their plain versions.

The ViT reads its self-attention off the fused qkv buffer through kernel
A1 behind the same size gate (vdn_torch.nn.vit).
"""

from __future__ import annotations

from typing import Optional

import torch

from vdn_torch.kernels.flash_attention import (flash_attention,
                                               flash_attention_colbias)

__all__ = ["dot_product_attention", "flash_enabled"]

FLASH_MIN_SEQ = 256


def _plain_attention(q, k, v, scale, bias=None):
    dt = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(dt)
    # mixed dtypes promote, as vdn's einsum does (SAM2's decoder: fp32
    # tokens against bf16 image keys)
    rt = torch.promote_types(dt, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(rt), v.to(rt))


def flash_enabled(tq: int, tk: int,
                  bias: Optional[torch.Tensor] = None) -> bool:
    """vdn's size gate for the long-sequence attention kernels.  A biased
    attention qualifies only with a per-column bias (shape [1, 1, 1, Tk])."""
    col_bias_ok = bias is None or tuple(bias.shape) == (1, 1, 1, tk)
    return col_bias_ok and tq >= FLASH_MIN_SEQ and tk >= FLASH_MIN_SEQ


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None,
                          use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention over [B, T, H, D] tensors (q: Tq, k / v: Tk); logits and
    softmax in fp32, probs rounded to the input dtype before the value
    product.  bias: optional additive [B|1, H|1, Tq|1, Tk] logits bias.
    use_flash: True / False force the kernels on / off; None (default) is
    the size gate ``flash_enabled``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = flash_enabled(q.shape[1], k.shape[1], bias)
    if use_flash:
        if bias is None:
            return flash_attention(q, k, v, scale)
        if bias.numel() == k.shape[1]:
            return flash_attention_colbias(q, k, v, bias.reshape(-1), scale)
    return _plain_attention(q, k, v, scale, bias)
