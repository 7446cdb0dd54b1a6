"""Multi-head attention with an fp32 softmax (vdn/ops/attention.py).

``dot_product_attention`` is the plain path; it is also what the ViT runs
below ``FLASH_MIN_SEQ`` tokens.  From there up the ViT reads attention off
the fused qkv buffer through kernel A1
(vdn_torch.kernels.flash_attention), as vdn's size gate does.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dot_product_attention", "flash_enabled"]

FLASH_MIN_SEQ = 256


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Attention over [B, T, H, D] tensors; logits and softmax in fp32,
    probs rounded to the input dtype before the value product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_enabled(tq: int, tk: int) -> bool:
    """vdn's size gate for the long-sequence attention kernel."""
    return tq >= FLASH_MIN_SEQ and tk >= FLASH_MIN_SEQ
