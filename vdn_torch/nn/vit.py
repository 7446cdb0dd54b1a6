"""DINOv2 vision transformer (vdn/nn/vit.py).

Tokens are [B, N, C]; input frames NHWC.  Parameter names are the
reference checkpoint's (``blocks.0.attn.qkv.weight``, ``ls1.gamma``,
vitg's ``blocks.0.mlp.w12.weight``, ...).  Two kernels carry the blocks,
behind vdn's size gates: A1 reads self-attention straight off the fused
qkv projection for N >= 256 tokens, and A2 runs the LN2 -> MLP ->
LayerScale -> residual tail for B * N >= 1024 rows.  vitg's FFN is SwiGLU
(``ffn="swiglufused"``), plain torch in float as vdn leaves it to XLA.

``quantize="int8"`` is the serving mode's W8A8 encoder (vdn/nn/vit.py:
143-275), behind ``int8_serving_enabled`` (B * N >= 1024 rows on the card):
F1 takes LN1 and the qkv projection, A1 stays the attention, F3 the
out-projection with LayerScale and the residual, and F4 the whole MLP
tail (F5 the SwiGLU tail for vitg).  The weights are quantized once per
weight version.

Configs (reference dinov2.py:339-415): vits 384/12/6, vitb 768/12/12,
vitl 1024/24/16, vitg 1536/40/24 with SwiGLU; patch 14, img_size 518,
interpolate_offset 0.1.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from vdn_torch.kernels.flash_attention import flash_attention_fused_qkv
from vdn_torch.kernels.int8 import (fused_ln_mlp_residual_int8,
                                    fused_ln_swiglu_residual_int8,
                                    int8_ln_linear, int8_proj_residual,
                                    int8_serving_enabled)
from vdn_torch.kernels.mlp import fused_ln_mlp_residual
from vdn_torch.nn.layers import Conv2d, LayerNorm, Linear, Mlp, SwiGLUFFN
from vdn_torch.ops.attention import dot_product_attention, flash_enabled
from vdn_torch.ops.resize import rescale2d

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6, ffn="mlp"),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12, ffn="mlp"),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16, ffn="mlp"),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24, ffn="swiglufused"),
}

# which intermediate blocks feed the DPT head, per encoder size
INTERMEDIATE_LAYER_IDX = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
    "vitg": [9, 19, 29, 39],
}

FUSED_MLP_MIN_ROWS = 1024  # vdn/ops/pallas/mlp.py fused_mlp_enabled


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int = 14):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)                     # [B, gh, gw, C]
        return y.reshape(y.shape[0], -1, y.shape[-1])


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def _init(self, g):
        self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def _attend(self, qkv: torch.Tensor) -> torch.Tensor:
        b, n, c3 = qkv.shape
        h = self.num_heads
        qkv = qkv.reshape(b, n, 3, h, c3 // (3 * h))
        if flash_enabled(n, n):
            out = flash_attention_fused_qkv(qkv)
        else:
            out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                        qkv[:, :, 2])
        return out.reshape(b, n, c3 // 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self._attend(self.qkv(x)))

    def forward_int8(self, x: torch.Tensor, norm: "LayerNorm",
                     gamma: torch.Tensor) -> torch.Tensor:
        """x + gamma * attn(norm(x)) with the int8 projections: F1 (LN
        inside) and F3 (LayerScale and residual inside)."""
        qkv = int8_ln_linear(x, norm.weight, norm.bias,
                             self.qkv.int8_weight(), self.qkv.bias, norm.eps)
        return int8_proj_residual(self._attend(qkv), x,
                                  self.proj.int8_weight(), self.proj.bias,
                                  gamma)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 quantize: Optional[str] = None, ffn: str = "mlp"):
        super().__init__()
        self.quantize = quantize
        self.ffn = ffn
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        if ffn == "mlp":
            self.mlp = Mlp(dim, int(dim * mlp_ratio))
        else:  # swiglufused: 2/3 of the MLP's hidden, up to a multiple of 8
            hidden = int(dim * mlp_ratio) * 2 // 3
            self.mlp = SwiGLUFFN(dim, (hidden + 7) // 8 * 8)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n2, mlp = self.norm2, self.mlp
        if self.quantize == "int8" and int8_serving_enabled(
                x.shape[0] * x.shape[1], x):
            x = self.attn.forward_int8(x, self.norm1, self.ls1.gamma)
            if self.ffn != "mlp":
                return fused_ln_swiglu_residual_int8(
                    x, n2.weight, n2.bias, mlp.w12.int8_weight(),
                    mlp.w12.bias, mlp.w3.int8_weight(), mlp.w3.bias,
                    self.ls2.gamma, n2.eps)
            return fused_ln_mlp_residual_int8(
                x, n2.weight, n2.bias, mlp.fc1.int8_weight(), mlp.fc1.bias,
                mlp.fc2.int8_weight(), mlp.fc2.bias, self.ls2.gamma, n2.eps)
        x = x + self.ls1(self.attn(self.norm1(x)))
        if self.ffn == "mlp" and x.shape[0] * x.shape[1] >= FUSED_MLP_MIN_ROWS:
            return fused_ln_mlp_residual(
                x, n2.weight, n2.bias, mlp.fc1.weight, mlp.fc1.bias,
                mlp.fc2.weight, mlp.fc2.bias, self.ls2.gamma, n2.eps)
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 patch_size: int = 14, img_size: int = 518,
                 interpolate_offset: float = 0.1,
                 quantize: Optional[str] = None, ffn: str = "mlp"):
        super().__init__()
        self.embed_dim, self.patch_size = embed_dim, patch_size
        self.interpolate_offset = interpolate_offset
        grid = img_size // patch_size
        self.num_pos_patches = grid * grid
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.num_pos_patches + 1, embed_dim))
        # kept for checkpoint-key parity with the reference (unused)
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, quantize, ffn)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim)

    def _init(self, g):
        self.cls_token.zero_()
        self.mask_token.zero_()
        self.pos_embed.copy_(
            torch.randn(self.pos_embed.shape, generator=g) * 0.02)

    def _interpolated_pos_embed(self, gh: int, gw: int,
                                dtype: torch.dtype) -> torch.Tensor:
        """Bicubic pos-embed interpolation with the reference's offset-0.1
        scale_factor convention (reference dinov2.py:179-210)."""
        n = self.num_pos_patches
        pos = self.pos_embed.float()
        if gh * gw == n and gh == gw:
            return pos.to(dtype)
        grid = int(math.sqrt(n))
        sh = (gh + self.interpolate_offset) / grid
        sw = (gw + self.interpolate_offset) / grid
        patch = pos[:, 1:].reshape(1, grid, grid, self.embed_dim)
        patch = rescale2d(patch, (sh, sw), "bicubic")
        assert patch.shape[1:3] == (gh, gw)
        patch = patch.reshape(1, gh * gw, self.embed_dim)
        return torch.cat([pos[:, :1], patch], dim=1).to(dtype)

    def prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        return tokens + self._interpolated_pos_embed(gh, gw, tokens.dtype)

    def get_intermediate_layers(self, x: torch.Tensor,
                                layer_idx: Sequence[int]
                                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """[(patch_tokens [B, N, C], cls_token [B, C])] for each requested
        block index, layer-normed (reference dinov2.py:297-321)."""
        wanted = set(int(i) for i in layer_idx)
        tokens = self.prepare_tokens(x)
        outs = {}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in wanted:
                outs[i] = tokens
            if len(outs) == len(wanted):
                break
        result = []
        for i in sorted(outs):
            t = self.norm(outs[i])
            result.append((t[:, 1:], t[:, 0]))
        return result

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] -> every block, then the norm: [B, 1 + N, C]."""
        tokens = self.prepare_tokens(x)
        for blk in self.blocks:
            tokens = blk(tokens)
        return self.norm(tokens)


def make_vit(encoder: str,
             quantize: Optional[str] = None) -> DinoVisionTransformer:
    return DinoVisionTransformer(**VIT_CONFIGS[encoder], quantize=quantize)
