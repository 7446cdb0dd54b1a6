"""Hiera hierarchical ViT backbone, SAM2's "hieradet" variant
(vdn/nn/hiera.py; reference sam2/modeling/backbones/hieradet.py:25-317).

Windowed multi-scale attention with q-pooling at the stage changes, global
attention at fixed block indices, and a windowed background position
embedding.  NHWC throughout; window partitioning is a reshape + permute.

Attention goes through ``dot_product_attention`` behind vdn's size gate:
at 256 x 256 and above the global blocks of ``hiera_base`` (12, 16, 20; 4
heads of 96 at 16 x 16 = 256 tokens) take kernel C2, read in place off the
fused qkv projection, and in training its backward D2
(vdn_torch.kernels.flash_attention).  Every other block stays plain: a
window holds at most 14 x 14 = 196 tokens.  The bicubic pos-embed resize
runs through A5a / A5b (vdn_torch.ops.resize), its backward on the
transposed plans.

Parameter names are the reference checkpoint's (``blocks.0.attn.qkv``,
``blocks.0.mlp.layers.0``, ``patch_embed.proj``); ``pos_embed`` and
``pos_embed_window`` are stored NCHW as the reference stores them
(vdn_torch.core.convert moves them to vdn's NHWC).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vdn_torch.nn.layers import Conv2d, LayerNorm, Linear
from vdn_torch.ops.attention import dot_product_attention
from vdn_torch.ops.resize import resize2d

HIERA_CONFIGS = {
    # sam2 yaml configs (tiny/small/b+/large)
    "hiera_tiny": dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                       global_att_blocks=(5, 7, 9),
                       window_pos_embed_bkg_spatial_size=(7, 7)),
    "hiera_small": dict(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
                        global_att_blocks=(7, 10, 13),
                        window_pos_embed_bkg_spatial_size=(7, 7)),
    "hiera_base": dict(embed_dim=96, num_heads=1, stages=(2, 3, 16, 3),
                       global_att_blocks=(12, 16, 20),
                       window_pos_embed_bkg_spatial_size=(14, 14)),
    "hiera_base_plus": dict(embed_dim=112, num_heads=2,
                            stages=(2, 3, 16, 3),
                            global_att_blocks=(12, 16, 20),
                            window_pos_embed_bkg_spatial_size=(14, 14)),
    "hiera_large": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
                        global_att_blocks=(23, 33, 43),
                        window_spec=(8, 4, 16, 8),
                        window_pos_embed_bkg_spatial_size=(7, 7)),
    # not a released variant: vdn's 4-block configuration for CPU tests
    "hiera_test": dict(embed_dim=32, num_heads=1, stages=(1, 1, 1, 1),
                       global_att_blocks=(2,),
                       window_pos_embed_bkg_spatial_size=(7, 7)),
}


def window_partition(x: torch.Tensor, window_size: int):
    """[B, H, W, C] -> ([B * nW, ws, ws, C], (Hp, Wp)), zero-padded to
    whole windows (reference backbones/utils.py:16-36)."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size, wp // window_size,
                  window_size, c)
    win = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, c)
    return win, (hp, wp)


def window_unpartition(win: torch.Tensor, window_size: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // ((hp // window_size) * (wp // window_size))
    x = win.reshape(b, hp // window_size, wp // window_size, window_size,
                    window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _max_pool_2x2(x: torch.Tensor, stride: Tuple[int, int]) -> torch.Tensor:
    """NHWC max pool with kernel == stride, incomplete windows dropped
    (torch MaxPool2d, floor mode)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(stride), tuple(stride))
    return y.permute(0, 2, 3, 1)


class HieraPatchEmbed(nn.Module):
    """7 x 7 / stride 4 / pad 3 patchify conv."""

    def __init__(self, embed_dim: int, in_ch: int = 3):
        super().__init__()
        self.proj = Conv2d(in_ch, embed_dim, 7, stride=4, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_stride: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dim_out, self.num_heads, self.q_stride = dim_out, num_heads, \
            q_stride
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, -1)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.q_stride is not None:
            q = _max_pool_2x2(q.reshape(b, h, w, -1), self.q_stride)
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, nh, -1)
        out = dot_product_attention(q, k, v)
        return self.proj(out.reshape(b, h, w, self.dim_out))


class SamMLP(nn.Module):
    """sam2_utils.MLP: layers.0 -> GELU (exact) -> layers.1."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.layers = nn.ModuleList([Linear(dim, hidden), Linear(hidden, out)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[1](F.gelu(self.layers[0](x)))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 mlp_ratio: float = 4.0,
                 q_stride: Optional[Tuple[int, int]] = None,
                 window_size: int = 0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.q_stride, self.window_size = q_stride, window_size
        self.norm1 = LayerNorm(dim)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_stride)
        self.norm2 = LayerNorm(dim_out)
        self.mlp = SamMLP(dim_out, int(dim_out * mlp_ratio), dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride is not None:
                shortcut = _max_pool_2x2(shortcut, self.q_stride)

        window_size = self.window_size
        h, w = x.shape[1:3]
        if window_size > 0:
            x, pad_hw = window_partition(x, window_size)
        x = self.attn(x)
        if self.q_stride is not None:
            window_size = self.window_size // self.q_stride[0]
            h, w = shortcut.shape[1:3]
            pad_h = (window_size - h % window_size) % window_size \
                if window_size else 0
            pad_w = (window_size - w % window_size) % window_size \
                if window_size else 0
            pad_hw = (h + pad_h, w + pad_w)
        if self.window_size > 0:
            x = window_unpartition(x, window_size, pad_hw, (h, w))

        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class Hiera(nn.Module):
    def __init__(self, embed_dim: int = 96, num_heads: int = 1,
                 q_pool: int = 3, q_stride: Tuple[int, int] = (2, 2),
                 stages: Tuple[int, ...] = (2, 3, 16, 3),
                 dim_mul: float = 2.0, head_mul: float = 2.0,
                 window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14,
                                                                       14),
                 window_spec: Tuple[int, ...] = (8, 4, 14, 7),
                 global_att_blocks: Tuple[int, ...] = (12, 16, 20)):
        super().__init__()
        depth = sum(stages)
        self.stage_ends = [sum(stages[:i]) - 1
                           for i in range(1, len(stages) + 1)]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]][:q_pool]
        self.patch_embed = HieraPatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, embed_dim, *window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(
            1, embed_dim, window_spec[0], window_spec[0]))
        blocks = []
        dim, heads, cur_stage = embed_dim, num_heads, 1
        for i in range(depth):
            dim_out = dim
            window_size = window_spec[cur_stage - 1]
            if global_att_blocks and i in global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * dim_mul)
                heads = int(heads * head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(
                dim, dim_out, heads,
                q_stride=tuple(q_stride) if i in q_pool_blocks else None,
                window_size=window_size))
            dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def _get_pos_embed(self, hw: Tuple[int, int],
                       dtype: torch.dtype) -> torch.Tensor:
        """The background table resized bicubically to the feature grid,
        plus the window table tiled over it, NHWC."""
        h, w = hw
        pos = resize2d(self.pos_embed.float().permute(0, 2, 3, 1), (h, w),
                       "bicubic", align_corners=False)
        win = self.pos_embed_window.float().permute(0, 2, 3, 1)
        pos = pos + win.repeat(1, h // win.shape[1], w // win.shape[2], 1)
        return pos.to(dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, H, W, 3] -> per-stage NHWC features (strides 4/8/16/32)."""
        x = self.patch_embed(x)
        x = x + self._get_pos_embed(x.shape[1:3], x.dtype)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outputs.append(x)
        return outputs


def make_hiera(variant: str = "hiera_base", **kw) -> Hiera:
    """A Hiera of ``variant``'s configuration; ``kw`` overrides it."""
    cfg = dict(HIERA_CONFIGS[variant])
    cfg.update(kw)
    return Hiera(**cfg)
