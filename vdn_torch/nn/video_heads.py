"""Research video-depth heads of the v1 model family (vdn/nn/video_heads.py).

- ``VideoDepthHeadSangyu`` (reference models/video_depth_head_v2_sangyu.py:
  179-318), the head the v1 model uses: interleaved temporal / spatial
  transformer stacks on the selected Hiera levels, an UpSampleAdd skip
  decoder and a final 4x upsample to (depth, dx, dy);
- ``VideoDepthHeadV1`` (reference models/video_depth_head.py:9-263):
  temporal attention over patch tokens, an MLP fusion and a ConvTranspose
  decoder;
- ``VideoDepthHeadV2`` (reference models/video_depth_head_v2.py:152-268)
  and ``FusionLayer`` (reference models/fusion_block.py:61-129).

Feature maps are NHWC, [B, S, H, W, C].  The heads' attention stays plain
at any length (``use_flash=False``, as vdn's), their upsamples run through
A5a / A5b (vdn_torch.ops.resize), BatchNorms in inference mode with stored
statistics (vdn_torch.models.refine.BatchNorm2d).  Parameter names are the
reference checkpoint's (``multi_head_attention.in_proj_weight``,
``ffn.0``, ``final_upscale_layer.8``, ``decoder.0.0``).

The heads build what the reference builds, including what their forward
never runs (the sangyu head's stacks on the levels outside
``attention_feature_levels`` and its ``fusion_layer``s, head v2's stacks
on levels 0-2), so reference checkpoints load key for key.  vdn's flax
modules create no parameters for those; the trainer decays them as optax
would (vdn_torch.train.trainer.V1Trainer).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vdn_torch.models.refine import BatchNorm2d
from vdn_torch.nn.dpt import ResidualConvUnit
from vdn_torch.nn.layers import Conv2d, LayerNorm, Linear
from vdn_torch.ops.attention import dot_product_attention
from vdn_torch.ops.resize import resize2d


def sinusoid_table(length: int, dim: int) -> np.ndarray:
    """(reference video_depth_head_v2_sangyu.py:8-15, with math imported)"""
    position = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * -(math.log(10000.0) / dim))
    emb = np.zeros((length, dim))
    emb[:, 0::2] = np.sin(position * div)
    emb[:, 1::2] = np.cos(position * div)
    return emb.astype(np.float32)


def _up2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear, align_corners=True, NHWC."""
    return resize2d(x, (x.shape[-3] * 2, x.shape[-2] * 2), "bilinear",
                    align_corners=True)


class MultiheadSelfAttention(nn.Module):
    """torch nn.MultiheadAttention (self-attention, batch_first) with its
    packed ``in_proj_weight`` [3C, C], always on the plain attention path
    (vdn/nn/video_heads.py:47-69)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def _init(self, g):
        # vdn's lecun-normal Linear over the [C, 3C] kernel
        std = math.sqrt(1.0 / self.in_proj_weight.shape[1])
        self.in_proj_weight.copy_(
            torch.randn(self.in_proj_weight.shape, generator=g) * std)
        self.in_proj_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        b, t, c = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype))
        qkv = qkv + self.in_proj_bias.to(qkv.dtype)
        q, k, v = qkv.split(c, dim=-1)
        h = self.num_heads
        out = dot_product_attention(q.reshape(b, t, h, -1),
                                    k.reshape(b, t, h, -1),
                                    v.reshape(b, t, h, -1), use_flash=False)
        return self.out_proj(out.reshape(b, t, c))


class TransformerBlock(nn.Module):
    """Pre-norm MHA + FFN (reference _sangyu.py:34-76)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.multi_head_attention = MultiheadSelfAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.ffn = nn.Sequential(Linear(dim, 4 * dim), nn.GELU(),
                                 Linear(4 * dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.multi_head_attention(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class _AxisAttentionStack(nn.Module):
    """N TransformerBlocks over the frames of each pixel (``temporal``) or
    the pixels of each frame of [B, S, H, W, C]."""

    def __init__(self, dim: int, num_heads: int = 8, num_blocks: int = 4,
                 temporal: bool = True):
        super().__init__()
        self.temporal = temporal
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads) for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h, w, c = x.shape
        if self.temporal:  # (b h w) s c
            y = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, s, c)
        else:  # (b s) (h w) c
            y = x.reshape(b * s, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y)
        if self.temporal:
            return y.reshape(b, h, w, s, c).permute(0, 3, 1, 2, 4)
        return y.reshape(b, s, h, w, c)


class UpSampleAdd(nn.Module):
    """2x bilinear up -> 3x3 conv / BN / ReLU, plus a 1x1 projection of the
    skip (reference _sangyu.py:17-32)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.ModuleList([Conv2d(in_ch, out_ch, 3, padding=1,
                                          bias=False), BatchNorm2d(out_ch)])
        self.skip_proj = Conv2d(out_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv[1](self.conv[0](_up2x(x))))
        return x + self.skip_proj(skip)


class VideoDepthHeadSangyu(nn.Module):
    """The v1 model's head: per level in ``attention_feature_levels``
    (temporal, spatial) x 2 attention stacks, a top-down UpSampleAdd
    decoder, a final 4x upsample to (depth, dx, dy)."""

    def __init__(self, sequence_length: int = 8, pe: str = "ape",
                 attention_feature_levels: Sequence[int] = (2, 3),
                 feature_channels: Sequence[int] = (96, 192, 384, 768)):
        super().__init__()
        ch = tuple(feature_channels)
        self.pe = pe
        self.attention_feature_levels = tuple(attention_feature_levels)
        if pe == "ape":
            self.pos_embeds = nn.ParameterList(
                nn.Parameter(torch.zeros(sequence_length, c)) for c in ch)

        def stacks(temporal):
            return nn.ModuleList(_AxisAttentionStack(c, 8, 4, temporal)
                                 for c in ch)

        self.temporal_layers_first = stacks(True)
        self.temporal_layers_second = stacks(True)
        self.spatial_layers_first = stacks(False)
        self.spatial_layers_second = stacks(False)
        self.upscale_layers = nn.ModuleList([
            UpSampleAdd(ch[3], ch[2]), UpSampleAdd(ch[2], ch[1]),
            UpSampleAdd(ch[1], ch[0])])
        # the reference's Sequential: 0 / 4 upsample, 3 / 7 / 9 ReLU
        fu = [nn.Identity() for _ in range(11)]
        fu[1] = Conv2d(ch[0], ch[0], 3, padding=1, bias=False)
        fu[2] = BatchNorm2d(ch[0])
        fu[5] = Conv2d(ch[0], ch[0], 3, padding=1, bias=False)
        fu[6] = BatchNorm2d(ch[0])
        fu[8] = Conv2d(ch[0], 48, 3, padding=1)
        fu[10] = Conv2d(48, 3, 3, padding=1)
        self.final_upscale_layer = nn.ModuleList(fu)
        # in the checkpoint, never run by the reference's forward
        # (_sangyu.py:272-276); input width as head v2's concat
        self.fusion_layer = nn.ModuleList(
            Conv2d(2 * c, c, 3, padding=1) for c in ch[:3])

    def _init(self, g):
        if self.pe == "ape":
            for p in self.pos_embeds:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)

    def _maybe_process(self, lvl: int, feat: torch.Tensor) -> torch.Tensor:
        if lvl not in self.attention_feature_levels:
            return feat
        s, c = feat.shape[1], feat.shape[-1]
        if self.pe == "ape":
            pe = self.pos_embeds[lvl][:s]
            feat = feat + pe[None, :, None, None, :].to(feat.dtype)
        elif self.pe == "sine":
            pe = torch.from_numpy(sinusoid_table(s, c)).to(feat.device)
            feat = feat + pe[None, :, None, None, :].to(feat.dtype)
        feat = self.temporal_layers_first[lvl](feat)
        feat = self.spatial_layers_first[lvl](feat)
        feat = self.temporal_layers_second[lvl](feat)
        return self.spatial_layers_second[lvl](feat)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        """features: 4 x [B, S, H_i, W_i, C_i] (strides 4..32) ->
        [B, S, 4 H_0, 4 W_0, 3]."""
        assert len(features) == 4
        processed = [self._maybe_process(i, f)
                     for i, f in enumerate(features)]
        b, s = processed[3].shape[:2]

        def flat(f):
            return f.reshape(b * s, *f.shape[2:])

        x = flat(processed[3])
        for up, skip in zip(self.upscale_layers, processed[2::-1]):
            x = up(x, flat(skip))
        fu = self.final_upscale_layer
        x = torch.relu(fu[2](fu[1](_up2x(x))))
        x = torch.relu(fu[6](fu[5](_up2x(x))))
        x = fu[10](torch.relu(fu[8](x)))
        return x.reshape(b, s, *x.shape[1:])


class ConvTransposeTorch(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1), NHWC, torch weight [I, O, 4, 4]
    (vdn/nn/video_heads.py:296-322)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 4, 4))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def _init(self, g):
        # vdn's variance_scaling(1/3, fan_in, uniform) on the HWIO kernel
        bound = math.sqrt(1.0 / (16 * self.weight.shape[0]))
        self.weight.copy_(torch.rand(self.weight.shape, generator=g)
                          * (2 * bound) - bound)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               self.weight.to(x.dtype), None, 2, 1)
        return y.permute(0, 2, 3, 1) + self.bias.to(x.dtype)


class VideoDepthHeadV1(nn.Module):
    """Head v1: temporal MHA over patch tokens, a residual MLP fusion and a
    ConvTranspose / BN decoder to (depth, dx, dy)."""

    def __init__(self, input_dim: int, sequence_length: int = 8,
                 img_size: Tuple[int, int] = (384, 384)):
        super().__init__()
        self.sequence_length, self.img_size = sequence_length, tuple(img_size)
        d = input_dim
        self.temporal_attention = MultiheadSelfAttention(d, 8)
        self.st_fusion = nn.ModuleList([Linear(d, d), nn.Identity(),
                                        nn.Identity(), Linear(d, d)])
        dims = [d, 1024, 512, 256, 128]
        self.decoder = nn.ModuleList(
            nn.ModuleList([ConvTransposeTorch(i, o), BatchNorm2d(o)])
            for i, o in zip(dims[:-1], dims[1:]))
        self.prediction_head = nn.ModuleList([
            Conv2d(128, 64, 3, padding=1), nn.Identity(),
            Conv2d(64, 3, 3, padding=1)])

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """features [B * S, N, D] -> [B, S, H, W, 3]."""
        bs, n, d = features.shape
        s = self.sequence_length
        b = bs // s
        ph, pw = self.img_size[0] // 14, self.img_size[1] // 14
        x = features.reshape(b, s, n, d)
        y = x.permute(0, 2, 1, 3).reshape(b * n, s, d)
        y = self.temporal_attention(y)
        x = y.reshape(b, n, s, d).permute(0, 2, 1, 3)
        f = self.st_fusion[3](torch.relu(self.st_fusion[0](x)))
        x = (x + f).reshape(b * s, ph, pw, d)
        for convt, bn in self.decoder:
            x = torch.relu(bn(convt(x)))
        x = torch.relu(self.prediction_head[0](x))
        x = self.prediction_head[2](x)
        if tuple(x.shape[1:3]) != self.img_size:
            x = resize2d(x, self.img_size, "bilinear", align_corners=False)
        return x.reshape(b, s, *self.img_size, 3)


class FusionLayer(nn.Module):
    """The 5-D per-sequence fusion block: upsample lhs (2x or to
    ``rhs_size``), 3x3 in-conv, residual conv units on lhs and rhs, fuse,
    1x1 out-conv.  [B, S, H, W, C] in and out."""

    def __init__(self, lhs_channels: int, out_channels: int,
                 rhs_size: Optional[Tuple[int, int]] = None,
                 align_corners: bool = True):
        super().__init__()
        self.rhs_size, self.align_corners = rhs_size, align_corners
        self.lhs_in_conv = Conv2d(lhs_channels, out_channels, 3, padding=1,
                                  bias=False)
        self.lhs_res_block = ResidualConvUnit(out_channels)
        self.rhs_res_block = ResidualConvUnit(out_channels)
        self.fusion_res_block = ResidualConvUnit(out_channels)
        self.out_conv = Conv2d(out_channels, out_channels, 1)

    def forward(self, lhs: torch.Tensor,
                rhs: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s = lhs.shape[:2]
        x = lhs.reshape(b * s, *lhs.shape[2:])
        size = self.rhs_size or (x.shape[1] * 2, x.shape[2] * 2)
        x = resize2d(x, size, "bilinear", align_corners=self.align_corners)
        out = self.lhs_res_block(self.lhs_in_conv(x))
        if rhs is not None:
            out = out + self.rhs_res_block(rhs.reshape(b * s,
                                                       *rhs.shape[2:]))
        out = self.out_conv(self.fusion_res_block(out))
        return out.reshape(b, s, *out.shape[1:])


class VideoDepthHeadV2(nn.Module):
    """Head v2: temporal + spatial attention on the deepest level, then
    ConvTranspose / BN upscaling with concat-conv fusion against the raw
    skip features, and a final 4x ConvTranspose to (depth, dx, dy)."""

    def __init__(self, sequence_length: int = 8,
                 feature_channels: Sequence[int] = (96, 192, 384, 768)):
        super().__init__()
        ch = tuple(feature_channels)
        self.temporal_layers = nn.ModuleList(
            _AxisAttentionStack(c, 8, 2, True) for c in ch)
        self.spatial_layers = nn.ModuleList(
            _AxisAttentionStack(c, 8, 1, False) for c in ch)
        self.upscale_layers = nn.ModuleList(
            nn.ModuleList([ConvTransposeTorch(ch[i + 1], ch[i]),
                           BatchNorm2d(ch[i])]) for i in range(3))
        fu = [nn.Identity() for _ in range(5)]
        fu[0] = ConvTransposeTorch(ch[0], ch[0] // 2)
        fu[1] = BatchNorm2d(ch[0] // 2)
        fu[3] = ConvTransposeTorch(ch[0] // 2, 3)
        fu[4] = BatchNorm2d(3)
        self.final_upscale_layer = nn.ModuleList(fu)
        self.fusion_layer = nn.ModuleList(
            Conv2d(2 * c, c, 3, padding=1) for c in ch[:3])

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        """features: 4 x [B, S, H_i, W_i, C_i] -> [B, S, 4 H_0, 4 W_0, 3]."""
        x = self.spatial_layers[3](self.temporal_layers[3](features[3]))
        b, s = x.shape[:2]
        x = x.reshape(b * s, *x.shape[2:])
        for i in reversed(range(3)):
            convt, bn = self.upscale_layers[i]
            x = torch.relu(bn(convt(x)))
            skip = features[i].reshape(b * s, *features[i].shape[2:])
            x = self.fusion_layer[i](torch.cat([x, skip], dim=-1))
        fu = self.final_upscale_layer
        x = torch.relu(fu[1](fu[0](x)))
        x = torch.relu(fu[4](fu[3](x)))
        return x.reshape(b, s, *x.shape[1:])
