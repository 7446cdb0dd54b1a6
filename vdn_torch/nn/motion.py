"""Temporal motion modules, clip path (vdn/nn/motion.py).

AnimateDiff-style self-attention across the frame axis, one spatial token
at a time.  Feature maps come in and go out as [(B*T), H, W, C]; inside,
tokens are relaid once to token-major [(B*N), T, C].  Two kernels carry
each transformer block: A3, the APE + q/k/v + T x T attention + out-proj
block, and A4, the LN -> GEGLU -> residual feed-forward.

The clip path computes no cache entries: vdn's clip path drops them and
XLA deletes their projections, which eager torch would pay for.  The
cached decode paths (_cached_local, _chunk_window, _cached_cp) belong to
the streaming port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vdn_torch.kernels.geglu import fused_ln_geglu_residual
from vdn_torch.kernels.temporal_attention import temporal_attention_block
from vdn_torch.nn.layers import GroupNorm, LayerNorm, Linear


def sinusoidal_positional_encoding(d_model: int, max_len: int) -> np.ndarray:
    """APE table (reference motion_module.py:195-213): [max_len, d_model]."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class PositionalEncoding(nn.Module):
    """Holds the APE table as the reference's ``pos_encoder.pe`` buffer."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_positional_encoding(d_model, max_len))[None])


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, 2 * dim_out)


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult 4; ``net.1`` is the reference's dropout."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])


class TemporalAttention(nn.Module):
    """Self-attention across frames with an absolute sinusoidal PE:
    [(B*N), T, C] -> [(B*N), T, C] (no residual)."""

    def __init__(self, query_dim: int, heads: int = 8,
                 temporal_max_len: int = 32):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(query_dim, query_dim, bias=False)
        self.to_k = Linear(query_dim, query_dim, bias=False)
        self.to_v = Linear(query_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(query_dim, query_dim),
                                     nn.Identity()])
        self.pos_encoder = PositionalEncoding(query_dim, temporal_max_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, c = x.shape[1], x.shape[2]
        out = self.to_out[0]
        return temporal_attention_block(
            x, self.pos_encoder.pe[0, :t], self.to_q.weight, self.to_k.weight,
            self.to_v.weight, out.weight, out.bias, self.heads,
            float((c // self.heads) ** -0.5))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8,
                 num_attention_blocks: int = 2, temporal_max_len: int = 32):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, heads, temporal_max_len)
            for _ in range(num_attention_blocks))
        self.norms = nn.ModuleList(
            LayerNorm(dim) for _ in range(num_attention_blocks))
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for norm, attn in zip(self.norms, self.attention_blocks):
            x = attn(norm(x)) + x
        net_0, net_2 = self.ff.net[0].proj, self.ff.net[2]
        return fused_ln_geglu_residual(
            x, self.ff_norm.weight, self.ff_norm.bias, net_0.weight,
            net_0.bias, net_2.weight, net_2.bias, self.ff_norm.eps)


class TemporalTransformer3D(nn.Module):
    """GroupNorm + proj_in/out around the transformer blocks
    (reference TemporalTransformer3DModel, motion_module.py:68-136)."""

    def __init__(self, in_channels: int, heads: int = 8, num_layers: int = 1,
                 num_attention_blocks: int = 2, norm_num_groups: int = 32,
                 temporal_max_len: int = 32):
        super().__init__()
        self.norm = GroupNorm(norm_num_groups, in_channels)
        self.proj_in = Linear(in_channels, in_channels)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(in_channels, heads,
                                     num_attention_blocks, temporal_max_len)
            for _ in range(num_layers))
        # zero-initialized so the temporal mixer starts as identity
        self.proj_out = Linear(in_channels, in_channels, zero_init=True)

    def forward(self, x: torch.Tensor, video_length: int) -> torch.Tensor:
        bt, hh, ww, c = x.shape
        t = video_length
        b, n = bt // t, hh * ww
        y = self.norm(x)
        y = y.reshape(b, t, n, c).transpose(1, 2).reshape(b * n, t, c)
        y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y)
        y = self.proj_out(y)
        y = y.reshape(b, n, t, c).transpose(1, 2).reshape(bt, hh, ww, c)
        return y + x


class TemporalModule(nn.Module):
    """Zero-initialized residual temporal mixer over [(B*T), H, W, C]."""

    def __init__(self, in_channels: int, num_attention_heads: int = 8,
                 num_transformer_block: int = 1,
                 num_attention_blocks: int = 2, temporal_max_len: int = 32):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(
            in_channels, num_attention_heads, num_transformer_block,
            num_attention_blocks, temporal_max_len=temporal_max_len)

    def forward(self, x: torch.Tensor, video_length: int) -> torch.Tensor:
        return self.temporal_transformer(x, video_length)
