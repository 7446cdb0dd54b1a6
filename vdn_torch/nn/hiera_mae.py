"""Plain (MAE-pretrained) Hiera backbone (vdn/nn/hiera_mae.py; the
torch-hub ``facebookresearch/hiera`` model the reference's v1 encoders
load, reference models/hiera_image_encoder.py:35).

Architecturally apart from SAM2's hieradet (vdn_torch/nn/hiera.py): one
dense position embedding, no windowed background table, no global-block
list, and "mask unit attention" over an unrolled token order with the
query pooling folded into the attention.  The unroll / reroll reorderings
are reshapes and permutes; the attention is head-batched einsums with an
fp32 softmax, as vdn runs it (no kernel: its windows are at most 64 tokens
and its global stages 49 at 224 x 224).

Parameter names are the hub checkpoint's (``blocks.0.attn.qkv``,
``blocks.0.mlp.fc1``, ``pos_embed`` [1, N, C], ``norm``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from vdn_torch.nn.layers import Conv2d, LayerNorm, Linear, Mlp
from vdn_torch.ops.resize import resize2d

# torch-hub configs (hub hiera.py:486-552); all share q_pool 3, q_stride
# 2 x 2, mask unit 8 x 8, patch conv 7 x 7 / s4 / p3, mlp_ratio 4, and
# double the width and heads per stage
HIERA_MAE_CONFIGS = {
    "hiera_tiny_224": dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2)),
    "hiera_small_224": dict(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2)),
    "hiera_base_224": dict(embed_dim=96, num_heads=1, stages=(2, 3, 16, 3)),
    "hiera_base_plus_224": dict(embed_dim=112, num_heads=2,
                                stages=(2, 3, 16, 3)),
    "hiera_large_224": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4)),
    "hiera_huge_224": dict(embed_dim=256, num_heads=4, stages=(2, 6, 36, 4)),
}

_Q_STRIDE = (2, 2)
_MASK_UNIT = (8, 8)
_Q_POOL = 3  # pooling stage transitions


def unroll_tokens(x: torch.Tensor, size: Tuple[int, int],
                  schedule: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """[B, h * w, C] row-major tokens -> Hiera's unrolled order: pooling
    offsets most significant, the mask-unit index least significant (hub
    hiera utils ``Unroll``)."""
    b, _, c = x.shape
    cur = list(size)
    batch = b
    x = x.reshape(batch, cur[0], cur[1], c)
    for sh, sw in schedule:
        cur = [cur[0] // sh, cur[1] // sw]
        x = x.reshape(batch, cur[0], sh, cur[1], sw, c)
        x = x.permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(batch * sh * sw, cur[0], cur[1], c)
        batch *= sh * sw
    return x.reshape(b, size[0] * size[1], c)


def reroll_tokens(x: torch.Tensor, size: Tuple[int, int],
                  schedule: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Inverse of ``unroll_tokens`` for a feature that has consumed the
    leading pool levels: [B, N, C] -> [B, size_h, size_w, C] (hub hiera
    utils ``Reroll``)."""
    b, n, c = x.shape
    mu = [1, 1]
    for sh, sw in schedule:
        n //= sh * sw
        x = x.reshape(b, sh, sw, n, mu[0], mu[1], c)
        x = x.permute(0, 3, 1, 4, 2, 5, 6)
        mu = [mu[0] * sh, mu[1] * sw]
        x = x.reshape(b, n, mu[0], mu[1], c)
    nh, nw = size[0] // mu[0], size[1] // mu[1]
    x = x.reshape(b, nh, nw, mu[0], mu[1], c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, size[0], size[1], c)


class MaePatchEmbed(nn.Module):
    """7 x 7 / s4 conv patchify (hub hiera.py:PatchEmbed)."""

    def __init__(self, embed_dim: int, in_ch: int = 3):
        super().__init__()
        self.proj = Conv2d(in_ch, embed_dim, 7, stride=4, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class MaskUnitAttention(nn.Module):
    """Attention within mask-unit windows (or global) with the query
    pooling folded in (hub hiera.py:MaskUnitAttention), on unrolled
    tokens: the window index is the token axis's least significant part."""

    def __init__(self, dim: int, dim_out: int, heads: int, q_stride: int = 1,
                 window_size: int = 0, use_mask_unit_attn: bool = False):
        super().__init__()
        self.dim_out, self.heads = dim_out, heads
        self.q_stride, self.window_size = q_stride, window_size
        self.use_mask_unit_attn = use_mask_unit_attn
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.heads
        hd = self.dim_out // h
        num_win = 1
        if self.use_mask_unit_attn:
            num_win = n // (self.q_stride * self.window_size)
        qkv = self.qkv(x).reshape(b, n // num_win, num_win, 3, h, hd)
        qkv = qkv.permute(3, 0, 4, 2, 1, 5)  # [3, B, h, win, intra, hd]
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.q_stride > 1:
            q = q.reshape(b, h, num_win, self.q_stride, -1, hd).amax(3)
        logits = torch.einsum("bhwqd,bhwkd->bhwqk", q.float(),
                              k.float()) * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhwqk,bhwkd->bhwqd", probs, v)
        out = out.permute(0, 3, 2, 1, 4).reshape(b, -1, self.dim_out)
        return self.proj(out)


class HieraMaeBlock(nn.Module):
    """norm1 -> (proj + unrolled max-pool on a width change) -> attn ->
    residual; norm2 -> MLP -> residual (hub hiera.py:HieraBlock)."""

    def __init__(self, dim: int, dim_out: int, heads: int,
                 mlp_ratio: float = 4.0, q_stride: int = 1,
                 window_size: int = 0, use_mask_unit_attn: bool = False):
        super().__init__()
        self.dim, self.dim_out, self.q_stride = dim, dim_out, q_stride
        self.norm1 = LayerNorm(dim)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)
        self.attn = MaskUnitAttention(dim, dim_out, heads, q_stride,
                                      window_size, use_mask_unit_attn)
        self.norm2 = LayerNorm(dim_out)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.dim != self.dim_out:
            x = self.proj(y)
            x = x.reshape(x.shape[0], self.q_stride, -1,
                          self.dim_out).amax(1)
        x = x + self.attn(y)
        return x + self.mlp(self.norm2(x))


class HieraMae(nn.Module):
    """The plain MAE Hiera trunk.  ``forward(x)`` returns (pooled [B, C_last],
    the trunk norm of the mean token, and the 4 NHWC stage maps), the hub
    forward with ``return_intermediates=True`` that the reference reads
    (hiera_image_encoder.py:44-61)."""

    def __init__(self, embed_dim: int = 96, num_heads: int = 1,
                 stages: Sequence[int] = (2, 3, 16, 3), img_size: int = 224,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.embed_dim, self.stages = embed_dim, tuple(stages)
        self.patch_embed = MaePatchEmbed(embed_dim)
        grid = img_size // 4
        self.pos_grid = (grid, grid)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, embed_dim))

        cum = [0]
        for d in stages:
            cum.append(cum[-1] + d)
        pool_blocks = set(cum[1:1 + _Q_POOL])  # first block of stages 1..3
        q_area = _Q_STRIDE[0] * _Q_STRIDE[1]
        mu_area = _MASK_UNIT[0] * _MASK_UNIT[1]
        blocks = []
        for i in range(cum[-1]):
            stage = next(s for s in range(len(stages))
                         if cum[s] <= i < cum[s + 1])
            dim = int(embed_dim * 2 ** stage)
            dim_in = dim // 2 if i == cum[stage] and stage > 0 else dim
            heads = num_heads * 2 ** stage
            q_stride = q_area if i in pool_blocks else 1
            window = max(1, mu_area // q_area ** stage)
            # stages 0 / 1 window-attend; the first block after a pooling
            # stage lags one block at the lower resolution (hub
            # hiera.py:448-452)
            mask_attn = stage < 2 or (stage == 2 and i == cum[2])
            blocks.append(HieraMaeBlock(dim_in, dim, heads, mlp_ratio,
                                        q_stride, window, mask_attn))
        self.blocks = nn.ModuleList(blocks)
        self._cum = cum
        self.norm = LayerNorm(int(embed_dim * 2 ** (len(stages) - 1)))

    def _init(self, g):
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape,
                                         generator=g) * 0.02)

    def _pos(self, gh: int, gw: int, dtype: torch.dtype) -> torch.Tensor:
        pos = self.pos_embed.float()
        if (gh, gw) != self.pos_grid:
            pos = pos.reshape(1, *self.pos_grid, self.embed_dim)
            pos = resize2d(pos, (gh, gw), "bicubic", align_corners=False)
            pos = pos.reshape(1, gh * gw, self.embed_dim)
        return pos.to(dtype)

    def forward(self, x: torch.Tensor):
        b, hh, ww, _ = x.shape
        gh, gw = hh // 4, ww // 4
        tokens = self.patch_embed(x).reshape(b, gh * gw, -1)
        tokens = tokens + self._pos(gh, gw, tokens.dtype)
        full_schedule = [_Q_STRIDE] * (len(self.stages) - 1)
        tokens = unroll_tokens(tokens, (gh, gw), full_schedule)

        cum = self._cum
        stage_ends = {cum[s + 1] - 1: s for s in range(len(self.stages))}
        size = [gh, gw]
        schedule = list(full_schedule)
        intermediates: List[torch.Tensor] = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            s = stage_ends.get(i)
            if s is not None:
                intermediates.append(reroll_tokens(tokens, tuple(size),
                                                   schedule))
                if s < _Q_POOL:  # the next stage opens with a q-pool block
                    size = [size[0] // _Q_STRIDE[0],
                            size[1] // _Q_STRIDE[1]]
                    schedule = schedule[1:]
        return self.norm(tokens.mean(1)), intermediates


def make_hiera_mae(variant: str = "hiera_base_224") -> HieraMae:
    return HieraMae(**HIERA_MAE_CONFIGS[variant])
