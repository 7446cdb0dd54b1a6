"""Cross-frame memory attention for the single-image depth model
(vdn/nn/memory.py).

The memory bank is a fixed-capacity, right-aligned ring ``[B, cap, HW, C]``
plus a count (the newest entry is the last slot); slots not yet written are
masked out of the cross-attention with a -inf bias per key column.  That
cross-attention (HW queries against cap * HW keys) runs through kernel C1,
the self-attention and the empty-memory branch through C2
(vdn_torch.ops.attention routes them).  2-D axial RoPE is real-valued
(vdn_torch.ops.rope); the memory encoder (sigmoid(depth) -> stride 2 * 7
mask pyramid -> ConvNeXt fuser -> sine pos enc) is NHWC.

State flows functionally: ``forward(feature, state)`` reads,
``encode(feature, depth)`` + ``update_memory_state`` write.  The count is a
Python int on the host: there are only cap + 1 slot masks, each built once
per device, and nothing syncs to read a count off the device.

Module names mirror the reference checkpoint keys (``layers.0.self_attn.
q_proj``, ``mask_downsampler.0.encoder.0``, ``fuser.layers.0.dwconv``,
``curr_pos_enc``, ``maskmem_tpos_enc``, ``no_mem_embed``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vdn_torch.nn.layers import Conv2d, LayerNorm, Linear
from vdn_torch.ops.attention import dot_product_attention
from vdn_torch.ops.rope import apply_rope, device_tables
from vdn_torch.ops.sine_pe import sine_position_embedding_2d


def init_memory_state(batch: int, num_tokens: int, channels: int,
                      capacity: int = 6, dtype: torch.dtype = torch.float32,
                      device=None) -> Dict:
    """Empty ring-buffer state (the newest entry lives in the last slot)."""
    shape = (batch, capacity, num_tokens, channels)
    return {"features": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros(shape, dtype=dtype, device=device),
            "count": 0}


def update_memory_state(state: Dict, feature: torch.Tensor,
                        pos: torch.Tensor) -> Dict:
    """Shift left, append the newest entry at the last slot (deque
    semantics).  ``pos`` is stored with the features; with the fork's
    pos-enc flags nothing reads it back."""
    feats, poss = state["features"], state["pos"]
    cap = feats.shape[1]
    return {
        "features": torch.cat([feats[:, 1:],
                               feature[:, None].to(feats.dtype)], dim=1),
        "pos": torch.cat([poss[:, 1:], pos[:, None].to(poss.dtype)], dim=1),
        "count": min(int(state["count"]) + 1, cap),
    }


@lru_cache(maxsize=32)
def slot_bias(capacity: int, num_tokens: int, count: int,
              device: torch.device) -> torch.Tensor:
    """fp32 [1, 1, 1, cap * HW]: 0 over the ``count`` newest (last) slots,
    -inf over the leading empty ones.  The 32 most recently used masks
    stay on their device (a bank has cap + 1 of them per token grid)."""
    bias = torch.zeros(capacity, num_tokens)
    bias[:capacity - count] = float("-inf")
    return bias.reshape(1, 1, 1, -1).to(device)


@lru_cache(maxsize=16)
def sine_position_encoding(gh: int, gw: int, c: int, dtype: torch.dtype,
                           device: torch.device) -> torch.Tensor:
    """The 2-D sine table [gh, gw, c] in ``dtype`` on ``device``; the 16
    most recently used stay there."""
    return torch.from_numpy(sine_position_embedding_2d(gh, gw, c)).to(
        device, dtype)


class RoPEAttention(nn.Module):
    """SAM2 RoPE attention: q / k / v / out projections with bias, axial
    2-D rope over the token grid; ``rope_k_repeat`` tiles the rope pattern
    over stacked memory entries; ``kv_in_dim`` is the width of the keys'
    and values' input where it is not the embedding's (SAM2's memory)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 rope_k_repeat: bool = False,
                 kv_in_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.rope_k_repeat = rope_k_repeat
        c = embedding_dim
        self.q_proj = Linear(c, c)
        self.k_proj = Linear(kv_in_dim or c, c)
        self.v_proj = Linear(kv_in_dim or c, c)
        self.out_proj = Linear(c, c)

    def forward(self, q, k, v, grid_hw: Tuple[int, int],
                bias: Optional[torch.Tensor] = None,
                num_k_exclude_rope: int = 0) -> torch.Tensor:
        """num_k_exclude_rope: trailing kv tokens (SAM2 object pointers)
        that skip the rotary encoding."""
        b, nq, c = q.shape
        nk = k.shape[1]
        h = self.num_heads
        dh = c // h
        q = self.q_proj(q).reshape(b, nq, h, dh)
        k = self.k_proj(k).reshape(b, nk, h, dh)
        v = self.v_proj(v).reshape(b, nk, h, dh)

        gh, gw = grid_hw
        assert gh * gw == nq
        # the tables are [T, 1, dh / 2] and broadcast over the head axis of
        # [B, T, H, dh]: no transposes around the rotation
        tables = device_tables(dh, gw, gh, q.device)
        q = apply_rope(q, *tables)
        num_k_rope = nk - num_k_exclude_rope
        repeat = num_k_rope // nq
        assert repeat * nq == num_k_rope and (
            repeat == 1 or self.rope_k_repeat)
        if num_k_exclude_rope:
            k = torch.cat([apply_rope(k[:, :num_k_rope], *tables,
                                      repeat_k=repeat),
                           k[:, num_k_rope:]], dim=1)
        else:
            k = apply_rope(k, *tables, repeat_k=repeat)
        out = dot_product_attention(q, k, v, bias=bias)
        return self.out_proj(out.reshape(b, nq, c))


class MemoryAttentionLayer(nn.Module):
    """Self-attn + RoPE cross-attn to memory + FFN.  The defaults are the
    fork's flags (pos enc only on the cross-attention queries, GELU); the
    SAM2 video config is relu with the pos enc on the keys."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu",
                 pos_enc_at_cross_attn_queries: bool = True,
                 pos_enc_at_cross_attn_keys: bool = False,
                 kv_in_dim: Optional[int] = None):
        super().__init__()
        self.activation = activation
        self.pos_enc_at_cross_attn_queries = pos_enc_at_cross_attn_queries
        self.pos_enc_at_cross_attn_keys = pos_enc_at_cross_attn_keys
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.self_attn = RoPEAttention(d_model, num_heads, False)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn_image = RoPEAttention(d_model, num_heads, True,
                                              kv_in_dim)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)

    def forward(self, tgt, memory, query_pos, grid_hw,
                bias: Optional[torch.Tensor] = None,
                memory_pos: Optional[torch.Tensor] = None,
                num_k_exclude_rope: int = 0) -> torch.Tensor:
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2, grid_hw)
        t2 = self.norm2(tgt)
        q_in = t2 + query_pos if self.pos_enc_at_cross_attn_queries else t2
        k_in = memory
        if self.pos_enc_at_cross_attn_keys and memory_pos is not None:
            k_in = memory + memory_pos
        tgt = tgt + self.cross_attn_image(
            q_in, k_in, memory, grid_hw, bias=bias,
            num_k_exclude_rope=num_k_exclude_rope)
        t2 = self.linear1(self.norm3(tgt))
        t2 = torch.relu(t2) if self.activation == "relu" else F.gelu(t2)
        return tgt + self.linear2(t2)


class MemoryAttention(nn.Module):
    """Layer stack with the input pos enc 0.1 * curr_pos."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int = 4,
                 dim_feedforward: Optional[int] = None,
                 activation: str = "gelu",
                 pos_enc_at_cross_attn_queries: bool = True,
                 pos_enc_at_cross_attn_keys: bool = False,
                 kv_in_dim: Optional[int] = None):
        super().__init__()
        dff = dim_feedforward or d_model * 2   # the fork's config
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(d_model, num_heads, dff, activation,
                                 pos_enc_at_cross_attn_queries,
                                 pos_enc_at_cross_attn_keys, kv_in_dim)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, curr, memory, curr_pos, grid_hw,
                bias: Optional[torch.Tensor] = None,
                memory_pos: Optional[torch.Tensor] = None,
                num_k_exclude_rope: int = 0) -> torch.Tensor:
        # 0.1 rounded to the compute dtype first, as vdn's weak-typed scalar
        tenth = float(torch.tensor(0.1, dtype=curr_pos.dtype))
        out = curr + tenth * curr_pos
        for layer in self.layers:
            out = layer(out, memory, curr_pos, grid_hw, bias=bias,
                        memory_pos=memory_pos,
                        num_k_exclude_rope=num_k_exclude_rope)
        return self.norm(out)


class MaskDownSampler(nn.Module):
    """One stride-s mask downsampling stage: conv s -> token LN -> GELU ->
    1x1 conv to embed_dim, indexed as the reference's Sequential."""

    def __init__(self, in_ch: int, embed_dim: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__()
        out_ch = in_ch * stride ** 2
        self.encoder = nn.Sequential(
            Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                   padding=padding),
            LayerNorm(out_ch, eps=1e-6),
            nn.GELU(),
            Conv2d(out_ch, embed_dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class CXBlock(nn.Module):
    """ConvNeXt block, NHWC."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def _init(self, g):
        self.gamma.fill_(1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dwconv(x))
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + self.gamma.to(y.dtype) * y


class Fuser(nn.Module):
    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    """(feature [B, gh, gw, C], depth [B, 14 gh, 14 gw, 1]) ->
    (memory_feature, memory_pos_enc), both [B, HW, C]; the fork's two-stage
    stride 2 * 7 = 14 mask downsampler."""

    def __init__(self, channels: int):
        super().__init__()
        self.mask_downsampler = nn.ModuleList([
            MaskDownSampler(1, 1, 3, 2, 1), MaskDownSampler(1, 1, 7, 7, 0)])
        self.pix_feat_proj = Conv2d(channels, channels, 1)
        self.fuser = Fuser(channels, 2)

    def forward(self, feature_map: torch.Tensor, depth: torch.Tensor):
        masks = torch.sigmoid(depth.float()).to(feature_map.dtype)
        for stage in self.mask_downsampler:
            masks = stage(masks)
        x = self.fuser(self.pix_feat_proj(feature_map) + masks)
        b, gh, gw, c = x.shape
        pos = sine_position_encoding(gh, gw, c, x.dtype, x.device)
        return (x.reshape(b, gh * gw, c),
                pos.reshape(1, gh * gw, c).expand(b, -1, -1))


class MemoryBlock(nn.Module):
    """Memory-conditioned feature refinement."""

    def __init__(self, channels: int, max_memory_length: int = 6,
                 num_attention_layers: int = 4):
        super().__init__()
        c = channels
        self.memory_attention = MemoryAttention(c, c // 64,
                                                num_attention_layers)
        self.curr_pos_enc = nn.Parameter(torch.zeros(1, 1, c))
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(1, max_memory_length, c))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, c))
        self.memory_encoder = MemoryEncoder(c)

    def _init(self, g):
        for p in (self.curr_pos_enc, self.maskmem_tpos_enc,
                  self.no_mem_embed):
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)

    def forward(self, img_feature: torch.Tensor, grid_hw: Tuple[int, int],
                state: Optional[Dict] = None) -> torch.Tensor:
        """img_feature [B, HW, C]; state None = the empty-memory branch."""
        b, hw, c = img_feature.shape
        dt = img_feature.dtype
        curr_pos = self.curr_pos_enc.to(dt)          # broadcasts over B, HW
        if state is None:
            memory = self.no_mem_embed.to(dt).expand(b, hw, c)
            return self.memory_attention(img_feature, memory, curr_pos,
                                         grid_hw)
        cap = state["features"].shape[1]
        mem = state["features"].to(dt).reshape(b, cap * hw, c)
        bias = slot_bias(cap, hw, int(state["count"]), img_feature.device)
        return self.memory_attention(img_feature, mem, curr_pos, grid_hw,
                                     bias=bias)

    def encode(self, img_feature: torch.Tensor, depth: torch.Tensor,
               grid_hw: Tuple[int, int]):
        """-> (memory_feature [B, HW, C], memory_pos_enc [B, HW, C])."""
        b, hw, c = img_feature.shape
        gh, gw = grid_hw
        return self.memory_encoder(img_feature.reshape(b, gh, gw, c), depth)
