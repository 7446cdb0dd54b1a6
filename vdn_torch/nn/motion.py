"""Temporal motion modules (vdn/nn/motion.py).

AnimateDiff-style self-attention across the frame axis, one spatial token
at a time.  Feature maps come in and go out as [(B*T), H, W, C]; inside,
tokens are relaid once to token-major [(B*N), T, C].  Two kernels carry
each transformer block: A3, the APE + q/k/v + T x T attention + out-proj
block, and A4, the LN -> GEGLU -> residual feed-forward.

``forward`` is the clip path and computes no cache entries (vdn's clip
path drops them and XLA deletes their projections, which eager torch
would pay for).  ``forward_stream`` is the streaming path; it returns the
entries, in vdn's contract: position-free packed K/V
[heads * B*N, T, max(2 * dh, 128)], lanes [K(dh) | V(dh) | zeros],
head-major rows (vdn/nn/motion.py:19-30).  Its cache argument is

- None: the stream's first frame (A3, plus the two entry projections);
- a tensor [h * B*N, 31, dpad], the frame's gathered window
  (``_cached_local``, the per-frame path);
- a pair (ring [h * B*N, CAP, dpad], one-hot [k, 32, CAP + k]), the
  batched chunk path (``_chunk_window``).

The window APE attaches by linearity: K at window position p is
to_k(raw) + to_k(pe[p]).  Every product of the cached paths sums in fp32
and is rounded to the compute dtype where vdn's einsums round; logits stay
fp32.

Context parallel (``seq_axis``, a mesh axis name resolved in the mesh in
use, vdn_torch.parallel.mesh): the clip path then takes vdn's generic
attention (the APE slice, or temporal RoPE, at the rank's global frame
offset, three projections, ``cp_attention`` over the seq group, to_out)
instead of A3, as vdn's A3 gate requires ``seq_axis is None``; a RoPE
model (``pos_embedding_type="rope"``) takes the same path with plain
attention.  The streaming decodes shard the window over the seq group:
``_cached_cp`` (the gathered window's shard, combined by
``distributed_kv_attention``) and the CP branch of ``_chunk_window`` (the
ring's shard of CAP columns; the window logits and the value product
summed over the group).  RoPE has no cache mode, as in vdn.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vdn_torch.kernels.geglu import fused_ln_geglu_residual
from vdn_torch.kernels.temporal_attention import temporal_attention_block
from vdn_torch.nn.layers import GroupNorm, LayerNorm, Linear
from vdn_torch.ops.attention import dot_product_attention
from vdn_torch.ops.rope import apply_rope, temporal_rope_freqs
from vdn_torch.parallel.context import (cp_attention,
                                        distributed_kv_attention,
                                        sequence_position_offset)
from vdn_torch.parallel.mesh import axis_group, axis_index, axis_size


def sinusoidal_positional_encoding(d_model: int, max_len: int) -> np.ndarray:
    """APE table (reference motion_module.py:195-213): [max_len, d_model]."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def ring_lane_width(dh: int) -> int:
    """Packed K/V ring lane width: 2 * dh, padded up to 128 lanes."""
    return max(2 * dh, 128)


def pack_ring_entry(k: torch.Tensor, v: torch.Tensor,
                    dpad: int) -> torch.Tensor:
    """k, v [h, n, t, dh] head-major -> [h * n, t, dpad] packed ring entry
    (lanes [K | V | zero pad])."""
    h, n, t, dh = k.shape
    parts = [k, v]
    if dpad > 2 * dh:
        parts.append(k.new_zeros(k.shape[:-1] + (dpad - 2 * dh,)))
    return torch.cat(parts, dim=-1).reshape(h * n, t, dpad)


def _ein(eq: str, *ops: torch.Tensor, dt=None) -> torch.Tensor:
    """einsum with fp32 sums over the operands' values; rounded to ``dt``
    (the compute dtype) unless dt is None (fp32 logits)."""
    y = torch.einsum(eq, *(o.float() for o in ops))
    return y if dt is None else y.to(dt)


def _hview(w: torch.Tensor, heads: int, dt) -> torch.Tensor:
    """Linear weight [C_out, C_in] -> [h, C_in, dh] in dt (vdn's
    ``_weights_hview``)."""
    return w.to(dt).reshape(heads, -1, w.shape[1]).transpose(1, 2)


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


def _window_start(offset: int, size: int, n: int) -> int:
    """``jax.lax.dynamic_slice``'s start: clamped to [0, n - size]."""
    return max(0, min(offset, n - size))


class TemporalAttention(nn.Module):
    """Self-attention across frames with an absolute sinusoidal PE
    (``"ape"``) or temporal RoPE (``"rope"``): [(B*N), T, C] ->
    [(B*N), T, C] (no residual).  ``seq_axis`` names the mesh axis the
    frames are sharded over (context parallel)."""

    def __init__(self, query_dim: int, heads: int = 8,
                 temporal_max_len: int = 32, pos_embedding_type: str = "ape",
                 seq_axis: Optional[str] = None):
        super().__init__()
        if pos_embedding_type not in ("ape", "rope"):
            raise NotImplementedError(pos_embedding_type)
        self.heads = heads
        self.pos_embedding_type = pos_embedding_type
        self.seq_axis = seq_axis
        self.to_q = Linear(query_dim, query_dim, bias=False)
        self.to_k = Linear(query_dim, query_dim, bias=False)
        self.to_v = Linear(query_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(query_dim, query_dim),
                                     nn.Identity()])
        self.pos_encoder = PositionalEncoding(query_dim, temporal_max_len)
        self._consts = None   # (key, tensors) of _stream_consts

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq_axis is not None or self.pos_embedding_type != "ape":
            return self._attend(x)
        t, c = x.shape[1], x.shape[2]
        out = self.to_out[0]
        return temporal_attention_block(
            x, self.pos_encoder.pe[0, :t], self.to_q.weight, self.to_k.weight,
            self.to_v.weight, out.weight, out.bias, self.heads,
            float((c // self.heads) ** -0.5))

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        """vdn's generic clip path (vdn/nn/motion.py:200-279, no cache):
        the APE slice or RoPE at this rank's global frame offset (0 without
        ``seq_axis``; a slice start clamped as ``dynamic_slice`` clamps
        it), three unfused projections, ``cp_attention`` over the seq group
        (plain attention without ``seq_axis``), to_out."""
        bn, t, c = x.shape
        h = self.heads
        max_len = self.pos_encoder.pe.shape[1]
        offset = 0
        if self.seq_axis is not None:
            offset = sequence_position_offset(self.seq_axis, t)
        start = _window_start(offset, t, max_len)
        if self.pos_embedding_type == "ape":
            x = x + self.pos_encoder.pe[0, start:start + t].to(x.dtype)
        query, key, value = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.pos_embedding_type == "rope":
            # on the full inner dim before the head split (reference
            # attention.py:279-282)
            cos, sin = temporal_rope_freqs(c, max_len)
            cos, sin = cos[start:start + t], sin[start:start + t]
            query = apply_rope(query, cos, sin)
            key = apply_rope(key, cos, sin)
        q, k, v = (a.reshape(bn, t, h, c // h) for a in (query, key, value))
        if self.seq_axis is not None:
            out = cp_attention(q, k, v, self.seq_axis)
        else:
            out = dot_product_attention(q, k, v, use_flash=False)
        return self.to_out[0](out.reshape(bn, t, c))

    def forward_stream(self, x: torch.Tensor, cache=None,
                       cache_len: Optional[int] = None):
        """Streaming decode: (out [(B*N), T_new, C], cache entry).  With
        ``seq_axis`` the cache is this rank's shard of the window and
        ``cache_len`` the window's valid entries over the whole axis
        (trailing shards may be zero padding)."""
        if cache is None:
            return self.forward(x), self._entry(x)
        if self.pos_embedding_type != "ape":
            raise ValueError("rope temporal attention has no cache mode")
        if isinstance(cache, tuple):
            return self._chunk_window(x, *cache)
        if self.seq_axis is not None:
            return self._cached_cp(x, cache, cache_len)
        return self._cached_local(x, cache)

    def _stream_consts(self, dt):
        """The streaming paths' weight-only tensors, made once per compute
        dtype and weight version rather than in every block of every frame
        (XLA folds them in vdn; eager torch would pay the casts and
        projections each call): the head views of to_q/k/v [h, C, dh] and
        of to_out [h, dh, C], held in fp32 with their values rounded to dt
        (as _ein reads them), the out bias and the APE table in dt, and the
        table's K/V projections pe_k, pe_v [h, max_len, dh] in dt."""
        wo = self.to_out[0]
        params = (self.to_q.weight, self.to_k.weight, self.to_v.weight,
                  wo.weight, wo.bias, self.pos_encoder.pe)
        key = (dt,) + tuple((p.device, p.data_ptr(), p._version)
                            for p in params)
        if self._consts is None or self._consts[0] != key:
            h = self.heads
            wq, wk, wv = (_hview(m.weight, h, dt).float().contiguous()
                          for m in (self.to_q, self.to_k, self.to_v))
            # out-projection [C_out, h * dh] -> [h, dh, C_out]
            wo_h = wo.weight.to(dt).t().reshape(
                h, -1, wo.weight.shape[0]).float().contiguous()
            pe = self.pos_encoder.pe[0].to(dt)
            pe_k = _ein("pc,hcd->hpd", pe, wk, dt=dt)
            pe_v = _ein("pc,hcd->hpd", pe, wv, dt=dt)
            self._consts = (key, (wq, wk, wv, wo_h, wo.bias.to(dt), pe,
                                  pe_k, pe_v))
        return self._consts[1]

    def _entry(self, x: torch.Tensor) -> torch.Tensor:
        """Position-free packed K/V of the raw (pre-PE) inputs."""
        dt = x.dtype
        _, wk, wv, _, _, _, _, _ = self._stream_consts(dt)
        k_e = _ein("ntc,hcd->hntd", x, wk, dt=dt)
        v_e = _ein("ntc,hcd->hntd", x, wv, dt=dt)
        return pack_ring_entry(k_e, v_e, ring_lane_width(k_e.shape[-1]))

    def _cached_local(self, x_new: torch.Tensor, cache: torch.Tensor):
        """Per-frame cached decode over the gathered window
        cache [h * B*N, d_in, dpad] (vdn/nn/motion.py:299-354): the
        window's K/V were projected once when each entry was written; the
        cache-side APE attaches on the logits (q . to_k(pe[p])) and on the
        output (probs . to_v(pe[p])) by linearity."""
        bn, t_new, c = x_new.shape
        h = self.heads
        dh = c // h
        d_in = cache.shape[1]
        t_total = d_in + t_new
        dt = x_new.dtype
        wq, wk, wv, wo_h, bo, pe, pe_k, pe_v = self._stream_consts(dt)
        q = _ein("ntc,hcd->hntd", x_new + pe[d_in:t_total][None], wq, dt=dt)
        k_e = _ein("ntc,hcd->hntd", x_new, wk, dt=dt)         # position-free
        v_e = _ein("ntc,hcd->hntd", x_new, wv, dt=dt)
        k_n = k_e + pe_k[:, None, d_in:t_total]
        v_n = v_e + pe_v[:, None, d_in:t_total]
        dpad = cache.shape[-1]
        kv = cache.reshape(h, bn, d_in, dpad).to(dt)

        qz = torch.cat([q, q.new_zeros(q.shape[:-1] + (dpad - dh,))], -1)
        qpe_c = _ein("hntd,hpd->hntp", q, pe_k[:, :d_in])
        logits = torch.cat([_ein("hntd,hnkd->hntk", qz, kv) + qpe_c,
                            _ein("hntd,hnkd->hntk", q, k_n)], -1) * dh ** -0.5
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = (_ein("hntk,hnkd->hntd", probs[..., :d_in], kv,
                    dt=dt)[..., dh:2 * dh]
               + _ein("hntk,hkd->hntd", probs[..., :d_in], pe_v[:, :d_in],
                      dt=dt)
               + _ein("hntk,hnkd->hntd", probs[..., d_in:], v_n, dt=dt))
        out = _ein("hntd,hdc->ntc", out, wo_h, dt=dt) + bo
        return out, pack_ring_entry(k_e, v_e, ring_lane_width(dh))

    def _chunk_window(self, x: torch.Tensor, buf: torch.Tensor,
                      onehot: torch.Tensor):
        """Batched streaming decode of k frames in one window attention
        (vdn/nn/motion.py:356-489).

        x [N, k, C]: this block's inputs for all k frames; buf
        [h * N, CAP, dpad]: the ring of position-free packed K/V; onehot
        [k, W, CAP + k]: onehot[j, p] selects the column (ring slot, or
        CAP + i for in-chunk frame i) at window position p of frame j's
        window, position W - 1 being the frame's own entry.  Queries sit at
        position W - 1.  Returns (out [N, k, C], entry [h * N, k, dpad]).

        With ``seq_axis`` the ring is this rank's shard [h * N, CAP / p,
        dpad] of the CAP axis (the one-hot's ring columns span the global
        CAP), x and the one-hot are replicated; each rank takes its slice
        of the ring columns, the last rank alone the in-chunk columns, and
        the window logits and the value product are summed over the group:
        every (frame, position) has one owning column."""
        n, kf, c = x.shape
        cap = buf.shape[1]
        w = self.pos_encoder.pe.shape[1]
        h = self.heads
        dh = c // h
        dt = x.dtype
        wq, wk, wv, wo_h, bo, pe, pe_k, pe_v = self._stream_consts(dt)

        qh = _ein("njc,hcd->hnjd", x + pe[w - 1], wq, dt=dt)   # [h, n, k, dh]
        k_n = _ein("njc,hcd->hnjd", x, wk, dt=dt)              # position-free
        v_n = _ein("njc,hcd->hnjd", x, wv, dt=dt)
        r = h * n
        dpad = ring_lane_width(dh)
        kv3 = buf.to(dt)
        entry = pack_ring_entry(k_n, v_n, dpad)
        qz = torch.cat([qh, qh.new_zeros(qh.shape[:-1] + (dpad - dh,))],
                       -1).reshape(r, kf, dpad)

        axis = self.seq_axis
        if axis is not None:
            p, my = axis_size(axis), axis_index(axis)
            cap_g = onehot.shape[2] - kf
            if cap_g != cap * p:
                raise ValueError(
                    "CP chunk window: the global ring capacity must be p * "
                    f"the local shard ({cap_g} != {p} * {cap})")
            own_chunk = 1.0 if my == p - 1 else 0.0
            onehot = torch.cat([onehot[:, :, my * cap:(my + 1) * cap],
                                onehot[:, :, cap_g:] * own_chunk], -1)

        lg_ring = _ein("rjd,rcd->rjc", qz, kv3)
        lg_new = _ein("hnjd,hncd->hnjc", qh, k_n)
        logits_cols = torch.cat([lg_ring, lg_new.reshape(r, kf, kf)], -1)
        qpe = _ein("hnjd,hpd->hnjp", qh, pe_k)
        # each frame's W window logits out of the CAP + k columns (exact:
        # one 1.0 term per position)
        logits_win = _ein("rjc,jpc->rjp", logits_cols, onehot)
        if axis is not None:
            logits_win = _psum(logits_win, axis)
        logits_win = logits_win + qpe.reshape(r, kf, w)
        pd = torch.softmax(logits_win * dh ** -0.5, dim=-1).to(dt)
        # probs scattered back to columns for the shared-column value sums
        p_cols = _ein("rjp,jpc->rjc", pd, onehot.to(dt), dt=dt)
        out = (_ein("rjc,rcd->rjd", p_cols[..., :cap], kv3,
                    dt=dt)[..., dh:2 * dh].reshape(h, n, kf, dh)
               + _ein("hnjc,hncd->hnjd", p_cols[..., cap:].reshape(
                   h, n, kf, kf), v_n, dt=dt))
        if axis is not None:
            out = _psum(out, axis)
        out = out + _ein("hnjp,hpd->hnjd", pd.reshape(h, n, kf, w), pe_v,
                         dt=dt)
        out = _ein("hnjd,hdc->njc", out, wo_h, dt=dt) + bo
        return out, entry

    def _cached_cp(self, x_new: torch.Tensor, cache: torch.Tensor,
                   cache_len: Optional[int]):
        """Per-frame decode with the window sharded over ``seq_axis``
        (vdn/nn/motion.py:491-549).  x_new [B*N, t_new, C] replicated; cache
        [h * B*N, d_local, dpad] this rank's shard of the position-free
        window.  The APE attaches by linearity at the global positions
        (clamped to the table, ``idx_cl``); columns at or past
        ``cache_len`` and, on every rank but the last, the new frames'
        columns take a -1e30 bias; distributed_kv_attention combines the
        shards exactly."""
        axis = self.seq_axis
        p, my = axis_size(axis), axis_index(axis)
        bn, t_new, c = x_new.shape
        h = self.heads
        dh = c // h
        d_local = cache.shape[1]
        cl = cache_len if cache_len is not None else p * d_local
        dt = x_new.dtype
        wq, wk, wv, wo_h, bo, pe, pe_k, pe_v = self._stream_consts(dt)
        idx = my * d_local + torch.arange(d_local, device=x_new.device)
        idx_cl = idx.clamp(max=pe.shape[0] - 1)

        q = _ein("ntc,hcd->hntd", x_new + pe[cl:cl + t_new][None], wq, dt=dt)
        k_e = _ein("ntc,hcd->hntd", x_new, wk, dt=dt)         # position-free
        v_e = _ein("ntc,hcd->hntd", x_new, wv, dt=dt)
        kv = cache.reshape(h, bn, d_local, cache.shape[-1]).to(dt)
        k_c = kv[..., :dh] + pe_k[:, None, idx_cl]
        v_c = kv[..., dh:2 * dh] + pe_v[:, None, idx_cl]
        k_n = k_e + pe_k[:, None, cl:cl + t_new]
        v_n = v_e + pe_v[:, None, cl:cl + t_new]
        neg = -1e30
        bias = torch.cat([
            torch.where(idx < cl, 0.0, neg).float(),
            torch.full((t_new,), 0.0 if my == p - 1 else neg,
                       device=x_new.device)])

        def bthd(a):                                    # [bn, T, h, dh]
            return a.permute(1, 2, 0, 3)

        out = distributed_kv_attention(
            bthd(q), bthd(torch.cat([k_c, k_n], 2)),
            bthd(torch.cat([v_c, v_n], 2)), axis, bias)
        out = _ein("nthd,hdc->ntc", out, wo_h, dt=dt) + bo
        return out, pack_ring_entry(k_e, v_e, ring_lane_width(dh))


def _psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum`` over the mesh axis."""
    x = x.contiguous()
    dist.all_reduce(x, group=axis_group(axis))
    return x


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8,
                 num_attention_blocks: int = 2, temporal_max_len: int = 32,
                 pos_embedding_type: str = "ape",
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, heads, temporal_max_len,
                              pos_embedding_type, seq_axis)
            for _ in range(num_attention_blocks))
        self.norms = nn.ModuleList(
            LayerNorm(dim) for _ in range(num_attention_blocks))
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, None)[0]

    def forward_stream(self, x: torch.Tensor, caches=None,
                       cache_len: Optional[int] = None):
        """(out, one cache entry per attention block)."""
        return self._run(x, caches or [None] * len(self.attention_blocks),
                         cache_len)

    def _run(self, x, caches, cache_len=None):
        entries = []
        for i, (norm, attn) in enumerate(zip(self.norms,
                                             self.attention_blocks)):
            if caches is None:
                y = attn(norm(x))
            else:
                y, entry = attn.forward_stream(norm(x), caches[i],
                                               cache_len)
                entries.append(entry)
            x = y + x
        net_0, net_2 = self.ff.net[0].proj, self.ff.net[2]
        return fused_ln_geglu_residual(
            x, self.ff_norm.weight, self.ff_norm.bias, net_0.weight,
            net_0.bias, net_2.weight, net_2.bias, self.ff_norm.eps), entries


class TemporalTransformer3D(nn.Module):
    """GroupNorm + proj_in/out around the transformer blocks
    (reference TemporalTransformer3DModel, motion_module.py:68-136)."""

    def __init__(self, in_channels: int, heads: int = 8, num_layers: int = 1,
                 num_attention_blocks: int = 2, norm_num_groups: int = 32,
                 temporal_max_len: int = 32, pos_embedding_type: str = "ape",
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.norm = GroupNorm(norm_num_groups, in_channels)
        self.proj_in = Linear(in_channels, in_channels)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(in_channels, heads,
                                     num_attention_blocks, temporal_max_len,
                                     pos_embedding_type, seq_axis)
            for _ in range(num_layers))
        # zero-initialized so the temporal mixer starts as identity
        self.proj_out = Linear(in_channels, in_channels, zero_init=True)

    def forward(self, x: torch.Tensor, video_length: int) -> torch.Tensor:
        return self._run(x, video_length, None)[0]

    def forward_stream(self, x: torch.Tensor, video_length: int,
                       caches=None, cache_len: Optional[int] = None):
        """(out, the blocks' cache entries in order)."""
        n_per = len(self.transformer_blocks[0].attention_blocks)
        n_all = n_per * len(self.transformer_blocks)
        return self._run(x, video_length, caches or [None] * n_all,
                         cache_len)

    def _run(self, x, video_length, caches, cache_len=None):
        bt, hh, ww, c = x.shape
        t = video_length
        b, n = bt // t, hh * ww
        y = self.norm(x)
        y = y.reshape(b, t, n, c).transpose(1, 2).reshape(b * n, t, c)
        y = self.proj_in(y)
        entries = []
        for i, blk in enumerate(self.transformer_blocks):
            if caches is None:
                y = blk(y)
            else:
                n_per = len(blk.attention_blocks)
                y, e = blk.forward_stream(
                    y, caches[i * n_per:(i + 1) * n_per], cache_len)
                entries.extend(e)
        y = self.proj_out(y)
        y = y.reshape(b, n, t, c).transpose(1, 2).reshape(bt, hh, ww, c)
        return y + x, entries


class TemporalModule(nn.Module):
    """Zero-initialized residual temporal mixer over [(B*T), H, W, C]."""

    def __init__(self, in_channels: int, num_attention_heads: int = 8,
                 num_transformer_block: int = 1,
                 num_attention_blocks: int = 2, temporal_max_len: int = 32,
                 pos_embedding_type: str = "ape",
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(
            in_channels, num_attention_heads, num_transformer_block,
            num_attention_blocks, temporal_max_len=temporal_max_len,
            pos_embedding_type=pos_embedding_type, seq_axis=seq_axis)

    def forward(self, x: torch.Tensor, video_length: int) -> torch.Tensor:
        return self.temporal_transformer(x, video_length)

    def forward_stream(self, x: torch.Tensor, video_length: int,
                       caches=None, cache_len: Optional[int] = None):
        """(out, cache entries); caches as TemporalAttention.forward_stream
        takes them, one per attention block, or None for the first frame."""
        return self.temporal_transformer.forward_stream(x, video_length,
                                                        caches, cache_len)
