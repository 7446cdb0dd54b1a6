"""A1's schedule on the card (csrc/flash_attn_qkv.cu), replayed in plain
torch on the CPU and held to ``flash_attention_fused_qkv_plain`` and to
vdn's Pallas kernel.

The kernel needs the card; what its design changes is the tiling and the
order of the online softmax, which plain torch can replay.  The work items
of ``a1_plan`` (frame, head, 128-row q tile), walked by the persistent
blocks, cover every q row of every (frame, head) once.  In an item each
of the two warpgroups takes 64 q rows (rows past T are zeros, as TMA
loads them), scales them to qs = bf16(q * bf16(scale * log2 e)), and walks
the keys in 128-key tiles in key order (the tail's keys past T masked to
-inf, their V rows zero): S = qs K^T in fp32, the running max m, alpha =
exp2(m_old - m) on O and on the row sum l, p = bf16(exp2(S - m)) rounded
against the running max, O += p V and l += the sum of the rounded p in
fp32 (the kernel's P V product with a column of ones beside V); then out
= bf16(O * (1 / l)) and, in the training forward (kLse), lse = m +
log2(l).  At a ragged T (90: one tile, 38 rows and keys past T; 257: three
tiles, the last with one key; 1370: eleven, the last with 90) the replay
must sit within chip_smoke.py's tolerance (KERNEL_ULPS bf16 ulps at each
output's scale) of the plain version, and of vdn's kernel run in Pallas
interpret mode as tests/test_torch_kernels.py runs it.

C2 (``flash_attention`` in bf16 at D 64, the memory block's attention) is
the same kernel in its kBthd form: A1's arithmetic on separate q [B, Tq,
H, 64] and k, v [B, Tk, H, 64], the items of ``a1_plan(b, Tq, h)`` over
the q tiles of Tq, each walking the Tk keys in 128-key tiles (the tail's
keys past Tk masked to -inf, their V rows zero; q rows past Tq zeros and
never stored).  Its replay is held to ``flash_attention_plain`` and to
vdn's ``flash_attention`` at the memory block's (Tq, Tk) = (1369, 1369)
and (1813, 1813), and at (90, 257), where Tq and Tk differ.

C1 (``flash_attention_colbias``, the memory bank's cross-attention) is
the same kernel in its kC1 form: kBthd with an fp32 bias per key column,
bias * log2 e rounded to fp32 and added to S before the row max (keys past
Tk masked after), and the key tiles whose every column is -inf skipped by
producer and consumers alike; a row max of -inf (no finite logit yet)
keeps O and l and shifts by 0.  Its replay is held to
``flash_attention_colbias_plain`` and to vdn's ``flash_attention_colbias``
at the bank's masks of 1, 3 and 6 written slots of 6 and at (90, 257),
and walking every tile instead of the live ones changes no bit.

C3 (``flash_attention_qkv``) is the same kernel in its kC3 form, on the
same items: q is not scaled, S = q K^T in fp32, the running max m in S's
units, alpha = exp2((m_old - m) c) and p = exp2(S c - m c) with c =
scale * log2 e in fp32 (vdn's exp(s - m) with s = S * scale), the row
sum l of the unrounded p kept in registers, O += bf16(p) V, out = O / l,
written [B, H, T, D].  Its replay is held to ``flash_attention_qkv_plain``
and to vdn's ``flash_attention_qkv`` at the same T.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdn.ops.pallas import flash_attention as jfa
from vdn_torch.kernels import LOG2E
from vdn_torch.kernels import flash_attention as fa

KERNEL_ULPS = 4    # chip_smoke.py: kernel vs plain, bf16 ulps at the scale
WG_ROWS = 64       # q rows of a consumer warpgroup
SMS = 132          # an H100 SXM


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def walk(b: int, t: int, h: int, sms: int) -> list:
    """The (frame, head, q tile) of each item, per persistent block in its
    order, as the kernel decodes them: item i is q tile i % n, head (i //
    n) % h, frame i // (n h); block k takes i = k, k + grid, ..."""
    plan = fa.a1_plan(b, t, h, sms)
    n = -(-t // fa.A1_ROWS)
    return [[(i // (n * h), (i // n) % h, i % n)
             for i in range(k, plan["items"], plan["grid"])]
            for k in range(plan["grid"])]


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, T, H, D] with rows past T as zeros up to a multiple of ``rows``
    (as TMA loads the tiles)."""
    b, t, h, d = x.shape
    return torch.cat([x, x.new_zeros((b, -(-t // rows) * rows - t, h, d))],
                     1)


def replay_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale=None):
    """(out [B, Tq, H, D], lse [B, H, Tq]) by the kernel's items, tiles and
    order: A1 (q, k, v off the fused qkv, Tq = Tk) and C2 (kBthd)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    rows = fa.A1_ROWS
    qs = _pad(q * fa._qscale(q, scale), rows).float()
    k, v = _pad(k, rows).float(), _pad(v, rows).float()
    out = torch.full(qs.shape, math.nan)
    lse = torch.full((b, h, qs.shape[1]), math.nan)
    for block in walk(b, tq, h, SMS):
        for bi, hi, qt in block:
            for w in range(rows // WG_ROWS):
                r = slice(qt * rows + w * WG_ROWS,
                          qt * rows + (w + 1) * WG_ROWS)
                qw = qs[bi, r, hi]
                o = torch.zeros((WG_ROWS, d))
                m = torch.full((WG_ROWS,), -math.inf)
                l = torch.zeros((WG_ROWS,))
                for k0 in range(0, k.shape[1], rows):
                    s = qw @ k[bi, k0:k0 + rows, hi].t()
                    s[:, torch.arange(k0, k0 + rows) >= tk] = -math.inf
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2(m - m_new)
                    o, l, m = o * alpha[:, None], l * alpha, m_new
                    p = _bf(torch.exp2(s - m[:, None]))
                    l = l + p.sum(1)
                    o = o + p @ v[bi, k0:k0 + rows, hi]
                out[bi, r, hi] = o * (1.0 / l)[:, None]
                lse[bi, hi, r] = m + torch.log2(l)
    return out[:, :tq].to(q.dtype), lse[..., :tq]


def replay_c1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, scale=None, skip: bool = True):
    """C1's out [B, Tq, H, D] by the kernel's items, tiles and order: the
    live key tiles only (``skip``) or every tile."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    rows = fa.A1_ROWS
    qs = _pad(q * fa._qscale(q, scale), rows).float()
    k, v = _pad(k, rows).float(), _pad(v, rows).float()
    bl = torch.full((k.shape[1],), -math.inf)
    bl[:tk] = bias.float() * LOG2E            # fp32, as the producer rounds
    tiles = [j for j in range(k.shape[1] // rows)
             if not skip or (bias[j * rows:(j + 1) * rows] > -math.inf).any()]
    out = torch.full(qs.shape, math.nan)
    for block in walk(b, tq, h, SMS):
        for bi, hi, qt in block:
            for w in range(rows // WG_ROWS):
                r = slice(qt * rows + w * WG_ROWS,
                          qt * rows + (w + 1) * WG_ROWS)
                o = torch.zeros((WG_ROWS, d))
                m = torch.full((WG_ROWS,), -math.inf)
                l = torch.zeros((WG_ROWS,))
                for j in tiles:
                    k0 = j * rows
                    s = qs[bi, r, hi] @ k[bi, k0:k0 + rows, hi].t()
                    s = s + bl[k0:k0 + rows]
                    s[:, torch.arange(k0, k0 + rows) >= tk] = -math.inf
                    m_new = torch.maximum(m, s.amax(1))
                    none = m_new == -math.inf
                    alpha = torch.where(none, 1.0, torch.exp2(m - m_new))
                    m_use = torch.where(none, 0.0, m_new)
                    o, l, m = o * alpha[:, None], l * alpha, m_new
                    p = _bf(torch.exp2(s - m_use[:, None]))
                    l = l + p.sum(1)
                    o = o + p @ v[bi, k0:k0 + rows, hi]
                out[bi, r, hi] = o * (1.0 / l)[:, None]
    return out[:, :tq].to(q.dtype)


def replay(qkv: torch.Tensor, scale=None):
    """A1: (out [B, T, H, D], lse [B, H, T]) by the kernel's items, tiles
    and order."""
    return replay_bthd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], scale)


def replay_c3(qkv: torch.Tensor, scale=None) -> torch.Tensor:
    """C3's out [B, H, T, D] by the kernel's items, tiles and order."""
    b, t, _, h, d = qkv.shape
    scale = d ** -0.5 if scale is None else scale
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    rows = fa.A1_ROWS
    tp = -(-t // rows) * rows
    pad = lambda x: torch.cat([x, x.new_zeros((b, tp - t, h, d))], 1)
    q, k, v = (pad(qkv[:, :, i]).float() for i in range(3))
    out = torch.full((b, h, tp, d), math.nan)
    for block in walk(b, t, h, SMS):
        for bi, hi, qt in block:
            for w in range(rows // WG_ROWS):
                r = slice(qt * rows + w * WG_ROWS,
                          qt * rows + (w + 1) * WG_ROWS)
                o = torch.zeros((WG_ROWS, d))
                m = torch.full((WG_ROWS,), -math.inf)
                l = torch.zeros((WG_ROWS,))
                for k0 in range(0, tp, rows):
                    s = q[bi, r, hi] @ k[bi, k0:k0 + rows, hi].t()
                    s[:, torch.arange(k0, k0 + rows) >= t] = -math.inf
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2((m - m_new) * c)
                    o, l, m = o * alpha[:, None], l * alpha, m_new
                    p = torch.exp2(s * c - (m * c)[:, None])
                    l = l + p.sum(1)                  # the unrounded p
                    o = o + _bf(p) @ v[bi, k0:k0 + rows, hi]
                out[bi, hi, r] = o / l[:, None]
    return out[:, :, :t].to(qkv.dtype)


def _close(got: torch.Tensor, want, what: str) -> None:
    if isinstance(want, torch.Tensor):
        want = want.float()
    g, w = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = w.abs().max().item()
    err = (g - w).abs().max().item()
    assert err <= KERNEL_ULPS * bf16_ulp(scale), (what, err, scale)


def _qkv(t: int, seed: int, h: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, t, 3, h, 64)).astype(np.float32)


@pytest.mark.parametrize("b,t,h", [(22, 1370, 16), (32, 1370, 16),
                                   (1, 1370, 16), (1, 37 * 49 + 1, 16),
                                   (22, 1370, 24), (22, 1370, 6),
                                   (22, 1370, 12), (16, 1370, 16),
                                   (1, 1369, 16), (1, 37 * 49, 16)])
def test_plan_covers_every_item_once(b, t, h):
    """The persistent blocks' walk takes every (frame, head, q tile) of
    the main path's shapes exactly once, with no more blocks than SMs
    (C2: the memory block's Tq 1369 and 1813 at one frame)."""
    plan = fa.a1_plan(b, t, h, SMS)
    n = -(-t // fa.A1_ROWS)
    assert plan["items"] == b * h * n
    assert plan["grid"] == min(plan["items"], SMS)
    seen = [x for block in walk(b, t, h, SMS) for x in block]
    assert len(seen) == len(set(seen)) == plan["items"]


@pytest.mark.parametrize("t", [90, 257, 1370])
def test_replay_matches_plain(t):
    """The replayed schedule within KERNEL_ULPS bf16 ulps of the plain
    version, out and lse, at each one's scale."""
    qkv = torch.from_numpy(_qkv(t, t)).to(torch.bfloat16)
    out, lse = replay(qkv)
    want_out, want_lse = fa.flash_attention_fused_qkv_lse_plain(qkv)
    _close(out, want_out, "out")
    _close(lse, want_lse, "lse")


@pytest.mark.parametrize("t", [90, 257])
def test_replay_matches_vdn(t):
    """The replay against vdn's flash_attention_fused_qkv and its training
    forward's lse ([B, n_colblocks, hb, T] -> [B, H, T]), Pallas in
    interpret mode."""
    a = _qkv(t, t + 1)
    qkv = torch.from_numpy(a).to(torch.bfloat16)
    jq = jnp.asarray(a, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want_out = jfa.flash_attention_fused_qkv(jq, None, 64)
        _, want_lse = jfa._flash_cols_call(jq, 64 ** -0.5, 64, 2,
                                           save_lse=True)
    out, lse = replay(qkv)
    _close(out, want_out, "out")
    _close(lse, np.asarray(want_lse).reshape(1, 2, t), "lse")


@pytest.mark.parametrize("t", [90, 257, 1370])
def test_c3_replay_matches_plain_and_vdn(t):
    """C3's replayed schedule within KERNEL_ULPS bf16 ulps of
    flash_attention_qkv_plain and of vdn's flash_attention_qkv (Pallas in
    interpret mode), [B, H, T, D]."""
    a = _qkv(t, t + 2)
    qkv = torch.from_numpy(a).to(torch.bfloat16)
    out = replay_c3(qkv)
    _close(out, fa.flash_attention_qkv_plain(qkv), "plain")
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_qkv(jnp.asarray(a, jnp.bfloat16),
                                       block_q=128)
    _close(out, want, "vdn")


def _bthd(tq: int, tk: int, seed: int, h: int = 2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, t, h, 64)).astype(np.float32)
            for t in (tq, tk, tk)]


@pytest.mark.parametrize("tq,tk", [(1369, 1369), (1813, 1813), (90, 257)])
def test_c2_replay_matches_plain_and_vdn(tq, tk):
    """C2's replayed schedule (A1's kernel in its kBthd form: separate q,
    k, v, the q tiles over Tq and the keys over Tk) within KERNEL_ULPS
    bf16 ulps of flash_attention_plain and of vdn's flash_attention
    (Pallas in interpret mode), [B, Tq, H, D]."""
    a = _bthd(tq, tk, tq + tk)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in a)
    out, _ = replay_bthd(q, k, v)
    _close(out, fa.flash_attention_plain(q, k, v), "plain")
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                     for x in a))
    _close(out, want, "vdn")


@pytest.mark.parametrize("tq,tk,dead", [(90, 540, 450), (90, 540, 270),
                                         (90, 540, 0), (90, 257, 140)])
def test_c1_replay_matches_plain_and_vdn(tq, tk, dead):
    """C1's replayed schedule (A1's kernel in its kC1 form: kBthd with a
    bias per key column, and the all -inf key tiles skipped) within
    KERNEL_ULPS bf16 ulps of flash_attention_colbias_plain and of vdn's
    flash_attention_colbias (Pallas in interpret mode), at the bank's slot
    masks (6 slots of Tq keys, -inf over the leading empty ones: 1, 3 and 6
    written) and at (Tq, Tk) = (90, 257) with its first 140 keys masked (a
    dead tile, a partly dead one, a tail of one key); walking every key
    tile gives the same bits."""
    rng = np.random.default_rng(tq + tk + dead)
    a = [rng.standard_normal((1, t, 2, 64)).astype(np.float32)
         for t in (tq, tk, tk)]
    bias = np.zeros(tk, np.float32)
    bias[:dead] = -np.inf
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in a)
    tb = torch.from_numpy(bias)
    out = replay_c1(q, k, v, tb)
    assert torch.equal(out, replay_c1(q, k, v, tb, skip=False))
    _close(out, fa.flash_attention_colbias_plain(q, k, v, tb), "plain")
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_colbias(
            *(jnp.asarray(x, jnp.bfloat16) for x in a), jnp.asarray(bias))
    _close(out, want, "vdn")
