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


def replay(qkv: torch.Tensor, scale=None):
    """(out [B, T, H, D], lse [B, H, T]) by the kernel's items, tiles and
    order."""
    b, t, _, h, d = qkv.shape
    scale = d ** -0.5 if scale is None else scale
    rows = fa.A1_ROWS
    tp = -(-t // rows) * rows
    # as TMA loads the tiles: rows and keys past T are zeros
    pad = lambda x: torch.cat([x, x.new_zeros((b, tp - t, h, d))], 1)
    qs = pad(qkv[:, :, 0] * fa._qscale(qkv, scale)).float()
    k, v = pad(qkv[:, :, 1]).float(), pad(qkv[:, :, 2]).float()
    out = torch.full((b, tp, h, d), math.nan)
    lse = torch.full((b, h, tp), math.nan)
    for block in walk(b, t, h, SMS):
        for bi, hi, qt in block:
            for w in range(rows // WG_ROWS):
                r = slice(qt * rows + w * WG_ROWS,
                          qt * rows + (w + 1) * WG_ROWS)
                q = qs[bi, r, hi]
                o = torch.zeros((WG_ROWS, d))
                m = torch.full((WG_ROWS,), -math.inf)
                l = torch.zeros((WG_ROWS,))
                for k0 in range(0, tp, rows):
                    s = q @ k[bi, k0:k0 + rows, hi].t()
                    s[:, torch.arange(k0, k0 + rows) >= t] = -math.inf
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2(m - m_new)
                    o, l, m = o * alpha[:, None], l * alpha, m_new
                    p = _bf(torch.exp2(s - m[:, None]))
                    l = l + p.sum(1)
                    o = o + p @ v[bi, k0:k0 + rows, hi]
                out[bi, r, hi] = o * (1.0 / l)[:, None]
                lse[bi, hi, r] = m + torch.log2(l)
    return out[:, :t].to(qkv.dtype), lse[..., :t]


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
                                   (22, 1370, 12), (16, 1370, 16)])
def test_plan_covers_every_item_once(b, t, h):
    """The persistent blocks' walk takes every (frame, head, q tile) of
    the main path's shapes exactly once, with no more blocks than SMs."""
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
