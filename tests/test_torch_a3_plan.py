"""A3's and D4's host-side plan (vdn_torch/kernels/temporal_attention.py
``temporal_plan``) and the stage order of their kernels (csrc/
temporal_attn.cu, temporal_attn_bwd.cu, temporal_attn.cuh), on the CPU.

The kernels need the card.  What the wrappers compute in Python is held
here: each product's persistent grid over the bf16 wgmma core's 128 x 128
tiles, and the T x T core's blocks of ``core_warps`` warps over the (token,
head) items, at vitl's and vitg's motion widths over a 32-frame window and
the training step's T 8, and on a card with more SMs than tiles; the
walks cover every tile and every item exactly once.

Then plain torch replays the stages in the kernels' order: the + pe row
pass, the qkv product (sums rounded to bf16), the core item by item in
its fragments' order -- S over dh in 16-wide k steps, fp32 softmax over
the keys < T of the 16 KT padded columns, bf16 probabilities against v
over 16-key steps (D4: dP beside S, delta, ds, then dv over 16-query
steps, dq over 16-key steps, dk over 16-query steps) -- and the out (D4:
doh, dx) products.  The replay holds the plain versions to 4 bf16 ulps
(bf16 outputs) and 1e-5 of scale (the fp32 probabilities), and vdn's
Pallas kernels in interpret mode to 4 bf16 ulps at bn 9-37, C 256, T 8
and 32.  Last, D4's wrapper hands the launch the weights as stored.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdn.ops.pallas import temporal_attention as jta
from vdn_torch.kernels import linear_f32acc
from vdn_torch.kernels import temporal_attention as ta
from vdn_torch.kernels.mlp import BN, WG_ROWS

torch.set_num_threads(2)

SMS = 132          # an H100 SXM
BF = torch.bfloat16
# (tokens, C) of the four motion modules at 518 px
MOTION = {"vitl": [(1369, 1024), (361, 1024), (1369, 256), (5476, 256)],
          "vitg": [(1369, 1536), (361, 1536), (1369, 384), (5476, 384)]}


def product_hits(m: int, n: int, grid: int) -> np.ndarray:
    """How often each 128 x 128 tile of [m, n] is in a warpgroup's walk:
    block b's two consumer warpgroups take tiles b + w grid, b + 3 grid,
    ... (csrc/bf16_wgmma.cuh, ping-pong)."""
    nt = n // BN
    tiles = -(-m // WG_ROWS) * nt
    hits = np.zeros(tiles, np.int32)
    for b in range(grid):
        for w in range(2):
            for t in range(b + w * grid, tiles, 2 * grid):
                hits[t] += 1
    return hits


def core_hits(items: int, grid: int, warps: int) -> np.ndarray:
    """How often each (token, head) item is in a warp's walk: warp w of
    block b takes items b warps + w, + grid warps, ..."""
    hits = np.zeros(items, np.int32)
    for b in range(grid):
        for w in range(warps):
            hits[b * warps + w::grid * warps] += 1
    return hits


@pytest.mark.parametrize("sms", [SMS, 10 ** 4])
@pytest.mark.parametrize("t", [32, 8])
@pytest.mark.parametrize("encoder", sorted(MOTION))
def test_plan_covers_and_fits(encoder, t, sms):
    """Every product's tiles and every core item once; no launch asks for
    more blocks than SMs, tiles or items a warp (D4 at the training
    widths, dh 128 and 32)."""
    for tokens, c in MOTION[encoder]:
        m = tokens * t
        mt = -(-m // WG_ROWS)
        backs = (False, True) if c // 8 in ta.BACKWARD_HEAD_DIMS else (False,)
        for backward in backs:
            plan = ta.temporal_plan(m, c, sms, t, 8, backward)
            for n, grid in ((3 * c, plan["grid_qkv"]), (c, plan["grid_c"])):
                assert grid == min(mt * (n // BN), sms)
                assert (product_hits(m, n, grid) == 1).all()
            warps = ta.core_warps(c // 8, t, backward)
            items = tokens * 8
            assert plan["grid_core"] == min(-(-items // warps), sms)
            assert (core_hits(items, plan["grid_core"], warps) == 1).all()


def test_core_warps_fit():
    """A core block's warps fit an H100 block's shared memory: 8 at T 32
    up to dh 64 (16 at T <= 16 up to dh 48), fewer at the wide heads."""
    assert [ta.core_warps(d, 32) for d in ta.FORWARD_HEAD_DIMS] == \
        [8, 8, 8, 4, 3]
    assert [ta.core_warps(d, 8, True) for d in ta.BACKWARD_HEAD_DIMS] == \
        [16, 11, 6]
    for d in ta.FORWARD_HEAD_DIMS:
        for t in (1, 8, 16, 17, 32):
            rows = 16 if t <= 16 else 32
            per_warp = ta.CORE_STAGES * 3 * rows * (d + 8) * 2
            assert 1 <= ta.core_warps(d, t) * per_warp <= ta.SMEM_MAX


def _inputs(seed, bn, t, c, with_g=False):
    rng = np.random.default_rng(seed)
    r = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)
    a = dict(x=r(bn, t, c), pe=r(t, c, k=0.5),
             w=[r(c, c, k=c ** -0.5) for _ in range(4)], bo=r(c, k=0.1))
    if with_g:
        a["g"] = r(bn, t, c)
    return a


def _torch(a):
    x = torch.from_numpy(a["x"]).to(BF)
    return (x, torch.from_numpy(a["pe"]), *map(torch.from_numpy, a["w"]),
            torch.from_numpy(a["bo"]))


def _heads(y, bn, t, heads, kt, n=1):
    """y [bn t, n c] -> n tensors [bn, heads, 16 kt, dh] fp32, rows past t
    zero (the core's slots)."""
    dh = y.shape[-1] // (n * heads)
    out = y.float().reshape(bn, t, n, heads, dh).permute(2, 0, 3, 1, 4)
    pad = torch.zeros(n, bn, heads, 16 * kt, dh)
    pad[:, :, :, :t] = out
    return pad.unbind(0)


def _k_steps(a, b, steps, width):
    """sum over k steps of ``width`` of a[..., step] @ b[step, ...] in
    fp32, in step order (mma.sync's k steps)."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for kk in range(steps):
        sl = slice(width * kk, width * (kk + 1))
        acc = acc + a[..., sl] @ b[..., sl, :]
    return acc


def _softmax(s, t, scale):
    """The core's fp32 softmax over the keys < t of the padded columns."""
    s = s * scale
    s[..., t:] = -math.inf
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def replay_forward(x, pe, wq, wk, wv, wo, bo, heads, scale):
    """A3's four launches in order (bf16)."""
    bn, t, c = x.shape
    dh, kt = c // heads, -(-t // 16)
    xp = (x.float() + pe[:t].to(BF).float()).to(BF)            # rows
    wqkv = torch.cat([wq, wk, wv]).to(BF)
    qkv = linear_f32acc(xp.reshape(-1, c), wqkv)                # qkv
    q, k, v = _heads(qkv, bn, t, heads, kt, 3)                  # core
    s = _k_steps(q, k.transpose(-1, -2), dh // 16, 16)
    p = _softmax(s, t, scale).to(BF).float()
    o = _k_steps(p, v, kt, 16)[:, :, :t].to(BF)
    pv = o.permute(0, 2, 1, 3).reshape(bn * t, c)
    out = (linear_f32acc(pv, wo).float() + bo.to(BF).float()).to(BF)  # out
    return out.reshape(bn, t, c), _softmax(s, t, scale)[:, :, :t, :t]


def replay_backward(x, pe, g, wq, wk, wv, wo, heads, scale):
    """D4's five launches in order (bf16)."""
    bn, t, c = x.shape
    dh, kt = c // heads, -(-t // 16)
    xp = (x.float() + pe[:t].to(BF).float()).to(BF)             # rows
    wqkv = torch.cat([wq, wk, wv]).to(BF)
    qkv = linear_f32acc(xp.reshape(-1, c), wqkv)                # qkv
    doh = torch.matmul(g.reshape(-1, c).float(),                # doh
                       wo.to(BF).float()).to(BF)
    q, k, v = _heads(qkv, bn, t, heads, kt, 3)                  # core
    (gd,) = _heads(doh, bn, t, heads, kt)
    s = _k_steps(q, k.transpose(-1, -2), dh // 16, 16)
    dp = _k_steps(gd, v.transpose(-1, -2), dh // 16, 16)
    p = _softmax(s, t, scale)
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(BF).float()
    pd = p.to(BF).float()
    dv = _k_steps(pd.transpose(-1, -2), gd, kt, 16).to(BF)
    dq = _k_steps(ds, k, kt, 16).to(BF)
    dk = _k_steps(ds.transpose(-1, -2), q, kt, 16).to(BF)
    dqkv = torch.stack([dq, dk, dv])[:, :, :, :t]               # [3, bn, h, t, dh]
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(bn * t, 3 * c)
    dx = torch.matmul(dqkv.float(), wqkv.float()).to(BF)        # dx
    return dx.reshape(bn, t, c)


def _ulps(got, want, ulps=4):
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.asarray(want, np.float32)))
    got = got.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= ulps * 2.0 ** (math.floor(math.log2(scale)) - 7), \
        (err, scale)


@pytest.mark.parametrize("bn,t,c,heads", [
    (37, 32, 256, 8),    # vitl's mm2 / mm3 width (dh 32)
    (9, 32, 1024, 8),    # mm0 / mm1 (dh 128)
    (20, 8, 256, 8),     # the training step's T
    (9, 20, 384, 8),     # vitg's dh 48; 20 frames of 32 padded rows
    (6, 32, 1536, 8),    # vitg's dh 192
    (12, 1, 512, 8),     # a streamed frame, dh 64
])
def test_forward_replay_is_the_plain_version(bn, t, c, heads):
    """A3's stages replayed equal the plain version within 4 bf16 ulps; the
    core's fp32 probabilities within 1e-5 of the plain softmax."""
    a = _inputs(bn + t + c, bn, t, c)
    args = _torch(a)
    scale = (c // heads) ** -0.5
    got, p = replay_forward(*args, heads, scale)
    _ulps(got, ta.temporal_attention_block_plain(*args, heads, scale))
    # the plain softmax on the same q, k (the stacked product's)
    x, pe, wq, wk, wv = args[:5]
    qkv = linear_f32acc((x + pe.to(BF)).reshape(-1, c),
                        torch.cat([wq, wk, wv]))
    q, k, _ = qkv.float().reshape(bn, t, 3, heads, c // heads).unbind(2)
    want = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, -1)
    assert (p - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("bn,t,c,heads", [
    (37, 8, 256, 8), (9, 32, 1024, 8), (11, 20, 512, 8)])
def test_backward_replay_is_the_plain_version(bn, t, c, heads):
    """D4's stages replayed equal the plain version within 4 bf16 ulps."""
    a = _inputs(bn + t + c, bn, t, c, with_g=True)
    x, pe, *w, _ = _torch(a)
    g = torch.from_numpy(a["g"]).to(BF)
    scale = (c // heads) ** -0.5
    _ulps(replay_backward(x, pe, g, *w, heads, scale),
          ta.temporal_attention_bwd_dx_plain(x, pe, g, *w, heads, scale))


@pytest.mark.parametrize("bn,t", [(37, 32), (9, 8)])
def test_replay_matches_vdn(bn, t):
    """The replays against vdn's temporal_attention_block and
    _fused_bwd_dx_impl, Pallas in interpret mode, bf16, C 256."""
    c, heads = 256, 8
    a = _inputs(bn * t, bn, t, c, with_g=True)
    scale = (c // heads) ** -0.5
    jx = jnp.asarray(a["x"], jnp.bfloat16)
    jw = [jnp.asarray(w) for w in a["w"]]
    with pltpu.force_tpu_interpret_mode():
        want = jta.temporal_attention_block(
            jx, jnp.asarray(a["pe"]), *jw, jnp.asarray(a["bo"]), heads,
            scale)
        want_dx = jta._fused_bwd_dx_impl(
            jx, jnp.asarray(a["pe"]), jnp.asarray(a["g"], jnp.bfloat16),
            *jw, heads, scale)
    # torch layout: the weights [out, in]
    x = torch.from_numpy(a["x"]).to(BF)
    pe = torch.from_numpy(a["pe"])
    w = [torch.from_numpy(np.ascontiguousarray(m.T)) for m in a["w"]]
    bo = torch.from_numpy(a["bo"])
    g = torch.from_numpy(a["g"]).to(BF)
    _ulps(replay_forward(x, pe, *w, bo, heads, scale)[0], want)
    _ulps(replay_backward(x, pe, g, *w, heads, scale), want_dx)


def test_wrappers_pass_weights_as_stored(monkeypatch):
    """A3's and D4's wrappers, their checks reached as on the card, hand
    the launch the stacked [3C, C] weight and to_out's [C, C] as stored
    (no transposed copy) and the plan's three grids."""
    seen, calls = [], []
    monkeypatch.setattr(ta, "use_kernel", lambda x: True)
    monkeypatch.setattr(ta, "sm_count", lambda index: SMS)
    monkeypatch.setattr(ta, "check_kernel_args",
                        lambda name, *ts: seen.append(ts))
    monkeypatch.setattr(ta, "launch", lambda name, *args: calls.append(
        (name, args)))
    bn, t, c = 5, 8, 256
    a = _inputs(0, bn, t, c, with_g=True)
    x, pe, wq, wk, wv, wo, bo = _torch(a)
    wq, wk, wv, wo = (w.to(BF) for w in (wq, wk, wv, wo))
    g = torch.from_numpy(a["g"]).to(BF)
    ta.temporal_attention_block(x, pe, wq, wk, wv, wo, bo, 8, 0.1)
    ta.temporal_attention_bwd_dx(x, pe, g, wq, wk, wv, wo, 8, 0.1)
    stacked = torch.cat([wq, wk, wv])
    for (name, args), tensors, backward in zip(calls, seen, (False, True)):
        by_ptr = {tt.data_ptr(): tt for tt in tensors}
        at = 7 if backward else 6      # wqkv's slot; wo's follows
        assert torch.equal(by_ptr[args[at]], stacked)
        assert args[at + 1] == wo.data_ptr()
        plan = ta.temporal_plan(bn * t, c, SMS, t, 8, backward)
        assert args[-3:] == (plan["grid_qkv"], plan["grid_c"],
                             plan["grid_core"])
    assert [n for n, _ in calls] == ["vdn_temporal_attention",
                                     "vdn_temporal_attention_bwd"]
