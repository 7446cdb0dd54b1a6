"""D1's schedule on the card (csrc/flash_attn_qkv_bwd.cu), replayed in
plain torch on the CPU and held to ``flash_attention_fused_qkv_bwd_plain``.

The kernel needs the card; what its design changes is the order and the
tiling of the sums, which plain torch can replay: the pre-pass (qs =
bf16(q * bf16(scale * log2 e)) once, delta = rowsum(dO * O) in fp32, lse
and delta padded to a multiple of ``D1_ROWS`` rows with +inf and 0), the
dK / dV blocks of 128 keys (two 64-key halves) over 64-row q tiles whose
rows past T are zeros, and the dQ blocks of 128 q rows summing dS K over
64-key tiles in key order, the keys past T of the last tile masked; P and
dS rounded to bf16 where they feed a product.  At a ragged T (90: one
block, the second q tile and key half partial; 257: three blocks, the last
nearly empty) the replay must sit within chip_smoke.py's D1 tolerance
(KERNEL_ULPS bf16 ulps at each output's scale) of the plain version.
D1's tests against vdn's Pallas backward stay in
tests/test_torch_kernels.py.
"""

import math

import numpy as np
import pytest
import torch

from vdn_torch.kernels import flash_attention as fa

KERNEL_ULPS = 4    # chip_smoke.py: kernel vs plain, bf16 ulps at the scale
ROWS, KEYS = 64, 64  # the kernel's q and key tiles


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def replay(qkv, out, lse, dout, scale=None):
    """dqkv [B, T, 3, H, 64] by the kernel's tiles and order."""
    b, t, _, h, d = qkv.shape
    scale = d ** -0.5 if scale is None else scale
    tp = -(-t // fa.D1_ROWS) * fa.D1_ROWS
    # the pre-pass, padded to tp rows: q, qs, dO zero; lse +inf, delta 0
    pad = lambda x: torch.cat([x, x.new_zeros((b, tp - t, h, d))], 1)
    q, k, v = (pad(qkv[:, :, i]).float() for i in range(3))
    qs = pad((qkv[:, :, 0] * fa._qscale(qkv, scale))).float()
    g = pad(dout).float()
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    delta = torch.cat([delta, delta.new_zeros((b, h, tp - t))], -1)
    lse2 = torch.cat([lse, lse.new_full((b, h, tp - t), math.inf)], -1)
    dq, dk, dv = (torch.zeros((b, tp, h, d)) for _ in range(3))
    for bi in range(b):
        for hi in range(h):
            sel = (bi, slice(None), hi)
            # dK / dV: each 64-key half of a 128-key block over the q tiles
            for k0 in range(0, tp, KEYS):
                kk, vv = k[sel][k0:k0 + KEYS], v[sel][k0:k0 + KEYS]
                adk, adv = torch.zeros((KEYS, d)), torch.zeros((KEYS, d))
                for q0 in range(0, tp, ROWS):
                    r = slice(q0, q0 + ROWS)
                    st = kk @ qs[sel][r].t()                 # S^T
                    dpt = vv @ g[sel][r].t()                 # dP^T
                    pt = torch.exp2(st - lse2[bi, hi, r])
                    adv += _bf(pt) @ g[sel][r]
                    dst = pt * (dpt - delta[bi, hi, r])
                    adk += _bf(dst) @ q[sel][r]
                dk[bi, k0:k0 + KEYS, hi] = adk * scale
                dv[bi, k0:k0 + KEYS, hi] = adv
            # dQ: each 128-row block over the 64-key tiles in key order
            for q0 in range(0, tp, fa.D1_ROWS):
                r = slice(q0, q0 + fa.D1_ROWS)
                acc = torch.zeros((fa.D1_ROWS, d))
                for k0 in range(0, tp, KEYS):
                    kt = k[sel][k0:k0 + KEYS]
                    s = qs[sel][r] @ kt.t()
                    dp = g[sel][r] @ v[sel][k0:k0 + KEYS].t()
                    p = torch.exp2(s - lse2[bi, hi, r, None])
                    p[:, torch.arange(k0, k0 + KEYS) >= t] = 0.0
                    ds = p * (dp - delta[bi, hi, r, None])
                    acc += _bf(ds) @ kt
                dq[bi, r, hi] = acc * scale
    dt = qkv.dtype
    return torch.stack([x[:, :t].to(dt) for x in (dq, dk, dv)], dim=2)


@pytest.mark.parametrize("t", [90, 257])
def test_tiled_schedule_matches_plain(t):
    """The replayed schedule within KERNEL_ULPS bf16 ulps of the plain
    version at each of dQ, dK and dV's scale; the rows past T and the
    masked keys change nothing."""
    rng = np.random.default_rng(t)
    b, h, d = 1, 2, 64
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, d)).astype(
        np.float32)).to(torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(torch.bfloat16)
    out, lse = fa.flash_attention_fused_qkv_lse_plain(qkv)
    got = replay(qkv, out, lse, dout)
    want = fa.flash_attention_fused_qkv_bwd_plain(qkv, out, lse, dout)
    assert got.shape == want.shape
    for i, name in enumerate(("dq", "dk", "dv")):
        g, w = got[:, :, i].float(), want[:, :, i].float()
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= KERNEL_ULPS * bf16_ulp(scale), (name, err, scale)
