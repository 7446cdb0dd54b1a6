"""F1's and F2's host-side plan (vdn_torch/kernels/int8.py ``linear_plan``
at N = F) and the per-tile arithmetic of their wgmma + TMA kernel
(csrc/int8_linear.cu on csrc/int8_wgmma.cuh and csrc/int8_tail.cuh), on
the CPU.

The kernel needs the card; what the wrapper computes in Python, the
persistent grid over 128 x int8.LINEAR_BN tiles of the qkv projection's
N = 3C, is held here at the main path's row counts (a streamed frame,
1,370; the 480 x 640 image, 1,814; the cached window, 22 x 1,370; the full
window, 32 x 1,370) and every model's C (384, 768, 1024, 1536): the
persistent blocks' walk covers every output tile once, with a block a tile
up to the card's SMs.  F2's wrapper refuses a width the tile does not
take.

Then plain torch replays the kernel's two launches in its order: the row
kernel (F1: vdn's fp32 LayerNorm; F2: none; then s = max(amax / 127,
1e-30), q = round_half_even(y * (1 / s))), then tile by tile the product
in one K chunk (exact int32 sums, (acc * sx) * sw) and the bias epilogue
bf16(v + b).  Output and int8 operands must equal the plain versions' bit
for bit, and the plain versions stay vdn's Pallas functions' (interpret
mode) at two widths: int8 operands equal but at quantization ties, the
output within 4 bf16 ulps outside the tie rows.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_f3_plan import ROWS, SMS, covers_once, tiles_of
from vdn.ops.pallas import int8 as jint8
from vdn_torch.kernels import int8, layer_norm_f32

KERNEL_ULPS = 4    # chip_smoke.py: kernel vs plain, bf16 ulps at the scale


@pytest.mark.parametrize("c", [384, 768, 1024, 1536])
@pytest.mark.parametrize("path", sorted(ROWS))
def test_plan_covers_and_fits(path, c):
    """The qkv projection's tiles (N = 3C), walked by the plan's persistent
    blocks, cover every output once, with a block a tile up to the SMs."""
    m, n = ROWS[path], 3 * c
    plan = int8.linear_plan(m, n, SMS)
    assert set(plan) == {"grid"} and n % int8.LINEAR_BN == 0
    assert plan["grid"] == min(-(-m // int8.WG_ROWS) * (n // int8.LINEAR_BN),
                               SMS)
    assert covers_once(m, n, int8.LINEAR_BN, plan["grid"])


@pytest.mark.parametrize("f", [200, 3 * 384 + 64])
def test_wrapper_refuses_untiled_width(monkeypatch, f):
    """F2 (and F1) on the card raise on an N the 128-wide tile does not
    take, before any launch."""
    monkeypatch.setattr(int8, "use_kernel", lambda x: True)
    x = torch.zeros((4, 384), dtype=torch.bfloat16)
    w = torch.ones((f, 384))
    with pytest.raises(ValueError, match="multiple of 128"):
        int8.int8_linear(x, w)
    with pytest.raises(ValueError, match="multiple of 128"):
        int8.int8_ln_linear(x, torch.ones(384), torch.zeros(384), w,
                            torch.zeros(f))


def replay(x, ln, w, b, plan):
    """F1's (``ln`` = (weight, bias)) or F2's two launches: the row
    kernel, then the one-chunk product and its bias epilogue tile by tile
    in the persistent blocks' order.  Returns the output and the int8 rows
    and their scales."""
    wq, sw = int8.quantize_weight_cols(w)
    m, c = x.shape
    f = wq.shape[0]
    y = layer_norm_f32(x, *ln, 1e-6) if ln is not None else x.float()
    s = torch.clamp_min(y.abs().amax(1) / torch.tensor(127.0), 1e-30)
    xq = torch.round(y * torch.reciprocal(s)[:, None]).to(torch.int8)
    out = torch.full((m, f), float("nan"), dtype=x.dtype)
    for tiles in tiles_of(m, f, int8.LINEAR_BN, plan["grid"]):
        for r0, c0 in tiles:
            rows = slice(r0, min(r0 + int8.WG_ROWS, m))
            cols = slice(c0, c0 + int8.LINEAR_BN)
            acc = (xq[rows].double() @ wq[cols].double().t()).float()
            v = acc * s[rows, None] * sw[cols]
            out[rows, cols] = (v + b[cols]).to(x.dtype)
    return out, xq, s[:, None]


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale
                             ).astype(np.float32))


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("m,c,sms", [(300, 384, 5), (128, 256, 3),
                                     (1370, 128, 132)])
def test_replay_is_the_plain_version(m, c, sms, ln):
    """F1's and F2's stages replayed over their tiles equal the plain
    versions bit for bit, output and operands (bf16, N = 3C; 300 rows: a
    partial last row tile; 1,370 rows on 132 SMs: a streamed frame's tile
    count at its narrowest)."""
    rng = np.random.default_rng(m + c + ln)
    x = _t(rng, m, c).to(torch.bfloat16)
    w, b = _t(rng, 3 * c, c, scale=c ** -0.5), _t(rng, 3 * c, scale=0.1)
    lnp = (_t(rng, c, scale=0.1) + 1.0, _t(rng, c, scale=0.1)) if ln \
        else None
    got, xq, sx = replay(x, lnp, w, b, int8.linear_plan(m, 3 * c, sms))
    ops = {}
    want = (int8.int8_ln_linear_plain(x, *lnp, w, b, operands=ops) if ln
            else int8.int8_linear_plain(x, w, b, operands=ops))
    assert torch.equal(got, want)
    assert torch.equal(xq, ops["xq"]) and torch.equal(sx, ops["sx"])


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("c", [384, 768])
def test_plain_matches_vdn(c, ln):
    """int8_ln_linear_plain / int8_linear_plain against vdn's Pallas
    int8_ln_linear / int8_linear in interpret mode (bf16, 2 x 150 rows,
    N = 3C): the int8 rows equal but at ties (<= 0.1%, by one), the output
    within KERNEL_ULPS bf16 ulps of vdn's scale outside the tie rows."""
    rng = np.random.default_rng(c + ln)
    f = 3 * c
    x = rng.standard_normal((2, 150, c)).astype(np.float32)
    w = (rng.standard_normal((c, f)) / math.sqrt(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(f)).astype(np.float32)
    ls = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w.T.copy())
    with pltpu.force_tpu_interpret_mode():
        if ln:
            want = jint8.int8_ln_linear(jx, jnp.asarray(ls), jnp.asarray(lb),
                                        jnp.asarray(w), jnp.asarray(b))
        else:
            want = jint8.int8_linear(jx, jnp.asarray(w), jnp.asarray(b))
    ops = {}
    if ln:
        got = int8.int8_ln_linear_plain(tx, torch.from_numpy(ls),
                                        torch.from_numpy(lb), tw,
                                        torch.from_numpy(b), operands=ops)
    else:
        got = int8.int8_linear_plain(tx, tw, torch.from_numpy(b),
                                     operands=ops)
    xf = jnp.asarray(jx, jnp.float32).reshape(-1, c)
    if ln:
        xf = jint8._ln_f32(xf, jnp.asarray(ls), jnp.asarray(lb), 1e-6)
    jq = np.asarray(jint8._quantize_rows_f32(xf)[0], np.int32)
    d = np.abs(ops["xq"].numpy().astype(np.int32) - jq)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    keep = ~(d > 0).any(1)
    g = got.float().numpy().reshape(-1, f)
    wnt = np.asarray(jnp.asarray(want, jnp.float32)).reshape(-1, f)
    scale = float(np.abs(wnt).max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert got.shape == want.shape
    assert np.abs(g[keep] - wnt[keep]).max() <= KERNEL_ULPS * ulp
