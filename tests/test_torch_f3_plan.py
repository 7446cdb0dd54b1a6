"""F3's host-side plan (vdn_torch/kernels/int8.py ``linear_plan`` at N =
C) and the per-tile arithmetic of its wgmma + TMA kernel
(csrc/int8_linear.cu on csrc/int8_wgmma.cuh and csrc/int8_tail.cuh), on
the CPU.

The kernel needs the card; what the wrapper computes in Python, the
persistent grid by row count over tiles int8.LINEAR_BN wide, is held here
at the main path's row counts (a streamed frame, 1,370; the 480 x 640 image, 1,814;
the cached window, 22 x 1,370; the full window, 32 x 1,370) and every
model's C (384, 768, 1024, 1536): the persistent blocks' walk covers
every output exactly once.

Then plain torch replays the kernel's two launches in its order: the row
quantizer (s = max(amax / 127, 1e-30), q = round_half_even(x * (1 / s)),
no LayerNorm), then tile by tile the product in one K chunk (exact int32
sums, (acc * sx) * sw) and the residual epilogue res + bf16((v + b) *
gamma).  Output and int8 operands must equal
``int8_proj_residual_plain``'s bit for bit.  F3's tests against vdn stay
in tests/test_torch_int8.py.
"""

import numpy as np
import pytest
import torch

from vdn_torch.kernels import int8

SMS = 132          # an H100 SXM
VIT_TOKENS = 1370
ROWS = {"stream": VIT_TOKENS, "image": 37 * 49 + 1,
        "clip": 22 * VIT_TOKENS, "clip_full": 32 * VIT_TOKENS}


def tiles_of(m: int, n: int, bn: int, grid: int) -> list:
    """The (first row, first column) of each tile, per persistent block in
    its order, as csrc/int8_wgmma.cuh walks them: tile t at rows (t / (n /
    bn)) * 128 and columns (t % (n / bn)) * bn; block b takes t = b, b +
    grid, ... (both consumer warpgroups on every tile, 64 rows each)."""
    nt = n // bn
    tiles = -(-m // int8.WG_ROWS) * nt
    return [[((t // nt) * int8.WG_ROWS, (t % nt) * bn)
             for t in range(b, tiles, grid)] for b in range(grid)]


def covers_once(m: int, n: int, bn: int, grid: int) -> bool:
    hits = np.zeros((-(-m // int8.WG_ROWS), n // bn), np.int32)
    blocks = tiles_of(m, n, bn, grid)
    assert len(blocks) == grid
    for tiles in blocks:
        for r, c in tiles:
            hits[r // int8.WG_ROWS, c // bn] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("c", [384, 768, 1024, 1536])
@pytest.mark.parametrize("path", sorted(ROWS))
def test_plan_covers_and_fits(path, c):
    """The product's tiles, walked by the plan's persistent blocks, cover
    every output once, at the width the kernel is built for, with a block
    a tile up to the card's SMs."""
    m = ROWS[path]
    plan = int8.linear_plan(m, c, SMS)
    assert set(plan) == {"grid"} and c % int8.LINEAR_BN == 0
    assert plan["grid"] == min(-(-m // int8.WG_ROWS) * (c // int8.LINEAR_BN),
                               SMS)
    assert covers_once(m, c, int8.LINEAR_BN, plan["grid"])


def test_plan_small_card():
    """A card of 4 SMs and one of more SMs than tiles still cover once."""
    for c in (384, 1024):
        for sms in (4, 10 ** 4):
            plan = int8.linear_plan(300, c, sms)
            assert covers_once(300, c, int8.LINEAR_BN, plan["grid"])


def replay(x, res, w, b, gamma, plan):
    """F3's two launches: the row quantizer, then the one-chunk product and
    its residual epilogue tile by tile in the persistent blocks' order.
    Returns the output and the int8 rows and their scales."""
    wq, sw = int8.quantize_weight_cols(w)
    m, c = x.shape
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(1) / torch.tensor(127.0), 1e-30)
    xq = torch.round(xf * torch.reciprocal(s)[:, None]).to(torch.int8)
    out = torch.full_like(res, float("nan"))
    for tiles in tiles_of(m, c, int8.LINEAR_BN, plan["grid"]):
        for r0, c0 in tiles:
            rows = slice(r0, min(r0 + int8.WG_ROWS, m))
            cols = slice(c0, c0 + int8.LINEAR_BN)
            acc = (xq[rows].double() @ wq[cols].double().t()).float()
            v = acc * s[rows, None] * sw[cols]
            o = ((v + b[cols]) * gamma[cols]).to(x.dtype)
            out[rows, cols] = res[rows, cols] + o
    return out, xq, s[:, None]


@pytest.mark.parametrize("m,c,sms", [(300, 384, 5), (128, 256, 3),
                                     (1370, 128, 132)])
def test_replay_is_the_plain_version(m, c, sms):
    """F3's stages replayed over its tiles equal the plain version bit for
    bit, output and operands (bf16; 300 rows: a partial last row tile;
    1,370 rows on 132 SMs: the streamed frame's tile count)."""
    rng = np.random.default_rng(m + c)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 ).astype(np.float32))

    x, res = t(m, c).to(torch.bfloat16), t(m, c).to(torch.bfloat16)
    w, b, gamma = t(c, c, scale=c ** -0.5), t(c, scale=0.1), t(c, scale=0.5)
    got, xq, sx = replay(x, res, w, b, gamma, int8.linear_plan(m, c, sms))
    ops = {}
    want = int8.int8_proj_residual_plain(x, res, w, b, gamma, operands=ops)
    assert torch.equal(got, want)
    assert torch.equal(xq, ops["xq"]) and torch.equal(sx, ops["sx"])
