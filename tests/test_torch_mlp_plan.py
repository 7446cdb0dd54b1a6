"""A2's and D3's host-side plan (vdn_torch/kernels/mlp.py ``mlp_plan``) and
the per-tile arithmetic of their bf16 wgmma + TMA kernels
(csrc/ln_mlp.cu, csrc/ln_mlp_bwd.cu on csrc/bf16_wgmma.cuh), on the CPU.

The kernels need the card; what the wrappers compute in Python, every
product's persistent grid by row count, is held here at the paths' row
counts: a streamed frame (1,370), the 480 x 640 image (1,814), the v4
training step (16 x 1,370), the cached window (22 x 1,370) and the full
window (32 x 1,370), at vitl's C 1024 and at vits' and vitb's C 384 /
768.  The persistent blocks' walk,
split between the two consumer warpgroups (in ping-pong each takes every
other tile of its block; in D3's cooperative paired product each takes
half the rows of every tile), covers every output exactly once.  (A
block's shared memory is held to an H100's by a static_assert in
csrc/bf16_wgmma.cuh, where its constants live.)

Then plain torch replays the kernels' stages in their order: A2's row
kernel (y = bf16(LN(x))), fc1's + b1, GELU epilogue and fc2's + b2, x
gamma, + x epilogue tile by tile on the products the plain version forms,
which must equal ``fused_ln_mlp_residual_plain`` bit for bit; D3's row
kernel (y, go = bf16(g * gamma)), the paired tile's epilogue (h and dhpre
from the two sums), dy, the LayerNorm backward rows, and the column sums
in the kernel's order (sequential over each chunk of rows, 64 for db1 in
the paired tiles, 128 for dls and dlb, then over the chunks in order),
whose bf16 outputs must equal
``fused_ln_mlp_residual_bwd_plain``'s bit for bit and whose fp32 column
sums, summed in another order, sit within 1e-5 of their scale.  A2's and
D3's tests against vdn stay in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from vdn_torch.kernels import layer_norm_f32, linear_f32acc
from vdn_torch.kernels import mlp

SMS = 132          # an H100 SXM
VIT_TOKENS = 1370
ROWS = {"stream": VIT_TOKENS, "image": 37 * 49 + 1, "v4": 16 * VIT_TOKENS,
        "clip": 22 * VIT_TOKENS, "clip_full": 32 * VIT_TOKENS}
COLSUM_TOL = 1e-5  # fp32 column sums in another order, at their scale


def products(m: int, c: int, f: int, plan: dict) -> list:
    """(name, tile width, N, grid, cooperative) of each product: fc1 and
    the N = C products in ping-pong, D3's paired product cooperative."""
    return [("fc1", mlp.BN, f, plan["grid_f"], False),
            ("fc2 / dy", mlp.BN, c, plan["grid_c"], False),
            ("pair", mlp.BN, f, plan["grid_f"], True)]


def wgmma_tiles(m: int, n: int, bn: int, grid: int, coop: bool) -> list:
    """The (first row, row count, first column) of each warpgroup's part of
    a tile, per persistent block and consumer warpgroup in its order, as
    csrc/bf16_wgmma.cuh walks them: tile t at rows (t / (n / bn)) *
    WG_ROWS and columns (t % (n / bn)) * bn; block b takes t = b, b + grid,
    ...; in ping-pong its warpgroup w takes the j-th of those with j % 2 ==
    w, whole; cooperative, every one, rows w * PAIR_ROWS onwards of it."""
    nt = n // bn
    tm = mlp.WG_ROWS
    tiles = -(-m // tm) * nt
    if coop:
        half = mlp.PAIR_ROWS
        return [[[((t // nt) * tm + w * half, half, (t % nt) * bn)
                  for t in range(b, tiles, grid)] for w in range(2)]
                for b in range(grid)]
    return [[[((t // nt) * tm, tm, (t % nt) * bn)
              for t in range(b + w * grid, tiles, 2 * grid)]
             for w in range(2)] for b in range(grid)]


def _covers_once(m, n, bn, grid, coop) -> bool:
    """Every part of a tile of [m, n] (m rounded up to WG_ROWS) in exactly
    one warpgroup's walk, at the granularity of a warpgroup's rows (the
    parts are aligned, so this is every output once)."""
    assert n % bn == 0
    rows = mlp.PAIR_ROWS if coop else mlp.WG_ROWS
    hits = np.zeros((-(-m // mlp.WG_ROWS) * mlp.WG_ROWS // rows, n // bn),
                    np.int32)
    blocks = wgmma_tiles(m, n, bn, grid, coop)
    assert len(blocks) == grid
    for groups in blocks:
        for walk in groups:
            for r, nr, c in walk:
                assert nr == rows and r % rows == 0 and c % bn == 0
                hits[r // rows, c // bn] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("path", sorted(ROWS))
def test_plan_covers_and_fits(path):
    """At vitl's widths every product's tiles, walked by the plan's
    persistent blocks and their two consumer warpgroups, cover every
    output once; each product asks for a block a tile up to the card's
    SMs."""
    m, c, f = ROWS[path], 1024, 4096
    plan = mlp.mlp_plan(m, c, f, SMS)
    for _, bn, n, grid, coop in products(m, c, f, plan):
        assert grid == min(-(-m // mlp.WG_ROWS) * (n // bn), SMS)
        assert _covers_once(m, n, bn, grid, coop)


@pytest.mark.parametrize("c", [384, 768])
def test_plan_small_widths(c):
    """vits / vitb widths at the cached window's rows and at a streamed
    frame; a card of 4 SMs (a grid far below the tile count) and one of
    more SMs than tiles (a block for each tile, most with one warpgroup
    idle) still cover once."""
    f = 4 * c
    for m, sms in ((ROWS["clip"], SMS), (ROWS["stream"], SMS), (300, 4),
                   (300, 10 ** 4)):
        plan = mlp.mlp_plan(m, c, f, sms)
        for _, bn, n, grid, coop in products(m, c, f, plan):
            assert grid <= sms
            assert _covers_once(m, n, bn, grid, coop)


def test_plan_tile_width():
    """The N = C products keep 128-wide tiles where they number fewer than
    the SMs: a streamed frame's 11 row tiles x 8 at C 1024 and the image's
    15 x 8 take a block each, while fc1's four times as many fill the
    card."""
    assert mlp.mlp_plan(ROWS["stream"], 1024, 4096, SMS) == {
        "grid_f": SMS, "grid_c": 88}
    assert mlp.mlp_plan(ROWS["image"], 1024, 4096, SMS) == {
        "grid_f": SMS, "grid_c": 120}
    assert mlp.mlp_plan(ROWS["clip"], 1024, 4096, SMS)["grid_c"] == SMS
    assert mlp.mlp_plan(ROWS["clip"], 384, 1536, SMS)["grid_c"] == SMS


def _params(rng, m, c, f):
    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 + offset).astype(np.float32))
    x = t(m, c).to(torch.bfloat16)
    return x, [t(c, scale=0.1, offset=1.0), t(c, scale=0.1),
               t(f, c, scale=c ** -0.5), t(f, scale=0.1),
               t(c, f, scale=f ** -0.5), t(c, scale=0.1),
               t(c, scale=0.5)]


def _walk(m, n, bn, grid, coop=False):
    """The row and column slices of each warpgroup's part of a tile, in
    the walk's order (parts past m skipped)."""
    for groups in wgmma_tiles(m, n, bn, grid, coop):
        for walk in groups:
            for r0, nr, c0 in walk:
                if r0 < m:
                    yield slice(r0, min(r0 + nr, m)), slice(c0, c0 + bn)


def replay_a2(x, ln_w, ln_b, w1, b1, w2, b2, gamma, plan, eps=1e-6):
    """A2's three launches: the row kernel, then fc1's and fc2's epilogues
    tile by tile over the products' sums rounded to bf16 (the shared
    products)."""
    bf = torch.bfloat16
    m, c = x.shape
    f = w1.shape[0]
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(bf)
    acc1 = linear_f32acc(y, w1)
    h = torch.empty((m, f), dtype=bf)
    for rows, cols in _walk(m, f, mlp.BN, plan["grid_f"]):
        hpre = (acc1[rows, cols].float() + b1[cols].to(bf).float()).to(bf)
        h[rows, cols] = mlp.gelu_f32(hpre.float(), bf).to(bf)
    acc2 = linear_f32acc(h, w2)
    out = torch.empty_like(x)
    for rows, cols in _walk(m, c, mlp.BN, plan["grid_c"]):
        o = (acc2[rows, cols].float() + b2[cols].to(bf).float()).to(bf)
        og = (o.float() * gamma[cols].to(bf).float()).to(bf)
        out[rows, cols] = (x[rows, cols].float() + og.float()).to(bf)
    return out


@pytest.mark.parametrize("m,sms", [(300, 5), (128, 3)])
def test_a2_replay_is_the_plain_version(m, sms):
    """A2's stages replayed over its tiles equal the plain version bit for
    bit (bf16, C 256, F 1024; 300 rows: a partial last tile)."""
    rng = np.random.default_rng(m)
    c, f = 256, 1024
    x, p = _params(rng, m, c, f)
    got = replay_a2(x, *p, mlp.mlp_plan(m, c, f, sms))
    want = mlp.fused_ln_mlp_residual_plain(x, *p)
    assert torch.equal(got, want)


def colsum_chunks(v: torch.Tensor, rows: int) -> torch.Tensor:
    """csrc/ln_mlp_bwd.cu's column sums of fp32 v [M, N]: each chunk of
    ``rows`` rows summed row after row, then the chunks in order."""
    chunks = []
    for r0 in range(0, v.shape[0], rows):
        acc = torch.zeros(v.shape[1])
        for r in range(r0, min(r0 + rows, v.shape[0])):
            acc = acc + v[r]
        chunks.append(acc)
    out = torch.zeros(v.shape[1])
    for part in chunks:
        out = out + part
    return out


def replay_d3(x, g, ln_w, ln_b, w1, b1, w2, gamma, plan, eps=1e-6):
    """D3's launches: the row kernel (y, go), the paired product's
    epilogue tile by tile (h, dhpre from the two sums rounded to bf16), dy,
    the LayerNorm backward rows, the column sums in the kernel's order (db1
    per paired tile of PAIR_ROWS rows, dls and dlb per COLSUM_ROWS)."""
    bf = torch.bfloat16
    m, c = x.shape
    f = w1.shape[0]
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(bf)
    go = (g.float() * gamma.to(bf).float()).to(bf)
    hacc, dhacc = linear_f32acc(y, w1), linear_f32acc(go, w2.t())
    h = torch.empty((m, f), dtype=bf)
    dhpre = torch.empty_like(h)
    for rows, cols in _walk(m, f, mlp.BN, plan["grid_f"], coop=True):
        hpre = (hacc[rows, cols].float() + b1[cols].to(bf).float()).to(bf)
        gel, dgel = mlp.dgelu_f32(hpre.float(), bf)
        h[rows, cols] = gel.to(bf)
        dhpre[rows, cols] = (dhacc[rows, cols].float() * dgel).to(bf)
    dyf = linear_f32acc(dhpre, w1.t()).float()
    dxh = dyf * ln_w.float()
    dvar = (dxh * xc).sum(-1, keepdim=True) * -0.5 * inv * inv * inv
    dxc = dxh * inv + (2.0 / c) * xc * dvar
    dx = (g.float() + (dxc - dxc.mean(-1, keepdim=True)).to(bf).float()
          ).to(bf)
    db1 = colsum_chunks(dhpre.float(), mlp.PAIR_ROWS)
    dls = colsum_chunks(dyf * (xc * inv), mlp.COLSUM_ROWS)
    dlb = colsum_chunks(dyf, mlp.COLSUM_ROWS)
    return dx, y, h, dhpre, dls, dlb, db1


@pytest.mark.parametrize("m,sms", [(300, 5), (200, 132)])
def test_d3_replay_is_the_plain_version(m, sms):
    """D3's stages replayed over its tiles: dx, y, h, dhpre equal the
    plain version bit for bit; dls, dlb, db1 (fp32, summed in chunks of
    rows) within COLSUM_TOL of their scale (bf16, C 256, F 1024)."""
    rng = np.random.default_rng(m + 1)
    c, f = 256, 1024
    x, p = _params(rng, m, c, f)
    ln_w, ln_b, w1, b1, w2, _, gamma = p
    g = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32)
                         ).to(torch.bfloat16)
    got = replay_d3(x, g, ln_w, ln_b, w1, b1, w2, gamma,
                    mlp.mlp_plan(m, c, f, sms))
    want = mlp.fused_ln_mlp_residual_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2,
                                               gamma)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    for a, b in zip(got[4:], want[4:]):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= COLSUM_TOL * scale
