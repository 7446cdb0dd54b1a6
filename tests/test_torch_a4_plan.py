"""A4's host-side plan (vdn_torch/kernels/geglu.py ``geglu_plan``) and the
per-tile arithmetic of its bf16 wgmma + TMA kernel (csrc/ln_geglu.cu on
csrc/bf16_wgmma.cuh), on the CPU.

The kernel needs the card; what the wrapper computes in Python, each
product's persistent grid by row count, is held here at the motion
modules' shapes of every model (vits, vitb, vitl, vitg: tokens 37^2,
19^2, 37^2, 74^2 at the widths ``nn/dpt_temporal.py`` gives them) over a
32-frame window and a streamed frame (T 1).  The persistent blocks' walk,
split between the two consumer warpgroups in ping-pong (each takes every
other tile of its block), covers every stored output exactly once: fc1's
tiles of 128 rows x 64 outputs (a B stage of 64 hidden and 64 gate rows of
w0) over [rows, F], fc2's 128 x 128 tiles over [rows, C], whose last one
is half empty at C 64 and 192 (nothing past C is stored).

Then plain torch replays the three launches in their order: the row
kernel (y = bf16(LN(x))), fc1's tiles, each a B stage of w0's hidden rows
[n0, n0 + 64) then gate rows [F + n0, F + n0 + 64) whose accumulator
columns c and c + 64 are one output's hidden and gate sums, paired by the
GEGLU epilogue, and fc2's tiles with (x + o) + b2, on the products the
plain version forms; the result must equal
``fused_ln_geglu_residual_plain`` bit for bit.  A4's tests against vdn
stay in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from vdn_torch.kernels import geglu, layer_norm_f32, linear_f32acc
from vdn_torch.kernels.mlp import BN, WG_ROWS, gelu_f32

SMS = 132          # an H100 SXM
# (tokens, C) of the four motion modules at 518 px, per model
MOTION = {"vits": [(1369, 192), (361, 384), (1369, 64), (5476, 64)],
          "vitb": [(1369, 384), (361, 768), (1369, 128), (5476, 128)],
          "vitl": [(1369, 1024), (361, 1024), (1369, 256), (5476, 256)],
          "vitg": [(1369, 1536), (361, 1536), (1369, 384), (5476, 384)]}


def tiles_of(m: int, n: int, tn: int, grid: int) -> list:
    """The (first row, first column) of each tile, per persistent block and
    consumer warpgroup in its order, as csrc/bf16_wgmma.cuh walks them in
    ping-pong: ceil(n / tn) column tiles, tile t at rows (t / n_tiles) *
    WG_ROWS and columns (t % n_tiles) * tn; block b's warpgroup w takes t =
    b + w grid, b + 3 grid, ..."""
    nt = -(-n // tn)
    tiles = -(-m // WG_ROWS) * nt
    return [[[((t // nt) * WG_ROWS, (t % nt) * tn)
              for t in range(b + w * grid, tiles, 2 * grid)]
             for w in range(2)] for b in range(grid)]


def covers_once(m: int, n: int, tn: int, grid: int) -> bool:
    """Every stored output of [m, n] in exactly one warpgroup's walk, at
    the granularity of a 64-column atom (tiles are WG_ROWS x tn, tn a
    multiple of 64; atoms past n are not stored)."""
    assert n % 64 == 0 and tn % 64 == 0
    mt = -(-m // WG_ROWS)
    hits = np.zeros((mt, -(-n // tn) * tn // 64), np.int32)
    blocks = tiles_of(m, n, tn, grid)
    assert len(blocks) == grid
    for groups in blocks:
        for walk in groups:
            for r, c in walk:
                hits[r // WG_ROWS, c // 64:(c + tn) // 64] += 1
    return bool((hits[:, :n // 64] == 1).all())


@pytest.mark.parametrize("t", [32, 1])
@pytest.mark.parametrize("encoder", sorted(MOTION))
def test_plan_covers_and_fits(encoder, t):
    """Each motion module's two products, walked by the plan's persistent
    blocks and their two consumer warpgroups, cover every output once; no
    product asks for more blocks than SMs or than it has tiles."""
    for tokens, c in MOTION[encoder]:
        m, f = tokens * t, 4 * c
        plan = geglu.geglu_plan(m, c, f, SMS)
        mt = -(-m // WG_ROWS)
        for n, tn, grid in ((f, geglu.HALF_BN, plan["grid_f"]),
                            (c, BN, plan["grid_c"])):
            assert grid == min(mt * -(-n // tn), SMS)
            assert covers_once(m, n, tn, grid)


def test_plan_half_empty_tile():
    """At vits' C 64 and 192 fc2's last column tile is half empty: one
    tile of [rows, 64], two of [rows, 192], each 128 wide."""
    assert geglu.geglu_plan(300, 64, 256, SMS) == {"grid_f": 12,
                                                   "grid_c": 3}
    assert geglu.geglu_plan(300, 192, 768, SMS) == {"grid_f": 36,
                                                    "grid_c": 6}
    assert covers_once(300, 64, BN, 3) and covers_once(300, 192, BN, 2)


def test_plan_small_card():
    """A card of 4 SMs (a grid far below the tile count) and one of more
    SMs than tiles still cover once."""
    for c in (64, 192, 256):
        f = 4 * c
        for sms in (4, 10 ** 4):
            plan = geglu.geglu_plan(300, c, f, sms)
            assert covers_once(300, f, geglu.HALF_BN, plan["grid_f"])
            assert covers_once(300, c, BN, plan["grid_c"])


def replay(x, ln_w, ln_b, w0, b0, w2, b2, plan, eps=1e-6):
    """A4's three launches: the row kernel, then fc1's GEGLU epilogue and
    fc2's (x + o) + b2 epilogue tile by tile over the products' sums
    rounded to bf16 (the products the plain version forms)."""
    bf = torch.bfloat16
    m, c = x.shape
    f = w2.shape[1]
    half = geglu.HALF_BN
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(bf)
    acc1 = linear_f32acc(y, w0)                       # [m, 2f]
    h = torch.full((m, f), float("nan"), dtype=bf)
    for groups in tiles_of(m, f, half, plan["grid_f"]):
        for walk in groups:
            for r0, n0 in walk:
                rows = slice(r0, min(r0 + WG_ROWS, m))
                # the B stage: hidden rows, then the gate rows of w0
                b_rows = torch.cat([torch.arange(n0, n0 + half),
                                    torch.arange(f + n0, f + n0 + half)])
                acc = acc1[rows][:, b_rows]
                bias = b0.to(bf)[b_rows]
                hid = (acc[:, :half].float() + bias[:half].float()).to(bf)
                gate = (acc[:, half:].float() + bias[half:].float()).to(bf)
                h[rows, n0:n0 + half] = (
                    hid.float() * gelu_f32(gate.float(), bf)).to(bf)
    acc2 = linear_f32acc(h, w2)
    out = torch.full_like(x, float("nan"))
    for groups in tiles_of(m, c, BN, plan["grid_c"]):
        for walk in groups:
            for r0, n0 in walk:
                rows = slice(r0, min(r0 + WG_ROWS, m))
                cols = slice(n0, min(n0 + BN, c))   # nothing past C
                xo = (x[rows, cols].float()
                      + acc2[rows, cols].float()).to(bf)
                out[rows, cols] = (xo.float()
                                   + b2[cols].to(bf).float()).to(bf)
    return out


@pytest.mark.parametrize("m,c,sms", [(300, 64, 5), (300, 256, 7),
                                     (128, 192, 3)])
def test_replay_is_the_plain_version(m, c, sms):
    """A4's stages replayed over its tiles equal the plain version bit for
    bit (bf16, F 4C; 300 rows: a partial last row tile; C 64 and 192: a
    half-empty fc2 tile)."""
    rng = np.random.default_rng(m + c)
    f = 4 * c

    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 + offset).astype(np.float32))

    x = t(m, c).to(torch.bfloat16)
    p = [t(c, scale=0.1, offset=1.0), t(c, scale=0.1),
         t(2 * f, c, scale=c ** -0.5), t(2 * f, scale=0.1),
         t(c, f, scale=f ** -0.5), t(c, scale=0.1)]
    got = replay(x, *p, geglu.geglu_plan(m, c, f, sms))
    want = geglu.fused_ln_geglu_residual_plain(x, *p)
    assert torch.equal(got, want)
