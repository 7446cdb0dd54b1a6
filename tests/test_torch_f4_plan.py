"""F4's host-side plan (vdn_torch/kernels/int8.py ``f4_plan``) and the
per-tile arithmetic of its wgmma + TMA kernel
(csrc/ln_mlp_int8.cu, csrc/int8_wgmma.cuh), on the CPU.

The kernel needs the card; what the wrapper computes in Python, fc2's tile
width and the persistent grids by row count, is held here at the main
path's row counts: a streamed frame (1,370), the 480 x 640 image (1,814),
the cached window (22 x 1,370) and the full window (32 x 1,370).  The
persistent blocks' walk over each product's tiles covers every output
exactly once.  (The shared memory of a block is held to an H100's by a
static_assert in csrc/int8_wgmma.cuh, where its constants live.)

Then plain torch replays the kernel's stages tile by tile in its order
(exact int32 sums, (acc * row scale) * column scale per F / 2 chunk, the
hidden's absmax gathered over fc1's tiles, fc2's chunk 0 dequantized
before chunk 1 is added: pj0 + pj1) and must equal
``fused_ln_mlp_residual_int8_plain`` bit for bit.  F4's tests against vdn
stay in tests/test_torch_int8.py.
"""

import numpy as np
import pytest
import torch

from vdn_torch.kernels import layer_norm_f32
from vdn_torch.kernels import int8
from vdn_torch.kernels.mlp import gelu_f32

SMS = 132          # an H100 SXM
VIT_TOKENS = 1370
ROWS = {"stream": VIT_TOKENS, "image": 37 * 49 + 1,
        "clip": 22 * VIT_TOKENS, "clip_full": 32 * VIT_TOKENS}


def wgmma_tiles(m: int, n: int, bn: int, grid: int) -> list:
    """The (first row, first column) of each tile, per persistent block in
    its order, as csrc/int8_wgmma.cuh walks them: tile t at rows
    (t / (n / bn)) * 128 and columns (t % (n / bn)) * bn; block b takes
    t = b, b + grid, ..."""
    nt = n // bn
    tiles = -(-m // int8.WG_ROWS) * nt
    return [[((t // nt) * int8.WG_ROWS, (t % nt) * bn)
             for t in range(b, tiles, grid)] for b in range(grid)]


def _covers_once(m, n, bn, grid):
    """Every output of [m, n] in exactly one tile of the persistent
    blocks' walk."""
    hits = np.zeros((-(-m // int8.WG_ROWS) * int8.WG_ROWS, n), np.int32)
    blocks = wgmma_tiles(m, n, bn, grid)
    assert len(blocks) == grid
    for tiles in blocks:
        for r, c in tiles:
            hits[r:r + int8.WG_ROWS, c:c + bn] += 1
    return bool((hits[:m] == 1).all())


@pytest.mark.parametrize("path", sorted(ROWS))
def test_plan_covers_and_fits(path):
    """Each product's tiles, walked by the plan's persistent blocks, cover
    every output once; no product asks for more blocks than the card has
    SMs, and at the main path's row counts both fill the card."""
    m, c, f = ROWS[path], 1024, 4096
    plan = int8.f4_plan(m, c, f, SMS)
    for n, bn, grid in ((f, int8.F4_BN1, plan["grid1"]),
                        (c, plan["bn2"], plan["grid2"])):
        assert grid == SMS
        assert _covers_once(m, n, bn, grid)


def test_plan_small_widths():
    """vits / vitb widths (C 384 / 768) on a card of 4 SMs: a grid smaller
    than the tile count still covers once; on a card of more SMs than
    tiles each tile has a block of its own."""
    for c, f in ((384, 1536), (768, 3072)):
        plan = int8.f4_plan(300, c, f, 4)
        assert plan["grid1"] == plan["grid2"] == 4
        assert _covers_once(300, f, int8.F4_BN1, plan["grid1"])
        assert _covers_once(300, c, plan["bn2"], plan["grid2"])
        plan = int8.f4_plan(300, c, f, 10 ** 4)
        assert _covers_once(300, f, int8.F4_BN1, plan["grid1"])
        assert _covers_once(300, c, plan["bn2"], plan["grid2"])


def _replay(x, ln_w, ln_b, w1, b1, w2, b2, gamma, plan, eps=1e-6):
    """F4's four stages in plain torch, fc1 and fc2 tile by tile in the
    persistent blocks' order."""
    (w1q, s1), (w2q, s2) = (int8.quantize_weight_cols(w) for w in (w1, w2))
    m, c = x.shape
    f = w1q.shape[0]
    half = f // int8.F_CHUNKS
    yq, sy = int8.quantize_rows(layer_norm_f32(x, ln_w, ln_b, eps))
    h = torch.empty((m, f))
    amax = torch.zeros((m, int8.F_CHUNKS))
    for tiles in wgmma_tiles(m, f, int8.F4_BN1, plan["grid1"]):
        for r0, c0 in tiles:
            rows = slice(r0, min(r0 + int8.WG_ROWS, m))
            cols = slice(c0, c0 + int8.F4_BN1)
            acc = (yq[rows].double() @ w1q[cols].double().t()).float()
            ht = gelu_f32(acc * sy[rows] * s1[cols] + b1[cols], x.dtype)
            h[rows, cols] = ht
            j = c0 // half
            amax[rows, j] = torch.maximum(amax[rows, j],
                                          ht.abs().amax(1))
    sh = torch.clamp_min(int8.over_127(amax), 1e-30)
    hq = torch.round(h.reshape(m, int8.F_CHUNKS, half)
                     * torch.reciprocal(sh)[..., None]).to(torch.int8)
    hq = hq.reshape(m, f)
    out = torch.empty_like(x)
    for tiles in wgmma_tiles(m, c, plan["bn2"], plan["grid2"]):
        for r0, c0 in tiles:
            rows = slice(r0, min(r0 + int8.WG_ROWS, m))
            cols = slice(c0, c0 + plan["bn2"])
            o = None
            for j in range(int8.F_CHUNKS):   # pj0, then + pj1
                k = slice(j * half, (j + 1) * half)
                acc = (hq[rows, k].double()
                       @ w2q[cols, k].double().t()).float()
                pj = acc * sh[rows, j:j + 1] * s2[cols]
                o = pj if o is None else o + pj
            o = (o + b2[cols]) * gamma[cols]
            out[rows, cols] = x[rows, cols] + o.to(x.dtype)
    return out


@pytest.mark.parametrize("m,sms", [(300, 5), (128, 3)])
def test_tiled_replay_is_the_plain_version(m, sms):
    """The kernel's stages replayed over its tiles equal the plain
    version bit for bit (bf16, C 256, F 1024: two chunks of 512)."""
    rng = np.random.default_rng(m)
    c, f = 256, 1024

    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 + offset).astype(np.float32))

    x = t(m, c).to(torch.bfloat16)
    ln_w, ln_b = t(c, scale=0.1, offset=1.0), t(c, scale=0.1)
    w1, b1 = t(f, c, scale=c ** -0.5), t(f, scale=0.1)
    w2, b2 = t(c, f, scale=f ** -0.5), t(c, scale=0.1)
    gamma = t(c, scale=0.5)
    plan = int8.f4_plan(m, c, f, sms)
    got = _replay(x, ln_w, ln_b, w1, b1, w2, b2, gamma, plan)
    want = int8.fused_ln_mlp_residual_int8_plain(x, ln_w, ln_b, w1, b1, w2,
                                                 b2, gamma)
    assert torch.equal(got, want)
