"""F5's host-side plan (vdn_torch/kernels/int8.py ``f5_plan``) and the
per-tile arithmetic of its kernel on the wgmma + TMA core's paired mode
(csrc/ln_swiglu_int8.cu, csrc/int8_wgmma.cuh), on the CPU.

The kernel needs the card; what the wrapper computes in Python, w3's tile
width and the persistent grids by row count, is held here at vitg's main
path row counts: a streamed frame (1,370), the 480 x 640 image (1,814), the
cached window (22 x 1,370) and the full window (32 x 1,370).  The paired
w12 tiles (128 rows x 64 outputs, their gate rows [n0, n0 + 64) and value
rows [F + n0, F + n0 + 64) of w12 in one 128-row B stage) cover every
hidden column once and each lies in one F / 2 chunk.

Then plain torch replays a paired tile as the kernel computes it (the
128-column int32 sum, (acc * row scale) * column scale with the value
half's scales at F + n, SwiGLU on columns c and c + 64 of the same
thread, the hidden's absmax gathered per (row, chunk) over the tiles) and
w3 as F4's fc2, and must equal ``fused_ln_swiglu_residual_int8_plain``'s
int8 operands and output bit for bit.  F5's tests against vdn stay in
tests/test_torch_vitg.py.
"""

import numpy as np
import pytest
import torch

from vdn_torch.kernels import LOG2E, layer_norm_f32
from vdn_torch.kernels import int8

SMS = 132          # an H100 SXM
VIT_TOKENS = 1370
ROWS = {"stream": VIT_TOKENS, "image": 37 * 49 + 1,
        "clip": 22 * VIT_TOKENS, "clip_full": 32 * VIT_TOKENS}


def paired_tiles(m: int, f: int, grid: int) -> list:
    """Per persistent block, in its order, the paired w12 tiles as
    csrc/int8_wgmma.cuh walks them (tile t: rows (t / (F / 64)) * 128,
    outputs (t % (F / 64)) * 64; block b takes t = b, b + grid, ...): each
    tile's rows, the w12 rows of its gate and value halves, its h columns
    and its F / 2 chunk."""
    per_row = f // int8.F5_BN1
    tiles = -(-m // int8.WG_ROWS) * per_row
    out = []
    for b in range(grid):
        blk = []
        for t in range(b, tiles, grid):
            r0 = (t // per_row) * int8.WG_ROWS
            n0 = (t % per_row) * int8.F5_BN1
            cols = torch.arange(n0, n0 + int8.F5_BN1)
            blk.append({"rows": slice(r0, min(r0 + int8.WG_ROWS, m)),
                        "gate": cols, "value": f + cols, "h": cols,
                        "chunk": n0 // (f // int8.F_CHUNKS)})
        out.append(blk)
    return out


@pytest.mark.parametrize("path", sorted(ROWS))
def test_plan_and_paired_tiles(path):
    """At vitg's widths (C 1536, F 4096) both products fill the card
    without asking for more blocks than SMs; the paired tiles cover every
    (row, h column) once, read the gate and value rows of the same
    outputs, and each lies in one F / 2 chunk."""
    m, c, f = ROWS[path], 1536, 4096
    plan = int8.f5_plan(m, c, f, SMS)
    # a frame's 11 row tiles x 12 column tiles of w3 fill 132 SMs
    assert plan == {"bn2": 128, "grid1": SMS, "grid2": SMS}
    hits = torch.zeros((-(-m // int8.WG_ROWS), f), dtype=torch.int32)
    blocks = paired_tiles(m, f, plan["grid1"])
    assert len(blocks) == SMS
    for blk in blocks:
        for tile in blk:
            rows, h = tile["rows"], tile["h"]
            assert rows.start % int8.WG_ROWS == 0
            assert rows.stop == min(rows.start + int8.WG_ROWS, m)
            assert torch.equal(tile["gate"], h)
            assert torch.equal(tile["value"], f + h)
            assert (h // (f // int8.F_CHUNKS) == tile["chunk"]).all()
            hits[rows.start // int8.WG_ROWS, h] += 1
    assert bool((hits == 1).all())


def test_plan_small_widths():
    """A card of fewer SMs than tiles: grids at the SM count; of more: one
    block per tile, and w3 at 64-wide tiles when 128-wide would leave SMs
    idle."""
    plan = int8.f5_plan(300, 256, 512, 4)
    assert plan == {"bn2": 128, "grid1": 4, "grid2": 4}
    plan = int8.f5_plan(300, 256, 512, 10 ** 4)
    assert plan == {"bn2": 64, "grid1": 3 * 512 // int8.F5_BN1,
                    "grid2": 3 * 256 // 64}


def _swiglu_epilogue(x1, x2):
    """The epilogue's arithmetic (ln_swiglu_int8.cu, EpiSwigluHidden):
    x1 * sig * x2, sig = 1 / (1 + exp2(x1 * -log2 e)), a true division."""
    sig = torch.ones(()) / (1.0 + torch.exp2(x1 * -LOG2E))
    return x1 * sig * x2


def _replay(x, ln_w, ln_b, w12, b12, w3, b3, gamma, grid, eps=1e-6):
    """F5's four stages in plain torch, w12 paired tile by paired tile in
    the persistent blocks' order, then w3 with its chunks dequantized in
    order (tests/test_torch_f4_plan.py replays fc2's tiles)."""
    (w12q, s12), (w3q, s3) = (int8.quantize_weight_cols(w)
                              for w in (w12, w3))
    m, c = x.shape
    f = w12q.shape[0] // 2
    half = f // int8.F_CHUNKS
    yq, sy = int8.quantize_rows(layer_norm_f32(x, ln_w, ln_b, eps))
    h = torch.empty((m, f))
    amax = torch.zeros((m, int8.F_CHUNKS))
    for blk in paired_tiles(m, f, grid):
        for tile in blk:
            rows, wrows = tile["rows"], torch.cat([tile["gate"],
                                                   tile["value"]])
            # one 128-column product: the gate columns, then the value ones
            acc = (yq[rows].double() @ w12q[wrows].double().t()).float()
            v = acc * sy[rows] * s12[wrows] + b12[wrows]
            ht = _swiglu_epilogue(v[:, :int8.F5_BN1], v[:, int8.F5_BN1:])
            h[rows, tile["h"]] = ht
            j = tile["chunk"]
            amax[rows, j] = torch.maximum(amax[rows, j], ht.abs().amax(1))
    sh = torch.clamp_min(int8.over_127(amax), 1e-30)
    hq = torch.round(h.reshape(m, int8.F_CHUNKS, half)
                     * torch.reciprocal(sh)[..., None]).to(torch.int8)
    hq = hq.reshape(m, f)
    o = None
    for j in range(int8.F_CHUNKS):   # pj0, then + pj1
        k = slice(j * half, (j + 1) * half)
        pj = (hq[:, k].double() @ w3q[:, k].double().t()).float() \
            * sh[:, j:j + 1] * s3
        o = pj if o is None else o + pj
    out = x + ((o + b3) * gamma).to(x.dtype)
    return out, {"yq": yq, "sy": sy, "hq": hq, "sh": sh}


@pytest.mark.parametrize("m,sms", [(300, 5), (128, 3)])
def test_paired_replay_is_the_plain_version(m, sms):
    """The paired w12 tiles and the SwiGLU epilogue, replayed in the
    kernel's order, give the plain version's int8 operands and output bit
    for bit (bf16, C 256, F 512: two chunks of 256, four paired tiles a
    row tile)."""
    rng = np.random.default_rng(m)
    c, f = 256, 512

    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 + offset).astype(np.float32))

    x = t(m, c).to(torch.bfloat16)
    ln_w, ln_b = t(c, scale=0.1, offset=1.0), t(c, scale=0.1)
    w12, b12 = t(2 * f, c, scale=c ** -0.5), t(2 * f, scale=0.1)
    w3, b3 = t(c, f, scale=f ** -0.5), t(c, scale=0.1)
    gamma = t(c, scale=0.5)
    plan = int8.f5_plan(m, c, f, sms)
    got, ops = _replay(x, ln_w, ln_b, w12, b12, w3, b3, gamma,
                       plan["grid1"])
    want_ops = {}
    want = int8.fused_ln_swiglu_residual_int8_plain(
        x, ln_w, ln_b, w12, b12, w3, b3, gamma, operands=want_ops)
    for k in ("yq", "sy", "hq", "sh"):
        assert torch.equal(ops[k], want_ops[k]), k
    assert torch.equal(got, want)
