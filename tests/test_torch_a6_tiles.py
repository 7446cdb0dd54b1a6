"""A6's schedule on the card (csrc/resize_island.cu), replayed in plain
torch on the CPU and held to ``fused_resize_island_plain`` and to vdn's
Pallas kernel.

The kernel needs the card; what its design changes is where each number
is formed, which plain torch can replay.  The work items of
``island_plan`` (frame, run of output rows, strip of 64 output columns),
walked by the persistent blocks, cover every output pixel once: the last
strip of a row is shifted to end at w_out and stores only the columns the
strip before it did not.  In an item the producers build one resized row
per output row, and one above and below the run: the H pass (the two
``rows_plan`` taps of feat in fp32 in order, zero-weight taps skipped,
rounded to bf16) over the strip's source columns, then the W pass (the
two bf16 column taps of ``_column_plan``, fp32 sum, rounded) into a ring
row laid out [C / 8][66][8]; rows and columns outside the image are zeros.
The consumer takes each ring row once: its A operand read from column dx
through the no-swizzle K-major descriptor (16 bytes a pixel, 1,056 bytes
a chunk of 8 channels; the replay reads it by those offsets and holds it
equal to an im2col) times the dx block of ``island_weights``' layout,
[W(0, dx) | W(1, dx) | W(2, dx)] (N = 96, read the same way), summed over
dx and the channels; block dy of ring row i is its part of output row i -
dy, and output row j is (block 0 of row j + block 1 of row j + 1) + block
2 of row j + 2.  The epilogue: + b1, ReLU, bf16, the dot with w2 in the
kernel's order (each lane of a quad its 8 channels by fused
multiply-adds, then the two shuffles), + b2, the activation.  The replay
must sit within KERNEL_ULPS bf16 ulps of the plain version and of vdn's
kernel in interpret mode.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdn.ops.pallas import resize_island as jisland
from vdn_torch.kernels import resize_island as ri

KERNEL_ULPS = 4   # chip_smoke.py: kernel vs plain, bf16 ulps at the scale
SMS = 132         # an H100 SXM
LBO, SBO = ri.ISLAND_COLS * 16, 128   # the ring's descriptor, bytes
N = 3 * ri.ISLAND_O                   # the weights' B rows a dx


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def walk(plan: dict) -> list:
    """(frame, first row, rows, strip) of each item, per persistent block
    in its order."""
    s, runs = plan["strips"], plan["runs"]
    out = []
    for k in range(plan["grid"]):
        items = []
        for i in range(k, plan["items"], plan["grid"]):
            y0 = (i // s) % runs * plan["run_rows"]
            items.append((i // (s * runs), y0, plan["run_rows"], i % s))
        out.append(items)
    return out


def tables(h, w, h_out, w_out):
    itab, ftab, src_cols = ri._island_tables(h, w, h_out, w_out)
    itab, ftab = torch.from_numpy(itab).long(), torch.from_numpy(ftab)
    nh, nw = 2 * h_out, 2 * w_out
    return (itab[:nh].view(h_out, 2), ftab[:nh].view(h_out, 2),
            itab[nh:nh + nw].view(w_out, 2), ftab[nh:nh + nw].view(w_out, 2),
            itab[nh + nw:].view(-1, 2), src_cols)


@functools.lru_cache(maxsize=None)
def _offsets(start: int, rows: int, k: int, lbo: int, sbo: int):
    m = torch.arange(rows)[:, None]
    kk = torch.arange(k)[None, :]
    at = start + lbo * (kk // 8) + sbo * (m // 8) + 16 * (m % 8) + 2 * (kk % 8)
    return at // 2


def operand(ring: torch.Tensor, start: int, rows: int, k: int, lbo: int,
            sbo: int) -> torch.Tensor:
    """[rows, k] bf16 values of a no-swizzle K-major operand in the flat
    bf16 memory ``ring`` at byte ``start``: element (m, kk) at start +
    lbo (kk // 8) + sbo (m // 8) + 16 (m % 8) + 2 (kk % 8)."""
    return ring[_offsets(start, rows, k, lbo, sbo)]


def replay(feat, w1, b1, w2, b2, out_hw, sigmoid=False, max_depth=1.0,
           sms=SMS):
    """out [N, h_out, w_out, 1] fp32 by the kernel's items and order, and
    the number of times each pixel was stored."""
    n, h, w, c = feat.shape
    h_out, w_out = out_hw
    htap, hwt, ctap, cwt, strips, src_cols = tables(h, w, h_out, w_out)
    plan = ri.island_plan(n, h_out, w_out, sms)
    wt, b1f, w2f = ri.island_weights(torch.as_tensor(w1), torch.as_tensor(b1),
                                     torch.as_tensor(w2))
    w2f = _bf(w2f)                          # as the kernel rounds it
    wflat = wt.float().reshape(-1)
    x = feat.float()
    out = torch.full((n, h_out, w_out), math.nan)
    stored = torch.zeros((n, h_out, w_out), dtype=torch.int32)
    cols = ri.ISLAND_COLS
    b2v = float(torch.as_tensor(b2).reshape(-1)[0])
    for block in walk(plan):
        for fr, y0, run_rows, s in block:
            rows = min(run_rows, h_out - y0)
            x0, s0 = (int(v) for v in strips[s])
            ring = []
            for i in range(rows + 2):
                ys = y0 - 1 + i
                slot = torch.zeros((c // 8, cols, 8))
                if 0 <= ys < h_out:
                    src = x[fr, :, s0:s0 + src_cols]           # [h, cols, C]
                    acc = torch.zeros((src_cols, c))
                    for t in range(2):
                        if hwt[ys, t] != 0:
                            acc = acc + src[htap[ys, t]] * hwt[ys, t]
                    hrow = _bf(acc)
                    xc = x0 - 1 + torch.arange(cols)
                    ok = (xc >= 0) & (xc < w_out)
                    xcc = xc.clamp(0, w_out - 1)
                    fa = hrow[ctap[xcc, 0] - s0]
                    fb = hrow[ctap[xcc, 1] - s0]
                    r = _bf(cwt[xcc, 0, None] * fa + cwt[xcc, 1, None] * fb)
                    r = torch.where(ok[:, None], r, torch.zeros(()))
                    slot = r.view(cols, c // 8, 8).permute(1, 0, 2)
                ring.append(slot.reshape(-1))
            steps = []   # per ring row: [64 px, 3 dy * 32]
            for flat in ring:
                acc = torch.zeros((ri.ISLAND_STRIP, N))
                for dx in range(3):
                    a = operand(flat, 16 * dx, ri.ISLAND_STRIP, c, LBO, SBO)
                    b = operand(wflat, dx * c * N * 2, N, c, N * 16, 128)
                    acc = acc + a @ b.t()
                steps.append(acc)
            o = ri.ISLAND_O
            for j in range(rows):
                acc = ((steps[j][:, :o] + steps[j + 1][:, o:2 * o])
                       + steps[j + 2][:, 2 * o:])
                y = _bf(torch.relu(acc + b1f))            # [64 px, 32]
                # the quad's lanes: channels 8 nj + 2 q + e, in (nj, e)
                # order, fused multiply-adds (exact in float64, then fp32)
                part = torch.zeros((ri.ISLAND_STRIP, 4), dtype=torch.float32)
                for nj in range(4):
                    for e in range(2):
                        ch = 8 * nj + 2 * torch.arange(4) + e
                        part = (part.double() + y[:, ch].double()
                                * w2f[ch].double()).float()
                z = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])
                z = z + b2v
                z = torch.sigmoid(z) * max_depth if sigmoid else torch.relu(z)
                xs = x0 + torch.arange(ri.ISLAND_STRIP)
                keep = (xs >= ri.ISLAND_STRIP * s) & (xs < w_out)
                out[fr, y0 + j, xs[keep]] = z[keep]
                stored[fr, y0 + j, xs[keep]] += 1
    return out[..., None], stored


def _args(n, h, w, c, seed):
    # the draws of tests/test_resize_island.py
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [r(n, h, w, c), r(3, 3, c, 32) / np.sqrt(9 * c), 0.1 * r(32),
            r(32, 1) / np.sqrt(32), 0.1 * r(1)]


def _close(got: torch.Tensor, want, what: str) -> None:
    g = got.float()
    w = torch.from_numpy(np.array(want, np.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = w.abs().max().item()
    err = (g - w).abs().max().item()
    assert err <= KERNEL_ULPS * bf16_ulp(scale), (what, err, scale)


@pytest.mark.parametrize("n,h_out,w_out", [
    (1, 518, 518), (32, 518, 518), (1, 518, 686), (32, 518, 686),
    (22, 518, 518)])
def test_plan_covers_every_pixel_once(n, h_out, w_out):
    """The persistent blocks' walk stores every output pixel of the main
    path's shapes exactly once, with no more blocks than SMs; the last
    strip ends at w_out, and a strip reads at most 40 source columns."""
    g = 8 * 37 if w_out == 518 else 8 * 49
    src_cols = ri._island_tables(8 * 37, g, h_out, w_out)[2]
    plan = ri.island_plan(n, h_out, w_out, SMS)
    assert plan["grid"] == min(plan["items"], SMS)
    assert plan["items"] == n * plan["strips"] * plan["runs"]
    assert plan["x0"][-1] + ri.ISLAND_STRIP == w_out
    seen = np.zeros((n, h_out, w_out), np.int32)
    for block in walk(plan):
        for fr, y0, run_rows, s in block:
            x0 = plan["x0"][s]
            lo = max(x0, ri.ISLAND_STRIP * s)
            seen[fr, y0:y0 + run_rows, lo:min(x0 + ri.ISLAND_STRIP,
                                              w_out)] += 1
    assert (seen == 1).all()
    # the busiest block's rows (each item's and its two halo rows) within
    # a fifth of an even share of the frames' rows, also at one frame (the
    # stream, an image: about one item an SM)
    busiest = -(-plan["items"] // plan["grid"]) * (plan["run_rows"] + 2)
    assert busiest <= 1.2 * n * plan["strips"] * h_out / SMS + 4
    assert src_cols <= 40


def test_ring_operand_is_im2col():
    """The A operands read by descriptor offsets from a ring row laid out
    [C / 8][66][8] at columns 0, 1, 2 equal that row's im2col, and the B
    operand of each dx from island_weights' layout is [W(0, dx) | W(1, dx)
    | W(2, dx)] rounded to bf16."""
    c, cols = 32, ri.ISLAND_COLS
    g = torch.Generator().manual_seed(0)
    img = _bf(torch.randn(cols, c, generator=g))          # [col, C]
    flat = img.view(cols, c // 8, 8).permute(1, 0, 2).reshape(-1)
    w1 = torch.randn(3, 3, c, 32, generator=g)
    wt = ri.island_weights(w1, torch.zeros(32), torch.zeros(32, 1))[0]
    wt = wt.float().reshape(-1)
    for dx in range(3):
        a = operand(flat, 16 * dx, ri.ISLAND_STRIP, c, LBO, SBO)
        assert torch.equal(a, img[dx:dx + ri.ISLAND_STRIP])
        b = operand(wt, dx * c * N * 2, N, c, N * 16, 128)
        assert torch.equal(b, torch.cat([_bf(w1[dy, dx]).t()
                                         for dy in range(3)]))


@pytest.mark.parametrize("n,h,w,c,out_hw,sigmoid,max_depth,seed", [
    (1, 37, 37, 128, (64, 64), False, 1.0, 0),    # one frame, one strip
    (1, 19, 19, 128, (40, 40), True, 20.0, 3),    # the sigmoid head
    (1, 21, 21, 192, (37, 37), False, 1.0, 0),    # vitg's C
    (1, 21, 21, 224, (37, 37), False, 1.0, 2),    # MAX_C
    (1, 16, 28, 128, (28, 49), False, 1.0, 1),    # a non-square grid
    (2, 16, 40, 192, (28, 70), True, 5.0, 4),     # a ragged last strip
])
def test_replay_matches_plain_and_vdn(n, h, w, c, out_hw, sigmoid,
                                      max_depth, seed):
    """The replayed schedule within KERNEL_ULPS bf16 ulps of
    fused_resize_island_plain and of vdn's fused_resize_island (Pallas in
    interpret mode), every pixel stored once."""
    feat, *params = _args(n, h, w, c, seed)
    tfeat = torch.from_numpy(feat).to(torch.bfloat16)
    tparams = [torch.from_numpy(p) for p in params]
    got, stored = replay(tfeat, *tparams, out_hw, sigmoid, max_depth)
    assert (stored == 1).all()
    _close(got, ri.fused_resize_island_plain(tfeat, *tparams, out_hw,
                                             sigmoid, max_depth), "plain")
    with pltpu.force_tpu_interpret_mode():
        want = jisland.fused_resize_island(
            jnp.asarray(feat, jnp.bfloat16),
            *(jnp.asarray(p) for p in params), out_hw, sigmoid, max_depth)
    _close(got, want, "vdn")


def test_replay_one_frame_many_blocks():
    """One frame spread over many blocks (the stream's and an image's
    case: items of a few rows, each with its two halo rows) and over one
    block (every item in turn through one ring) give the same output."""
    feat, *params = _args(1, 20, 36, 128, 5)
    tfeat = torch.from_numpy(feat).to(torch.bfloat16)
    tparams = [torch.from_numpy(p) for p in params]
    many, s1 = replay(tfeat, *tparams, (35, 70), sms=SMS)
    one, s2 = replay(tfeat, *tparams, (35, 70), sms=1)
    assert (s1 == 1).all() and (s2 == 1).all()
    assert torch.equal(many, one)
    _close(many, ri.fused_resize_island_plain(tfeat, *tparams, (35, 70)),
           "plain")
