"""A6: the fused resize + fp32 output island of the DPT head.

Replaces vdn/ops/pallas/resize_island.py ``fused_resize_island``
(``_kernel``, with its H pass ``_padded_h_resize``):
act(conv1x1(relu(conv3x3(resize_bilinear_ac(feat))))) -> [N, H, W, 1] fp32
without writing the full-resolution C-channel feature, or its H-resized
half, to memory.  One launch (csrc/resize_island.cu): persistent blocks
walk ``island_plan``'s items (frame, run of output rows, strip of
ISLAND_STRIP output columns); in each, producer warpgroups build the
resized rows (the H pass, then the W pass) into a ring in shared memory
while a consumer warpgroup runs the 3x3 conv on wgmma from the ring and
the block's resident weights (each ring row once, against the three dy
blocks of a dx at a time), then the 1x1 and the activation.

Rounding points, vdn's kernel's (resize_island.py:132-176): H-resized rows
in the compute dtype (resize_rows' fp32 sums of the merged, sorted taps,
zero-weight taps skipped); W-resize weights rounded to the compute dtype,
fp32 sum, rounded; conv3x3 on compute-dtype operands with fp32 sums, + b1,
ReLU, rounded to the compute dtype; the 1x1 with compute-dtype weights,
fp32 sum, + b2, then ReLU (or sigmoid * max_depth).  The TPU's lane packing
(4 output columns per 128 lanes) does not carry over: the conv runs on the
resized image with zero padding 1.  Weights in vdn's layout: w1 [3, 3, C,
O], b1 [O], w2 [O, 1], b2 [1].

Training: vdn's backward recomputes the composite the kernel replaces
(resize_island.py:233-282): with grad enabled and an input requiring it,
A6 runs as an autograd Function whose backward is autograd of
``island_composite`` -- the bilinear resize through A5a / A5b (their
transposed-plan backwards included), then the 3x3 and 1x1 convs in fp32
-- for the inputs that require grad.  It forms the full-resolution
C-channel feature once more, vdn's own memory trade.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vdn_torch.kernels import (check_kernel_args, grads_of_plain, launch,
                               launches, same_dispatch, save_dispatch,
                               sm_count, use_kernel, wants_grad)
from vdn_torch.kernels.resize import (_rows_plan, cached_on_device,
                                      dense_matrix, dense_plan, plan_key,
                                      resize_rows_plain, rows_plan)
from vdn_torch.ops.resize import plan_axis

ISLAND_STRIP = 64   # output columns of an item (the kernel's wgmma M)
ISLAND_COLS = ISLAND_STRIP + 2   # resized columns a ring row holds
ISLAND_O = 32       # conv3x3 output channels (wgmma N)
# the weights ([32, 9C] bf16), a ring of three resized rows and the two
# staging rows fit a block's shared memory up to C 224 (above C 192 the
# channels go through the staging rows in groups; the kernel picks the
# ring and the groups, csrc/resize_island.cu pick_ring)
MAX_C = 224


def _plans(h_in: int, w_in: int, h_out: int, w_out: int):
    return (plan_axis(h_out, h_in, "bilinear", True, None),
            plan_axis(w_out, w_in, "bilinear", True, None))


def fused_resize_island_plain(feat, w1, b1, w2, b2, out_hw: Sequence[int],
                              sigmoid: bool = False,
                              max_depth: float = 1.0) -> torch.Tensor:
    """The same function in torch, step by step, with the kernel's
    rounding points."""
    n, h, w, c = feat.shape
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    dt = feat.dtype
    (hidx, hw), (widx, ww) = _plans(h, w, h_out, w_out)
    xh = resize_rows_plain(feat, *rows_plan(hidx, hw, feat.device))
    rw = dense_plan(widx, ww, w, dt, feat.device)             # [w_out, w]
    up = torch.einsum("xw,nhwc->nhxc", rw.float(), xh.float()).to(dt)
    acc = F.conv2d(up.float().permute(0, 3, 1, 2),
                   w1.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = torch.relu(acc + b1.float().view(1, -1, 1, 1)).to(dt)
    z = torch.einsum("nohw,o->nhw", y.float(), w2.reshape(-1).to(dt).float())
    z = z + b2.float().reshape(())
    z = torch.sigmoid(z) * max_depth if sigmoid else torch.relu(z)
    return z[..., None]


@functools.lru_cache(maxsize=64)
def _column_plan(idx_bytes: bytes, w_bytes: bytes, shape, in_size: int):
    """The nonzeros of each row of the bf16-rounded dense W-resize matrix
    (bilinear: one or two; a row with one gets a zero-weight second tap
    on its first column)."""
    dense = dense_matrix(idx_bytes, w_bytes, shape, in_size)
    dense = torch.from_numpy(dense).to(torch.bfloat16).float().numpy()
    cidx = np.zeros((shape[0], 2), np.int32)
    cw = np.zeros((shape[0], 2), np.float32)
    for o in range(shape[0]):
        nz = np.flatnonzero(dense[o])
        if len(nz) > 2:
            raise ValueError("fused_resize_island: a W-resize row has more "
                             "than two taps")
        cidx[o, :len(nz)], cw[o, :len(nz)] = nz, dense[o, nz]
        if len(nz) == 1:
            cidx[o, 1] = nz[0]
    return cidx, cw


def strip_origins(w_out: int) -> Tuple[int, ...]:
    """The first output column of each strip: ISLAND_STRIP apart, the last
    shifted to end at w_out (or at 0 where w_out < ISLAND_STRIP)."""
    return tuple(min(ISLAND_STRIP * s, max(0, w_out - ISLAND_STRIP))
                 for s in range(-(-w_out // ISLAND_STRIP)))


@functools.lru_cache(maxsize=256)
def island_plan(n: int, h_out: int, w_out: int, sms: int) -> dict:
    """A6's launch for n frames of h_out x w_out output pixels on a card
    of ``sms`` SMs.  Items are (frame, run of output rows,
    strip of ISLAND_STRIP output columns), strip fastest: item i is strip
    i % strips, run (i // strips) % runs, frame i // (strips runs); the
    last strip is shifted to end at w_out (x0), and stores only from
    ISLAND_STRIP * its index.  The runs are the split of h_out that
    minimises the rows of the busiest block (each item builds its rows and
    one more above and below); the persistent blocks are min(items, sms),
    block k taking items k, k + grid, ..."""
    x0 = strip_origins(w_out)
    strips = len(x0)
    best = None
    for want in range(1, h_out + 1):
        run_rows = -(-h_out // want)
        runs = -(-h_out // run_rows)
        items = n * strips * runs
        busiest = -(-items // min(items, sms)) * (run_rows + 2)
        if best is None or (busiest, items) < best[0]:
            best = ((busiest, items), runs, run_rows)
    (_, items), runs, run_rows = best
    return {"strips": strips, "x0": x0, "runs": runs, "run_rows": run_rows,
            "items": items, "grid": min(items, sms)}


@functools.lru_cache(maxsize=64)
def _island_tables(h_in: int, w_in: int, h_out: int, w_out: int):
    """(itab int32, ftab fp32, src_cols) of csrc/resize_island.cu: H taps
    and weights [h_out, 2] (``rows_plan``'s, a one-tap row padded with a
    zero-weight tap), W taps and weights [w_out, 2] (``_column_plan``'s),
    per strip (x0, first source column); src_cols the most source columns
    a strip reads."""
    (hidx, hw), (widx, ww) = _plans(h_in, w_in, h_out, w_out)
    pidx, pw = _rows_plan(*plan_key(hidx, hw))
    if pidx.shape[1] > 2:
        raise ValueError("fused_resize_island: an H-resize row has more "
                         "than two taps")
    if pidx.shape[1] == 1:
        pidx, pw = np.repeat(pidx, 2, 1), np.pad(pw, ((0, 0), (0, 1)))
    cidx, cw = _column_plan(*plan_key(widx, ww, w_in))
    spans = []
    for x in strip_origins(w_out):
        cols = cidx[max(x - 1, 0):min(x + ISLAND_STRIP + 1, w_out)]
        spans.append((int(cols.min()), int(cols.max())))
    src_cols = max(hi - lo + 1 for lo, hi in spans)
    strips = [(x, min(lo, w_in - src_cols))
              for x, (lo, _) in zip(strip_origins(w_out), spans)]
    itab = np.concatenate([pidx.reshape(-1), cidx.reshape(-1),
                           np.asarray(strips, np.int32).reshape(-1)])
    ftab = np.concatenate([pw.reshape(-1), cw.reshape(-1)])
    return itab.astype(np.int32), ftab.astype(np.float32), src_cols


def island_tables(h_in: int, w_in: int, h_out: int, w_out: int, device):
    """(itab, ftab) on ``device`` and src_cols (see ``_island_tables``)."""
    itab, ftab, src_cols = _island_tables(h_in, w_in, h_out, w_out)
    tabs = cached_on_device(("island", h_in, w_in, h_out, w_out),
                            lambda: (torch.from_numpy(itab),
                                     torch.from_numpy(ftab)), device)
    return tabs[0], tabs[1], src_cols


def island_weights(w1, b1, w2) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(conv weights rounded to bf16 in the kernel's K-major B layout, one
    block per dx: [3 dx, C / 8, 3 dy * O, 8], element [dx, ci // 8, dy * O
    + o, ci % 8] = w1[dy, dx, ci, o], one copy from w1 as it is laid out;
    b1 and w2 [O] fp32, w2 rounded to bf16 by the kernel).  The model's
    fp32 b1 and w2 come back as they are."""
    kh, kw, c, o = w1.shape
    wt = torch.empty((kw, c // 8, kh * o, 8), dtype=torch.bfloat16,
                     device=w1.device)
    wt.view(kw, c // 8, kh, o, 8).copy_(
        w1.unflatten(2, (c // 8, 8)).permute(1, 2, 0, 4, 3))
    return (wt, b1.float().contiguous(),
            w2.reshape(-1).float().contiguous())


def island_composite(feat, w1, b1, w2, b2, out_hw: Sequence[int],
                     sigmoid: bool = False,
                     max_depth: float = 1.0) -> torch.Tensor:
    """The unfused path A6 replaces (vdn's _composite_reference with
    packed_island_head): the align-corners bilinear resize in feat's dtype
    (vdn_torch.ops.resize), conv3x3 on operands in that dtype summed in
    fp32, + b1, ReLU, the 1x1 in fp32, + b2, the activation."""
    from vdn_torch.ops.resize import resize2d
    dt = feat.dtype
    up = resize2d(feat, out_hw, "bilinear", align_corners=True)
    y = F.conv2d(up.permute(0, 3, 1, 2).float(),
                 w1.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = torch.relu(y + b1.float().view(1, -1, 1, 1))
    z = torch.einsum("nohw,o->nhw", y, w2.reshape(-1).float())
    z = z + b2.float().reshape(())
    z = torch.sigmoid(z) * max_depth if sigmoid else torch.relu(z)
    return z[..., None]


class _ResizeIsland(torch.autograd.Function):
    """A6 forward; autograd of the recomputed composite backward."""

    @staticmethod
    def forward(ctx, feat, w1, b1, w2, b2, out_hw, sigmoid, max_depth):
        ctx.save_for_backward(feat, w1, b1, w2, b2)
        ctx.args = (tuple(out_hw), sigmoid, max_depth)
        save_dispatch(ctx)
        return _forward(feat, w1, b1, w2, b2, out_hw, sigmoid, max_depth)

    @staticmethod
    def backward(ctx, g):
        args = ctx.args
        with same_dispatch(ctx):
            return (*grads_of_plain(
                lambda *a: island_composite(*a, *args), ctx.saved_tensors,
                ctx.needs_input_grad[:5], g), None, None, None)


def fused_resize_island(feat, w1, b1, w2, b2, out_hw: Sequence[int],
                        sigmoid: bool = False,
                        max_depth: float = 1.0) -> torch.Tensor:
    """feat [N, h, w, C] -> [N, H, W, 1] fp32 (see the module docstring).
    Differentiable (composite recompute) where grad is enabled and an
    input requires it."""
    if wants_grad(feat, w1, b1, w2, b2):
        return _ResizeIsland.apply(feat, w1, b1, w2, b2, out_hw, sigmoid,
                                   max_depth)
    return _forward(feat, w1, b1, w2, b2, out_hw, sigmoid, max_depth)


def _forward(feat, w1, b1, w2, b2, out_hw, sigmoid, max_depth):
    if not use_kernel(feat):
        return fused_resize_island_plain(feat, w1, b1, w2, b2, out_hw,
                                         sigmoid, max_depth)
    n, h, w, c = feat.shape
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    if (feat.dtype != torch.bfloat16 or tuple(w1.shape[:2]) != (3, 3)
            or w1.shape[2] != c or w1.shape[3] != ISLAND_O or c % 16
            or c > MAX_C):
        raise ValueError(f"fused_resize_island: kernel takes bf16 feat with C "
                         f"a multiple of 16 up to {MAX_C} and w1 [3, 3, C, "
                         f"{ISLAND_O}], got {tuple(feat.shape)} {feat.dtype}, "
                         f"w1 {tuple(w1.shape)}")
    itab, ftab, src_cols = island_tables(h, w, h_out, w_out, feat.device)
    plan = island_plan(n, h_out, w_out, sm_count(feat.device.index))
    feat = feat.contiguous()
    wt, b1f, w2f = island_weights(w1, b1, w2)
    b2f = b2.float().reshape(1).contiguous()
    out = torch.empty((n, h_out, w_out), dtype=torch.float32,
                      device=feat.device)
    check_kernel_args("fused_resize_island", feat, itab, ftab, wt, b1f, w2f,
                      b2f, out)
    launch("vdn_resize_island", feat.data_ptr(), n, h, w, c, h_out, w_out,
           itab.data_ptr(), ftab.data_ptr(), plan["strips"], plan["runs"],
           plan["run_rows"], src_cols, wt.data_ptr(), b1f.data_ptr(), w2f.data_ptr(), b2f.data_ptr(),
           int(bool(sigmoid)), float(max_depth), out.data_ptr(),
           plan["grid"])
    launches["fused_resize_island"] += 1
    return out[..., None]
