"""A6: the fused W-resize + fp32 output island of the DPT head.

Replaces vdn/ops/pallas/resize_island.py ``fused_resize_island``
(``_kernel``): act(conv1x1(relu(conv3x3(resize_bilinear_ac(feat))))) ->
[N, H, W, 1] fp32 without writing the full-resolution C-channel feature to
memory.  The H axis runs first through ``resize_rows`` (A5a) into a
zero-padded plan -- row 0 and the rows past h_out are zeros, the conv's
vertical padding and the tile overrun -- then csrc/resize_island.cu does the
W axis, the 3x3 conv, the 1x1 and the activation per band of output rows.

Rounding points, vdn's kernel's (resize_island.py:132-176): H-resized rows
in the compute dtype; W-resize weights rounded to the compute dtype, fp32
sum, rounded; conv3x3 on compute-dtype operands with fp32 sums, + b1,
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
                               use_kernel, wants_grad)
from vdn_torch.kernels.resize import (cached_on_device, dense_matrix,
                                      dense_plan, plan_key, resize_rows,
                                      resize_rows_plain, rows_plan)
from vdn_torch.ops.resize import plan_axis

TILE_ROWS = 8   # output rows per block of the CUDA kernel (its padding)
# the CUDA kernel's shared-memory limit: all conv weights and a band of
# resized rows; bands of 8 rows up to C 176, of 4 rows up to C 224
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


def padded_h_plan(hidx, hw, h_out: int, hp: int):
    """vdn's _padded_h_resize plan: a zero-weight row on top, then the
    h_out real rows, then zero-weight rows up to hp."""
    taps = hidx.shape[1]
    idx = np.concatenate([hidx[:1], hidx] + [hidx[-1:]] * (hp - h_out - 1))
    w = np.concatenate([np.zeros((1, taps), np.float32), hw,
                        np.zeros((hp - h_out - 1, taps), np.float32)])
    return idx, w


@functools.lru_cache(maxsize=64)
def _column_plan(idx_bytes: bytes, w_bytes: bytes, shape, in_size: int):
    """The nonzeros of each row of the bf16-rounded dense W-resize matrix
    (bilinear: one or two; a row with one gets a zero-weight second tap)."""
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
    return cidx, cw


def column_plan(idx, w, in_size: int, device):
    """(column taps [w_out, 2] int32, weights [w_out, 2] fp32) on device."""
    key = plan_key(idx, w, in_size)
    return cached_on_device(
        ("island_columns",) + key,
        lambda: map(torch.from_numpy, _column_plan(*key)), device)


def island_weights(w1, b1, w2, dt) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(conv weights [O, 9C] in dt, b1 fp32, w2 rounded to dt, as fp32)."""
    kh, kw, c, o = w1.shape
    wt = w1.to(dt).permute(3, 0, 1, 2).reshape(o, kh * kw * c).contiguous()
    return (wt, b1.float().contiguous(),
            w2.reshape(-1).to(dt).float().contiguous())


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
            or w1.shape[2] != c or w1.shape[3] != 32 or c % 16 or c > MAX_C):
        raise ValueError(f"fused_resize_island: kernel takes bf16 feat with C "
                         f"a multiple of 16 up to {MAX_C} and w1 [3, 3, C, 32],"
                         f" got {tuple(feat.shape)} {feat.dtype}, w1 "
                         f"{tuple(w1.shape)}")
    (hidx, hw), (widx, ww) = _plans(h, w, h_out, w_out)
    hp = -(-h_out // TILE_ROWS) * TILE_ROWS + 2
    xh = resize_rows(feat.contiguous(), *padded_h_plan(hidx, hw, h_out, hp),
                     hp)
    cidx, cw = column_plan(widx, ww, w, feat.device)
    wt, b1f, w2f = island_weights(w1, b1, w2, torch.bfloat16)
    b2f = b2.float().reshape(1).contiguous()
    out = torch.empty((n, h_out, w_out), dtype=torch.float32,
                      device=feat.device)
    check_kernel_args("fused_resize_island", xh, cidx, cw, wt, b1f, w2f, b2f,
                      out)
    launch("vdn_resize_island", xh.data_ptr(), n, hp, w, c, h_out, w_out,
           cidx.data_ptr(), cw.data_ptr(), wt.data_ptr(), b1f.data_ptr(),
           w2f.data_ptr(), b2f.data_ptr(), int(bool(sigmoid)),
           float(max_depth), out.data_ptr())
    launches["fused_resize_island"] += 1
    return out[..., None]
