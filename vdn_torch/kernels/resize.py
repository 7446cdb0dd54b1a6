"""A5a, A5b and B1: one-axis interpolation and row mixing.

Replace vdn/ops/pallas/resize.py:

- ``resize_rows`` (A5a, ``_rows_kernel``): x [N, R_in, W, C] -> [N, out, W,
  C], each output row a blend of at most MAX_TAPS input rows (4 in a
  forward plan, up to 8 in a backward's transposed one) with fp32 weights,
  summed in fp32 and rounded once to x's dtype (csrc/resize_rows.cu).  A
  plan with more taps (the transposed plan of a large upsample: hieradet's
  bicubic pos-embed, 14 -> 64 rows, has 19) takes A5b's dense form over
  [N, R_in, W * C], as vdn sends a plan its rows kernel does not support
  to ``resize_mid_axis`` (vdn/ops/resize.py:222-232);
- ``resize_mid_axis`` (A5b, ``_resize_kernel``): x [N, R, M] -> [N, S, M],
  out[n, s, m] = sum_r W[s, r] x[n, r, m] with the dense weights rounded to
  x's dtype first and fp32 sums (csrc/resize_mid_axis.cu);
- ``select_rows`` (B1, the same ``_resize_kernel`` with a runtime weight
  slab): the streaming K/V window gather, weights a device tensor [S, R].

The interpolation plans are host numpy (vdn_torch.ops.resize.plan_axis);
their device copies are cached per device.  ``select_rows`` and
``resize_mid_axis`` share one CUDA kernel but keep separate launch counts.

Training: the VJP of a banded interpolation matmul is another one, so
with grad enabled and x requiring it, ``resize_rows`` and
``resize_mid_axis`` run as autograd Functions whose backward is the same
kernel on the transposed plan (``transpose_plan``, vdn/ops/resize.py:
132-199): per input row, the output rows that read it and their weights.
B1 (``select_rows``) has no backward: on the card it raises when grad is
required.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from vdn_torch.kernels import (check_kernel_args, launch, launches,
                               same_dispatch, save_dispatch, use_kernel,
                               wants_grad)

MAX_TAPS = 8   # csrc/resize_rows.cu; 4 forward, up to 8 in a transposed plan
MAX_DEVICE_PLANS = 256   # about ten image sizes' worth of axis plans
_device_plans: "OrderedDict[tuple, Tuple[torch.Tensor, ...]]" = OrderedDict()


@functools.lru_cache(maxsize=256)
def _rows_plan(idx_bytes: bytes, w_bytes: bytes, shape: Tuple[int, int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """vdn's per-row tap list: nonzero taps merged per source row (weights
    summed in float64, then fp32) and sorted by source row.  An all-zero
    row keeps its first tap at weight 0, as vdn does.  Rows are padded to
    the longest with zero-weight taps (which add exact zeros); a plan wider
    than MAX_TAPS is returned as it is and runs dense (``_resize_rows``)."""
    idx = np.frombuffer(idx_bytes, np.int32).reshape(shape)
    w = np.frombuffer(w_bytes, np.float32).reshape(shape)
    rows = []
    for o in range(shape[0]):
        taps: Dict[int, float] = {}
        for t in range(shape[1]):
            if w[o, t] != 0.0:
                i = int(idx[o, t])
                taps[i] = taps.get(i, 0.0) + float(w[o, t])
        rows.append(sorted(taps.items()) or [(int(idx[o, 0]), 0.0)])
    width = max(len(r) for r in rows)
    pidx = np.zeros((shape[0], width), np.int32)
    pw = np.zeros((shape[0], width), np.float32)
    for o, taps in enumerate(rows):
        pidx[o] = taps[0][0]
        for t, (i, wt) in enumerate(taps):
            pidx[o, t], pw[o, t] = i, wt
    return pidx, pw


@functools.lru_cache(maxsize=256)
def dense_matrix(idx_bytes: bytes, w_bytes: bytes, shape: Tuple[int, int],
                in_size: int) -> np.ndarray:
    """[out, in] dense interpolation matrix (vdn's ``_dense_weights``)."""
    idx = np.frombuffer(idx_bytes, np.int32).reshape(shape)
    w = np.frombuffer(w_bytes, np.float32).reshape(shape)
    dense = np.zeros((shape[0], in_size), np.float32)
    o = np.arange(shape[0])
    for tap in range(shape[1]):
        np.add.at(dense, (o, idx[:, tap]), w[:, tap])
    return dense


@functools.lru_cache(maxsize=256)
def _transpose_plan(idx_bytes: bytes, w_bytes: bytes, shape: Tuple[int, int],
                    in_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """vdn/ops/resize.py ``_transpose_plan``: per INPUT row, the output
    rows that read it and their weights (a tap per (output, tap) entry, in
    output order; zero-width rows keep one zero-weight tap)."""
    idx = np.frombuffer(idx_bytes, np.int32).reshape(shape)
    w = np.frombuffer(w_bytes, np.float32).reshape(shape)
    out_size, taps = shape
    buckets = [[] for _ in range(in_size)]
    for o in range(out_size):
        for t in range(taps):
            buckets[int(idx[o, t])].append((o, float(w[o, t])))
    taps_t = max(1, max(len(b) for b in buckets))
    idx_t = np.zeros((in_size, taps_t), np.int32)
    w_t = np.zeros((in_size, taps_t), np.float32)
    for i, b in enumerate(buckets):
        for j, (o, wt) in enumerate(b):
            idx_t[i, j] = o
            w_t[i, j] += wt
    return idx_t, w_t


def transpose_plan(idx: np.ndarray, w: np.ndarray, in_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The plan of the VJP of the interpolation ``(idx, w)`` from
    ``in_size`` rows."""
    return _transpose_plan(*plan_key(idx, w), in_size)


def plan_key(idx: np.ndarray, w: np.ndarray, *extra) -> tuple:
    """A hashable key of a host plan: the arguments of the cached plan
    functions above."""
    idx = np.ascontiguousarray(idx, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    return (idx.tobytes(), w.tobytes(), idx.shape) + extra


def cached_on_device(key: tuple, make, device) -> Tuple[torch.Tensor, ...]:
    """The tensors ``make()`` returns, moved to ``device`` once per key;
    the MAX_DEVICE_PLANS most recently used stay there."""
    k = key + (str(device),)
    if k in _device_plans:
        _device_plans.move_to_end(k)
    else:
        _device_plans[k] = tuple(t.to(device) for t in make())
        if len(_device_plans) > MAX_DEVICE_PLANS:
            _device_plans.popitem(last=False)
    return _device_plans[k]


def rows_plan(idx: np.ndarray, w: np.ndarray, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tap rows [out, taps] int32, tap weights [out, taps] fp32) on
    ``device``."""
    key = plan_key(idx, w)
    return cached_on_device(
        ("rows",) + key, lambda: map(torch.from_numpy, _rows_plan(*key)),
        device)


def dense_plan(idx: np.ndarray, w: np.ndarray, in_size: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """The dense [out, in] weights rounded to ``dtype``, on ``device``."""
    key = plan_key(idx, w, in_size)
    return cached_on_device(
        ("dense", dtype) + key,
        lambda: [torch.from_numpy(dense_matrix(*key)).to(dtype)], device)[0]


# ------------------------------------------------------------- plain versions
def resize_rows_plain(x: torch.Tensor, pidx: torch.Tensor,
                      pw: torch.Tensor) -> torch.Tensor:
    """x [N, R_in, W, C] with the padded tap plan -> [N, out, W, C]: taps
    summed in order in fp32 (fp32 weights), rounded once to x's dtype."""
    acc = None
    for t in range(pidx.shape[1]):
        term = x.index_select(1, pidx[:, t]).float() * pw[:, t].view(
            1, -1, 1, 1)
        acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def mix_rows_plain(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """x [N, R, M], weights [S, R] already in x's dtype -> [N, S, M]:
    fp32 sums, rounded once to x's dtype."""
    return torch.matmul(weights.float(), x.float()).to(x.dtype)


# ------------------------------------------------------------- wrappers
def _check_dtype(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: kernel takes bf16 or fp32, got {x.dtype}")


def _vec(x: torch.Tensor, row_elems: int, *ptrs: torch.Tensor) -> int:
    """Elements per 16-byte access where rows and pointers allow it."""
    vec = 16 // x.element_size()
    if row_elems % vec or any(t.data_ptr() % 16 for t in ptrs):
        return 1
    return vec


class _Resize(torch.autograd.Function):
    """A resize along one axis (``impl`` = _resize_rows or _resize_mid);
    its backward is the same kernel on the transposed plan."""

    @staticmethod
    def forward(ctx, x, impl, idx, w, out_size):
        ctx.impl, ctx.plan, ctx.in_size = impl, (idx, w), x.shape[1]
        save_dispatch(ctx)
        return impl(x, idx, w, out_size)

    @staticmethod
    def backward(ctx, g):
        idx_t, w_t = transpose_plan(*ctx.plan, ctx.in_size)
        with same_dispatch(ctx):
            return (ctx.impl(g.contiguous(), idx_t, w_t, ctx.in_size),
                    None, None, None, None)


def resize_rows(x: torch.Tensor, idx: np.ndarray, w: np.ndarray,
                out_size: int) -> torch.Tensor:
    """x [N, R_in, W, C] -> [N, out_size, W, C]: per output row o,
    sum_t w[o, t] * x[:, idx[o, t]] (the H axis of an NHWC resize).
    Differentiable (the transposed plan) where grad is enabled and x
    requires it."""
    if wants_grad(x):
        return _Resize.apply(x, _resize_rows, idx, w, out_size)
    return _resize_rows(x, idx, w, out_size)


def _resize_rows(x: torch.Tensor, idx: np.ndarray, w: np.ndarray,
                 out_size: int) -> torch.Tensor:
    pidx, pw = rows_plan(idx, w, x.device)
    if pidx.shape[0] != out_size:
        raise ValueError("resize_rows: plan rows != out_size")
    if pidx.shape[1] > MAX_TAPS:
        # the same blend through the dense weights: a plan [N, R, W, C]
        # over its H axis is A5b's [N, R, W * C]
        n, r_in, wd, c = x.shape
        y = _resize_mid(x.reshape(n, r_in, wd * c), idx, w, out_size)
        return y.reshape(n, out_size, wd, c)
    if not use_kernel(x):
        return resize_rows_plain(x, pidx, pw)
    _check_dtype("resize_rows", x)
    x = x.contiguous()
    n, r_in, wd, c = x.shape
    out = torch.empty((n, out_size, wd, c), dtype=x.dtype, device=x.device)
    check_kernel_args("resize_rows", x, pidx, pw, out, aligned=False)
    if n > 65535:
        raise ValueError(f"resize_rows: N = {n} > 65535")
    row = wd * c
    launch("vdn_resize_rows", x.data_ptr(), n, r_in, row, out_size,
           pidx.shape[1], pidx.data_ptr(), pw.data_ptr(), out.data_ptr(),
           int(x.dtype == torch.bfloat16), _vec(x, row, x, out))
    launches["resize_rows"] += 1
    return out


def _mix_rows(name: str, x: torch.Tensor, weights: torch.Tensor
              ) -> torch.Tensor:
    if not use_kernel(x):
        return mix_rows_plain(x, weights)
    if name == "select_rows" and wants_grad(x, weights):
        raise RuntimeError("select_rows: the kernel has no backward; run "
                           "under torch.no_grad()")
    _check_dtype(name, x)
    x = x.contiguous()
    weights = weights.contiguous()
    n, r, m = x.shape
    s = weights.shape[0]
    if weights.shape[1] != r:
        raise ValueError(f"{name}: weights {tuple(weights.shape)} vs x "
                         f"rows {r}")
    out = torch.empty((n, s, m), dtype=x.dtype, device=x.device)
    check_kernel_args(name, x, weights, out, aligned=False)
    launch("vdn_resize_mid_axis", x.data_ptr(), n, r, m, s,
           weights.data_ptr(), out.data_ptr(),
           int(x.dtype == torch.bfloat16), _vec(x, m, x, out))
    launches[name] += 1
    return out


def resize_mid_axis(x: torch.Tensor, idx: np.ndarray, w: np.ndarray,
                    out_size: int) -> torch.Tensor:
    """x [N, R_in, M] -> [N, out_size, M] with out[:, o] = sum_t w[o, t] *
    x[:, idx[o, t]], through the dense weights rounded to x's dtype.
    Differentiable (the transposed plan) where grad is enabled and x
    requires it."""
    if wants_grad(x):
        return _Resize.apply(x, _resize_mid, idx, w, out_size)
    return _resize_mid(x, idx, w, out_size)


def _resize_mid(x: torch.Tensor, idx: np.ndarray, w: np.ndarray,
                out_size: int) -> torch.Tensor:
    weights = dense_plan(idx, w, x.shape[1], x.dtype, x.device)
    if weights.shape[0] != out_size:
        raise ValueError("resize_mid_axis: plan rows != out_size")
    return _mix_rows("resize_mid_axis", x, weights)


def select_rows(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """x [N, R, M] x runtime weights [S, R] -> [N, S, M] (the streaming
    window gather with a one-hot slab: exact, one 1.0 term per row)."""
    return _mix_rows("select_rows", x, weights.to(x.dtype))
