"""Torch-convention 2-D interpolation for NHWC tensors (vdn/ops/resize.py).

The reference leans on ``F.interpolate`` on the clip path in two
conventions: bilinear with align_corners=True (DPT fusion upsamples, the
output island, the final depth resize) and bicubic (A = -0.75) with an
explicit ``scale_factor`` (the ViT pos-embed, offset 0.1); SAM2 adds
``nearest`` (its FPN's top-down 2x) and ``bilinear_aa``, torch's
antialiased bilinear (the mask prompt's 1024 -> 256 downsample: 8 nonzero
taps a row at 4x; upsampling it is plain half-pixel bilinear).  As in
vdn, each axis gets a host-built plan -- per output index the source taps
and their weights, computed the way torch computes them -- and the two
axes run one after the other, each rounded to the input dtype:

- the H axis through ``resize_rows`` (A5a): fp32 tap weights and sums;
- the W axis through ``resize_mid_axis`` (A5b): the dense weights rounded
  to the input dtype, fp32 sums.

These are the rounding points of vdn's Pallas path (``_rows_kernel`` and
``_resize_kernel``), which a single 2-D ``F.interpolate`` does not have.
An axis whose plan is the identity is skipped.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vdn_torch.kernels.resize import resize_mid_axis, resize_rows

__all__ = ["plan_axis", "resize2d", "rescale2d"]


def _source_coords(out_size: int, in_size: int, align_corners: bool,
                   scale: Optional[float], cubic: bool) -> np.ndarray:
    """Fractional source coordinate for each output index (torch convention)."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size <= 1:
            return np.zeros((out_size,), dtype=np.float64)
        return dst * (in_size - 1) / (out_size - 1)
    # half-pixel; an explicit scale_factor is used as given, not out / in
    inv_scale = (1.0 / scale) if scale is not None else (in_size / out_size)
    src = (dst + 0.5) * inv_scale - 0.5
    if not cubic:
        # torch clamps the source index at 0 for linear (not for cubic)
        src = np.maximum(src, 0.0)
    return src


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Torch's 4-tap cubic convolution weights for fractional offset t,
    taps at offsets (-1, 0, 1, 2) from floor(src)."""
    def k1(x):  # |x| in [0, 1]
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k2(x):  # |x| in [1, 2]
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return np.stack([k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)], axis=-1)


def _antialias_plan(out_size: int, in_size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """torch's antialiased bilinear (aten's _compute_indices_weights_aa):
    a triangle filter widened by the downsampling factor, weights
    normalized per output; ceil(support) * 2 + 1 taps, the unused ones 0."""
    s = in_size / out_size
    support = s if s > 1.0 else 1.0
    inv = (1.0 / s) if s > 1.0 else 1.0
    max_taps = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, max_taps), np.int64)
    w = np.zeros((out_size, max_taps), np.float64)
    for o in range(out_size):
        center = s * (o + 0.5)
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        for j in range(xmax - xmin):
            w[o, j] = max(0.0, 1.0 - abs((j + xmin - center + 0.5) * inv))
            idx[o, j] = xmin + j
        tot = w[o].sum()
        if tot > 0:
            w[o] /= tot
    return idx.astype(np.int32), w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def plan_axis(out_size: int, in_size: int, method: str, align_corners: bool,
              scale: Optional[float]) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [out, taps] int32, weights [out, taps] fp32) of one axis:
    "bilinear" or "bicubic" (align_corners and scale as torch's),
    "bilinear_aa" or "nearest" (torch's floor(o * in / out); both ignore
    align_corners and scale, as vdn's plans do)."""
    if method == "bilinear_aa":
        return _antialias_plan(out_size, in_size)
    if method == "nearest":
        src = np.floor(np.arange(out_size, dtype=np.float64) * in_size
                       / out_size)
        idx = np.clip(src.astype(np.int64), 0, in_size - 1)
        return (idx.astype(np.int32)[:, None],
                np.ones((out_size, 1), np.float32))
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"resize method {method!r}: bilinear, bicubic, "
                         f"bilinear_aa or nearest")
    cubic = method == "bicubic"
    src = _source_coords(out_size, in_size, align_corners, scale, cubic)
    base = np.floor(src)
    t = src - base
    base = base.astype(np.int64)
    if cubic:
        w = _cubic_weights(t)
        idx = base[:, None] + np.arange(-1, 3)[None, :]
    else:
        w = np.stack([1.0 - t, t], axis=-1)
        idx = base[:, None] + np.arange(0, 2)[None, :]
    # torch clamps the tap index (replicate border), keeping the weight
    idx = np.clip(idx, 0, in_size - 1)
    return idx.astype(np.int32), w.astype(np.float32)


def _is_identity(idx: np.ndarray, w: np.ndarray, in_size: int) -> bool:
    """One tap of weight 1 mapping i -> i (vdn's identity shortcut)."""
    out_size, taps = idx.shape
    if out_size != in_size:
        return False
    hot = np.argmax(w, axis=1)
    rows = np.arange(out_size)
    return bool(np.allclose(w[rows, hot], 1.0)
                and np.allclose(np.where(np.arange(taps)[None] == hot[:, None],
                                         0, w), 0.0)
                and np.array_equal(idx[rows, hot], np.arange(in_size)))


def _resize(x: torch.Tensor, out_h: int, out_w: int, method: str,
            align_corners: bool, sh: Optional[float],
            sw: Optional[float]) -> torch.Tensor:
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    n = int(np.prod(lead, dtype=np.int64)) if lead else 1
    idx, wt = plan_axis(out_h, h, method, align_corners, sh)
    if not _is_identity(idx, wt, h):
        x = resize_rows(x.reshape(n, h, w, c), idx, wt, out_h)
        h = out_h
    idx, wt = plan_axis(out_w, w, method, align_corners, sw)
    if not _is_identity(idx, wt, w):
        x = resize_mid_axis(x.reshape(n * h, w, c), idx, wt, out_w)
        w = out_w
    return x.reshape(*lead, h, w, c)


def resize2d(x: torch.Tensor, out_hw: Sequence[int], method: str = "bilinear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize the two spatial axes of an [..., H, W, C] tensor to out_hw."""
    return _resize(x, int(out_hw[0]), int(out_hw[1]), method, align_corners,
                   None, None)


def rescale2d(x: torch.Tensor, scale_factor: Tuple[float, float],
              method: str = "bicubic") -> torch.Tensor:
    """Resize an [..., H, W, C] tensor with torch's ``scale_factor=``
    coordinate mapping: the output is floor(in * scale), and source
    coordinates are scaled by 1 / scale, not by in / out."""
    sh, sw = (float(s) for s in scale_factor)
    h, w = x.shape[-3], x.shape[-2]
    return _resize(x, int(np.floor(h * sh)), int(np.floor(w * sw)), method,
                   False, sh, sw)
