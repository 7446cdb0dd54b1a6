"""Depth evaluation metric suite (numpy, host-side; vdn/eval/metrics.py).

The reference depthcrafter metrics
(reference eval_depthcrafter/metric.py:3-171): per-frame masked means
averaged over frames, matching the torch semantics including the
"zero-out invalid then divide by valid count" convention.

Shapes: [T, H, W] (sequence of frames); valid_mask boolean.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["EVAL_METRICS", "compute_metrics", "depth2disparity"]


def _frame_mean(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    v = np.where(mask, values, 0.0)
    n = mask.sum(axis=(-1, -2))
    return v.sum(axis=(-1, -2)) / n


def abs_relative_difference(output, target, valid_mask):
    return _frame_mean(np.abs(output - target) / target, valid_mask).mean()


def abs_difference(output, target, valid_mask):
    return _frame_mean(np.abs(output - target), valid_mask).mean()


def squared_relative_difference(output, target, valid_mask):
    return _frame_mean(np.abs(output - target) ** 2 / target,
                       valid_mask).mean()


def rmse_linear(output, target, valid_mask):
    mse = _frame_mean((output - target) ** 2, valid_mask)
    return np.sqrt(mse).mean()


def rmse_log(output, target, valid_mask):
    d = np.where(valid_mask, np.log(output) - np.log(target), 0.0)
    mse = d ** 2
    n = valid_mask.sum(axis=(-1, -2))
    return np.sqrt(mse.sum(axis=(-1, -2)) / n).mean()


def log10(output, target, valid_mask):
    d = np.abs(np.log10(output) - np.log10(target))
    return d[valid_mask].mean()


def _threshold_percentage(output, target, thr, valid_mask):
    ratio = np.maximum(output / target, target / output)
    return _frame_mean((ratio < thr).astype(np.float64), valid_mask).mean()


def delta1_acc(output, target, valid_mask):
    return _threshold_percentage(output, target, 1.25, valid_mask)


def delta2_acc(output, target, valid_mask):
    return _threshold_percentage(output, target, 1.25 ** 2, valid_mask)


def delta3_acc(output, target, valid_mask):
    return _threshold_percentage(output, target, 1.25 ** 3, valid_mask)


def i_rmse(output, target, valid_mask):
    d = np.where(valid_mask, 1.0 / output - 1.0 / target, 0.0)
    n = valid_mask.sum(axis=(-1, -2))
    return np.sqrt((d ** 2).sum(axis=(-1, -2)) / n).mean()


def silog_rmse(output, target, valid_mask):
    d = np.where(valid_mask, np.log(output) - np.log(target), 0.0)
    n = valid_mask.sum(axis=(-1, -2))
    first = (d ** 2).sum(axis=(-1, -2)) / n
    second = d.sum(axis=(-1, -2)) ** 2 / (n.astype(np.float64) ** 2)
    return np.sqrt((first - second).mean()) * 100


def temporal_gradient_matching_error(output, target, valid_mask,
                                     threshold: float = 0.05):
    """TGM (reference metric.py:3-33): masked |d pred - d gt| along AXIS 1
    where the gt gradient is below threshold.

    Replicated literally: the reference metric is written for [B, S, H, W]
    (axis 1 = time) but the eval protocol feeds it [T, H, W]
    (eval.py:129-148), so in practice the published protocol differences
    along the H axis.  We follow the reference byte-for-byte; pass 4-D
    input to get true temporal gradients."""
    pg = output[:, 1:] - output[:, :-1]
    tg = target[:, 1:] - target[:, :-1]
    mask = (tg < threshold) & valid_mask[:, :-1]
    diff = np.where(mask, np.abs(pg - tg), 0.0)
    n = mask.sum(axis=(-1, -2))
    return (diff.sum(axis=(-1, -2)) / n).mean()


EVAL_METRICS: Sequence[str] = (
    "abs_relative_difference",
    "delta1_acc",
    "temporal_gradient_matching_error",
    "abs_difference",
    "rmse_linear",
    "delta2_acc",
    "delta3_acc",
)

_ALL = {name: fn for name, fn in list(globals().items())
        if callable(fn) and not name.startswith("_")}


def depth2disparity(depth: np.ndarray) -> np.ndarray:
    disp = np.zeros_like(depth)
    pos = depth > 0
    disp[pos] = 1.0 / depth[pos]
    return disp


def compute_metrics(pred_depth: np.ndarray, gt_depth: np.ndarray,
                    valid_mask: np.ndarray,
                    names: Sequence[str] = EVAL_METRICS
                    ) -> Dict[str, float]:
    """Drops frames with no valid pixels (reference eval.py:139-144)."""
    frame_valid = valid_mask.sum(axis=(-1, -2)) > 0
    p = pred_depth[frame_valid].astype(np.float64)
    g = gt_depth[frame_valid].astype(np.float64)
    m = valid_mask[frame_valid]
    return {name: float(_ALL[name](p, g, m)) for name in names}
