"""Host-side least-squares scale/shift and cross-fade for window stitching.

numpy copies of vdn/ops/scale_shift.py ``scale_and_shift_np`` and
``interpolate_frames_np`` (reference utils/util.py:40-74), kept here so the
port imports no JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["scale_and_shift_np", "interpolate_frames_np"]


def scale_and_shift_np(prediction, target, mask):
    prediction = prediction.astype(np.float32)
    target = target.astype(np.float32)
    mask = mask.astype(np.float32)
    a_00 = np.sum(mask * prediction * prediction)
    a_01 = np.sum(mask * prediction)
    a_11 = np.sum(mask)
    b_0 = np.sum(mask * prediction * target)
    b_1 = np.sum(mask * target)
    det = a_00 * a_11 - a_01 * a_01
    if det == 0:
        return 1.0, 0.0
    return ((a_11 * b_0 - a_01 * b_1) / det, (-a_01 * b_0 + a_00 * b_1) / det)


def interpolate_frames_np(frames_pre, frames_post):
    """Linear cross-fade between two equal-length frame lists."""
    assert len(frames_pre) == len(frames_post)
    n = len(frames_pre)
    step = 1.0 / (n - 1)
    weights = [0.0] + [i * step for i in range(1, n - 1)] + [1.0]
    return [frames_pre[i] * (1 - weights[i]) + frames_post[i] * weights[i]
            for i in range(n)]
