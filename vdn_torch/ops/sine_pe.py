"""2-D sine / cosine position embedding, SAM2 convention
(vdn/ops/sine_pe.py).

PositionEmbeddingSine with normalize=True and scale 2 pi as a cached numpy
table: channels = [y sines / cosines | x sines / cosines], NHWC.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = ["sine_position_embedding_2d"]


@lru_cache(maxsize=32)
def sine_position_embedding_2d(h: int, w: int, channels: int,
                               temperature: float = 10000.0) -> np.ndarray:
    """Returns [h, w, channels] fp32 (channels must be even)."""
    assert channels % 2 == 0
    num_feats = channels // 2
    scale = 2 * math.pi
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.ones((h, 1)) * np.arange(1, w + 1, dtype=np.float64)[None, :]
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale

    dim_t = np.arange(num_feats, dtype=np.float64)
    dim_t = temperature ** (2 * np.floor(dim_t / 2) / num_feats)

    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    # interleave sin(even) / cos(odd)
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]),
                      np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]),
                      np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)
