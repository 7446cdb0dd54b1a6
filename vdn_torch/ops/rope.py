"""Rotary position embeddings with real sin / cos pairs (vdn/ops/rope.py).

- 1-D temporal RoPE over the frame axis (``temporal_rope_freqs``):
  frequencies over the full inner dim; the motion modules with
  ``pos_embedding_type="rope"`` rotate q and k [B*N, T, C] before the head
  split, with the table's rows at the rank's global frame offset
  (vdn_torch.nn.motion).
- 2-D axial RoPE over the spatial token grid of the memory attention
  (``axial_rope_freqs``): per-head-dim frequencies, the first half of the
  pairs rotates by x, the second by y; ``repeat_k`` tiles the pattern over
  stacked memory entries.

The tables are numpy, cached per argument set; ``device_tables`` keeps the
most recently used ones on a device, shaped for broadcasting over heads.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple, Union

import numpy as np
import torch

__all__ = ["temporal_rope_freqs", "axial_rope_freqs", "apply_rope",
           "device_tables"]

Table = Union[np.ndarray, torch.Tensor]


@lru_cache(maxsize=64)
def temporal_rope_freqs(dim: int, end: int, theta: float = 10000.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape [end, dim // 2] (pairs interleaved)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    t = np.arange(end, dtype=np.float64)
    angles = np.outer(t, freqs)
    return (np.cos(angles).astype(np.float32),
            np.sin(angles).astype(np.float32))


@lru_cache(maxsize=64)
def axial_rope_freqs(head_dim: int, end_x: int, end_y: int,
                     theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of shape [end_x * end_y, head_dim // 2] for a row-major
    (y, x) token grid: first head_dim // 4 pairs rotate by x, rest by y."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 4)[:quarter] / head_dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    t_x, t_y = t % end_x, np.floor(t / end_x)
    angles = np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)],
                            axis=-1)
    return (np.cos(angles).astype(np.float32),
            np.sin(angles).astype(np.float32))


@lru_cache(maxsize=16)
def device_tables(head_dim: int, end_x: int, end_y: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The axial (cos, sin) as fp32 tensors [T, 1, head_dim // 2] on
    ``device``: they broadcast over the head axis of a [B, T, H, D] tensor.
    The 16 most recently used tables stay on their device."""
    return tuple(torch.from_numpy(a[:, None]).to(device)
                 for a in axial_rope_freqs(head_dim, end_x, end_y))


def apply_rope(x: torch.Tensor, cos: Table, sin: Table,
               repeat_k: int = 1) -> torch.Tensor:
    """Rotate interleaved (even, odd) pairs of the last axis of x in fp32
    and round back to x's dtype.

    cos / sin: [T0, D // 2] tables for x [..., T, D], or [T0, 1, D // 2]
    for x [..., T, H, D] (any number of broadcast axes between the token
    axis and the pairs); T must equal T0 * repeat_k, the ``rope_k_repeat``
    tiling for cross-attention to stacked memories.  The token axis is
    split into (repeat_k, T0) and the table broadcasts over the repeats:
    no tiled copy of it is made."""
    cos = torch.as_tensor(cos, device=x.device)
    sin = torch.as_tensor(sin, device=x.device)
    d = x.shape[-1]
    axis = x.ndim - cos.ndim             # the token axis of x
    t0 = cos.shape[0]
    assert t0 * repeat_k == x.shape[axis] and cos.shape[-1] == d // 2, (
        cos.shape, repeat_k, x.shape)
    xf = x.float().reshape(*x.shape[:axis], repeat_k, t0,
                           *x.shape[axis + 1:-1], d // 2, 2)
    even, odd = xf[..., 0], xf[..., 1]
    out = torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                      dim=-1)
    return out.reshape(x.shape).to(x.dtype)
