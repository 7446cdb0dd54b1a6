"""Torch-convention 2-D interpolation for NHWC tensors.

The counterpart of vdn/ops/resize.py on the clip path: bilinear with
align_corners=True (DPT fusion upsamples, the output island, the final
depth resize) and bicubic (A = -0.75) with an explicit ``scale_factor``
for the ViT pos-embed (offset 0.1).  Both run as ``F.interpolate`` on a
channels-last view, as the JAX package's configuration with
``VDN_PALLAS_RESIZE=0`` runs them through XLA.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["resize2d", "rescale2d"]


def _interpolate_nhwc(x: torch.Tensor, **kw) -> torch.Tensor:
    h, w, c = x.shape[-3:]
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2), **kw)
    return y.permute(0, 2, 3, 1).reshape(*x.shape[:-3], *y.shape[2:], c)


def resize2d(x: torch.Tensor, out_hw: Sequence[int], method: str = "bilinear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize the two spatial axes of an [..., H, W, C] tensor to out_hw."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if out_hw == tuple(x.shape[-3:-1]):
        return x
    return _interpolate_nhwc(x, size=out_hw, mode=method,
                             align_corners=align_corners)


def rescale2d(x: torch.Tensor, scale_factor: Tuple[float, float],
              method: str = "bicubic") -> torch.Tensor:
    """Resize an [..., H, W, C] tensor with torch's ``scale_factor=``
    coordinate mapping: the output is floor(in * scale), and source
    coordinates are scaled by 1 / scale, not by in / out."""
    return _interpolate_nhwc(x, scale_factor=tuple(scale_factor), mode=method,
                             align_corners=False)
