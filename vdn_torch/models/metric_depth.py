"""Metric (absolute-scale) depth model (vdn/models/metric_depth.py).

Depth-Anything-V2 with a sigmoid-bounded head scaled by ``max_depth``.  No
memory block; a plain single-image forward.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from vdn_torch.models.presets import build_preset
from vdn_torch.nn.dpt import DPTHead
from vdn_torch.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit


class MetricDepthAnythingV2(nn.Module):
    def __init__(self, encoder: str = "vitl", features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 max_depth: float = 20.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = encoder
        self.max_depth = max_depth
        self.compute_dtype = compute_dtype
        self.pretrained = make_vit(encoder)
        self.depth_head = DPTHead(self.pretrained.embed_dim, features,
                                  out_channels, sigmoid_output=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] -> metric depth [B, H, W] fp32 in meters."""
        b, h, w, _ = x.shape
        ph, pw = h // 14, w // 14
        feats = self.pretrained.get_intermediate_layers(
            x.to(self.compute_dtype), INTERMEDIATE_LAYER_IDX[self.encoder])
        depth = self.depth_head.depth(feats, ph, pw)
        return depth[..., 0].float() * self.max_depth


def build_metric_depth_anything_v2(
        encoder: str = "vitl",
        compute_dtype: Union[torch.dtype, str] = torch.float32,
        device: Union[torch.device, str] = "cuda",
        generator: Optional[torch.Generator] = None,
        **kw) -> MetricDepthAnythingV2:
    """A preset model with parameters drawn from ``generator`` (seed 0 by
    default) with vdn's initializers, in eval mode on ``device``: the card
    unless the caller asks for the CPU.

    On the card pass ``compute_dtype="bf16"``: the attention kernels take
    bf16 only, and from 256 tokens on (any image of 224 x 224 or more) a
    forward in the default fp32 raises ValueError at its first attention.
    fp32 on the card is for reference runs inside
    ``kernels.plain_reference()``."""
    return build_preset(MetricDepthAnythingV2, encoder, compute_dtype, device,
                        generator, **kw)
