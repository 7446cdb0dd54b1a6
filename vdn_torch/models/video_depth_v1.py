"""The v1 research model: dual Hiera encoders and the sangyu
spatio-temporal head (vdn/models/video_depth_v1.py; reference
models/video_depth_model.py:18-127).

One Hiera encodes the RGB frames, a second one [depth, nx, ny] (the input
depth and the first two components of its normal map); their pyramids are
summed level by level, the sangyu head decodes them to (depth, dx, dy),
and the normal is rebuilt as [-dx, -dy, 1].

Encoders: hub names ending in ``_224`` (``hiera_base_224``, the
reference's own) take the plain MAE Hiera (vdn_torch.nn.hiera_mae), bare
names (``hiera_base``) SAM2's hieradet (vdn_torch.nn.hiera).  At 256 x 256
and above hieradet's global blocks run kernel C2 and, in training, D2;
the head's resizes run A5a / A5b.

The reference reinterprets NHWC encoder features as NCHW with ``.view``
(video_depth_model.py:96-97) and its checkpoints are trained with that
relabeling: ``scrambled_layout=True`` (default) repeats it,
``scrambled_layout=False`` wires NHWC consistently.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vdn_torch.nn.hiera import HIERA_CONFIGS, make_hiera
from vdn_torch.nn.hiera_mae import HIERA_MAE_CONFIGS, make_hiera_mae
from vdn_torch.nn.layers import init_parameters
from vdn_torch.nn.video_heads import VideoDepthHeadSangyu
from vdn_torch.ops.normals import normal_vector
from vdn_torch.ops.resize import resize2d


class VideoDepthEstimationModel(nn.Module):
    def __init__(self, sequence_length: int = 8,
                 attention_feature_levels: Sequence[int] = (2, 3),
                 encoder: str = "hiera_base", use_residual: bool = False,
                 use_final_relu: bool = False,
                 use_depth_feature: bool = True,
                 use_rgb_feature: bool = True,
                 scrambled_layout: bool = True):
        super().__init__()
        self.use_residual, self.use_final_relu = use_residual, use_final_relu
        self.use_depth_feature = use_depth_feature
        self.use_rgb_feature = use_rgb_feature
        self.scrambled_layout = scrambled_layout
        if encoder in HIERA_MAE_CONFIGS:
            make = lambda: make_hiera_mae(encoder)  # noqa: E731
            dim0 = HIERA_MAE_CONFIGS[encoder]["embed_dim"]
        else:
            make = lambda: make_hiera(encoder)  # noqa: E731
            dim0 = HIERA_CONFIGS[encoder]["embed_dim"]
        self.img_encoder = make()
        self.encoder = make()
        self.head = VideoDepthHeadSangyu(
            sequence_length=sequence_length,
            attention_feature_levels=tuple(attention_feature_levels),
            feature_channels=tuple(dim0 * 2 ** i for i in range(4)))

    @staticmethod
    def _pyramid(enc: nn.Module, x: torch.Tensor):
        out = enc(x)
        # the MAE family returns (pooled, intermediates); the reference
        # drops the first (hiera_image_encoder.py:58)
        return out[1] if isinstance(out, tuple) else out

    def forward(self, depth: torch.Tensor, img: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """depth [B, S, H, W], img [B, S, H, W, 3] -> (depth [B, S, H, W],
        normal [B, S, H, W, 3])."""
        b, s, h, w = depth.shape
        normals = normal_vector(depth)
        depth_img = torch.cat([depth[..., None], normals[..., :2]], -1)
        feats = []
        if self.use_depth_feature:
            feats.append(self._pyramid(self.encoder,
                                       depth_img.reshape(b * s, h, w, 3)))
        if self.use_rgb_feature:
            feats.append(self._pyramid(self.img_encoder,
                                       img.reshape(b * s, h, w, 3)))
        levels = ([d + r for d, r in zip(*feats)] if len(feats) == 2
                  else feats[0])
        if self.scrambled_layout:
            # the reference's .view(B, S, C, H, W) of NHWC memory (a pure
            # reinterpretation), relabelled to the head's NHWC
            levels = [f.reshape(b, s, f.shape[-1], f.shape[1], f.shape[2])
                      .permute(0, 1, 3, 4, 2) for f in levels]
        else:
            levels = [f.reshape(b, s, *f.shape[1:]) for f in levels]

        out = self.head(levels)  # [B, S, h', w', 3]
        if tuple(out.shape[2:4]) != (h, w):
            out = resize2d(out.reshape(b * s, *out.shape[2:]), (h, w),
                           "bilinear", align_corners=True)
            out = out.reshape(b, s, h, w, 3)
        out_depth = out[..., 0]
        if self.use_residual:
            out_depth = out_depth + depth
        dx, dy = out[..., 1], out[..., 2]
        normal = torch.stack([-dx, -dy, torch.ones_like(dx)], -1)
        if self.use_final_relu:
            out_depth = torch.relu(out_depth)
        return out_depth, normal


def build_video_depth_v1(encoder: str = "hiera_base",
                         device: Union[torch.device, str] = "cuda",
                         generator: Optional[torch.Generator] = None,
                         **kw) -> VideoDepthEstimationModel:
    """A v1 model with parameters drawn from ``generator`` (seed 0 by
    default) with vdn's initializers, in fp32 as vdn runs it, on
    ``device``: the card unless the caller asks for the CPU.  ``kw`` goes
    to VideoDepthEstimationModel (sequence_length,
    attention_feature_levels, scrambled_layout, ...)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("VideoDepthEstimationModel: no CUDA device; pass "
                           "device='cpu' to build on the CPU")
    model = VideoDepthEstimationModel(encoder=encoder, **kw)
    init_parameters(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
    return model.to(device)
