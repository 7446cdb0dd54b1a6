"""DPT decoder head, NHWC (vdn/nn/dpt.py).

Module names mirror the reference checkpoint keys (projects.i,
resize_layers.i, scratch.layerN_rn, scratch.refinenetN,
scratch.output_conv1, scratch.output_conv2.0/.2).  As in vdn, each fusion
block's 1x1 out_conv runs before its align-corners upsample (the two
commute exactly, at a quarter of the FLOPs).  The upsamples run through
A5a/A5b (vdn_torch.ops.resize) and the upsampling output island through
A6, as vdn's TPU path routes them.

``quantize`` ("int8" or "int8_static", vdn/nn/dpt.py:34-111, 192-204)
goes to the convs vdn quantizes: the projections, the layerN_rn convs,
every refinenet conv and output_conv1; never resize_layers.3, the
transposed convs or the fp32 output island.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vdn_torch.kernels.resize_island import fused_resize_island
from vdn_torch.nn.layers import Conv2d, ConvTranspose2d
from vdn_torch.ops.resize import resize2d


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, quantize: Optional[str] = None):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1,
                            quantize=quantize)
        self.conv2 = Conv2d(features, features, 3, padding=1,
                            quantize=quantize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(x))
        return self.conv2(torch.relu(y)) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, quantize: Optional[str] = None):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, quantize)
        self.resConfUnit2 = ResidualConvUnit(features, quantize)
        self.out_conv = Conv2d(features, features, 1, quantize=quantize)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        if size is None:
            size = (out.shape[-3] * 2, out.shape[-2] * 2)
        out = self.out_conv(out)
        return resize2d(out, size, "bilinear", align_corners=True)


class Scratch(nn.Module):
    """The reference's ``scratch`` namespace.  ``sigmoid_output`` selects
    the metric-depth head: the final activation is a sigmoid, scaled by
    max_depth at the model level."""

    def __init__(self, features: int, out_channels: Sequence[int],
                 sigmoid_output: bool = False,
                 quantize: Optional[str] = None):
        super().__init__()
        f, qz = features, quantize
        self.sigmoid_output = sigmoid_output
        self.layer1_rn = Conv2d(out_channels[0], f, 3, padding=1, bias=False,
                                quantize=qz)
        self.layer2_rn = Conv2d(out_channels[1], f, 3, padding=1, bias=False,
                                quantize=qz)
        self.layer3_rn = Conv2d(out_channels[2], f, 3, padding=1, bias=False,
                                quantize=qz)
        self.layer4_rn = Conv2d(out_channels[3], f, 3, padding=1, bias=False,
                                quantize=qz)
        self.refinenet1 = FeatureFusionBlock(f, qz)
        self.refinenet2 = FeatureFusionBlock(f, qz)
        self.refinenet3 = FeatureFusionBlock(f, qz)
        self.refinenet4 = FeatureFusionBlock(f, qz)
        self.output_conv1 = Conv2d(f, f // 2, 3, padding=1, quantize=qz)
        # fp32 accumulation island (vdn/nn/dpt.py:112-121)
        self.output_conv2 = nn.Sequential(
            Conv2d(f // 2, 32, 3, padding=1, accum_dtype=torch.float32),
            nn.ReLU(),
            Conv2d(32, 1, 1))

    def fuse(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        l1, l2, l3, l4 = layers
        r1, r2 = self.layer1_rn(l1), self.layer2_rn(l2)
        r3, r4 = self.layer3_rn(l3), self.layer4_rn(l4)
        p4 = self.refinenet4(r4, None, tuple(r3.shape[-3:-1]))
        p3 = self.refinenet3(p4, r3, tuple(r2.shape[-3:-1]))
        p2 = self.refinenet2(p3, r2, tuple(r1.shape[-3:-1]))
        return self.refinenet1(p2, r1, None)

    def output_head(self, path_1: torch.Tensor, out_hw: Tuple[int, int]):
        """Returns (depth [B, H, W, 1] fp32, the upscaled feature or None).

        Routed as vdn's (vdn/nn/dpt.py:136-177): when the head upsamples,
        A6 (fused_resize_island) takes the resize and both island convs
        and the upscaled feature is never formed (None); otherwise the
        plain composite runs.  The last activation is a ReLU, or with
        ``sigmoid_output`` a sigmoid."""
        out = self.output_conv1(path_1)
        if not (out.shape[-3] < out_hw[0] and out.shape[-2] < out_hw[1]):
            act = torch.sigmoid if self.sigmoid_output else torch.relu
            up = resize2d(out, out_hw, "bilinear", align_corners=True)
            return act(self.output_conv2(up)), up
        conv1, conv2 = self.output_conv2[0], self.output_conv2[2]
        depth = fused_resize_island(
            out, conv1.weight.permute(2, 3, 1, 0), conv1.bias,
            conv2.weight[:, :, 0, 0].t(), conv2.bias, tuple(out_hw),
            self.sigmoid_output, 1.0)
        return depth, None


class DPTHead(nn.Module):
    """features: fused channel width; out_channels: pyramid widths."""

    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 sigmoid_output: bool = False,
                 quantize: Optional[str] = None):
        super().__init__()
        oc = out_channels
        self.projects = nn.ModuleList(
            Conv2d(in_channels, o, 1, quantize=quantize) for o in oc)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, 4),
            ConvTranspose2d(oc[1], oc[1], 2, 2),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(features, oc, sigmoid_output, quantize)

    def project_features(self, out_features, patch_h: int, patch_w: int):
        """4 x tokens [B, ph * pw, C] (or (tokens, cls)) -> NHWC pyramid."""
        maps = []
        for item, project, resize in zip(out_features, self.projects,
                                         self.resize_layers):
            tokens = item[0] if isinstance(item, (tuple, list)) else item
            x = tokens.reshape(tokens.shape[0], patch_h, patch_w,
                               tokens.shape[-1])
            maps.append(resize(project(x)))
        return maps

    def depth(self, out_features, patch_h: int, patch_w: int) -> torch.Tensor:
        """Depth [B, 14 ph, 14 pw, 1] fp32 alone: the upscaled feature is
        not formed where A6 takes the output island."""
        layers = self.project_features(out_features, patch_h, patch_w)
        path_1 = self.scratch.fuse(layers)
        return self.scratch.output_head(
            path_1, (patch_h * 14, patch_w * 14))[0]

    def forward(self, out_features, patch_h: int, patch_w: int):
        """Returns (depth, the upscaled feature), as the reference head."""
        layers = self.project_features(out_features, patch_h, patch_w)
        path_1 = self.scratch.fuse(layers)
        out_hw = (patch_h * 14, patch_w * 14)
        depth, up = self.scratch.output_head(path_1, out_hw)
        if up is None:
            up = resize2d(self.scratch.output_conv1(path_1), out_hw,
                          "bilinear", align_corners=True)
        return depth, up
