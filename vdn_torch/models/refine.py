"""Depth-refinement models v2-v5 (vdn/models/refine.py).

All take Depth-Anything depth maps as input (uint16 scale), stack [depth,
normal_x, normal_y] as a 3-channel image, run the DINOv2 encoder and the
temporal DPT head, and combine the output with the input through small
version-specific heads:

- v2: concat(out, input) -> 1x1 conv / BN / ReLU twice (``final_res``);
- v3: input-scale head + zero-conv residual (``final_scale2``,
  ``final_res2``);
- v4: ``scale_head`` + zero-conv ``shift_head``, output x max_depth (the
  canonical model, trained by vdn_torch.train.trainer.RefineTrainer);
- v5: v4 with an internal 224 x 224 resize before the encoder.

Parameter names are the reference checkpoint's (``temporal_head.*``,
``scale_head.feat.1.*``, ``shift_head.0.*``, ``final_res.1.running_mean``,
...), so vdn's params tree loads through vdn_torch.core.convert.  The
per-frame global scale head is median -> zero conv -> exp(tanh(x) *
max_log_scale), the median torch.quantile's (linear between the two middle
values), found exactly by vdn_torch.ops.select.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from vdn_torch.models.presets import build_preset
from vdn_torch.nn.dpt_temporal import DPTHeadTemporal
from vdn_torch.nn.layers import Conv2d
from vdn_torch.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit
from vdn_torch.ops.normals import normal_vector
from vdn_torch.ops.resize import resize2d
from vdn_torch.ops.select import differentiable_value, kth_smallest


def quantile_median(x: torch.Tensor) -> torch.Tensor:
    """torch.quantile(x, 0.5) over the last axis (linear-interpolated),
    differentiable as vdn's (the mean of the elements equal to each of the
    two middle values)."""
    n = x.shape[-1]
    pos = (n - 1) * 0.5
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    lo_v = differentiable_value(x, kth_smallest(x, lo + 1))
    if hi == lo or frac == 0.0:
        return lo_v
    hi_v = differentiable_value(x, kth_smallest(x, hi + 1))
    return lo_v * (1 - frac) + hi_v * frac


class ZeroConv(Conv2d):
    """1x1 NHWC conv initialized to zero (reference _v4.py:54-60)."""

    def __init__(self, in_ch: int, out_ch: int = 1):
        super().__init__(in_ch, out_ch, 1)

    def _init(self, g):
        self.weight.zero_()
        self.bias.zero_()


class GlobalScaleHead(nn.Module):
    """median -> ZeroConv -> exp(tanh * max_log_scale) (reference
    GlobalScaleHead, _v4.py:74-86): x [N, H, W, C] -> [N, 1, 1, 1]."""

    def __init__(self, channels: int = 1, max_log_scale: float = 1.0):
        super().__init__()
        self.max_log_scale = max_log_scale
        # index 0 is the reference's median pool (no parameters)
        self.feat = nn.Sequential(nn.Identity(), ZeroConv(channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        med = quantile_median(x.reshape(n, -1, c).transpose(1, 2))  # [N, C]
        g = self.feat[1](med[:, None, None, :])
        return torch.exp(torch.tanh(g) * self.max_log_scale)


class BatchNorm2d(nn.Module):
    """Inference-mode BN over the last (channel) axis with stored running
    statistics (the v2 ``final_res`` head).  As in vdn all four are
    parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def _init(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        y = (x.float() - self.running_mean) * inv * self.weight + self.bias
        return y.to(x.dtype)


class RefineVideoDepth(nn.Module):
    """The v2-v5 refinement model; ``version`` picks the head wiring."""

    def __init__(self, version: int = 4, encoder: str = "vitl",
                 features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 num_frames: int = 32, max_depth: float = 65535.0,
                 use_residual: bool = True, input_normal: bool = True,
                 internal_size: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if version not in (2, 3, 4, 5):
            raise ValueError(f"RefineVideoDepth: version {version}")
        self.version, self.encoder = version, encoder
        self.max_depth = max_depth
        self.use_residual, self.input_normal = use_residual, input_normal
        self.internal_size = internal_size
        self.compute_dtype = compute_dtype
        self.pretrained = make_vit(encoder)
        head = DPTHeadTemporal(self.pretrained.embed_dim, features,
                               out_channels, num_frames)
        if version >= 4:
            self.temporal_head = head
            self.scale_head = GlobalScaleHead()
            self.shift_head = nn.Sequential(ZeroConv(1))
        elif version == 3:
            self.head = head
            self.final_scale2 = GlobalScaleHead()
            self.final_res2 = nn.Sequential(ZeroConv(1))
        else:
            self.head = head
            self.final_res = nn.Sequential(
                Conv2d(2, 1, 1), BatchNorm2d(1), nn.ReLU(), Conv2d(1, 1, 1),
                BatchNorm2d(1), nn.ReLU())

    def dpt_head(self) -> DPTHeadTemporal:
        return self.temporal_head if self.version >= 4 else self.head

    def forward(self, input_depth: torch.Tensor) -> torch.Tensor:
        """input_depth [B, S, H, W] (uint16 scale) -> refined depth
        [B, S, H, W] fp32."""
        b, s, h, w = input_depth.shape
        x = input_depth.float() / (self.max_depth if self.version != 2
                                   else 65535.0)
        if self.version >= 3:
            head = self.scale_head if self.version >= 4 else self.final_scale2
            scale = head(x.reshape(b * s, h, w, 1)).reshape(b, s, 1, 1)
            x = x * scale

        enc_in = x
        if self.internal_size is not None:  # v5
            size = (self.internal_size, self.internal_size)
            enc_in = resize2d(x[..., None], size, "bilinear",
                              align_corners=True)[..., 0]
        eh, ew = enc_in.shape[2:]
        if self.input_normal:
            normals = normal_vector(enc_in)
            stacked = torch.cat([enc_in[..., None], normals[..., :2]], -1)
        else:
            stacked = enc_in[..., None].expand(b, s, eh, ew, 3)

        frames = stacked.reshape(b * s, eh, ew, 3).to(self.compute_dtype)
        ph, pw = eh // 14, ew // 14
        feats = self.pretrained.get_intermediate_layers(
            frames, INTERMEDIATE_LAYER_IDX[self.encoder])
        depth = self.dpt_head()(feats, ph, pw, s)
        depth = resize2d(depth, (h, w), "bilinear", align_corners=True)
        out = torch.relu(depth.float())[..., 0].reshape(b, s, h, w)

        if self.use_residual:
            if self.version == 2:
                cat = torch.stack([out, x], -1).reshape(b * s, h, w, 2)
                out = self.final_res(cat)[..., 0].reshape(b, s, h, w)
            else:
                res = self.shift_head if self.version >= 4 else self.final_res2
                y = res(out.reshape(b * s, h, w, 1))
                out = x + y[..., 0].reshape(b, s, h, w)
        if self.version >= 4:
            out = out * self.max_depth
        return out


def match_seq_to_first_median(x: torch.Tensor, eps: float = 1e-8,
                              scale: bool = True) -> torch.Tensor:
    """Align frames 1..S-1 of x [B, S, H, W] to frame 0's median and MAD
    (reference _v3.py:89-126; torch's lower median)."""
    b, s, h, w = x.shape
    flat = x.reshape(b, s, -1)
    k = (flat.shape[-1] - 1) // 2 + 1
    med = differentiable_value(flat, kth_smallest(flat, k))[..., None, None]
    mad_flat = (x - med).abs().reshape(b, s, -1)
    mad = differentiable_value(mad_flat,
                               kth_smallest(mad_flat, k))[..., None, None]
    ref_med, ref_mad = med[:, :1], mad[:, :1]
    cur_med, cur_mad = med[:, 1:], mad[:, 1:]
    denom = torch.where(cur_mad > eps, cur_mad, torch.ones_like(cur_mad))
    if scale:
        rest = (x[:, 1:] - cur_med) / denom * ref_mad + ref_med
    else:
        rest = x[:, 1:] - cur_med + ref_med
    return torch.cat([x[:, :1], rest], dim=1)


def build_refine_video_depth(
        version: int = 4, encoder: str = "vitl",
        compute_dtype: Union[torch.dtype, str] = torch.float32,
        device: Union[torch.device, str] = "cuda",
        generator: Optional[torch.Generator] = None,
        **kw) -> RefineVideoDepth:
    """A preset refinement model (v5: internal size 224, as vdn's CLI
    builds it) with parameters drawn from ``generator`` (seed 0 by default)
    with vdn's initializers, on ``device``: the card unless the caller asks
    for the CPU.  On the card pass ``compute_dtype="bf16"`` (the attention
    kernels take bf16 only); fp32 there is for reference runs inside
    ``kernels.plain_reference()``."""
    if version == 5:
        kw.setdefault("internal_size", 224)
    return build_preset(RefineVideoDepth, encoder, compute_dtype, device,
                        generator, version=version, **kw)
