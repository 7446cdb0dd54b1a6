"""Shared building blocks (NHWC convs, torch-reference parameter names).

The counterparts of vdn/nn/layers.py.  Public layouts stay vdn's: feature
maps NHWC, tokens [B, N, C]; convs run on channels-last views internally.
Parameters are stored in the reference's torch layout and dtype (fp32) and
cast to the input's dtype at use; every bias is added after the product,
in the compute dtype, as vdn does.  ``init_parameters`` fills a module tree
from an explicit ``torch.Generator`` with vdn's initializers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vdn_torch.kernels import layer_norm_f32

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def init_parameters(root: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every module of ``root`` that defines ``_init``."""
    with torch.no_grad():
        for m in root.modules():
            init = getattr(m, "_init", None)
            if init is not None:
                init(generator)


def _uniform_fan_in(w: torch.Tensor, fan_in: int, g: torch.Generator):
    # flax variance_scaling(1/3, "fan_in", "uniform"): bound sqrt(1/fan_in)
    bound = math.sqrt(1.0 / fan_in)
    w.copy_(torch.rand(w.shape, generator=g) * (2 * bound) - bound)


class Conv2d(nn.Module):
    """NHWC conv.  ``accum_dtype`` sets the accumulator and output dtype
    apart from the input's: bf16 operands with fp32 accumulation and output
    for the DPT output island (vdn/nn/dpt.py:112-121).  ``groups`` is
    vdn's ``feature_group_count`` (the memory encoder's depthwise 7x7)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0,
                 bias: bool = True,
                 accum_dtype: Optional[torch.dtype] = None,
                 groups: int = 1):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.accum_dtype = accum_dtype
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def _init(self, g):
        _uniform_fan_in(self.weight, self.weight[0].numel(), g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        w = self.weight.to(dt)
        if self.accum_dtype is not None and self.accum_dtype != dt:
            # operands rounded to the compute dtype, products and sums in
            # the accumulator dtype
            x, w = x.to(self.accum_dtype), w.to(self.accum_dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None, self.stride,
                     self.padding, 1, self.groups).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ConvTranspose2d(nn.Module):
    """NHWC transposed conv (padding 0), torch weight layout [I, O, kh, kw]."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: IntPair,
                 stride: IntPair, bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def _init(self, g):
        kh, kw = self.weight.shape[2:]
        _uniform_fan_in(self.weight, kh * kw * self.weight.shape[0], g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               self.weight.to(x.dtype), None,
                               self.stride).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with an fp32 island, eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def _init(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias,
                              self.eps).to(x.dtype)


class GroupNorm(nn.Module):
    """Channel-last group norm (torch GroupNorm semantics), fp32 stats."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def _init(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        xf = x.float().reshape(n, -1, self.num_groups, c // self.num_groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class Linear(nn.Module):
    """Linear with torch's [out, in] weight; ``zero_init`` for the motion
    modules' proj_out (vdn/nn/motion.py:636-639)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _init(self, g):
        if self.zero_init:
            self.weight.zero_()
        else:  # lecun normal
            std = math.sqrt(1.0 / self.weight.shape[1])
            self.weight.copy_(torch.randn(self.weight.shape, generator=g) * std)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Mlp(nn.Module):
    """fc1 -> GELU (exact) -> fc2 (reference dinov2_layers/mlp.py)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))
