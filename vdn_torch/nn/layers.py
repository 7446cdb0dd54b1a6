"""Shared building blocks (NHWC convs, torch-reference parameter names).

The counterparts of vdn/nn/layers.py.  Public layouts stay vdn's: feature
maps NHWC, tokens [B, N, C]; convs run on channels-last views internally.
Parameters are stored in the reference's torch layout and dtype (fp32) and
cast to the input's dtype at use; every bias is added after the product,
in the compute dtype, as vdn does.  ``init_parameters`` fills a module tree
from an explicit ``torch.Generator`` with vdn's initializers.

The int8 serving mode (``quantize``) quantizes the weights of a Linear or
Conv2d once per weight version (``int8_weight``); a Conv2d with
``quantize="int8_static"`` serves with the activation absmax that the last
``quant_calibration`` pass recorded.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vdn_torch.kernels import layer_norm_f32
from vdn_torch.kernels.int8 import quantize_weight_cols
from vdn_torch.ops.int8_conv import (int8_conv, int8_conv_enabled,
                                     quantize_weight_ochan)

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


_CALIBRATING = contextvars.ContextVar("vdn_torch_quant_calibration",
                                      default=False)


@contextlib.contextmanager
def quant_calibration(model: nn.Module):
    """The calibration pass of ``quantize="int8_static"`` (vdn's apply with
    ``mutable=["quant_stats"]``): inside it every such Conv2d of ``model``
    runs its float conv and records the running max of ``|x|`` over the
    pass (``act_amax``); the stats of an earlier pass are cleared first.
    A model without such a conv runs unchanged."""
    convs = [m for m in model.modules()
             if isinstance(m, Conv2d) and m.quantize == "int8_static"]
    if not convs:
        yield
        return
    for conv in convs:
        conv.act_amax = None
    token = _CALIBRATING.set(True)
    try:
        yield
    finally:
        _CALIBRATING.reset(token)


def calibrating() -> bool:
    """True inside a ``quant_calibration`` pass."""
    return _CALIBRATING.get()


def _cached(module: nn.Module, weight: torch.Tensor, quantize):
    """quantize(weight), kept on ``module`` until the weight changes (a new
    version, device or storage)."""
    key = (weight.device, weight.data_ptr(), weight._version)
    if module._int8_cache is None or module._int8_cache[0] != key:
        module._int8_cache = (key, quantize(weight))
    return module._int8_cache[1]


def _uniform_fan_in(w: torch.Tensor, fan_in: int, g: torch.Generator):
    # flax variance_scaling(1/3, "fan_in", "uniform"): bound sqrt(1/fan_in)
    bound = math.sqrt(1.0 / fan_in)
    w.copy_(torch.rand(w.shape, generator=g) * (2 * bound) - bound)


class Conv2d(nn.Module):
    """NHWC conv.  ``accum_dtype`` sets the accumulator and output dtype
    apart from the input's: bf16 operands with fp32 accumulation and output
    for the DPT output island (vdn/nn/dpt.py:112-121).  ``groups`` is
    vdn's ``feature_group_count`` (the memory encoder's depthwise 7x7).

    ``quantize`` (serving only, vdn/nn/layers.py:99-140): ``"int8"`` runs
    the int8 conv with per-frame scales where vdn's gate passes;
    ``"int8_static"`` records the input's absmax inside
    ``quant_calibration`` (and runs the float conv there), then serves with
    that scale, or per frame while uncalibrated.  Never with
    ``accum_dtype`` (the fp32 island) or ``groups`` > 1.  The recorded
    ``act_amax`` is a buffer outside the state_dict: a checkpoint loads
    with ``strict=True`` whatever the mode."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0,
                 bias: bool = True,
                 accum_dtype: Optional[torch.dtype] = None,
                 groups: int = 1, quantize: Optional[str] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.accum_dtype = accum_dtype
        self.groups = groups
        self.quantize = quantize
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.register_buffer("act_amax", None, persistent=False)
        self._int8_cache = None

    def int8_weight(self):
        """(int8 [Cout, kh, kw, Cin], fp32 scales [Cout]), per weight
        version: the layout of int8_conv's im2col rows."""
        def quantize(w):
            wq, s = quantize_weight_ochan(w)
            return wq.permute(0, 2, 3, 1).contiguous(), s
        return _cached(self, self.weight, quantize)

    def _init(self, g):
        _uniform_fan_in(self.weight, self.weight[0].numel(), g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantize in ("int8", "int8_static") \
                and self.accum_dtype is None:
            y = self._forward_int8(x)
            if y is not None:
                return y
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

    def _forward_int8(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The int8 route, or None where the float conv runs: while
        calibrating (after recording |x|'s max) or where the gate says
        no."""
        static = self.quantize == "int8_static"
        if static and calibrating():
            amax = x.detach().float().abs().amax()
            self.act_amax = amax if self.act_amax is None else torch.maximum(
                self.act_amax, amax)
            return None
        if self.groups != 1 or not int8_conv_enabled(
                x, self.weight.shape, self.stride, static):
            return None
        y = int8_conv(x, self.int8_weight(), self.stride, self.padding,
                      self.act_amax if static else None)
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
        self._int8_cache = None

    def int8_weight(self):
        """(int8 [out, in], fp32 scales [out]) of the weight, per weight
        version: the int8 kernels' pre-quantized operand."""
        return _cached(self, self.weight, quantize_weight_cols)

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
