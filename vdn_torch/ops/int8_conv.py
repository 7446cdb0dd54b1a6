"""W8A8 int8 convolution of the DPT head's serving mode
(vdn/ops/int8_conv.py).

vdn runs it at the XLA level (``lax.conv_general_dilated`` on int8
operands with int32 accumulation), not as a TPU kernel; the port's product
is ``torch._int_mm`` on the int8 im2col rows [frames * oh * ow, kh * kw *
Cin] of a few frames at a time (at most IM2COL_BYTES of them, so a 296 x
296 window never holds its whole im2col) against the weights [Cout, kh *
kw * Cin].  The int32 sums are exact, so the result equals vdn's bit for
bit up to the dequantization's fp32 products.

Scales, as vdn's:

- weights per output channel, ``round(w / s)``, s = max(amax / 127, 1e-30)
  over (Cin, kh, kw);
- activations per frame, ``round(x * (1 / s))`` (dynamic, ``"int8"``), or
  one calibrated scale s = max(amax, 1e-30) / 127 with the values clipped
  to +-127 (``"int8_static"``, vdn_torch.nn.layers.Conv2d);
- dequantized as ``float(acc) * (sx * sw)``, cast to x's dtype; the caller
  adds the bias in that dtype.

``int8_conv_enabled`` is vdn's gate verbatim: its thresholds decide which
convs quantize, so they are semantics here, not tuning.  ``counts``
tallies the convs that took the int8 route.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vdn_torch.kernels.int8 import over_127

__all__ = ["quantize_weight_ochan", "quantize_frames", "int8_conv_enabled",
           "int8_conv", "counts", "reset_counts"]

counts = {"int8_conv": 0}
IM2COL_BYTES = 1 << 28   # the int8 im2col rows of one product, at most


def reset_counts() -> None:
    counts["int8_conv"] = 0


def quantize_weight_ochan(w: torch.Tensor):
    """Conv weight [Cout, Cin, kh, kw] -> (int8 of the same shape, fp32
    scales [Cout])."""
    wf = w.detach().float()
    s = torch.clamp_min(over_127(wf.abs().amax((1, 2, 3))), 1e-30)
    return torch.round(wf / s[:, None, None, None]).to(torch.int8), s


def quantize_frames(x: torch.Tensor):
    """NHWC float -> (int8, fp32 per-frame scales [N, 1, 1, 1])."""
    xf = x.float()
    s = torch.clamp_min(over_127(xf.abs().amax((1, 2, 3), keepdim=True)),
                        1e-30)
    return torch.round(xf * torch.reciprocal(s)).to(torch.int8), s


def int8_conv_enabled(x: torch.Tensor, weight_shape: Sequence[int],
                      stride: Tuple[int, int] = (1, 1),
                      static: bool = False) -> bool:
    """vdn's gate (vdn/ops/int8_conv.py:52-88) for input x NHWC and a
    weight of torch shape (Cout, Cin, kh, kw): Cin and Cout >= 64 (with
    ``VDN_FORCE_INT8`` that alone); N * oh * ow >= 32768 output rows; the
    dynamic mode leaves out oh * ow > 160^2; kh * kw * Cout >= 512.
    ``VDN_DISABLE_INT8_CONV=1`` turns every conv to float."""
    if os.environ.get("VDN_DISABLE_INT8_CONV", "0") == "1":
        return False
    cout, cin, kh, kw = weight_shape
    if cin < 64 or cout < 64:
        return False
    if os.environ.get("VDN_FORCE_INT8"):
        return True
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    oh, ow = h // stride[0], w // stride[1]
    if n * oh * ow < 32 * 1024:
        return False
    if not static and oh * ow > 160 * 160:
        return False
    return kh * kw * cout >= 512


def int8_conv(x: torch.Tensor, weight, stride: Tuple[int, int],
              padding: Tuple[int, int],
              amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x NHWC, weight (wq [Cout, kh, kw, Cin] int8, sw [Cout] fp32) as
    vdn_torch.nn.layers.Conv2d.int8_weight gives it -> NHWC in x's dtype,
    without the bias.  ``amax``: the calibrated activation absmax (static
    scale); None quantizes per frame."""
    wq, sw = weight
    cout, kh, kw, cin = wq.shape
    k = kh * kw * cin
    if amax is None:
        xq, sx = quantize_frames(x)
    else:
        sx = over_127(torch.clamp_min(amax.float(), 1e-30))
        xq = torch.clamp(torch.round(x.float() * torch.reciprocal(sx)),
                         -127, 127).to(torch.int8)
    n, h, w, _ = x.shape
    (sh, sw_), (ph, pw) = stride, padding
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw_ + 1
    if ph or pw:
        xq = F.pad(xq, (0, 0, pw, pw, ph, ph))
    wmat = wq.reshape(cout, k).t()
    scale = sx.reshape(-1, 1, 1, 1) * sw           # [N or 1, 1, 1, Cout]
    out = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    step = max(1, IM2COL_BYTES // (oh * ow * k))
    for n0 in range(0, n, step):
        xs = xq[n0:n0 + step]
        if (kh, kw, sh, sw_) == (1, 1, 1, 1):
            cols = xs
        else:
            cols = xq.new_empty((xs.shape[0], oh, ow, kh, kw, cin))
            for i in range(kh):
                for j in range(kw):
                    cols[:, :, :, i, j] = xs[:, i:i + sh * (oh - 1) + 1:sh,
                                             j:j + sw_ * (ow - 1) + 1:sw_]
        acc = torch._int_mm(cols.reshape(-1, k), wmat)
        sc = scale if scale.shape[0] == 1 else scale[n0:n0 + step]
        out[n0:n0 + step] = (acc.reshape(-1, oh, ow, cout).float()
                             * sc).to(x.dtype)
    counts["int8_conv"] += 1
    return out
