"""A2: fused LayerNorm -> MLP -> LayerScale -> residual (ViT block tail).

Replaces vdn/ops/pallas/mlp.py ``fused_ln_mlp_residual``
(``_ln_mlp_kernel``).  On the H100 the kernel (csrc/ln_mlp.cu) is bound by
its two products; W1/W2 (8 MB each) cannot stay resident in a block's
shared memory as they did in VMEM, so it runs as row statistics + two
tiled GEMMs with a LayerNorm prologue and fused epilogues (see the note
in the .cu file).  Weights are torch Linear layout: w1 [F, C], w2 [C, F].
"""

from __future__ import annotations

import math

import torch

from vdn_torch.kernels import (LOG2E, check_kernel_args, launch, launches,
                               layer_norm_f32, linear_f32acc, use_kernel)

_GELU_A = math.sqrt(2.0 / math.pi)
_GELU_B = 0.044715


def gelu_f32(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """GELU of fp32 ``x`` in the TPU kernels' flavour for compute dtype
    ``dt``: the tanh form on bf16 (vdn/ops/pallas/mlp.py _gelu_fast_f32),
    exact erf otherwise."""
    if dt != torch.bfloat16:
        return torch.nn.functional.gelu(x)
    u = _GELU_A * (x + _GELU_B * x * x * x)
    e = torch.exp2(u * (2.0 * LOG2E))
    return 0.5 * x * (1.0 + (1.0 - 2.0 / (e + 1.0)))


def fused_ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                eps: float = 1e-6) -> torch.Tensor:
    """x [..., C] -> x + gamma * (fc2(gelu(fc1(LN(x)) + b1)) + b2), with
    the rounding points of mlp.py:137-149."""
    dt = x.dtype
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(dt)
    h = linear_f32acc(y, w1) + b1.to(dt)
    h = gelu_f32(h.float(), dt).to(dt)
    o = linear_f32acc(h, w2) + b2.to(dt)
    return x + o * gamma.to(dt)


def fused_ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, gamma,
                          eps: float = 1e-6) -> torch.Tensor:
    if not use_kernel(x):
        return fused_ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2,
                                           gamma, eps)
    c = x.shape[-1]
    f = w1.shape[0]
    if (x.dtype != torch.bfloat16 or w1.shape != (f, c)
            or w2.shape != (c, f) or c % 32 or f % 32):
        raise ValueError(f"fused_ln_mlp_residual: kernel takes bf16 x with "
                         f"C, F multiples of 32, got x {tuple(x.shape)} "
                         f"{x.dtype}, w1 {tuple(w1.shape)}")
    bf = torch.bfloat16
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    args = [x2, ln_w.float().contiguous(), ln_b.float().contiguous(),
            w1.to(bf).contiguous(), b1.to(bf).contiguous(),
            w2.to(bf).contiguous(), b2.to(bf).contiguous(),
            gamma.to(bf).contiguous()]
    mean = torch.empty(m, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    h = torch.empty((m, f), dtype=bf, device=x.device)
    out = torch.empty_like(x2)
    check_kernel_args("fused_ln_mlp_residual", *args, mean, rstd, h, out)
    ptr = [a.data_ptr() for a in args]
    launch("vdn_ln_mlp_residual", ptr[0], m, c, f, *ptr[1:], float(eps),
           mean.data_ptr(), rstd.data_ptr(), h.data_ptr(), out.data_ptr())
    launches["fused_ln_mlp_residual"] += 1
    return out.reshape(x.shape)
