"""Model-zoo presets (vdn/models/presets.py; reference run_video.py:28-33)
and the build function the models share."""

from __future__ import annotations

from typing import Optional, Union

import torch

from vdn_torch.core.dtypes import get_policy
from vdn_torch.nn.layers import init_parameters

MODEL_CONFIGS = {
    "vits": dict(encoder="vits", features=64,
                 out_channels=(48, 96, 192, 384)),
    "vitb": dict(encoder="vitb", features=128,
                 out_channels=(96, 192, 384, 768)),
    "vitl": dict(encoder="vitl", features=256,
                 out_channels=(256, 512, 1024, 1024)),
}


def build_preset(cls, encoder: str,
                 compute_dtype: Union[torch.dtype, str] = torch.float32,
                 device: Union[torch.device, str] = "cuda",
                 generator: Optional[torch.Generator] = None, **kw):
    """``cls`` at the ``encoder`` preset with parameters drawn from
    ``generator`` (seed 0 by default) with vdn's initializers, in eval mode
    on ``device``: the card unless the caller asks for the CPU.

    On the card pass ``compute_dtype="bf16"``: the attention kernels take
    bf16 only, and from 256 tokens on (any image of 224 x 224 or more) a
    forward in the default fp32 raises ValueError at its first attention.
    fp32 on the card is for reference runs inside
    ``kernels.plain_reference()``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{cls.__name__}: no CUDA device; pass "
                           f"device='cpu' to build on the CPU")
    if isinstance(compute_dtype, str):
        compute_dtype = get_policy(compute_dtype).compute_dtype
    cfg = dict(MODEL_CONFIGS[encoder])
    cfg.update(kw)
    model = cls(compute_dtype=compute_dtype, **cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(device).eval()
