"""flax params -> torch state_dict, the inverse of vdn.core.convert.

``state_dict_from_flax`` undoes ``vdn.core.convert.convert_torch_state``
leaf by leaf, so one set of weights (made for the JAX package, or a
released checkpoint converted for it) loads into the port's modules with
``load_state_dict``:

- ``name_N`` path components become ``name.N``;
- a rank-2 ``kernel`` becomes ``weight`` transposed (Linear);
- a rank-4 ``kernel`` goes HWIO -> OIHW (Conv2d), or is un-flipped back to
  torch's IOHW for ConvTranspose2d keys;
- ``scale`` becomes ``weight`` (LayerNorm / GroupNorm);
- everything else (cls_token, pos_embed, gamma, ...) copies verbatim.

These are the rules the clip-depth, single-image and metric-depth models
use at every encoder size (vitg's SwiGLU ``mlp.w12`` / ``mlp.w3`` kernels
are rank-2 and transpose like any Linear's; the memory block's ``gamma``
and (1, ., C) embeddings copy verbatim,
its depthwise and stride convs are plain rank-4 kernels), and the
refinement models v2-v5 (vdn_torch.models.refine): their zero convs
(``shift_head_0``, ``scale_head/feat_1``) are rank-4 kernels, the v2
BatchNorm's ``scale`` becomes ``weight`` and its running statistics copy
verbatim.  A reference torch checkpoint of the older layout (``head.*``,
``final_res2.*``, ``final_scale2.*``) takes the v4 names key by key
through vdn_torch.train.trainer.rename_with_map with ``V4_RENAME_MAP``, as
vdn's training CLI renames it.  The SAM2 / Hiera leaves
(``embedding``, ``in_proj``, NHWC pos-embed tables) come with their port;
until then such a tree fails to load as unexpected keys.

Registered buffers that vdn recomputes (the sinusoidal ``pe``) are not in
the flax tree; the port's modules rebuild them.

vdn's ``quant_stats`` collection (one ``act_amax`` per conv of an
``int8_static`` model, recorded by its calibration pass) maps by the same
path rules onto the port's ``Conv2d.act_amax`` buffers
(``load_quant_stats``), which stay out of the state_dict.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "load_flax_params", "load_quant_stats",
           "DEFAULT_CONVT_PATTERNS"]

# torch modules that are ConvTranspose2d (vdn.core.convert's defaults)
DEFAULT_CONVT_PATTERNS = (
    r"resize_layers\.0\.",
    r"resize_layers\.1\.",
    r"output_upscaling\.0\.",
    r"output_upscaling\.3\.",
)

_INDEXED = re.compile(r"^(.*)_(\d+)$")


def _flatten(tree: Mapping, prefix=()) -> Iterable:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_key(path) -> str:
    parts = []
    for comp in path:
        m = _INDEXED.match(comp)
        parts.extend([m.group(1), m.group(2)] if m else [comp])
    return ".".join(parts)


def state_dict_from_flax(params: Mapping,
                         convt_patterns: Iterable[str] = DEFAULT_CONVT_PATTERNS
                         ) -> Dict[str, torch.Tensor]:
    """params: a flax params tree of numpy arrays (a ``{"params": ...}``
    wrapper is accepted).  Returns fp32-preserving torch tensors keyed by
    the reference checkpoint's names."""
    if set(params) == {"params"}:
        params = params["params"]
    convt_re = [re.compile(p) for p in convt_patterns]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        value = np.asarray(value)
        leaf = path[-1]
        path = list(path)
        if leaf == "kernel":
            key = _torch_key(path[:-1] + ["weight"])
            if value.ndim == 4:
                if any(p.search(key) for p in convt_re):
                    # flipped HWIO -> torch ConvTranspose2d (I, O, kh, kw)
                    value = np.transpose(value, (2, 3, 0, 1))[:, :, ::-1, ::-1]
                else:
                    value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
            elif value.ndim == 2:
                value = value.T
            else:
                raise ValueError(f"unhandled kernel rank for {key}: "
                                 f"{value.shape}")
        elif leaf == "scale":
            key = _torch_key(path[:-1] + ["weight"])
        else:
            key = _torch_key(path)
        out[key] = torch.tensor(np.ascontiguousarray(value))
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping,
                     convt_patterns: Iterable[str] = DEFAULT_CONVT_PATTERNS
                     ) -> list:
    """Load a vdn params tree into ``module``.  Every leaf must land on a
    parameter; returns the parameter names the tree did not cover (those
    flax never creates because vdn never calls them, e.g.
    refinenet4.resConfUnit1), which keep their values.  The ``pe``
    buffers are rebuilt by the modules and not listed."""
    state = state_dict_from_flax(params, convt_patterns)
    missing, unexpected = module.load_state_dict(state, strict=False)
    if unexpected:
        raise KeyError(f"flax params with no module parameter: {unexpected}")
    return [k for k in missing if not k.endswith(".pe")]


def load_quant_stats(module: torch.nn.Module, stats: Mapping) -> int:
    """Set each conv's calibrated ``act_amax`` from vdn's ``quant_stats``
    tree (a ``{"quant_stats": ...}`` wrapper is accepted), on the conv's
    device.  Returns the number of convs set; a path with no conv of the
    module raises."""
    if set(stats) == {"quant_stats"}:
        stats = stats["quant_stats"]
    n = 0
    for path, value in _flatten(stats):
        if path[-1] != "act_amax":
            raise KeyError(f"unexpected quant_stats leaf {path}")
        conv = module.get_submodule(_torch_key(path[:-1]))
        conv.act_amax = torch.tensor(np.asarray(value, np.float32),
                                     device=conv.weight.device)
        n += 1
    return n
