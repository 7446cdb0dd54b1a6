"""Standalone encoder adapters (vdn/nn/encoders.py; reference
models/dinov2_encoder.py:6-61 and models/hiera_image_encoder.py:5-61).

The reference wrappers fetch pretrained weights over the network; these
give the same interfaces over the port's own backbones, with weights
loaded from converted checkpoints.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from vdn_torch.nn.hiera import make_hiera
from vdn_torch.nn.hiera_mae import HIERA_MAE_CONFIGS, make_hiera_mae
from vdn_torch.nn.vit import make_vit

_DINOV2_SIZES = {
    "dinov2_vits14": "vits", "facebook/dinov2-small": "vits",
    "dinov2_vitb14": "vitb", "facebook/dinov2-base": "vitb",
    "dinov2_vitl14": "vitl", "facebook/dinov2-large": "vitl",
    "dinov2_vitg14": "vitg", "facebook/dinov2-giant": "vitg",
}


class DINOv2Encoder(nn.Module):
    """The last hidden state without the CLS token, as the HF AutoModel
    wrapper returns it (reference models/dinov2_encoder.py:44-60)."""

    def __init__(self, model_name: str = "dinov2_vits14"):
        super().__init__()
        self.model = make_vit(_DINOV2_SIZES[model_name])
        self.feature_dim = self.model.embed_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] -> patch tokens [B, N, C]."""
        return self.model(x)[:, 1:]


class HieraImageEncoder(nn.Module):
    """A 4-level feature pyramid, [B, H_i, W_i, C_i] per level (reference
    models/hiera_image_encoder.py:44-61).  Hub names (``hiera_base_224``)
    take the plain MAE Hiera, ``sam2_``-prefixed or bare names the SAM2
    hieradet variant."""

    def __init__(self, model_name: str = "hiera_base_224"):
        super().__init__()
        self._mae = model_name in HIERA_MAE_CONFIGS
        if self._mae:
            self.model = make_hiera_mae(model_name)
        else:
            self.model = make_hiera(
                model_name.removeprefix("sam2_").replace("_224", ""))

    def forward(self, x: torch.Tensor
                ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
        """(trunk output, intermediates), the reference's (classifier
        logits, intermediates) contract: the MAE family returns its pooled
        trunk-norm output first, hieradet None."""
        out = self.model(x)
        if self._mae:
            return out
        return None, out
