"""Single-image depth model with cross-frame memory
(vdn/models/depth_anything_v2.py).

DINOv2 encoder, memory attention on the last intermediate feature, DPT
head.  The memory is a functional carry, as in vdn:

    depth, mem_feat = model(x, state)                 # state=None: no memory
    entry = model.encode_memory(mem_feat, depth)
    state = update_memory_state(state, *entry)

The host-side wrapper is vdn_torch.pipelines.infer_image.  ``quantize``
is the serving mode as in VideoDepthAnything (vdn/models/
depth_anything_v2.py:44-57): the encoder dynamic int8, the DPT head's convs
int8 with per-frame (``"int8"``) or calibrated (``"int8_static"``)
scales; the memory block stays float.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vdn_torch.models.presets import build_preset
from vdn_torch.nn.dpt import DPTHead
from vdn_torch.nn.memory import MemoryBlock
from vdn_torch.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit


class DepthAnythingV2(nn.Module):
    def __init__(self, encoder: str = "vitl", features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 max_memory_length: int = 6,
                 num_mem_attention_layers: int = 4,
                 compute_dtype: torch.dtype = torch.float32,
                 quantize: Optional[str] = None):
        super().__init__()
        self.encoder = encoder
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        enc_q = "int8" if quantize == "int8_static" else quantize
        self.pretrained = make_vit(encoder, enc_q)
        self.memory_block = MemoryBlock(
            self.pretrained.embed_dim, max_memory_length,
            num_mem_attention_layers)
        self.depth_head = DPTHead(self.pretrained.embed_dim, features,
                                  out_channels, quantize=quantize)

    def forward(self, x: torch.Tensor, state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, H, W, 3] -> (depth [B, H, W] fp32, the memory-attended
        feature [B, HW, C] to be encoded into memory)."""
        b, h, w, _ = x.shape
        ph, pw = h // 14, w // 14
        feats = self.pretrained.get_intermediate_layers(
            x.to(self.compute_dtype), INTERMEDIATE_LAYER_IDX[self.encoder])
        mem_feat = self.memory_block(feats[-1][0], (ph, pw), state)
        feats = feats[:-1] + [(mem_feat, feats[-1][1])]
        # the head's island (A6) has applied a ReLU already; the plain
        # composite of a head that does not upsample has too
        depth = torch.relu(self.depth_head.depth(feats, ph, pw).float())
        return depth[..., 0], mem_feat

    def encode_memory(self, mem_feat: torch.Tensor, depth: torch.Tensor):
        """(feature [B, HW, C], depth [B, H, W]) -> (mem_feature, mem_pos),
        the new memory-bank entry."""
        # grid from the depth resolution (robust to non-square inputs)
        gh, gw = depth.shape[1] // 14, depth.shape[2] // 14
        return self.memory_block.encode(mem_feat, depth[..., None], (gh, gw))


def build_depth_anything_v2(
        encoder: str = "vitl",
        compute_dtype: Union[torch.dtype, str] = torch.float32,
        device: Union[torch.device, str] = "cuda",
        generator: Optional[torch.Generator] = None,
        quantize: Optional[str] = None, **kw) -> DepthAnythingV2:
    """A preset model (vits, vitb, vitl, vitg) with parameters drawn from
    ``generator`` (seed 0 by default) with vdn's initializers, in eval mode
    on ``device``: the card unless the caller asks for the CPU.

    On the card pass ``compute_dtype="bf16"``: the attention kernels take
    bf16 only, and from 256 tokens on (any image of 224 x 224 or more) a
    forward in the default fp32 raises ValueError at its first attention.
    fp32 on the card is for reference runs inside
    ``kernels.plain_reference()``.  ``quantize``: None, ``"int8"`` or
    ``"int8_static"`` (serving only)."""
    return build_preset(DepthAnythingV2, encoder, compute_dtype, device,
                        generator, quantize=quantize, **kw)
