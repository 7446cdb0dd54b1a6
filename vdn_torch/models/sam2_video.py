"""SAM2 video tracking: memory-conditioned promptable segmentation
(vdn/models/sam2_video.py; reference sam2/modeling/sam2_base.py:497-910),
sam2.1 video flags: 7 mask-memory slots, 64-wide memory features, object
pointers (4 tokens of 64 each) with signed sine temporal encodings, the
memory attention with a relu FFN.

The memory attention (vdn_torch.nn.memory.MemoryAttention, four layers of
one 256-wide head over the 64 x 64 tokens at 1024 x 1024) takes kernel C2
at D 256 on the card: its self-attention over 4096 tokens and its
cross-attention over 4096 m + 4 p keys (m mask memories, p object
pointers), eight launches a tracked frame.  The host-side orchestration
(which memories and pointers a frame reads) is
vdn_torch.pipelines.sam2_video.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from vdn_torch.models.sam2_image import (Sam2ImageModel, on_device,
                                         NO_OBJ_SCORE)
from vdn_torch.nn.layers import Conv2d, LayerNorm, Linear
from vdn_torch.nn.memory import (Fuser, MemoryAttention,
                                 sine_position_encoding)
from vdn_torch.ops.resize import resize2d

__all__ = ["get_1d_sine_pe", "Sam2MaskDownSampler", "Sam2MemoryEncoder",
           "Sam2VideoModel", "build_sam2_video_model", "NO_OBJ_SCORE"]


def get_1d_sine_pe(pos: torch.Tensor, dim: int,
                   temperature: float = 10000.0) -> torch.Tensor:
    """(reference sam2_utils.py:64-74)"""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    pos_embed = pos[..., None] / dim_t
    return torch.cat([torch.sin(pos_embed), torch.cos(pos_embed)], dim=-1)


class Sam2MaskDownSampler(nn.Module):
    """The stride-16 mask pyramid (reference memory_encoder.py:17-58 with
    total_stride 16): four stride-2 3 x 3 convs, channels 1 -> 4 -> 16 ->
    64 -> 256, each with a LayerNorm and a GELU, then a 1 x 1 projection;
    indices 0 .. 12 as the torch Sequential's."""

    def __init__(self, embed_dim: int = 256):
        super().__init__()
        layers, ch = [], 1
        for _ in range(4):
            layers += [Conv2d(ch, ch * 4, 3, stride=2, padding=1),
                       LayerNorm(ch * 4), nn.GELU()]
            ch *= 4
        layers.append(Conv2d(ch, embed_dim, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class Sam2MemoryEncoder(nn.Module):
    """(pix_feat [B, h, w, 256], mask) -> the 64-wide memory feature and
    its sine position encoding (reference memory_encoder.py:137-181,
    sam2.1 config)."""

    def __init__(self, in_dim: int = 256, out_dim: int = 64):
        super().__init__()
        self.out_dim = out_dim
        self.mask_downsampler = Sam2MaskDownSampler(in_dim)
        self.pix_feat_proj = Conv2d(in_dim, in_dim, 1)
        self.fuser = Fuser(in_dim, 2)
        self.out_proj = Conv2d(in_dim, out_dim, 1)

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor,
                skip_mask_sigmoid: bool = False):
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        x = self.out_proj(self.fuser(x))
        _, h, w, _ = x.shape
        pos = sine_position_encoding(h, w, self.out_dim, x.dtype,
                                     x.device)[None].expand(x.shape)
        return x, pos


class Sam2VideoModel(Sam2ImageModel):
    """Sam2ImageModel plus the memory machinery (sam2.1 video config)."""

    def __init__(self, trunk_variant: str = "hiera_base_plus",
                 d_model: int = 256, image_size: int = 1024,
                 num_maskmem: int = 7, mem_dim: int = 64,
                 max_obj_ptrs_in_encoder: int = 16,
                 sigmoid_scale_for_mem_enc: float = 20.0,
                 sigmoid_bias_for_mem_enc: float = -10.0,
                 use_mlp_for_obj_ptr_proj: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(trunk_variant, d_model, image_size,
                         use_mlp_for_obj_ptr_proj=use_mlp_for_obj_ptr_proj,
                         compute_dtype=compute_dtype, **kw)
        d = d_model
        self.num_maskmem, self.mem_dim = num_maskmem, mem_dim
        self.max_obj_ptrs_in_encoder = max_obj_ptrs_in_encoder
        self.sigmoid_scale_for_mem_enc = sigmoid_scale_for_mem_enc
        self.sigmoid_bias_for_mem_enc = sigmoid_bias_for_mem_enc
        # vdn's flags (vdn/models/sam2_video.py:112-116): the keys' pos enc
        # flag stays off, so memory_pos reaches the layers unused
        self.memory_attention = MemoryAttention(
            d, 1, 4, dim_feedforward=2048, activation="relu",
            pos_enc_at_cross_attn_queries=False, kv_in_dim=mem_dim)
        self.memory_encoder = Sam2MemoryEncoder(d, mem_dim)
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(num_maskmem, 1, 1, mem_dim))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, d))
        self.obj_ptr_tpos_proj = Linear(d, mem_dim)
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, mem_dim))
        # 4 x 4 / 4 conv from a full-size mask to the prompt's resolution
        # (reference sam2_base.py:110 mask_downsample)
        self.mask_downsample = Conv2d(1, 1, 4, stride=4)

    def _embeddings(self):
        return super()._embeddings() + [
            self.maskmem_tpos_enc, self.no_mem_pos_enc,
            self.no_obj_embed_spatial]

    def use_mask_as_output(self, features: Dict[str, torch.Tensor],
                           mask_inputs: torch.Tensor):
        """A binary input mask [B, 1, S, S] turned into output logits
        without the decoder (reference sam2_base.py:415-465); the object
        pointer still comes from the SAM heads fed the mask-downsampled
        prompt.  Returns predict()'s tuple."""
        out_scale, out_bias = 20.0, -10.0
        mask = mask_inputs.float()
        high_res = mask * out_scale + out_bias
        s = high_res.shape[-1]
        low_res = resize2d(high_res.permute(0, 2, 3, 1), (s // 4, s // 4),
                           "bilinear_aa").permute(0, 3, 1, 2)
        ious = mask.new_ones(mask.shape[0], 1)
        mask_ds = self.mask_downsample(mask.permute(0, 2, 3, 1))
        _, _, _, obj_ptr, _ = self.predict(features, mask_input=mask_ds,
                                           multimask_output=False)
        is_obj = (mask.flatten(1) > 0.0).any(dim=1)
        lam = is_obj.float()[:, None]
        object_score_logits = out_scale * lam + out_bias
        if self.pred_obj_scores:
            if self.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1 - lam) * self.no_obj_ptr.to(obj_ptr.dtype)
        return low_res, high_res, ious, obj_ptr, object_score_logits

    def condition_features(self, features: Dict[str, torch.Tensor],
                           memory: torch.Tensor, memory_pos: torch.Tensor,
                           num_obj_ptr_tokens: int
                           ) -> Dict[str, torch.Tensor]:
        """The stride-16 tokens cross-attended to the assembled memory
        (reference _prepare_memory_conditioned_features:497-678); the raw
        features of encode_image_raw (no no-memory embedding)."""
        s16 = features["image_embed"]
        b, h, w, c = s16.shape
        tokens = s16.reshape(b, h * w, c)
        pos = sine_position_encoding(h, w, c, tokens.dtype,
                                     tokens.device).reshape(
            1, h * w, c).expand(tokens.shape)
        out = self.memory_attention(
            tokens, self._cast(memory), pos, (h, w),
            memory_pos=self._cast(memory_pos),
            num_k_exclude_rope=num_obj_ptr_tokens)
        feats = dict(features)
        feats["image_embed"] = out.reshape(b, h, w, c)
        return feats

    def add_no_mem(self, features: Dict[str, torch.Tensor]):
        s16 = features["image_embed"]
        out = dict(features)
        out["image_embed"] = s16 + self.no_mem_embed.reshape(
            1, 1, 1, -1).to(s16.dtype)
        return out

    def encode_memory(self, features: Dict[str, torch.Tensor],
                      high_res_masks: torch.Tensor,
                      object_score_logits: torch.Tensor):
        """(reference _encode_new_memory:679-728): the scaled sigmoid of the
        mask and the pixel features -> (maskmem_feat [B, h, w, 64],
        maskmem_pos).  high_res_masks [B, 1, S, S]."""
        pix_feat = features["image_embed"]
        mask = torch.sigmoid(high_res_masks.permute(0, 2, 3, 1))
        mask = (mask * self.sigmoid_scale_for_mem_enc
                + self.sigmoid_bias_for_mem_enc)
        feat, pos = self.memory_encoder(pix_feat, self._cast(mask),
                                        skip_mask_sigmoid=True)
        is_obj = (object_score_logits > 0).to(feat.dtype)
        feat = feat + (1.0 - is_obj[..., None, None]) \
            * self.no_obj_embed_spatial.reshape(1, 1, 1, -1).to(feat.dtype)
        return feat, pos

    def maskmem_pos_with_tpos(self, pos: torch.Tensor,
                              t_pos: int) -> torch.Tensor:
        """The slot's temporal embedding added (reference :544-556): slot
        num_maskmem - t_pos - 1."""
        return pos + self.maskmem_tpos_enc[self.num_maskmem - t_pos - 1]

    def obj_ptr_tokens(self, obj_ptrs: torch.Tensor, t_diffs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[P, C] pointers and their signed frame offsets -> (tokens [P *
        4, 64], pos [P * 4, 64]) (reference :618-640)."""
        c = self.d_model
        split = c // self.mem_dim
        t_max = self.max_obj_ptrs_in_encoder - 1
        pos = self.obj_ptr_tpos_proj(get_1d_sine_pe(t_diffs / t_max, c))
        tokens = obj_ptrs.reshape(-1, split, self.mem_dim).reshape(
            -1, self.mem_dim)
        return tokens, pos.repeat_interleave(split, dim=0)


def build_sam2_video_model(trunk_variant: str = "hiera_base_plus",
                           image_size: int = 1024,
                           compute_dtype: Optional[torch.dtype] = None,
                           device: Union[torch.device, str] = "cuda",
                           generator: Optional[torch.Generator] = None,
                           **kw) -> Sam2VideoModel:
    """A Sam2VideoModel (sam2.1 video flags; ``kw`` goes to it) with
    seeded random parameters, on the card unless ``device`` says
    otherwise."""
    return on_device(Sam2VideoModel(trunk_variant, image_size=image_size,
                                    compute_dtype=compute_dtype, **kw),
                     device, generator, "Sam2VideoModel")
