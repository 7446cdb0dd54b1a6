"""SAM2's promptable image segmentation: model and predictor
(vdn/models/sam2_image.py; reference sam2/modeling/sam2_base.py:160-434,
sam2/sam2_image_predictor.py).

Hiera trunk -> FPN neck (scalp 1) -> the no-memory embedding on the
stride-16 map -> prompt encoder -> two-way mask decoder, with the sam2.1
flags (high-res skips, object scores, sigmoid IoU, dynamic multimask
stability).  Checkpoint keys as the reference's: ``image_encoder.trunk`` /
``.neck``, ``sam_prompt_encoder``, ``sam_mask_decoder``, ``no_mem_embed``,
``obj_ptr_proj``, ``no_obj_ptr``.

On the card the trunk's global blocks take kernel C2 (hiera_base_plus at
1024 x 1024: 8 heads of 56 over 4096 tokens, three launches an image) and
the resizes A5a / A5b (the pos-embed's bicubic, the FPN's nearest, the
masks' bilinear); the decoder is plain.  ``compute_dtype`` is vdn's: None
keeps fp32 (vdn's default), torch.bfloat16 casts the image and the
decoder's inputs (the serving benchmark's bf16).

Video tracking (the memory-conditioned step) is
vdn_torch.models.sam2_video / vdn_torch.pipelines.sam2_video.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from vdn_torch.nn.hiera import make_hiera
from vdn_torch.nn.layers import Linear, init_parameters
from vdn_torch.nn.sam2 import (FpnNeck, MaskDecoder, PromptEncoder,
                               SamGenericMLP)
from vdn_torch.ops.resize import resize2d

NO_OBJ_SCORE = -1024.0
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(image_rgb: np.ndarray, size: int) -> np.ndarray:
    """uint8 / float RGB HWC -> the normalized [size, size, 3] fp32 input:
    / 255, a cv2 INTER_LINEAR resize to size x size where the image is
    another size (cv2 is imported only then: an image already at ``size``
    needs none), ImageNet mean / std."""
    img = image_rgb.astype(np.float32) / 255.0
    if img.shape[:2] != (size, size):
        import cv2
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class Sam2ImageEncoder(nn.Module):
    """trunk + neck with scalp 1, the stride-32 level dropped
    (reference backbones/image_encoder.py:14-42)."""

    def __init__(self, trunk_variant: str = "hiera_base_plus",
                 d_model: int = 256):
        super().__init__()
        self.trunk = make_hiera(trunk_variant)
        dim = self.trunk.patch_embed.proj.weight.shape[0]
        self.neck = FpnNeck(d_model, [dim * 2 ** i for i in (3, 2, 1, 0)],
                            fpn_top_down_levels=(2, 3),
                            fpn_interp_model="nearest")

    def forward(self, x: torch.Tensor):
        feats, pos = self.neck(self.trunk(x))
        return feats[:-1], pos[:-1]


class Sam2ImageModel(nn.Module):
    def __init__(self, trunk_variant: str = "hiera_base_plus",
                 d_model: int = 256, image_size: int = 1024,
                 backbone_stride: int = 16, pred_obj_scores: bool = True,
                 pred_obj_scores_mlp: bool = True,
                 fixed_no_obj_ptr: bool = True,
                 iou_prediction_use_sigmoid: bool = True,
                 use_mlp_for_obj_ptr_proj: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = d_model
        self.d_model, self.image_size = d, image_size
        self.pred_obj_scores = pred_obj_scores
        self.fixed_no_obj_ptr = fixed_no_obj_ptr
        self.compute_dtype = compute_dtype
        emb = image_size // backbone_stride
        self.image_encoder = Sam2ImageEncoder(trunk_variant, d)
        self.sam_prompt_encoder = PromptEncoder(
            d, (emb, emb), (image_size, image_size), mask_in_chans=16)
        self.sam_mask_decoder = MaskDecoder(
            d, use_high_res_features=True, pred_obj_scores=pred_obj_scores,
            pred_obj_scores_mlp=pred_obj_scores_mlp,
            use_multimask_token_for_obj_ptr=True,
            iou_prediction_use_sigmoid=iou_prediction_use_sigmoid,
            dynamic_multimask_via_stability=True)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d))
        self.obj_ptr_proj = (SamGenericMLP(d, d, d, 3)
                             if use_mlp_for_obj_ptr_proj else Linear(d, d))
        if pred_obj_scores:
            self.no_obj_ptr = nn.Parameter(torch.zeros(1, d))

    def _init(self, g):
        for p in self._embeddings():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)

    def _embeddings(self):
        return [self.no_mem_embed] + (
            [self.no_obj_ptr] if self.pred_obj_scores else [])

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def encode_image(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, S, S, 3] (S = image_size, normalized) -> feature dict."""
        feats = self.encode_image_raw(x)
        s16 = feats["image_embed"]
        feats["image_embed"] = s16 + self.no_mem_embed.reshape(
            1, 1, 1, -1).to(s16.dtype)
        return feats

    def encode_image_raw(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """encode_image without the no-memory embedding (a tracked frame
        gets memory instead)."""
        (s0, s1, s16), _ = self.image_encoder(self._cast(x))
        s0p, s1p = self.sam_mask_decoder.project_high_res_features(s0, s1)
        return {"image_embed": s16, "high_res_0": s0p, "high_res_1": s1p}

    def predict(self, features: Dict[str, torch.Tensor],
                point_coords: Optional[torch.Tensor] = None,
                point_labels: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                mask_input: Optional[torch.Tensor] = None,
                multimask_output: bool = True,
                apply_obj_gating: bool = True):
        """The SAM heads (reference _forward_sam_heads, sam2_base.py:256-
        408).  ``apply_obj_gating=False`` is the image predictor's
        (sam2_image_predictor.py:430-466: masks never replaced by
        NO_OBJ_SCORE); tracking keeps the gating.

        Returns (low_res_multimasks [B, M, S / 4, S / 4], high_res [B, M,
        S, S], ious [B, M], obj_ptr [B, C], object_score_logits [B, 1])."""
        backbone = features["image_embed"]
        b = backbone.shape[0]
        dev = backbone.device
        if point_coords is None and boxes is None:
            point_coords = torch.zeros(b, 1, 2, device=dev)
            point_labels = -torch.ones(b, 1, device=dev)
        sparse, dense = self.sam_prompt_encoder(
            points=point_coords, labels=point_labels, boxes=boxes,
            masks=mask_input)
        image_pe = self.sam_prompt_encoder.get_dense_pe(dev)
        c = self._cast
        low_res, ious, sam_tokens, obj_logits = self.sam_mask_decoder(
            c(backbone), c(image_pe), c(sparse), c(dense), multimask_output,
            high_res_features=(c(features["high_res_0"]),
                               c(features["high_res_1"])))
        is_obj = obj_logits > 0
        if self.pred_obj_scores and apply_obj_gating:
            low_res = torch.where(is_obj[:, None, None], low_res,
                                  torch.full_like(low_res, NO_OBJ_SCORE))
        low_res = low_res.float()
        s = self.image_size
        high_res = resize2d(low_res.permute(0, 2, 3, 1), (s, s),
                            "bilinear").permute(0, 3, 1, 2)
        sam_token = sam_tokens[:, 0]
        if multimask_output and sam_tokens.shape[1] > 1:
            best = torch.argmax(ious, dim=-1)
            sam_token = sam_tokens[torch.arange(b, device=dev), best]
        obj_ptr = self.obj_ptr_proj(sam_token)
        if self.pred_obj_scores:
            lam = is_obj.to(obj_ptr.dtype)
            if self.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1 - lam) * self.no_obj_ptr.to(obj_ptr.dtype)
        return low_res, high_res, ious, obj_ptr, obj_logits


class Sam2ImagePredictor:
    """The reference predictor's surface (sam2/sam2_image_predictor.py):
    ``set_image`` then ``predict`` with points or a box, or
    ``predict_batch`` over single-point prompts.  Outputs are tensors on
    the model's device."""

    def __init__(self, model: Sam2ImageModel, mask_threshold: float = 0.0):
        self.model = model
        self.mask_threshold = mask_threshold
        self._features = None
        self._orig_hw = None

    @property
    def device(self) -> torch.device:
        return self.model.no_mem_embed.device

    @torch.no_grad()
    def set_image(self, image_rgb: np.ndarray) -> None:
        """uint8 / float RGB HWC -> cached features (square resize)."""
        self._orig_hw = tuple(image_rgb.shape[:2])
        img = preprocess(image_rgb, self.model.image_size)
        self._features = self.model.encode_image(
            torch.from_numpy(img)[None].to(self.device))

    def _scale(self) -> np.ndarray:
        h, w = self._orig_hw
        s = self.model.image_size
        return np.array([s / w, s / h], np.float32)

    def _to_original(self, high: torch.Tensor, return_logits: bool):
        masks = resize2d(high.permute(0, 2, 3, 1), self._orig_hw,
                         "bilinear").permute(0, 3, 1, 2)
        return masks if return_logits else masks > self.mask_threshold

    @torch.no_grad()
    def predict(self, point_coords=None, point_labels=None, box=None,
                multimask_output: bool = True, return_logits: bool = False):
        """point_coords / box in original-image pixels -> (masks [M, H, W]
        bool, or float logits with ``return_logits``; ious [M];
        low_res_logits [M, h, w]).  A box is two labeled corner points
        (labels 2 / 3), as the reference predictor encodes it."""
        assert self._features is not None, "call set_image first"
        scale = self._scale()
        pts, lbls = [], []
        if point_coords is not None:
            pts.append(np.asarray(point_coords, np.float32) * scale)
            lbls.append(np.asarray(point_labels, np.float32))
        if box is not None:
            pts.append(np.asarray(box, np.float32).reshape(2, 2) * scale)
            lbls.append(np.asarray([2.0, 3.0], np.float32))
        dev = self.device
        pc = torch.from_numpy(np.concatenate(pts, axis=0)[None]).to(dev)
        pl = torch.from_numpy(np.concatenate(lbls, axis=0)[None]).to(dev)
        low, high, ious, _, _ = self.model.predict(
            self._features, pc, pl, multimask_output=multimask_output,
            apply_obj_gating=False)
        return self._to_original(high, return_logits)[0], ious[0], low[0]

    @torch.no_grad()
    def predict_batch(self, point_coords, point_labels=None,
                      multimask_output: bool = True,
                      return_logits: bool = False):
        """Single-point prompts [P, 2] (original pixels) over the cached
        image, decoded as one batch (the features broadcast to P) ->
        (masks [P, M, H, W], ious [P, M], low_res [P, M, h, w])."""
        assert self._features is not None, "call set_image first"
        pc = np.asarray(point_coords, np.float32) * self._scale()
        n = pc.shape[0]
        pl = (np.ones((n, 1), np.float32) if point_labels is None
              else np.asarray(point_labels, np.float32).reshape(n, 1))
        dev = self.device
        feats = {k: v.expand(n, *v.shape[1:])
                 for k, v in self._features.items()}
        low, high, ious, _, _ = self.model.predict(
            feats, torch.from_numpy(pc[:, None]).to(dev),
            torch.from_numpy(pl).to(dev), multimask_output=multimask_output,
            apply_obj_gating=False)
        return self._to_original(high, return_logits), ious, low


def on_device(model: nn.Module, device: Union[torch.device, str],
              generator: Optional[torch.Generator], name: str) -> nn.Module:
    """``model`` with vdn's initializers drawn from ``generator`` (seed 0
    by default), moved to ``device``: the card unless the caller asks for
    the CPU, where a build without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device; pass device='cpu' to "
                           f"build on the CPU")
    init_parameters(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
    return model.to(device).eval()


def build_sam2_image_model(trunk_variant: str = "hiera_base_plus",
                           image_size: int = 1024,
                           compute_dtype: Optional[torch.dtype] = None,
                           device: Union[torch.device, str] = "cuda",
                           generator: Optional[torch.Generator] = None,
                           **kw) -> Sam2ImageModel:
    """A Sam2ImageModel (sam2.1 flags; ``kw`` goes to it) with seeded
    random parameters, on the card unless ``device`` says otherwise."""
    return on_device(Sam2ImageModel(trunk_variant, image_size=image_size,
                                    compute_dtype=compute_dtype, **kw),
                     device, generator, "Sam2ImageModel")
