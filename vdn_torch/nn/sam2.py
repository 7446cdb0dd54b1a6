"""SAM2's promptable-segmentation components (vdn/nn/sam2.py): the FPN
neck, the prompt encoder, the two-way transformer and the mask decoder
(reference sam2/modeling/backbones/image_encoder.py:44-134,
sam/prompt_encoder.py:16-202, sam/transformer.py:1-188,
sam/mask_decoder.py:1-295).

The memory attention and the memory encoder's fuser are
vdn_torch.nn.memory's; the Hiera trunk is vdn_torch.nn.hiera.  NHWC
feature maps, tokens [B, N, C].  The decoder's attention stays plain at
any length (vdn passes ``use_flash=False``): its queries are a handful of
tokens.

Dtypes follow vdn's promotion: fp32 parameters (embeddings, tokens) meet
the compute dtype's activations and promote, so under a bf16 compute
dtype the decoder's tokens, and after the first block its keys, run in
fp32 as vdn's do.

Parameter names are the reference checkpoint's (``point_embeddings.0``,
``mask_downscaling.0``, ``output_upscaling.0``, ``output_hypernetworks_
mlps.0.layers.0``, ``convs.0.conv``, ``pe_layer.positional_encoding_
gaussian_matrix``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vdn_torch.nn.layers import Conv2d, ConvTranspose2d, LayerNorm, Linear
from vdn_torch.nn.memory import sine_position_encoding
from vdn_torch.ops.attention import dot_product_attention
from vdn_torch.ops.resize import resize2d


class Embedding(nn.Embedding):
    """A torch Embedding whose rows are read whole (``weight``), drawn as
    flax's nn.Embed draws them: normal with std 1 / sqrt(features)."""

    def _init(self, g):
        self.weight.copy_(torch.randn(self.weight.shape, generator=g)
                          / math.sqrt(self.weight.shape[1]))


class SamGenericMLP(nn.Module):
    """sam2_utils.MLP: num_layers Linears with relu between, an optional
    sigmoid on the output; ``layers.0`` .. ``layers.{n-1}``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, sigmoid_output: bool = False):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class SamAttention(nn.Module):
    """SAM's attention with an optional internal downsampling
    (reference sam/transformer.py:189-248); always the plain path."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        c = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(embedding_dim, c)
        self.k_proj = Linear(embedding_dim, c)
        self.v_proj = Linear(embedding_dim, c)
        self.out_proj = Linear(c, embedding_dim)

    def forward(self, q, k, v) -> torch.Tensor:
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, nq, c = q.shape
        nk = k.shape[1]
        h = self.num_heads
        out = dot_product_attention(q.reshape(b, nq, h, c // h),
                                    k.reshape(b, nk, h, c // h),
                                    v.reshape(b, nk, h, c // h),
                                    use_flash=False)
        return self.out_proj(out.reshape(b, nq, c))


class TwoWayAttentionBlock(nn.Module):
    """(reference sam/transformer.py:110-188)"""

    def __init__(self, embedding_dim: int, num_heads: int,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        d = embedding_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SamAttention(d, num_heads, 1)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.cross_attn_token_to_image = SamAttention(
            d, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.mlp = SamGenericMLP(d, mlp_dim, d, 2)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.norm4 = LayerNorm(d, eps=1e-5)
        self.cross_attn_image_to_token = SamAttention(
            d, num_heads, attention_downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """(reference sam/transformer.py:1-108)"""

    def __init__(self, depth: int, embedding_dim: int, num_heads: int,
                 mlp_dim: int, attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = SamAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe [B, H, W, C]; point_embedding [B, N,
        C] -> (queries [B, N, C], keys [B, H * W, C])."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class RandomPositionEncoding(nn.Module):
    """PositionEmbeddingRandom (reference position_encoding.py:133-183):
    the gaussian matrix is the buffer
    ``positional_encoding_gaussian_matrix`` [2, F]."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def _init(self, g):
        self.positional_encoding_gaussian_matrix.copy_(torch.randn(
            self.positional_encoding_gaussian_matrix.shape, generator=g))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1]^2, [..., 2] -> [..., 2 F]."""
        coords = 2.0 * coords - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix.to(
            coords.dtype)
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    """(reference sam/prompt_encoder.py:16-202).  Point labels: -1 pad, 0
    negative, 1 positive, 2 / 3 box corners.  fp32 throughout (vdn casts
    its outputs to the compute dtype at the decoder)."""

    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16):
        super().__init__()
        c, mc = embed_dim, mask_in_chans
        self.embed_dim = c
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = RandomPositionEncoding(c // 2)
        self.point_embeddings = nn.ModuleList(Embedding(1, c)
                                              for _ in range(4))
        self.not_a_point_embed = Embedding(1, c)
        self.no_mask_embed = Embedding(1, c)
        self.mask_downscaling = nn.Sequential(
            Conv2d(1, mc // 4, 2, stride=2), LayerNorm(mc // 4),
            nn.GELU(), Conv2d(mc // 4, mc, 2, stride=2), LayerNorm(mc),
            nn.GELU(), Conv2d(mc, c, 1))

    def _coords(self, xy: torch.Tensor) -> torch.Tensor:
        """Pixel coordinates (x, y) -> [0, 1] by the input image's size."""
        hw = self.input_image_size
        return xy / torch.tensor([float(hw[1]), float(hw[0])],
                                 device=xy.device)

    def get_dense_pe(self, device=None) -> torch.Tensor:
        """[1, H, W, C] grid positional encoding."""
        device = device or self._device()
        h, w = self.image_embedding_size
        y = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
        return self.pe_layer(grid)[None]

    def _device(self) -> torch.device:
        return self.pe_layer.positional_encoding_gaussian_matrix.device

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                     pad: bool = True) -> torch.Tensor:
        """points [B, N, 2] (pixel coords), labels [B, N] -> [B, N(+1),
        C]."""
        points = points.float() + 0.5
        labels = labels.float()
        if pad:
            b = points.shape[0]
            points = torch.cat([points, points.new_zeros(b, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        emb = self.pe_layer(self._coords(points))
        labels = labels[..., None]
        emb = torch.where(labels == -1, self.not_a_point_embed.weight, emb)
        for i, e in enumerate(self.point_embeddings):
            emb = torch.where(labels == i, emb + e.weight, emb)
        return emb

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [B, 4] xyxy -> [B, 2, C]."""
        coords = (boxes.float() + 0.5).reshape(-1, 2, 2)
        emb = self.pe_layer(self._coords(coords))
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return emb + corner

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks [B, 4H, 4W, 1] -> dense embedding [B, H, W, C]."""
        return self.mask_downscaling(masks)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        h, w = self.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, h, w, self.embed_dim)

    def forward(self, points=None, labels=None, boxes=None, masks=None):
        """-> (sparse [B, N, C], dense [B, H, W, C])."""
        batch = 1
        sparse = []
        if points is not None:
            batch = points.shape[0]
            sparse.append(self.embed_points(points, labels,
                                            pad=boxes is None))
        if boxes is not None:
            batch = boxes.shape[0]
            sparse.append(self.embed_boxes(boxes))
        sparse = (torch.cat(sparse, dim=1) if sparse else torch.zeros(
            batch, 0, self.embed_dim, device=self._device()))
        dense = (self.embed_masks(masks) if masks is not None
                 else self.no_mask_dense(batch))
        return sparse, dense


class MaskDecoder(nn.Module):
    """(reference sam/mask_decoder.py:1-295), sam2.1 config: high-res skip
    features, object-score prediction, dynamic multimask stability."""

    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256,
                 use_high_res_features: bool = True,
                 pred_obj_scores: bool = True,
                 pred_obj_scores_mlp: bool = True,
                 use_multimask_token_for_obj_ptr: bool = True,
                 iou_prediction_use_sigmoid: bool = False,
                 dynamic_multimask_via_stability: bool = True,
                 dynamic_multimask_stability_delta: float = 0.05,
                 dynamic_multimask_stability_thresh: float = 0.98,
                 two_way_depth: int = 2, two_way_heads: int = 8,
                 two_way_mlp_dim: int = 2048):
        super().__init__()
        d = transformer_dim
        self.transformer_dim = d
        self.num_mask_tokens = num_multimask_outputs + 1
        self.use_high_res_features = use_high_res_features
        self.pred_obj_scores = pred_obj_scores
        self.use_multimask_token_for_obj_ptr = \
            use_multimask_token_for_obj_ptr
        self.dynamic_multimask_via_stability = \
            dynamic_multimask_via_stability
        self.stability_delta = dynamic_multimask_stability_delta
        self.stability_thresh = dynamic_multimask_stability_thresh
        self.transformer = TwoWayTransformer(two_way_depth, d, two_way_heads,
                                             two_way_mlp_dim)
        self.iou_token = Embedding(1, d)
        self.mask_tokens = Embedding(self.num_mask_tokens, d)
        if pred_obj_scores:
            self.obj_score_token = Embedding(1, d)
            self.pred_obj_score_head = (SamGenericMLP(d, d, 1, 3)
                                        if pred_obj_scores_mlp
                                        else Linear(d, 1))
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(d, d // 4, 2, 2), LayerNorm(d // 4), nn.GELU(),
            ConvTranspose2d(d // 4, d // 8, 2, 2))
        if use_high_res_features:
            self.conv_s0 = Conv2d(d, d // 8, 1)
            self.conv_s1 = Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            SamGenericMLP(d, d, d // 8, 3)
            for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = SamGenericMLP(
            d, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth,
            sigmoid_output=iou_prediction_use_sigmoid)

    def forward(self, image_embeddings, image_pe, sparse_prompts,
                dense_prompts, multimask_output: bool,
                high_res_features=None):
        """image_embeddings / dense [B, H, W, C]; image_pe [1, H, W, C];
        sparse [B, N, C] -> (masks [B, M, 4H, 4W], iou [B, M], sam_tokens
        [B, M', C], object_score_logits [B, 1])."""
        d = self.transformer_dim
        b = sparse_prompts.shape[0]
        toks = [self.iou_token.weight, self.mask_tokens.weight]
        s = 0
        if self.pred_obj_scores:
            toks = [self.obj_score_token.weight] + toks
            s = 1
        output_tokens = torch.cat(toks, dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1),
                            sparse_prompts], dim=1)
        src = image_embeddings + dense_prompts
        pos = image_pe.expand(src.shape)
        hs, keys = self.transformer(src, pos, tokens)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1:s + 1 + self.num_mask_tokens]

        _, hh, wh, _ = src.shape
        up = keys.reshape(b, hh, wh, d)
        conv0, norm, _, conv3 = self.output_upscaling
        if self.use_high_res_features:
            # pre-projected by project_high_res_features (the reference
            # applies conv_s0 / conv_s1 in SAM2Base, mask_decoder.py:221)
            feat_s0, feat_s1 = high_res_features
            x = F.gelu(norm(conv0(up) + feat_s1))
            upscaled = F.gelu(conv3(x) + feat_s0)
        else:
            upscaled = F.gelu(conv3(F.gelu(norm(conv0(up)))))
        hyper = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)],
                            dim=1)  # [B, M, d / 8]
        rt = torch.promote_types(hyper.dtype, upscaled.dtype)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper.to(rt),
                             upscaled.to(rt))
        iou_pred = self.iou_prediction_head(iou_token_out)
        if self.pred_obj_scores:
            object_score_logits = self.pred_obj_score_head(hs[:, 0])
        else:
            object_score_logits = masks.new_full((b, 1), 10.0)

        if multimask_output:
            masks_out, iou_out = masks[:, 1:], iou_pred[:, 1:]
            sam_tokens = (mask_tokens_out[:, 1:]
                          if self.use_multimask_token_for_obj_ptr
                          else mask_tokens_out[:, :1])
        elif self.dynamic_multimask_via_stability:
            masks_out, iou_out = self._dynamic_multimask(masks, iou_pred)
            sam_tokens = mask_tokens_out[:, :1]
        else:
            masks_out, iou_out = masks[:, :1], iou_pred[:, :1]
            sam_tokens = mask_tokens_out[:, :1]
        return masks_out, iou_out, sam_tokens, object_score_logits

    def project_high_res_features(self, fpn_s0, fpn_s1):
        """conv_s0 / conv_s1 on the stride-4 / 8 FPN maps (the reference
        runs these in SAM2Base before the decoder)."""
        return self.conv_s0(fpn_s0), self.conv_s1(fpn_s1)

    def stability_scores(self, mask_logits: torch.Tensor) -> torch.Tensor:
        flat = mask_logits.flatten(-2)
        delta = self.stability_delta
        area_i = (flat > delta).sum(-1).float()
        area_u = (flat > -delta).sum(-1).float()
        return torch.where(area_u > 0, area_i / area_u,
                           torch.ones_like(area_i))

    def _dynamic_multimask(self, all_logits, all_iou):
        """(reference mask_decoder.py:215-260): the single-mask output
        where it is stable, else the best of the multimask outputs."""
        multi_logits, multi_iou = all_logits[:, 1:], all_iou[:, 1:]
        best = torch.argmax(multi_iou, dim=-1)
        bidx = torch.arange(multi_iou.shape[0], device=best.device)
        best_logits = multi_logits[bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]
        single_logits, single_iou = all_logits[:, :1], all_iou[:, :1]
        stable = (self.stability_scores(single_logits)
                  >= self.stability_thresh)
        masks = torch.where(stable[..., None, None], single_logits,
                            best_logits)
        iou = torch.where(stable, single_iou, best_iou)
        return masks, iou


class NeckConv(nn.Module):
    """The torch Sequential wrapper ``convs.{i}.conv``
    (image_encoder.py:76-87)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FpnNeck(nn.Module):
    """FPN neck with sine position encodings
    (reference backbones/image_encoder.py:44-134).  Input: the trunk's
    features, stride 4 -> 32; output: d_model maps and their position
    encodings in the same order.  ``backbone_channel_list`` is high stride
    first, as the reference's."""

    def __init__(self, d_model: int = 256,
                 backbone_channel_list: Sequence[int] = (768, 384, 192, 96),
                 fpn_top_down_levels: Sequence[int] = (2, 3),
                 fpn_interp_model: str = "nearest"):
        super().__init__()
        self.d_model = d_model
        self.convs = nn.ModuleList(NeckConv(c, d_model)
                                   for c in backbone_channel_list)
        self.fpn_top_down_levels = tuple(fpn_top_down_levels)
        self.fpn_interp_model = fpn_interp_model

    def forward(self, xs: Sequence[torch.Tensor]):
        n = len(xs) - 1
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        pos: List[Optional[torch.Tensor]] = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](xs[i])
            if i in self.fpn_top_down_levels and prev is not None:
                h, w = prev.shape[1:3]
                top_down = resize2d(prev.float(), (2 * h, 2 * w),
                                    self.fpn_interp_model)
                prev = lateral + top_down.to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
            h, w = prev.shape[1:3]
            pos[i] = sine_position_encoding(
                h, w, self.d_model, prev.dtype, prev.device)[None].expand(
                    prev.shape)
        return out, pos
