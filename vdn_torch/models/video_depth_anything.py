"""Video depth model: DINOv2 encoder + temporal DPT head
(vdn/models/video_depth_anything.py).

- ``forward(x)``: x [B, T, H, W, 3] -> depth [B, T, H, W] fp32
- ``forward_features(x)``: the ViT's four intermediate layers over the
  flattened frames
- ``forward_depth(features, x_shape, caches, want_entries, cache_len)``:
  decode features of T frames, with the streaming cache entries when
  asked
- ``forward_window`` / ``forward_window_cached``: the window steps of
  vdn_torch.pipelines.infer_video, which reuse the previous window's
  encoder features for the seed frames (the encoder is per-frame, so the
  reuse is exact).

``quantize`` is the serving mode (vdn/models/video_depth_anything.py:
45-59): ``"int8"`` quantizes the encoder's projections and MLP (dynamic,
F1-F4) and the head's convs with per-frame scales; ``"int8_static"``
keeps the encoder dynamic and gives the head convs calibrated scales
(vdn_torch.nn.layers.quant_calibration; the pipelines calibrate on their
first window or frame).  Inference only.

``pe`` is the motion modules' position embedding ("ape", or temporal
"rope"); ``seq_axis`` (vdn_torch.parallel.mesh.SEQ_AXIS) makes the
temporal attention span that mesh axis: the model then runs on each rank's
block of frames, under vdn_torch.parallel.context.
make_context_parallel_forward (or ``use_mesh`` for the streaming decodes).
Neither adds a parameter: one state dict loads into every variant.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vdn_torch.models.presets import build_preset
from vdn_torch.nn.dpt_temporal import DPTHeadTemporal
from vdn_torch.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit
from vdn_torch.ops.resize import resize2d


class VideoDepthAnything(nn.Module):
    def __init__(self, encoder: str = "vitl", features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 num_frames: int = 32,
                 compute_dtype: torch.dtype = torch.float32,
                 quantize: Optional[str] = None, pe: str = "ape",
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.encoder = encoder
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        # the encoder's int8 kernels quantize per row at every call, so they
        # stay dynamic under the calibrated head mode
        enc_q = "int8" if quantize == "int8_static" else quantize
        self.pretrained = make_vit(encoder, enc_q)
        self.head = DPTHeadTemporal(self.pretrained.embed_dim, features,
                                    out_channels, num_frames, quantize, pe,
                                    seq_axis)

    def forward_features(self, x: torch.Tensor):
        """x [B, T, H, W, 3] -> 4 x (tokens [(B*T), N, C], cls)."""
        b, t, h, w, c = x.shape
        flat = x.reshape(b * t, h, w, c).to(self.compute_dtype)
        return self.pretrained.get_intermediate_layers(
            flat, INTERMEDIATE_LAYER_IDX[self.encoder])

    def forward_depth(self, features, x_shape: Tuple[int, ...], caches=None,
                      want_entries: bool = False,
                      cache_len: Optional[int] = None):
        """Decode features of T frames into (depth [B, T, H, W] fp32
        relu'd, cache entries).  Entries (tuple of 8) come back when
        ``caches`` is given or ``want_entries`` is set, else None; see
        DPTHeadTemporal.decode_temporal (also for ``cache_len``)."""
        b, t, h, w, _ = x_shape
        head = self.head
        ph, pw = h // 14, w // 14
        r1, r2, l3, l4 = head.decode_pre(features, ph, pw)
        p3, entries = head.decode_temporal(l3, l4, tuple(r2.shape[-3:-1]), t,
                                           caches, want_entries, cache_len)
        depth = head.decode_post(p3, r1, r2, (ph * 14, pw * 14))
        depth = resize2d(depth, (h, w), "bilinear", align_corners=True)
        depth = torch.relu(depth.float())
        return depth[..., 0].reshape(b, t, h, w), entries

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_depth(self.forward_features(x), x.shape)[0]

    def forward_window(self, x: torch.Tensor):
        """x [B, T, H, W, 3] -> (depth [B, T, H, W], features)."""
        features = self.forward_features(x)
        return self.forward_depth(features, x.shape)[0], features

    def forward_window_cached(self, x_new: torch.Tensor, seed_features):
        """Window forward over [seed ‖ new] frames; ``seed_features`` are
        previous-window encoder features for the first frames of this
        window (already gathered at the KEYFRAMES indices)."""
        b, t_new, h, w, c = x_new.shape
        t_seed = seed_features[0][0].shape[0] // b
        t = t_seed + t_new
        new_feats = self.forward_features(x_new)

        def cat(s, n):
            s = s.reshape(b, t_seed, *s.shape[1:])
            n = n.reshape(b, t_new, *n.shape[1:])
            return torch.cat([s, n], dim=1).reshape(b * t, *s.shape[2:])

        features = [tuple(cat(s, n) for s, n in zip(sl, nl))
                    for sl, nl in zip(seed_features, new_feats)]
        return self.forward_depth(features, (b, t, h, w, c))[0], features


def build_video_depth_anything(
        encoder: str = "vitl",
        compute_dtype: Union[torch.dtype, str] = torch.float32,
        device: Union[torch.device, str] = "cuda",
        generator: Optional[torch.Generator] = None,
        **kw) -> VideoDepthAnything:
    """A preset model with parameters drawn from ``generator`` (seed 0 by
    default) with vdn's initializers, in eval mode on ``device``: the card
    unless the caller asks for the CPU.

    On the card pass ``compute_dtype="bf16"``: the attention kernels take
    bf16 only, and from 256 tokens on (any image of 224 x 224 or more) a
    forward in the default fp32 raises ValueError at its first attention.
    fp32 on the card is for reference runs inside
    ``kernels.plain_reference()``.  ``quantize="int8"`` or
    ``"int8_static"`` in ``kw`` builds the serving mode, ``pe="rope"`` the
    temporal-RoPE motion modules, ``seq_axis="seq"`` the context-parallel
    model."""
    return build_preset(VideoDepthAnything, encoder, compute_dtype, device,
                        generator, **kw)
