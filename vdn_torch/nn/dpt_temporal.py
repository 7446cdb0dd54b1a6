"""Temporal DPT head: the DPT decoder with four temporal mixers
(vdn/nn/dpt_temporal.py).

TemporalModules follow the layer_3 / layer_4 projections and refinenet4 /
refinenet3.  The three stages mirror vdn's split (frame-independent head,
frame-sequential middle, full-resolution tail); ``forward`` composes them
for the clip path, and the streaming pipeline calls them one by one.
``quantize`` reaches the DPT convs only; the temporal mixers stay float,
as in vdn.  ``pe`` ("ape" / "rope") and ``seq_axis`` (context parallel over
the frame axis) go to the four motion modules, ``cache_len`` to their
context-parallel streaming decode.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vdn_torch.nn.dpt import DPTHead
from vdn_torch.nn.motion import TemporalModule

NUM_MOTION_MODULES = 4
CACHE_ENTRIES_PER_MODULE = 2


class DPTHeadTemporal(DPTHead):
    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 num_frames: int = 32, quantize: Optional[str] = None,
                 pe: str = "ape", seq_axis: Optional[str] = None):
        super().__init__(in_channels, features, out_channels,
                         quantize=quantize)
        widths = (out_channels[2], out_channels[3], features, features)
        self.motion_modules = nn.ModuleList(
            TemporalModule(w, num_attention_heads=8, num_transformer_block=1,
                           num_attention_blocks=2,
                           temporal_max_len=num_frames,
                           pos_embedding_type=pe, seq_axis=seq_axis)
            for w in widths)

    def forward(self, out_features, patch_h: int, patch_w: int,
                frame_length: int) -> torch.Tensor:
        """Returns depth [(B*T), 14 ph, 14 pw, 1] fp32."""
        r1, r2, l3, l4 = self.decode_pre(out_features, patch_h, patch_w)
        p3, _ = self.decode_temporal(l3, l4, tuple(r2.shape[-3:-1]),
                                     frame_length)
        return self.decode_post(p3, r1, r2, (patch_h * 14, patch_w * 14))

    def decode_pre(self, out_features, patch_h: int, patch_w: int):
        """Frame-independent head: projections + the l1/l2 RCU convs."""
        l1, l2, l3, l4 = self.project_features(out_features, patch_h, patch_w)
        return self.scratch.layer1_rn(l1), self.scratch.layer2_rn(l2), l3, l4

    def decode_temporal(self, l3, l4, r2_hw: Tuple[int, int],
                        frame_length: int, caches=None,
                        want_entries: bool = False,
                        cache_len: Optional[int] = None):
        """All four temporal mixers and the refinenet4/3 fusion between.

        Returns (p3 at r2's resolution, entries): ``entries`` is the tuple of
        8 new cache entries when ``caches`` is given (8 gathered windows,
        or 8 (ring, one-hot) pairs) or ``want_entries`` is set (the
        stream's first frame), else None -- the clip path pays nothing for
        them.  ``cache_len``: with ``seq_axis`` and gathered windows, the
        valid entries of the window over the whole seq axis (each rank's
        caches are its shard, zero-padded so the window divides the
        axis)."""
        t = frame_length
        mm, s = self.motion_modules, self.scratch
        stream = caches is not None or want_entries
        entries = []

        def mix(i, x):
            if not stream:
                return mm[i](x, t)
            k = CACHE_ENTRIES_PER_MODULE
            sub = None if caches is None else list(caches[k * i:k * (i + 1)])
            y, e = mm[i].forward_stream(x, t, sub, cache_len)
            entries.extend(e)
            return y

        r3 = s.layer3_rn(mix(0, l3))
        r4 = s.layer4_rn(mix(1, l4))
        p4 = mix(2, s.refinenet4(r4, None, tuple(r3.shape[-3:-1])))
        p3 = mix(3, s.refinenet3(p4, r3, tuple(r2_hw)))
        return p3, (tuple(entries) if stream else None)

    def decode_post(self, p3, r1, r2, out_hw) -> torch.Tensor:
        """Frame-independent full-resolution tail."""
        p2 = self.scratch.refinenet2(p3, r2, tuple(r1.shape[-3:-1]))
        p1 = self.scratch.refinenet1(p2, r1, None)
        depth, _ = self.scratch.output_head(p1, out_hw)
        return depth
