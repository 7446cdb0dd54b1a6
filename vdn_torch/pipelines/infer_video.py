"""Windowed clip inference with keyframe re-anchoring and stitching
(vdn/pipelines/infer_video.py).

The reference protocol (reference video_depth_anything/video_depth.py:
67-156) with its constants unchanged: 32-frame windows at stride 22, the
first 10 inputs of each window are the previous window's KEYFRAMES, then
per-window least-squares scale/shift alignment against keyframe
references and an 8-frame cross-fade.

The first window encodes all 32 frames; every later window encodes only
its 22 new frames and gathers the 10 seed frames' encoder features from
the previous window on the device (``index_select`` at KEYFRAMES).  Depth
goes to the host once per window; stitching is numpy.  For a
``quantize="int8_static"`` model the first window is the calibration pass
(vdn/pipelines/infer_video.py:61-76, 117-124): the encoder runs int8 in it
and the head convs float while they record their scales, on top of the
scales the model holds (``load_quant_stats`` or an earlier pass); its depth
and features seed the cache as in any first window.  As in vdn, where the
pass merges into a local copy of the params, the call leaves the model's
scales as it found them.

``cache_encoder=False`` (or a ``forward_fn``) is vdn's re-encoding path
(vdn/pipelines/infer_video.py:80-99, 129-140): every window encodes all 32
frames, its first OVERLAP inputs copied from the previous window's input
at KEYFRAMES, and ``forward_fn(x)`` (the model's forward by default) gives
the depth.  It runs no calibration pass: an int8_static model serves on
the scales it holds (per frame where it holds none), as vdn's plain apply.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vdn_torch.nn.layers import quant_calibration, restored_quant_stats
from vdn_torch.ops.resize import resize2d
from vdn_torch.ops.scale_shift import interpolate_frames_np, scale_and_shift_np
from vdn_torch.pipelines.transform import (adjust_input_size_for_ratio,
                                           preprocess_frame)

# infer settings, do not change (reference video_depth.py:29-33)
INFER_LEN = 32
OVERLAP = 10
KEYFRAMES = [0, 12, 24, 25, 26, 27, 28, 29, 30, 31]
INTERP_LEN = 8


def gather_seed_features(prev_feats, keyframes: torch.Tensor):
    """Previous window's per-frame features -> those of the KEYFRAMES."""
    def gather(a):
        a = a.reshape(-1, INFER_LEN, *a.shape[1:]).index_select(1, keyframes)
        return a.reshape(-1, *a.shape[2:])
    return [tuple(gather(a) for a in layer) for layer in prev_feats]


@torch.no_grad()
def infer_video_depth(model, frames: np.ndarray, target_fps: float,
                      input_size: int = 518,
                      forward_fn: Optional[Callable] = None,
                      cache_encoder: bool = True):
    """frames: [N, H, W, 3] RGB (uint8 or float 0-255).

    Returns (depths [N, H, W] fp32 numpy at source resolution, target_fps).

    ``cache_encoder`` (default): reuse the previous window's encoder
    features for the KEYFRAMES seed frames instead of re-encoding them.
    ``forward_fn`` (x [1, 32, h, w, 3] on the model's device -> depth [1,
    32, h, w]) forces the re-encoding path, as ``cache_encoder=False``
    does with the model's own forward.
    """
    device = next(model.parameters()).device
    n_frames = len(frames)
    frame_h, frame_w = frames[0].shape[:2]
    input_size = adjust_input_size_for_ratio(frame_h, frame_w, input_size)

    frame_list = [frames[i] for i in range(n_frames)]
    frame_step = INFER_LEN - OVERLAP
    append_len = ((frame_step - (n_frames % frame_step)) % frame_step
                  + (INFER_LEN - frame_step))
    frame_list = frame_list + [frame_list[-1].copy()] * append_len

    def window_input(start, lo, hi):
        x = np.stack([preprocess_frame(frame_list[start + i], input_size)
                      for i in range(lo, hi)], axis=0)[None]
        return torch.from_numpy(x).to(device)

    if forward_fn is not None:
        cache_encoder = False
    elif not cache_encoder:
        forward_fn = model

    keyframes = torch.tensor(KEYFRAMES, device=device)
    depth_list = []
    prev_feats = pre_input = None
    with restored_quant_stats(model):
        for frame_id in range(0, n_frames, frame_step):
            if not cache_encoder:
                x = window_input(frame_id, 0, INFER_LEN)
                if pre_input is not None:
                    x[:, :OVERLAP] = pre_input.index_select(1, keyframes)
                depth = forward_fn(x)
                pre_input = x
            elif prev_feats is None:
                with quant_calibration(model):
                    depth, prev_feats = model.forward_window(
                        window_input(frame_id, 0, INFER_LEN))
            else:
                depth, prev_feats = model.forward_window_cached(
                    window_input(frame_id, OVERLAP, INFER_LEN),
                    gather_seed_features(prev_feats, keyframes))
            depth = resize2d(depth[0][..., None], (frame_h, frame_w),
                             "bilinear", align_corners=True)[..., 0]
            depth = depth.cpu().numpy()
            depth_list += [depth[i] for i in range(depth.shape[0])]

    # ---- stitching (reference video_depth.py:118-154) ----
    aligned = []
    ref_align = []
    align_len = OVERLAP - INTERP_LEN
    kf_align_list = KEYFRAMES[:align_len]

    for frame_id in range(0, len(depth_list), INFER_LEN):
        if not aligned:
            aligned += depth_list[:INFER_LEN]
            for kf_id in kf_align_list:
                ref_align.append(depth_list[frame_id + kf_id])
        else:
            curr_align = [depth_list[frame_id + i]
                          for i in range(len(kf_align_list))]
            scale, shift = scale_and_shift_np(
                np.concatenate(curr_align), np.concatenate(ref_align),
                np.ones_like(np.concatenate(ref_align)))

            pre_depths = aligned[-INTERP_LEN:]
            post_depths = depth_list[frame_id + align_len:
                                     frame_id + OVERLAP]
            post_depths = [np.maximum(d * scale + shift, 0)
                           for d in post_depths]
            aligned[-INTERP_LEN:] = interpolate_frames_np(pre_depths,
                                                          post_depths)
            for i in range(OVERLAP, INFER_LEN):
                aligned.append(np.maximum(
                    depth_list[frame_id + i] * scale + shift, 0))
            ref_align = ref_align[:1]
            for kf_id in kf_align_list[1:]:
                ref_align.append(np.maximum(
                    depth_list[frame_id + kf_id] * scale + shift, 0))

    return np.stack(aligned[:n_frames], axis=0), target_fps
