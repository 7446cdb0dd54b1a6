"""Host-side preprocessing without cv2 (vdn/pipelines/transform.py).

``preprocess_frame`` resizes with torch's bicubic (align_corners=False,
A = -0.75), the same cubic kernel and half-pixel mapping as cv2's
INTER_CUBIC, then normalizes with the ImageNet statistics.  The two agree
to float32 rounding (tests/test_torch_modules.py states the tolerance).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["compute_resize_hw", "adjust_input_size_for_ratio",
           "preprocess_frame", "image2tensor_bgr", "IMAGENET_MEAN",
           "IMAGENET_STD"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _constrain_to_multiple_of(x: float, multiple: int, min_val: int = 0
                              ) -> int:
    y = int(np.round(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def compute_resize_hw(height: int, width: int, target: int = 518,
                      multiple: int = 14) -> Tuple[int, int]:
    """'lower_bound' keep-aspect size selection (reference
    util/transform.py:62-107): both sides >= target, multiples of 14."""
    scale = max(target / height, target / width)
    return (_constrain_to_multiple_of(scale * height, multiple, target),
            _constrain_to_multiple_of(scale * width, multiple, target))


def adjust_input_size_for_ratio(height: int, width: int,
                                input_size: int = 518) -> int:
    """>16:9 inputs shrink the working size (reference video_depth.py:69-72)."""
    ratio = max(height, width) / min(height, width)
    if ratio > 1.78:
        input_size = int(input_size * 1.777 / ratio)
        input_size = round(input_size / 14) * 14
    return input_size


def preprocess_frame(frame_rgb: np.ndarray, input_size: int = 518
                     ) -> np.ndarray:
    """uint8/float RGB HWC frame -> normalized fp32 [h, w, 3] network input."""
    img = frame_rgb.astype(np.float32) / 255.0
    new_hw = compute_resize_hw(img.shape[0], img.shape[1], input_size)
    if new_hw != img.shape[:2]:
        t = torch.from_numpy(img).permute(2, 0, 1)[None]
        t = F.interpolate(t, size=new_hw, mode="bicubic", align_corners=False)
        img = t[0].permute(1, 2, 0).numpy()
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def image2tensor_bgr(raw_bgr: np.ndarray, input_size: int = 518
                     ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """BGR image (the cv2.imread convention) -> ([1, h, w, 3] network
    input, the image's own (H, W))."""
    h, w = raw_bgr.shape[:2]
    return preprocess_frame(raw_bgr[..., ::-1], input_size)[None], (h, w)
