"""Stateful single-image inference with cross-frame memory
(vdn/pipelines/infer_image.py).

A thin host wrapper with the reference's ergonomics
(``infer_image(raw_bgr, input_size)`` / ``clear_memory()``) over the
functional model: the memory lives in an explicit ring-buffer state carried
between calls, in the model's compute dtype on the model's device.  For a
``quantize="int8_static"`` model the first image (no memory yet) is the
calibration pass of the head's convs (vdn/pipelines/infer_image.py:34-55);
after ``clear_memory()`` the next first image calibrates again, on top of
the scales the model keeps (the running max, as vdn merges its stats into
``self.params``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vdn_torch.models.depth_anything_v2 import DepthAnythingV2
from vdn_torch.nn.layers import quant_calibration
from vdn_torch.nn.memory import init_memory_state, update_memory_state
from vdn_torch.ops.resize import resize2d
from vdn_torch.pipelines.transform import image2tensor_bgr


class DepthAnythingV2Pipeline:
    def __init__(self, model: DepthAnythingV2, capacity: int = 6):
        self.model = model
        self.capacity = capacity
        self.state: Optional[Dict] = None

    def clear_memory(self) -> None:
        self.state = None

    @torch.no_grad()
    def infer_image(self, raw_bgr: np.ndarray, input_size: int = 518
                    ) -> np.ndarray:
        """BGR image [H, W, 3] -> depth [H, W] fp32 at the image's size."""
        model = self.model
        device = next(model.parameters()).device
        x, (h, w) = image2tensor_bgr(raw_bgr, input_size)
        x = torch.from_numpy(x).to(device)
        if self.state is None:
            with quant_calibration(model):
                depth, mem_feat = model(x, None)
            # the bank holds compute-dtype values (vdn keeps the same
            # values in fp32)
            self.state = init_memory_state(
                x.shape[0], mem_feat.shape[1], mem_feat.shape[2],
                self.capacity, mem_feat.dtype, device)
        else:
            depth, mem_feat = model(x, self.state)
        self.state = update_memory_state(
            self.state, *model.encode_memory(mem_feat, depth))
        out = resize2d(depth[..., None], (h, w), "bilinear",
                       align_corners=True)
        return out[0, :, :, 0].cpu().numpy()
