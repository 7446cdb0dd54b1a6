"""Connected-components labelling for SAM2's mask post-processing
(vdn/ops/connected_components.py; reference sam2/utils/misc.py:47-63 over
sam2/csrc/connected_components.cu).

8-connectivity labels and per-pixel component areas over binary masks, on
tensors: on the card the hand-written kernel
(vdn_torch.kernels.connected_components, one launch for a batch of
masks), on the CPU its plain version.  The labels are vdn's C++
union-find's bit for bit (native/connected_components.cc): 1-based over
the foreground in the raster order of each component's first pixel, 0 on
the background; areas carry the component's size at each of its pixels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vdn_torch.kernels.connected_components import connected_components

__all__ = ["get_connected_components", "fill_holes_in_mask_scores",
           "remove_small_sprinkles"]


def get_connected_components(mask: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask [N, H, W] (or [N, 1, H, W]) binary -> (labels, areas), the same
    shape, int32 (a nonzero value is foreground; a float mask truncates to
    uint8 first, as vdn's astype does)."""
    if mask.dim() == 4:
        labels, areas = connected_components(mask[:, 0])
        return labels[:, None], areas[:, None]
    return connected_components(mask)


def fill_holes_in_mask_scores(mask: torch.Tensor,
                              max_area: int) -> torch.Tensor:
    """Small negative regions (holes of at most ``max_area`` pixels) set to
    the small positive score 0.1 (reference sam2/utils/misc.py:309-325)."""
    if max_area <= 0:
        raise ValueError(f"max_area must be positive, got {max_area}")
    _, areas = get_connected_components(mask <= 0)
    return torch.where((areas > 0) & (areas <= max_area), 0.1, mask)


def remove_small_sprinkles(mask: torch.Tensor,
                           max_area: int) -> torch.Tensor:
    """Small positive regions (at most ``max_area`` pixels) set to -0.1
    (0 in an integer or bool mask), as vdn's."""
    _, areas = get_connected_components(mask > 0)
    fill = -0.1 if mask.is_floating_point() else 0
    return torch.where((areas > 0) & (areas <= max_area), fill, mask)
