"""Surface normals from depth maps (vdn/ops/normals.py; reference
utils/normal_utils.py:1-52).

depth [..., H, W] -> unit normals [..., H, W, 3] from reflect-padded Sobel
gradients, n = normalize([-Ix, -Iy, 1]), in the input's dtype (fp32 on the
refinement models' path).  The 3 x 3 stencils are written out as shifted
sums, so no convolution algorithm (TF32 on the card) changes the numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["sobel_ix_iy", "normal_vector"]

_KX = ((1, 0, -1), (2, 0, -2), (1, 0, -1))
_KY = ((1, 2, 1), (0, 0, 0), (-1, -2, -1))


def _stencil(p: torch.Tensor, k, h: int, w: int, scale: float):
    acc = None
    for i in range(3):
        for j in range(3):
            if k[i][j]:
                term = p[:, i:i + h, j:j + w] * (k[i][j] * scale)
                acc = term if acc is None else acc + term
    return acc


def sobel_ix_iy(img: torch.Tensor, normalize_kernel: bool = True):
    """img [..., H, W] -> (Ix, Iy), each [..., H, W]."""
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    p = F.pad(x, (1, 1, 1, 1), mode="reflect")[:, 0]
    scale = 1.0 / 8.0 if normalize_kernel else 1.0
    ix = _stencil(p, _KX, h, w, scale).reshape(*lead, h, w)
    iy = _stencil(p, _KY, h, w, scale).reshape(*lead, h, w)
    return ix, iy


def normal_vector(img: torch.Tensor, normalize_kernel: bool = True,
                  scale_xy: float = 1.0, scale_z: float = 1.0,
                  eps: float = 1e-8) -> torch.Tensor:
    """img [..., H, W] -> unit normals [..., H, W, 3]."""
    ix, iy = sobel_ix_iy(img, normalize_kernel)
    n = torch.stack([-scale_xy * ix, -scale_xy * iy,
                     scale_z * torch.ones_like(ix)], dim=-1)
    norm = torch.sqrt((n * n).sum(-1, keepdim=True) + eps)
    return n / norm
