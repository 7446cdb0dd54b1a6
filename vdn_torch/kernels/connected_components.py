"""Connected components (8-connectivity) of binary masks: labels and
per-pixel component areas (csrc/connected_components.cu).

The function of vdn's host union-find (native/connected_components.cc,
vdn/ops/connected_components.py), bit for bit: a component's root is its
smallest raster index; labels are 1-based over the foreground, numbered in
the raster order of each component's first pixel, 0 on the background;
areas hold the component's size at each of its pixels, 0 on the
background.  vdn has no Pallas form of it (it is not one of the TPU
kernels): the kernel keeps SAM2's masks on the card, where vdn copies them
to the host.

``connected_components(mask)`` takes mask [N, H, W] (nonzero = foreground,
as the C++ reads its uint8 bytes) on the card, one launch count a call; on
the CPU it takes the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vdn_torch.kernels import (check_kernel_args, launch, launches,
                               use_kernel)

CHUNK = 1024   # csrc/connected_components.cu: pixels of a rank chunk


def _as_bytes(mask: torch.Tensor) -> torch.Tensor:
    """The mask as the C++ reads it: uint8 (a float truncates, as numpy's
    astype does), [N, H, W] contiguous."""
    if mask.dim() != 3:
        raise ValueError(f"connected_components: mask [N, H, W], got "
                         f"{tuple(mask.shape)}")
    return mask.to(torch.uint8).contiguous()


def _neighbour_min(lab: torch.Tensor, fg: torch.Tensor, big: int
                   ) -> torch.Tensor:
    """The least label over each foreground pixel and its foreground
    8-neighbours (background reads as ``big``)."""
    n, h, w = lab.shape
    pad = torch.full((n, h + 2, w + 2), big, dtype=lab.dtype,
                     device=lab.device)
    pad[:, 1:-1, 1:-1] = torch.where(fg, lab, big)
    m = pad[:, 1:-1, 1:-1].clone()
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy != 1 or dx != 1:
                m = torch.minimum(m, pad[:, dy:dy + h, dx:dx + w])
    return torch.where(fg, m, lab)


def connected_components_plain(mask: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in torch, by hooking and pointer jumping:
    every pixel's parent starts at itself (a raster index of the batch);
    each round hooks each root to the least root among its pixels'
    foreground 8-neighbours (scatter of the minimum: roots only ever move
    to a smaller index of the same component), then jumps (``lab =
    lab[lab]``) until every parent is a root.  When no root moves, each
    component is one tree rooted at its smallest index.  Pure neighbour-min
    propagation would need as many rounds as a component's longest path (a
    1024 x 1024 spiral: ~500k); the jumps keep the rounds near the log.
    Then each image's roots are ranked in raster order (cumsum) and the
    areas counted (bincount)."""
    m = _as_bytes(mask)
    n, h, w = m.shape
    fg = m != 0
    total = n * h * w
    idx = torch.arange(total, device=m.device).reshape(n, h, w)
    lab = idx.clone()
    while True:
        hook = _neighbour_min(lab, fg, total)
        flat = lab.reshape(-1)
        before = flat.clone()
        flat.scatter_reduce_(0, flat[fg.reshape(-1)],
                             hook.reshape(-1)[fg.reshape(-1)], "amin")
        while True:
            jumped = flat[flat]
            if torch.equal(jumped, flat):
                break
            flat.copy_(jumped)
        if torch.equal(flat, before):
            break
    flat = lab.reshape(-1)
    is_root = fg.reshape(-1) & (flat == idx.reshape(-1))
    rank = torch.cumsum(is_root.reshape(n, h * w).int(), dim=1).reshape(-1)
    labels = torch.where(fg.reshape(-1), rank[flat], 0)
    counts = torch.bincount(flat[fg.reshape(-1)], minlength=total)
    areas = torch.where(fg.reshape(-1), counts[flat], 0)
    return (labels.int().reshape(n, h, w), areas.int().reshape(n, h, w))


def connected_components(mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask [N, H, W] (nonzero = foreground) -> (labels, areas) int32
    [N, H, W]; on a CUDA tensor one launch of the kernel (N masks), on the
    CPU the plain version."""
    if not use_kernel(mask):
        return connected_components_plain(mask)
    name = "connected_components"
    m = _as_bytes(mask)
    n, h, w = m.shape
    if n > 65535 or h > 65535 or h * w >= 2 ** 31:
        raise ValueError(f"{name}: N, H <= 65535 and H * W < 2^31, got "
                         f"{tuple(m.shape)}")
    labels = torch.empty((n, h, w), dtype=torch.int32, device=m.device)
    areas = torch.empty_like(labels)
    roots = torch.zeros((n, -(-h * w // CHUNK)), dtype=torch.int32,
                        device=m.device)
    check_kernel_args(name, labels, areas, roots)
    launch("vdn_connected_components", m.data_ptr(), n, h, w,
           labels.data_ptr(), areas.data_ptr(), roots.data_ptr())
    launches[name] += 1
    return labels, areas
