"""Exact order statistics (vdn/ops/select.py).

vdn finds the k-th smallest value by radix select over the bit-planes of
fp32 (a TPU sort costs tens of milliseconds); on the GPU ``torch.kthvalue``
(or a sort) returns the same exact value.  As in vdn:

- ``kth_smallest`` is 1-indexed along the last axis, k clamped to [1, n],
  and carries no gradient;
- ``differentiable_value`` recovers such a value differentiably as the mean
  of the elements exactly equal to it, which spreads the cotangent evenly
  over exact ties (vdn's own tie rule).
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["kth_smallest", "differentiable_value"]


def kth_smallest(x: torch.Tensor, k: Union[int, torch.Tensor]
                 ) -> torch.Tensor:
    """Exact k-th smallest (1-indexed) along the last axis, k clamped to
    [1, n]; returns the batch shape, without gradient.  ``k`` is an int,
    or an integer tensor (scalar or of the batch shape) for a count the
    data decides, taken without a device round trip."""
    n = x.shape[-1]
    x = x.detach()
    if isinstance(k, int):
        return torch.kthvalue(x, min(max(k, 1), n), dim=-1).values
    k = torch.broadcast_to(k.to(torch.long).clamp(1, n), x.shape[:-1])
    return torch.sort(x, dim=-1).values.gather(-1, (k - 1)[..., None])[..., 0]


def differentiable_value(x: torch.Tensor, value: torch.Tensor
                         ) -> torch.Tensor:
    """``value`` (a statistic of x along the last axis) as the mean of the
    elements of x exactly equal to it: differentiable in x."""
    eq = x == value[..., None]
    n_eq = eq.sum(-1).clamp_min(1)
    return torch.where(eq, x, torch.zeros_like(x)).sum(-1) / n_eq
