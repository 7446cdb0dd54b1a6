"""Checkpoint IO (vdn/core/checkpoint.py).

``load_torch_checkpoint`` reads a torch ``.pth`` / ``.pt`` file (a released
checkpoint in the reference's layout, or ``torch.save(model.state_dict())``
of a port module) into a flat {name: fp32 tensor} dict under vdn's
contract: a ``model`` / ``state_dict`` / ``module`` wrapper is unwrapped
(vdn/core/checkpoint.py:123-126), only tensors are kept, floating tensors
are cast to fp32 (vdn/core/convert.py:103-104), and the registered buffers
that the modules rebuild are dropped (``DEFAULT_SKIP``,
vdn/core/convert.py:40-43).  The file is read with ``torch.load(...,
weights_only=True)``: no pickled code runs.  vdn's own reader drops a 0-d
tensor (it keeps only ``np.ndarray`` values); this one keeps it.

``load_checkpoint`` loads such a file into a port module: the port keeps
the reference's parameter names, so a released checkpoint loads
unchanged, and any other missing or unexpected key raises.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

__all__ = ["DEFAULT_SKIP", "load_torch_checkpoint", "load_checkpoint"]

# registered buffers the modules rebuild (vdn/core/convert.py:40-43)
DEFAULT_SKIP: Sequence[str] = (
    r"\.pe$",                # sinusoidal temporal positional encoding
    r"num_batches_tracked",  # torch BN bookkeeping
)
_SKIP = [re.compile(p) for p in DEFAULT_SKIP]


def _skipped(key: str) -> bool:
    return any(p.search(key) for p in _SKIP)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint -> {key: tensor} on the CPU, floating tensors in
    fp32, without the ``DEFAULT_SKIP`` keys."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper_key in ("model", "state_dict", "module"):
        if isinstance(obj, dict) and isinstance(obj.get(wrapper_key), dict):
            obj = obj[wrapper_key]
    if not isinstance(obj, dict):
        raise ValueError(f"unexpected checkpoint structure in {path}")
    return {k: v.float() if v.is_floating_point() else v
            for k, v in obj.items()
            if isinstance(v, torch.Tensor) and not _skipped(k)}


def load_checkpoint(model: nn.Module, path: str,
                    rename: Optional[Callable[[str], Optional[str]]] = None
                    ) -> None:
    """Load the checkpoint at ``path`` into ``model``'s parameters and
    buffers (copied onto their device and dtype).  ``rename`` rewrites each
    key first (None drops it), as vdn's converter takes it; e.g. the refine
    checkpoints' ``lambda k: rename_with_map(k, V4_RENAME_MAP)``
    (vdn_torch.train.trainer).  Raises KeyError naming every key of the
    model the file lacks (the ``DEFAULT_SKIP`` buffers excepted) and every
    key of the file the model lacks."""
    state = load_torch_checkpoint(path)
    if rename is not None:
        state = {new: v for new, v in ((rename(k), v) for k, v in
                                       state.items()) if new is not None}
    want = set(model.state_dict())
    missing = sorted(k for k in want - set(state) if not _skipped(k))
    unexpected = sorted(set(state) - want)
    if missing or unexpected:
        raise KeyError(f"{path}: missing keys {missing}, unexpected keys "
                       f"{unexpected}")
    model.load_state_dict(state, strict=False)
