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

Native checkpoints (vdn/core/checkpoint.py:132-185, orbax there):
``save_pytree`` / ``restore_pytree`` write and read one state dict with
``torch.save`` / ``torch.load(weights_only=True)``; ``TrainCheckpointer``
keeps the last ``max_to_keep`` training states (model, optimizer,
scheduler, epoch) of a run.  Its saves are asynchronous as orbax's are:
``save`` queues a copy of every tensor on the tensors' own stream (pinned
host memory, ``non_blocking``), so the copy reads each parameter and
optimizer moment before any later launch on that stream (the next
``optimizer.step()``) writes it in place, and returns; a background
thread waits for the copies and writes the file.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

__all__ = ["DEFAULT_SKIP", "load_torch_checkpoint", "load_checkpoint",
           "save_pytree", "restore_pytree", "TrainCheckpointer"]

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


def save_pytree(path: str, tree: Any) -> None:
    """``tree`` (a state dict, or a module's) to ``path`` with
    ``torch.save``, written whole or not at all (a temporary file, then a
    rename)."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)


def restore_pytree(path: str, template: Optional[Any] = None) -> Any:
    """The state dict at ``path`` (``torch.load(weights_only=True)``, on the
    CPU); with a module as ``template``, loaded into it (strict) and the
    module returned."""
    state = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if isinstance(template, nn.Module):
        template.load_state_dict(state)
        return template
    return state


def _snapshot(tree: Any, pinned: bool) -> Any:
    """A copy of ``tree`` (dicts, lists, tuples; tensors copied to the host,
    the rest kept).  A CUDA tensor's copy is queued on its current stream
    into pinned memory (``pinned``), so it reads the tensor as it stands at
    this point of the stream; a CPU tensor is cloned at once."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
            out.copy_(t, non_blocking=pinned)
            return out
        return t.clone()
    if isinstance(tree, dict):
        return {k: _snapshot(v, pinned) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v, pinned) for v in tree)
    return tree


class TrainCheckpointer:
    """The training state of a run, one ``<step>.pt`` file a save under
    ``directory``, the newest ``max_to_keep`` kept.

    ``save(step, state)`` takes ``{"model": module, "optimizer": optimizer,
    "scheduler": scheduler, "epoch": int}`` (any key may be missing) and
    returns once the copies of its tensors are queued; ``wait()`` or the
    final ``close()`` blocks until the files are written.
    ``restore_latest(model, optimizer, scheduler)`` loads the newest file
    into them and returns its epoch (None without a file); with
    ``BatchLoader.set_epoch`` it gives a deterministic resume."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def steps(self) -> list:
        """The saved steps, oldest first."""
        return sorted(int(n[:-3]) for n in os.listdir(self.directory)
                      if n.endswith(".pt") and n[:-3].isdigit())

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        self.wait()
        tree = {k: (v.state_dict() if hasattr(v, "state_dict") else v)
                for k, v in state.items()}
        pinned = torch.cuda.is_available()
        snap = _snapshot(tree, pinned)
        event = None
        if pinned:  # after the copies queued on the current stream
            event = torch.cuda.Event()
            event.record()

        def write():
            try:
                if event is not None:
                    event.synchronize()
                save_pytree(self._path(step), snap)
                for old in self.steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))
            except Exception as exc:  # raised again by wait()
                self._error = exc

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def restore_latest(self, model: Optional[nn.Module] = None,
                       optimizer=None, scheduler=None) -> Optional[int]:
        step = self.latest_step()
        if step is None:
            return None
        state = restore_pytree(self._path(step))
        for key, target in (("model", model), ("optimizer", optimizer),
                            ("scheduler", scheduler)):
            if target is not None:
                target.load_state_dict(state[key])
        return int(state["epoch"])

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

