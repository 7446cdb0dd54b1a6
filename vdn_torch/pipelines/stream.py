"""Streaming video depth: bounded memory over clips of any length
(vdn/pipelines/stream.py).

The reference streaming policy (reference video_depth_stream.py:57-59,
133-158), replicated exactly: each frame attends over 31 cache entries --
entries [0:2] + [-29:] of the logical list, frame 0 being a permanent
anchor -- plus its own, and after frame id >= 11 the second-oldest entry is
evicted (GAP = 41).  The cache is eight fixed-capacity rings on the model's
device, one per attention block, in the compute dtype: [h * N_i, CAPACITY,
dpad_i] of position-free packed K/V (vdn_torch.nn.motion).  The host keeps
only the logical-slot indirection (lists of ints); cache tensors never leave
the device, and slot writes update the rings in place.

Paths:

- the first frame decodes alone and its entries are replicated over the
  first INFER_LEN slots (reference video_depth_stream.py:117); for a
  ``quantize="int8_static"`` model it is also the calibration pass of the
  head's convs (vdn/pipelines/stream.py:180-194), after a ``reset()`` on
  top of the scales the model keeps (the running max, as vdn's);
- one frame (``_step_one``): B1 (``select_rows``) gathers the 31-entry
  window out of every ring with a [31, CAPACITY] one-hot, the model
  decodes, and the frame's entries are written to its slot;
- k > 1 frames (``_step_batched``): the whole chunk decodes in one window
  attention per block (``_chunk_window``), each frame reading its window
  out of [ring | in-chunk entries] through a host-built column map; the
  ring writes follow, last writer wins per slot.

Both give the per-frame result up to the order of fp32 sums.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vdn_torch.kernels.resize import select_rows
from vdn_torch.nn.layers import quant_calibration
from vdn_torch.ops.resize import resize2d
from vdn_torch.pipelines.transform import (adjust_input_size_for_ratio,
                                           preprocess_frame)

INFER_LEN = 32
OVERLAP = 10
INTERP_LEN = 8
GAP = (INFER_LEN - OVERLAP) * 2 - 1 - (OVERLAP - INTERP_LEN)  # == 41
CAPACITY = GAP + 2  # most logical entries ever alive (43)


class VideoDepthStreamPipeline:
    """Streaming pipeline over a VideoDepthAnything (vdn_torch) model."""

    def __init__(self, model, input_size: int = 518):
        self.model = model
        self.default_input_size = input_size
        self.device = next(model.parameters()).device
        self.reset()

    def reset(self):
        self.input_size: Optional[int] = None
        self.frame_hw: Optional[Tuple[int, int]] = None
        self.slots: List[int] = []       # logical order -> physical slot
        self.free: List[int] = []
        self.buffers: Optional[Tuple[torch.Tensor, ...]] = None
        self.id = -1

    def _advance(self) -> Tuple[List[int], int]:
        """Host bookkeeping for one frame: cache window + write slot, then
        the sliding-window eviction (reference :155-158)."""
        sel = self.slots[0:2] + self.slots[-(INFER_LEN - 3):]
        assert len(sel) == INFER_LEN - 1
        slot = self.free.pop()
        self.slots.append(slot)
        if self.id + INFER_LEN > GAP + 1:
            self.free.append(self.slots.pop(1))
        return sel, slot

    def _decode(self, x: torch.Tensor, caches=None):
        """x [1, k, h, w, 3] -> (depth [k, frame_h, frame_w], the frames'
        cache entries)."""
        m = self.model
        depth, entries = m.forward_depth(m.forward_features(x), x.shape,
                                         caches, want_entries=True)
        depth = resize2d(depth[0, ..., None], self.frame_hw, "bilinear",
                         align_corners=True)[..., 0]
        return depth, entries

    def _write(self, entries, slots: List[int]) -> None:
        """In-chunk frame j's entries into ring slot slots[j], in order
        (last writer wins)."""
        for buf, e in zip(self.buffers, entries):
            for j, slot in enumerate(slots):
                buf[:, slot] = e[:, j]

    def _step_one(self, x: torch.Tensor, sel: List[int],
                  slot: int) -> torch.Tensor:
        onehot = torch.eye(CAPACITY, dtype=self.buffers[0].dtype,
                           device=self.device)[sel]             # [31, CAP]
        depth, entries = self._decode(
            x, tuple(select_rows(buf, onehot) for buf in self.buffers))
        self._write(entries, [slot])
        return depth

    def _step_batched(self, x: torch.Tensor, colsel: List[List[int]],
                      slots: List[int]) -> torch.Tensor:
        onehot = F.one_hot(torch.tensor(colsel, device=self.device),
                           CAPACITY + len(slots)).float()  # [k, 32, CAP + k]
        depth, entries = self._decode(
            x, tuple((buf, onehot) for buf in self.buffers))
        self._write(entries, slots)
        return depth

    def infer_video_depth_one(self, frame: np.ndarray) -> np.ndarray:
        """frame: RGB HWC (uint8 or float 0-255) -> depth [H, W] fp32."""
        return self.infer_video_depth_chunk([frame])[0]

    @torch.no_grad()
    def infer_video_depth_chunk(self, frames, fetch: bool = True) -> list:
        """Decode a chunk of frames; the same result as calling
        ``infer_video_depth_one`` on each.  Returns one depth [H, W] per
        frame: fp32 numpy, or with ``fetch=False`` tensors on the model's
        device that may still be in flight."""
        if self.input_size is None:
            h, w = frames[0].shape[:2]
            self.frame_hw = (h, w)
            self.input_size = adjust_input_size_for_ratio(
                h, w, self.default_input_size)
        xs = []
        for f in frames:
            assert f.shape[:2] == self.frame_hw
            xs.append(preprocess_frame(f, self.input_size))

        out: List[torch.Tensor] = []
        i = 0
        if self.buffers is None:
            self.id += 1
            x = torch.from_numpy(xs[0][None, None]).to(self.device)
            with quant_calibration(self.model):
                depth, entries = self._decode(x)
            self.buffers = tuple(
                e.new_zeros((e.shape[0], CAPACITY, e.shape[2]))
                for e in entries)
            for buf, e in zip(self.buffers, entries):
                buf[:, :INFER_LEN] = e
            self.slots = list(range(INFER_LEN))
            self.free = list(range(INFER_LEN, CAPACITY))
            if self.id + INFER_LEN > GAP + 1:
                self.free.append(self.slots.pop(1))
            out.append(depth[-1])
            i = 1

        if i < len(xs):
            sel, slots_w, colsel = None, [], []
            writer = {}  # physical slot -> in-chunk frame index
            for j in range(len(xs) - i):
                self.id += 1
                sel, slot = self._advance()
                colsel.append([CAPACITY + writer[s] if s in writer else s
                               for s in sel] + [CAPACITY + j])
                writer[slot] = j
                slots_w.append(slot)
            x = torch.from_numpy(np.stack(xs[i:])[None]).to(self.device)
            if len(slots_w) > 1:
                depths = self._step_batched(x, colsel, slots_w)
            else:
                depths = self._step_one(x, sel, slots_w[0])
            out.extend(depths)
        if fetch:
            return [d.cpu().numpy() for d in out]
        return out
