"""Dataset base: sequence scanning + load/crop/resize pipeline
(vdn/data/base.py).

Re-design of the shared structure of the seven reference dataset classes
(reference data/SintelDataset.py:16-260 et al.): each dataset scans its
directory layout into "sequence pointers" (dicts of per-type frame-path
lists), and frames pass through the same pipeline:

  load -> (upscale if smaller than output) -> random/center crop ->
  final resize to output_size

Host code, numpy and cv2 as vdn's, so that an item is vdn's bit for bit:
RGB floats in [0,1] HWC, depth [H, W] fp32, masks [H, W] bool; batches
are NHWC numpy (``vdn_torch.data.factory.prefetch_to_device`` moves them
to the card).  cv2 is imported in ``_resize``, the one place that calls
it: a frame at least as large as the output, random- or centre-cropped
to it, never reaches it, so a dataset whose ``read_frame`` needs no cv2
runs on a machine without it.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SequenceFolderDataset", "make_windows", "read_dpt_file"]


def read_dpt_file(filepath: str) -> np.ndarray:
    """Sintel .dpt depth reader (reference SintelDataset.py:84-108)."""
    with open(filepath, "rb") as f:
        tag = np.fromfile(f, dtype=np.float32, count=1)
        if tag != np.float32(202021.25):
            raise IOError(f"Invalid dpt file tag in {filepath}")
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        data = np.fromfile(f, dtype=np.float32, count=-1)
        if data.size != width * height:
            raise IOError(f"Dpt file size mismatch in {filepath}")
        return data.reshape(height, width)


def make_windows(files_per_type: Dict[str, List[str]], seq_len: int,
                 stride: int) -> List[Dict[str, List[str]]]:
    """Slice aligned per-type frame lists into stride-separated windows
    (reference SintelDataset.py:110-161 pointer creation)."""
    lengths = [len(v) for v in files_per_type.values()]
    if not lengths or min(lengths) < seq_len:
        return []
    n = min(lengths)
    out = []
    for start in range(0, n - seq_len + 1, stride):
        out.append({dt: files[start:start + seq_len]
                    for dt, files in files_per_type.items()})
    return out


class SequenceFolderDataset:
    """Base class; subclasses implement ``scan()`` and ``read_frame()``."""

    #: interpolation for non-rgb types ("linear" or "nearest")
    depth_interp = "linear"

    def __init__(self, root_dir: str,
                 data_types: Sequence[str] = ("rgb", "depth"),
                 sequence_length: int = 8, sequence_stride: int = 1,
                 output_size: Tuple[int, int] = (436, 1024),
                 use_random_crop: bool = False, seed: int = 0, **kwargs):
        if not os.path.isdir(root_dir):
            raise FileNotFoundError(f"Root directory not found: {root_dir}")
        self.root_dir = root_dir
        self.data_types = list(data_types)
        self.sequence_length = sequence_length
        self.sequence_stride = sequence_stride
        self.output_size = tuple(output_size)
        self.use_random_crop = use_random_crop
        self._rng = np.random.default_rng(seed)
        self.extra = kwargs
        self.samples = self.scan()
        if not self.samples:
            raise RuntimeError(
                f"No valid data found under {root_dir} "
                f"for {type(self).__name__}")

    # ---- subclass API -------------------------------------------------
    def scan(self) -> List[Dict[str, List[str]]]:
        raise NotImplementedError

    def read_frame(self, path: str, data_type: str) -> np.ndarray:
        """-> float32 HWC (rgb) or HW (depth/mask-as-float)."""
        raise NotImplementedError

    # ---- pipeline -----------------------------------------------------
    def __len__(self) -> int:
        return len(self.samples)

    def _resize(self, img: np.ndarray, size_hw: Tuple[int, int],
                data_type: str) -> np.ndarray:
        import cv2
        interp = cv2.INTER_LINEAR
        if data_type != "rgb" and self.depth_interp == "nearest":
            interp = cv2.INTER_NEAREST
        return cv2.resize(img, (size_hw[1], size_hw[0]),
                          interpolation=interp)

    def _transform(self, img: np.ndarray, data_type: str,
                   pre_resize: Optional[Tuple[int, int]],
                   crop: Optional[Tuple[int, int, int, int]]) -> np.ndarray:
        th, tw = self.output_size
        if pre_resize is not None and img.shape[:2] != pre_resize:
            img = self._resize(img, pre_resize, data_type)
        h, w = img.shape[:2]
        if crop is not None:
            top, left, ch, cw = crop
            img = img[top:top + ch, left:left + cw]
        else:  # center crop
            top = max((h - th) // 2, 0)
            left = max((w - tw) // 2, 0)
            img = img[top:top + th, left:left + tw]
        if img.shape[:2] != (th, tw):
            img = self._resize(img, (th, tw), data_type)
        return img

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        paths = self.samples[idx]
        th, tw = self.output_size

        ref = self.read_frame(paths["rgb"][0], "rgb")
        h, w = ref.shape[:2]
        pre_resize = None
        if h < th or w < tw:
            scale = max(th / h, tw / w)
            pre_resize = (math.ceil(h * scale), math.ceil(w * scale))
            h, w = pre_resize

        crop = None
        if self.use_random_crop:
            top = int(self._rng.integers(0, max(h - th, 0) + 1))
            left = int(self._rng.integers(0, max(w - tw, 0) + 1))
            crop = (top, left, th, tw)

        out: Dict[str, np.ndarray] = {}
        for dt, frame_paths in paths.items():
            frames = [self._transform(self.read_frame(p, dt), dt,
                                      pre_resize, crop)
                      for p in frame_paths]
            arr = np.stack(frames, axis=0)
            if dt == "mask":
                arr = arr.astype(bool)
            out[dt] = arr
            out[f"{dt}_paths"] = list(frame_paths)
        return out
