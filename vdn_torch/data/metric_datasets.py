"""Metric-depth datasets: Hypersim, VKITTI2, KITTI
(vdn/data/metric_datasets.py; reference
metric_depth/dataset/{hypersim,vkitti2,kitti}.py).

File-list driven ("img_path depth_path" per line); preprocessing is the
DA-V2 lower-bound/multiple-of-14 resize + ImageNet norm, with a random
square crop for training.  Returns NHWC numpy samples
{image [h,w,3], depth [h,w] (meters), valid_mask [h,w]}.  cv2 and h5py
are imported where a file is read.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vdn_torch.pipelines.transform import (IMAGENET_MEAN, IMAGENET_STD,
                                           compute_resize_hw)

__all__ = ["Hypersim", "VKITTI2", "KITTI",
           "hypersim_distance_to_depth"]


def hypersim_distance_to_depth(distance: np.ndarray) -> np.ndarray:
    """Euclidean distance -> planar depth for Hypersim's pinhole
    (reference hypersim.py:11-24)."""
    width, height, focal = 1024, 768, 886.81
    px = np.linspace(-0.5 * width + 0.5, 0.5 * width - 0.5,
                     width).reshape(1, width).repeat(height, 0)[..., None]
    py = np.linspace(-0.5 * height + 0.5, 0.5 * height - 0.5,
                     height).reshape(height, 1).repeat(width, 1)[..., None]
    pz = np.full([height, width, 1], focal, np.float32)
    plane = np.concatenate([px, py, pz], axis=2).astype(np.float32)
    return distance / np.linalg.norm(plane, 2, 2) * focal


class _FileListDataset:
    def __init__(self, filelist_path: str, mode: str,
                 size: Tuple[int, int] = (518, 518), seed: int = 0):
        self.mode = mode
        self.size = size
        self._rng = np.random.default_rng(seed)
        with open(filelist_path) as f:
            self.filelist = [ln for ln in f.read().splitlines() if ln]

    def __len__(self):
        return len(self.filelist)

    def _read_depth(self, path: str) -> np.ndarray:
        raise NotImplementedError

    def _postprocess(self, sample: Dict) -> Dict:
        return sample

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        import cv2
        img_path, depth_path = self.filelist[item].split(" ")[:2]
        img = cv2.imread(img_path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        depth = self._read_depth(depth_path)

        h, w = img.shape[:2]
        new_h, new_w = compute_resize_hw(h, w, self.size[0])
        img = cv2.resize(img, (new_w, new_h),
                         interpolation=cv2.INTER_CUBIC)
        resize_target = self.mode == "train"
        if resize_target and depth.shape[:2] != (new_h, new_w):
            depth = cv2.resize(depth, (new_w, new_h),
                               interpolation=cv2.INTER_NEAREST)
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        if self.mode == "train":  # random square crop (transform.py:247-272)
            th, tw = self.size
            hs = int(self._rng.integers(0, new_h - th + 1))
            ws = int(self._rng.integers(0, new_w - tw + 1))
            img = img[hs:hs + th, ws:ws + tw]
            depth = depth[hs:hs + th, ws:ws + tw]
        sample = {"image": img.astype(np.float32),
                  "depth": depth.astype(np.float32),
                  "image_path": img_path}
        return self._postprocess(sample)


class Hypersim(_FileListDataset):
    """h5 euclidean distance -> planar depth; NaNs masked out
    (reference hypersim.py:27-75)."""

    def _read_depth(self, path):
        import h5py
        with h5py.File(path, "r") as f:
            distance = np.array(f["dataset"])
        return hypersim_distance_to_depth(distance)

    def _postprocess(self, sample):
        valid = ~np.isnan(sample["depth"])
        sample["depth"] = np.where(valid, sample["depth"], 0.0)
        sample["valid_mask"] = valid
        return sample


class VKITTI2(_FileListDataset):
    """uint16 png depth in cm -> m; valid = depth <= 80
    (reference vkitti2.py:36-47)."""

    def _read_depth(self, path):
        import cv2
        d = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        return d.astype(np.float32) / 100.0

    def _postprocess(self, sample):
        sample["valid_mask"] = sample["depth"] <= 80
        return sample


class KITTI(_FileListDataset):
    """val-only; uint16 png / 256 -> m; valid = depth > 0
    (reference kitti.py:10-52)."""

    def __init__(self, filelist_path, mode="val", size=(518, 518), seed=0):
        if mode != "val":
            raise NotImplementedError("KITTI is a val-only dataset")
        super().__init__(filelist_path, mode, size, seed)

    def _read_depth(self, path):
        import cv2
        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        return d.astype(np.float32) / 256.0

    def _postprocess(self, sample):
        sample["valid_mask"] = sample["depth"] > 0
        return sample
