"""Dataset implementations (layout adapters over SequenceFolderDataset;
vdn/data/datasets.py).

Each class mirrors one reference dataset's directory structure and frame
decoding (citations inline).  All return {rgb [S,H,W,3] f32 0-1,
depth [S,H,W] f32, depth_anything_v2 [S,H,W] f32 (uint16 range),
mask [S,H,W] bool}.  Frames are decoded with cv2, imported inside the
readers.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from vdn_torch.data.base import (SequenceFolderDataset, make_windows,
                           read_dpt_file)


def _read_rgb(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def _read_uint16(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img.astype(np.float32)


def _list_scene_dirs(path: str) -> List[str]:
    return sorted(d for d in os.listdir(path)
                  if os.path.isdir(os.path.join(path, d)))


class SintelDataset(SequenceFolderDataset):
    """rgb/<scene>/*.png, depth/<scene>/*.dpt, depth_anything_v2 uint16 png
    (reference data/SintelDataset.py:16-260; mask = all-ones)."""
    folder_map = {"rgb": "rgb", "depth": "depth",
                  "depth_anything_v2": "depth_anything_v2", "mask": "depth"}

    def scan(self):
        primary = os.path.join(self.root_dir,
                               self.folder_map[self.data_types[0]])
        ext = {"rgb": (".png", ".jpg"), "depth": (".dpt",),
               "depth_anything_v2": (".png",), "mask": (".dpt",)}
        pointers = []
        for scene in _list_scene_dirs(primary):
            per_type: Dict[str, List[str]] = {}
            for dt in self.data_types:
                d = os.path.join(self.root_dir, self.folder_map[dt], scene)
                if not os.path.isdir(d):
                    per_type = {}
                    break
                per_type[dt] = sorted(
                    os.path.join(d, f) for f in os.listdir(d)
                    if f.endswith(ext[dt]))
            if per_type:
                pointers += make_windows(per_type, self.sequence_length,
                                         self.sequence_stride)
        return pointers

    def read_frame(self, path, data_type):
        if data_type == "rgb":
            return _read_rgb(path)
        if data_type == "depth":
            return read_dpt_file(path)
        if data_type == "depth_anything_v2":
            return _read_uint16(path)
        if data_type == "mask":
            return np.ones_like(read_dpt_file(path), np.float32)
        raise ValueError(data_type)


class PointOdysseyDataset(SequenceFolderDataset):
    """<split>/<scene>/{rgbs,depths,depth_anything_v2,masks}
    (reference data/PointOdysseyDataset.py:15-429); depth uint16 png with
    0 -> max+1 sentinel, mask = png mask AND depth!=0."""
    folder_map = {"rgb": "rgbs", "depth": "depths",
                  "depth_anything_v2": "depth_anything_v2", "mask": "masks"}

    def scan(self):
        subdirs = self.extra.get("subdirs", ["train", "test"])
        exclude = set(self.extra.get("exclude_scenes", []) or [])
        pointers = []
        for sub in subdirs:
            base = os.path.join(self.root_dir, sub)
            if not os.path.isdir(base):
                continue
            for scene in _list_scene_dirs(base):
                if scene in exclude:
                    continue
                per_type = {}
                for dt in self.data_types:
                    d = os.path.join(base, scene, self.folder_map[dt])
                    if not os.path.isdir(d):
                        per_type = {}
                        break
                    suffix = ".jpg" if dt == "rgb" else ".png"
                    per_type[dt] = sorted(
                        os.path.join(d, f) for f in os.listdir(d)
                        if f.endswith(suffix))
                if per_type:
                    pointers += make_windows(per_type, self.sequence_length,
                                             self.sequence_stride)
        return pointers

    def read_frame(self, path, data_type):
        if data_type == "rgb":
            return _read_rgb(path)
        if data_type == "depth":
            d = _read_uint16(path)
            zero = d == 0
            d[zero] = d.max() + 1  # invalid -> far (reference :207-212)
            return d
        if data_type == "depth_anything_v2":
            return _read_uint16(path)
        if data_type == "mask":
            m = _read_uint16(path) != 0
            depth_path = path.replace(os.sep + "masks" + os.sep,
                                      os.sep + "depths" + os.sep
                                      ).replace("mask_", "depth_")
            if os.path.exists(depth_path):
                m &= _read_uint16(depth_path) != 0
            return m.astype(np.float32)
        raise ValueError(data_type)


class TartanAirDataset(SequenceFolderDataset):
    """<env>/Data_<difficulty>/<traj>/{image,depth,depth_anything_v2}_<cam>
    (reference data/TartanAirDataset.py:15-230); depth stored as rgba-fused
    fp32 png."""
    folder_map = {"rgb": "image", "depth": "depth",
                  "depth_anything_v2": "depth_anything_v2", "mask": "depth"}

    def scan(self):
        envs = self.extra.get("envs") or _list_scene_dirs(self.root_dir)
        difficulties = self.extra.get("difficulties", ["easy", "hard"])
        cameras = self.extra.get("cameras", ["left"])
        pointers = []
        for env in envs:
            for diff in difficulties:
                dpath = os.path.join(self.root_dir, env, f"Data_{diff}")
                if not os.path.isdir(dpath):
                    continue
                for traj in _list_scene_dirs(dpath):
                    for cam in cameras:
                        per_type = {}
                        for dt in self.data_types:
                            d = os.path.join(
                                dpath, traj,
                                f"{self.folder_map[dt]}_{cam}")
                            if not os.path.isdir(d):
                                per_type = {}
                                break
                            per_type[dt] = sorted(
                                os.path.join(d, f) for f in os.listdir(d)
                                if f.endswith(".png"))
                        if per_type:
                            pointers += make_windows(
                                per_type, self.sequence_length,
                                self.sequence_stride)
        return pointers

    @staticmethod
    def _read_depth_rgba(path):
        import cv2
        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if raw is None:
            raise IOError(path)
        if raw.ndim == 3 and raw.shape[2] == 4:
            return raw.view(np.float32)[..., 0]
        return raw.astype(np.float32)

    def read_frame(self, path, data_type):
        if data_type == "rgb":
            return _read_rgb(path)
        if data_type == "depth":
            return self._read_depth_rgba(path)
        if data_type == "depth_anything_v2":
            return _read_uint16(path)
        if data_type == "mask":
            return np.ones_like(self._read_depth_rgba(path), np.float32)
        raise ValueError(data_type)


class VKittiDataset(SequenceFolderDataset):
    """Scene*/<variation>/frames/{rgb,depth,depth_anything_v2}/<camera>
    (reference data/VKittiDataset.py:13-200); depth uint16 png in cm."""
    folder_map = {"rgb": "rgb", "depth": "depth",
                  "depth_anything_v2": "depth_anything_v2", "mask": "depth"}

    def scan(self):
        cameras = self.extra.get("cameras", ["Camera_0"])
        pointers = []
        scenes = sorted(d for d in os.listdir(self.root_dir)
                        if d.startswith("Scene")
                        and os.path.isdir(os.path.join(self.root_dir, d)))
        for scene in scenes:
            for variation in _list_scene_dirs(
                    os.path.join(self.root_dir, scene)):
                base = os.path.join(self.root_dir, scene, variation,
                                    "frames")
                for cam in cameras:
                    per_type = {}
                    for dt in self.data_types:
                        d = os.path.join(base, self.folder_map[dt], cam)
                        if not os.path.isdir(d):
                            per_type = {}
                            break
                        per_type[dt] = sorted(
                            os.path.join(d, f) for f in os.listdir(d)
                            if f.endswith((".png", ".jpg")))
                    if per_type:
                        pointers += make_windows(per_type,
                                                 self.sequence_length,
                                                 self.sequence_stride)
        return pointers

    def read_frame(self, path, data_type):
        if data_type == "rgb":
            return _read_rgb(path)
        if data_type in ("depth", "depth_anything_v2"):
            return _read_uint16(path)
        if data_type == "mask":
            return (_read_uint16(path) > 0).astype(np.float32)
        raise ValueError(data_type)


class NYUv2Dataset(SequenceFolderDataset):
    """rgb jpgs + depth .npy (stored transposed, reference
    data/NYUv2Dataset.py:247-257); mask = depth > 0."""
    depth_interp = "nearest"
    folder_map = {"rgb": "rgb", "depth": "depth",
                  "depth_anything_v2": "depth_anything_v2", "mask": "depth"}

    def scan(self):
        ext = {"rgb": ".jpg", "depth": ".npy",
               "depth_anything_v2": ".png", "mask": ".npy"}
        primary = os.path.join(self.root_dir,
                               self.folder_map[self.data_types[0]])
        pointers = []
        for scene in _list_scene_dirs(primary):
            primary_files = sorted(glob.glob(os.path.join(
                primary, scene, f"*{ext[self.data_types[0]]}")))
            per_type = {dt: [] for dt in self.data_types}
            ok = True
            for f in primary_files:
                base = os.path.splitext(os.path.basename(f))[0]
                for dt in self.data_types:
                    p = os.path.join(self.root_dir, self.folder_map[dt],
                                     scene, base + ext[dt])
                    if not os.path.exists(p):
                        ok = False
                        break
                    per_type[dt].append(p)
                if not ok:
                    break
            if ok and per_type[self.data_types[0]]:
                pointers += make_windows(per_type, self.sequence_length,
                                         self.sequence_stride)
        return pointers

    def read_frame(self, path, data_type):
        if data_type == "rgb":
            return _read_rgb(path)
        if data_type == "depth_anything_v2":
            return _read_uint16(path)
        if data_type == "depth":
            return np.load(path).astype(np.float32).T
        if data_type == "mask":
            return (np.load(path).astype(np.float32).T > 0).astype(
                np.float32)
        raise ValueError(data_type)


class BonnDataset(SequenceFolderDataset):
    """TUM-style scenes with rgb.txt/depth.txt timestamp association
    (reference data/BonnDataset.py:16-261); depth mm -> m."""
    folder_map = {}

    def scan(self):
        exclude = set(self.extra.get("exclude_scenes", []) or [])
        pointers = []
        for scene in _list_scene_dirs(self.root_dir):
            if scene in exclude:
                continue
            scene_dir = os.path.join(self.root_dir, scene)
            rgb_txt = os.path.join(scene_dir, "rgb.txt")
            depth_txt = os.path.join(scene_dir, "depth.txt")
            if not (os.path.exists(rgb_txt) and os.path.exists(depth_txt)):
                continue

            def parse(txt):
                entries = []
                with open(txt) as f:
                    for line in f:
                        line = line.strip()
                        if not line or line.startswith("#"):
                            continue
                        ts, rel = line.split()[:2]
                        entries.append((float(ts), rel))
                return entries

            rgbs = parse(rgb_txt)
            depths = parse(depth_txt)
            if not rgbs or not depths:
                continue
            d_ts = np.array([t for t, _ in depths])
            per_type = {dt: [] for dt in self.data_types}
            for ts, rel in rgbs:
                j = int(np.argmin(np.abs(d_ts - ts)))
                if "rgb" in per_type:
                    per_type["rgb"].append(os.path.join(scene_dir, rel))
                if "depth" in per_type:
                    per_type["depth"].append(
                        os.path.join(scene_dir, depths[j][1]))
                if "mask" in per_type:
                    per_type["mask"].append(
                        os.path.join(scene_dir, depths[j][1]))
                if "depth_anything_v2" in per_type:
                    per_type["depth_anything_v2"].append(os.path.join(
                        scene_dir, "depth_anything_v2",
                        os.path.basename(rel).replace(".jpg", ".png")))
            pointers += make_windows(per_type, self.sequence_length,
                                     self.sequence_stride)
        return pointers

    def read_frame(self, path, data_type):
        if data_type == "rgb":
            return _read_rgb(path)
        if data_type == "depth":
            return _read_uint16(path) / 1000.0  # mm -> m (reference :236)
        if data_type == "depth_anything_v2":
            return _read_uint16(path)
        if data_type == "mask":
            return (_read_uint16(path) != 0).astype(np.float32)
        raise ValueError(data_type)


class DA2KDataset(SequenceFolderDataset):
    """Single-image benchmark (sequence length 1, reference
    data/DA2KDataset.py:17-227): rgb jpgs matched to depth_anything_v2
    pngs; mask = all ones."""
    folder_map = {"rgb": "rgb", "depth": "depth_anything_v2",
                  "depth_anything_v2": "depth_anything_v2",
                  "mask": "depth_anything_v2"}

    def scan(self):
        rgb_base = os.path.join(self.root_dir, "rgb")
        pointers = []
        for rgb_path in sorted(glob.glob(
                os.path.join(rgb_base, "**", "*.jpg"), recursive=True)):
            rel = os.path.relpath(rgb_path, rgb_base)
            rel_png = os.path.splitext(rel)[0] + ".png"
            per_type = {}
            ok = True
            for dt in self.data_types:
                if dt == "rgb":
                    per_type[dt] = [rgb_path]
                    continue
                p = os.path.join(self.root_dir, self.folder_map[dt],
                                 rel_png)
                if not os.path.exists(p):
                    ok = False
                    break
                per_type[dt] = [p]
            if ok:
                pointers.append(per_type)
        return pointers

    def read_frame(self, path, data_type):
        if data_type == "rgb":
            return _read_rgb(path)
        if data_type in ("depth", "depth_anything_v2"):
            return _read_uint16(path)
        if data_type == "mask":
            return np.ones(_read_uint16(path).shape[:2], np.float32)
        raise ValueError(data_type)


DATASET_REGISTRY = {
    "SintelDataset": SintelDataset,
    "PointOdysseyDataset": PointOdysseyDataset,
    "TartanAirDataset": TartanAirDataset,
    "VKittiDataset": VKittiDataset,
    "NYUv2Dataset": NYUv2Dataset,
    "BonnDataset": BonnDataset,
    "DA2KDataset": DA2KDataset,
}
