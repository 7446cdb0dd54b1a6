"""DA-2K pairwise relative-depth benchmark (vdn/eval/da2k.py; reference
DA-2K.md:1-38).

annotations.json maps image paths to point-pair annotations where "point1"
is always the closer point; accuracy = fraction of pairs where the model's
(relative, larger-is-closer) depth agrees.  cv2 reads the images and is
imported when the function runs.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["evaluate_da2k"]


def evaluate_da2k(benchmark_root: str,
                  infer_fn: Callable[[np.ndarray], np.ndarray],
                  scene_type: Optional[str] = None) -> Dict[str, float]:
    """infer_fn: BGR image -> relative depth [H, W] (larger = closer,
    disparity-style like DepthAnythingV2).  Returns accuracy overall and
    per scene type (second path component of the image key); a tie picks
    point2."""
    import cv2
    with open(os.path.join(benchmark_root, "annotations.json")) as f:
        annotations = json.load(f)

    correct: Dict[str, int] = {}
    total: Dict[str, int] = {}
    for image_path, pairs in annotations.items():
        scene = image_path.split("/")[1] if "/" in image_path else "all"
        if scene_type and scene != scene_type:
            continue
        raw = cv2.imread(os.path.join(benchmark_root, image_path))
        if raw is None:
            continue
        depth = infer_fn(raw)
        for ann in pairs:
            (h1, w1), (h2, w2) = ann["point1"], ann["point2"]
            pred_closer = ("point1" if depth[int(h1), int(w1)]
                           > depth[int(h2), int(w2)] else "point2")
            key = scene
            total[key] = total.get(key, 0) + 1
            if pred_closer == ann["closer_point"]:
                correct[key] = correct.get(key, 0) + 1

    out = {f"accuracy/{k}": correct.get(k, 0) / n
           for k, n in total.items()}
    n_all = sum(total.values())
    out["accuracy"] = (sum(correct.values()) / n_all) if n_all else 0.0
    out["num_pairs"] = float(n_all)
    return out
