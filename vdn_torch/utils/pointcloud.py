"""Depth map -> point cloud (vdn/utils/pointcloud.py; reference
metric_depth/depth_to_pointcloud.py).

The pinhole back-projection in numpy, written as standard ASCII PLY (the
reference uses open3d).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["depth_to_pointcloud", "save_ply"]


def depth_to_pointcloud(depth: np.ndarray, focal_x: float, focal_y: float,
                        rgb: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """depth [H, W] (meters) -> points [N, 3] (+ colors [N, 3] uint8) of
    the pixels with depth > 0.

    Pinhole model with the principal point at the image center
    (reference depth_to_pointcloud.py: x = (u - W/2)/f * z)."""
    h, w = depth.shape
    u = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    v = np.arange(h, dtype=np.float32)[:, None].repeat(w, 1)
    z = depth.astype(np.float32)
    x = (u - w / 2.0) / focal_x * z
    y = (v - h / 2.0) / focal_y * z
    valid = z > 0
    points = np.stack([x[valid], y[valid], z[valid]], axis=-1)
    colors = None
    if rgb is not None:
        colors = rgb[valid].astype(np.uint8)
    return points, colors


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None):
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            line = f"{points[i, 0]:.6f} {points[i, 1]:.6f} {points[i, 2]:.6f}"
            if colors is not None:
                line += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
            f.write(line + "\n")
