"""Video frame IO (vdn/utils/video_io.py; reference utils/dc_utils.py:19-86).

A cv2 reader with fps / max_res control, the min-max colorized depth and a
cv2 mp4 writer.  cv2 and matplotlib are imported inside the functions
that use them, so that the module imports on a machine without either.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["read_video_frames", "colorize_depth", "save_video"]


def read_video_frames(video_path: str, process_length: int = -1,
                      target_fps: float = -1, max_res: int = -1
                      ) -> Tuple[np.ndarray, float]:
    """-> (frames [N, H, W, 3] uint8 RGB, fps)."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    original_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    if target_fps <= 0:
        target_fps = original_fps
    stride = max(round(original_fps / target_fps), 1)
    fps = original_fps / stride

    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    scale = 1.0
    if max_res > 0 and max(width, height) > max_res:
        scale = max_res / max(width, height)

    frames = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            if scale < 1.0:
                frame = cv2.resize(frame, (round(width * scale),
                                           round(height * scale)))
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if 0 < process_length <= len(frames):
                break
        idx += 1
    cap.release()
    return np.stack(frames) if frames else np.zeros((0,)), fps


def colorize_depth(depth: np.ndarray, cmap: str = "inferno",
                   grayscale: bool = False) -> np.ndarray:
    """[H, W] depth -> uint8 RGB visualization (min-max normalized)."""
    d = depth.astype(np.float32)
    d = (d - d.min()) / max(d.max() - d.min(), 1e-8)
    if grayscale:
        g = (d * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    import matplotlib
    colors = matplotlib.colormaps.get_cmap(cmap)(d)[..., :3]
    return (colors * 255).astype(np.uint8)


def save_video(frames: np.ndarray, output_path: str, fps: float = 10.0,
               is_depths: bool = False, grayscale: bool = False):
    """frames: [N, H, W(, 3)] RGB; depths are colorized with inferno
    (reference dc_utils.py:72-86)."""
    import cv2
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(output_path,
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {output_path}")
    try:
        for frame in frames:
            if is_depths:
                frame = colorize_depth(frame, grayscale=grayscale)
            writer.write(cv2.cvtColor(
                np.ascontiguousarray(frame.astype(np.uint8)),
                cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
