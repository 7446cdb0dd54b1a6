"""Video depth CLI (vdn/cli/run_video.py; reference run_video.py).

Usage:
  python -m vdn_torch.cli.run_video --video-path in.mp4 --encoder vitl \
      --checkpoint checkpoints/video_depth_anything_vitl.pth \
      [--streaming [--chunk-size 8]] [--int8 | --int8-dynamic] \
      [--max-res 1280] [--target-fps -1] [--max-len -1] [--device cuda]

Writes ``<name>_src.mp4``, ``<name>_vis.mp4`` and ``<name>_depths.npy``.
The device work (``build_model``, ``infer_frames``) is apart from the file
IO in ``main``, which needs cv2 (and matplotlib unless ``--grayscale``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def build_model(encoder: str, checkpoint: str, compute_dtype: str = "bf16",
                quantize: Optional[str] = None, device: str = "cuda"):
    """VideoDepthAnything at ``encoder`` with the checkpoint's weights;
    ``quantize``: None, "int8_static" (``--int8``: the first window or
    frame is the calibration pass of the head's convs) or "int8"
    (``--int8-dynamic``)."""
    from vdn_torch.core.checkpoint import load_checkpoint
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    model = build_video_depth_anything(encoder, compute_dtype=compute_dtype,
                                       device=device, quantize=quantize)
    load_checkpoint(model, checkpoint)
    return model


def infer_frames(model, frames: np.ndarray, fps: float,
                 input_size: int = 518, streaming: bool = False,
                 chunk_size: int = 8):
    """frames [N, H, W, 3] RGB -> (depths [N, H, W] fp32, fps).

    Cached windows through ``infer_video_depth``, or with ``streaming``
    chunks of ``chunk_size`` frames through ``VideoDepthStreamPipeline``,
    each chunk's depths copied to the host after the next chunk is queued
    (so the host's copy overlaps the device's work)."""
    from vdn_torch.pipelines.infer_video import infer_video_depth
    from vdn_torch.pipelines.stream import VideoDepthStreamPipeline

    if not streaming:
        return infer_video_depth(model, frames, fps, input_size)
    pipe = VideoDepthStreamPipeline(model, input_size)
    k = max(1, chunk_size)
    pending, out = [], []
    for start in range(0, len(frames), k):
        chunk = pipe.infer_video_depth_chunk(list(frames[start:start + k]),
                                             fetch=False)
        out.extend(d.cpu().numpy() for d in pending)
        pending = chunk
    out.extend(d.cpu().numpy() for d in pending)
    return np.stack(out), fps


def main(argv=None):
    parser = argparse.ArgumentParser(description="Video Depth (vdn_torch)")
    parser.add_argument("--video-path", type=str, required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--outdir", type=str, default="./vis_video_depth")
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitl"])
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--max-res", type=int, default=1280)
    parser.add_argument("--target-fps", type=float, default=-1)
    parser.add_argument("--max-len", type=int, default=-1)
    parser.add_argument("--streaming", action="store_true",
                        help="bounded-memory per-frame decode")
    parser.add_argument("--chunk-size", type=int, default=8,
                        help="frames per streaming dispatch (1 = reference "
                             "per-frame granularity)")
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving mode: W8A8-dynamic encoder "
                             "matmuls + calibrated-static head convs (the "
                             "first window/frame is the calibration pass)")
    parser.add_argument("--int8-dynamic", action="store_true",
                        help="int8 with per-frame dynamic conv scales "
                             "(zero-calibration variant of --int8)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from vdn_torch.utils.video_io import read_video_frames, save_video

    model = build_model(
        args.encoder, args.checkpoint, args.compute_dtype,
        quantize=("int8" if args.int8_dynamic
                  else "int8_static" if args.int8 else None),
        device=args.device)
    frames, fps = read_video_frames(args.video_path, args.max_len,
                                    args.target_fps, args.max_res)
    print(f"{len(frames)} frames @ {fps:.2f} fps")
    depths, fps = infer_frames(model, frames, fps, args.input_size,
                               args.streaming, args.chunk_size)

    os.makedirs(args.outdir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.video_path))[0]
    save_video(frames, os.path.join(args.outdir, f"{base}_src.mp4"),
               fps=fps)
    save_video(depths, os.path.join(args.outdir, f"{base}_vis.mp4"),
               fps=fps, is_depths=True, grayscale=args.grayscale)
    np.save(os.path.join(args.outdir, f"{base}_depths.npy"), depths)


if __name__ == "__main__":
    main()
