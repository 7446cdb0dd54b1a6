"""Metric (absolute-scale) single-image depth CLI (vdn/cli/run_metric.py;
reference metric_depth/run.py:1-80).

Usage:
  python -m vdn_torch.cli.run_metric --img-path img_or_dir --encoder vitl \
      --load-from checkpoints/depth_anything_v2_metric_hypersim_vitl.pth \
      --max-depth 20 [--save-numpy] [--device cuda]

Reading and writing the images needs cv2 (and matplotlib unless
``--grayscale``); ``build_metric_pipeline`` needs neither.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def build_metric_pipeline(encoder: str, checkpoint: str,
                          max_depth: float = 20.0,
                          compute_dtype: str = "fp32",
                          device: str = "cuda"):
    """Returns ``infer(raw_bgr, input_size) -> depth [H, W] meters``.

    The relative pipeline's host protocol (lower-bound resize to a
    multiple of 14, ImageNet norm, align-corners bilinear back to the
    image's size; reference depth_anything_v2.py:57-92) around the
    sigmoid-bounded metric head x max_depth."""
    from vdn_torch.core.checkpoint import load_checkpoint
    from vdn_torch.models.metric_depth import build_metric_depth_anything_v2
    from vdn_torch.ops.resize import resize2d
    from vdn_torch.pipelines.transform import image2tensor_bgr

    model = build_metric_depth_anything_v2(
        encoder, compute_dtype=compute_dtype, device=device,
        max_depth=max_depth)
    load_checkpoint(model, checkpoint)

    @torch.no_grad()
    def infer(raw_bgr: np.ndarray, input_size: int = 518) -> np.ndarray:
        x, (h, w) = image2tensor_bgr(raw_bgr, input_size)
        depth = model(torch.from_numpy(x).to(device))
        out = resize2d(depth[..., None], (h, w), "bilinear",
                       align_corners=True)
        return out[0, :, :, 0].cpu().numpy()

    return infer


def _list_images(img_path: str):
    if os.path.isfile(img_path):
        if img_path.endswith("txt"):
            with open(img_path) as f:
                return f.read().splitlines()
        return [img_path]
    return sorted(glob.glob(os.path.join(img_path, "**/*"), recursive=True))


def save_depth_image(out_name: str, raw_bgr: np.ndarray, vis_rgb: np.ndarray,
                     pred_only: bool) -> None:
    """The colorized depth, alone or beside the input with a 50-pixel white
    margin, as a BGR image file."""
    import cv2
    vis = cv2.cvtColor(vis_rgb, cv2.COLOR_RGB2BGR)
    if not pred_only:
        margin = np.ones((raw_bgr.shape[0], 50, 3), np.uint8) * 255
        vis = cv2.hconcat([raw_bgr, margin, vis])
    cv2.imwrite(out_name, vis)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Depth Anything V2 Metric Depth Estimation (vdn_torch)")
    parser.add_argument("--img-path", type=str, required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--outdir", type=str, default="./vis_depth")
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--load-from", "--checkpoint", dest="load_from",
                        type=str, required=True)
    parser.add_argument("--max-depth", type=float, default=20)
    parser.add_argument("--save-numpy", action="store_true",
                        help="save the raw metric depth as .npy")
    parser.add_argument("--pred-only", action="store_true")
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import cv2
    from vdn_torch.utils.video_io import colorize_depth

    infer = build_metric_pipeline(args.encoder, args.load_from,
                                  args.max_depth, args.compute_dtype,
                                  args.device)
    filenames = _list_images(args.img_path)
    os.makedirs(args.outdir, exist_ok=True)
    for k, filename in enumerate(filenames):
        print(f"Progress {k + 1}/{len(filenames)}: {filename}")
        raw = cv2.imread(filename)
        if raw is None:
            continue
        depth = infer(raw, args.input_size)
        stem = os.path.splitext(os.path.basename(filename))[0]
        if args.save_numpy:
            np.save(os.path.join(args.outdir, stem + "_raw_depth_meter.npy"),
                    depth)
        # metric maps color near=small (the reference does not invert)
        vis = colorize_depth(depth, cmap="Spectral", grayscale=args.grayscale)
        save_depth_image(os.path.join(args.outdir, stem + ".png"), raw, vis,
                         args.pred_only)


if __name__ == "__main__":
    main()
