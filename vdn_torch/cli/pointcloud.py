"""Depth maps -> point clouds from images (vdn/cli/pointcloud.py;
reference metric_depth/depth_to_pointcloud.py:1-110).

Usage:
  python -m vdn_torch.cli.pointcloud --img-path imgs/ --encoder vitl \
      --load-from checkpoints/depth_anything_v2_metric_hypersim_vitl.pth \
      --max-depth 20 --focal-length-x 470.4 --focal-length-y 470.4 \
      [--device cuda]

Writes one ``.ply`` per image (ascii, xyz + rgb; vdn_torch/utils/
pointcloud.py).  Reading the images needs cv2.
"""

from __future__ import annotations

import argparse
import os

from vdn_torch.cli.run_metric import _list_images, build_metric_pipeline


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate depth maps and point clouds from images "
                    "(vdn_torch)")
    parser.add_argument("--encoder", default="vitl", type=str,
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--load-from", "--checkpoint", dest="load_from",
                        type=str, required=True)
    parser.add_argument("--max-depth", default=20, type=float)
    parser.add_argument("--img-path", type=str, required=True)
    parser.add_argument("--outdir", type=str, default="./vis_pointcloud")
    parser.add_argument("--focal-length-x", default=470.4, type=float)
    parser.add_argument("--focal-length-y", default=470.4, type=float)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import cv2
    from vdn_torch.utils.pointcloud import depth_to_pointcloud, save_ply

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
        points, colors = depth_to_pointcloud(
            depth, args.focal_length_x, args.focal_length_y,
            rgb=cv2.cvtColor(raw, cv2.COLOR_BGR2RGB))
        out = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(filename))[0] + ".ply")
        save_ply(out, points, colors)


if __name__ == "__main__":
    main()
