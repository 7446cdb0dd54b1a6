"""Single-image depth CLI (vdn/cli/run.py; reference run.py:1-70).

Usage:
  python -m vdn_torch.cli.run --img-path img_or_dir --encoder vitl \
      --checkpoint checkpoints/depth_anything_v2_vitl.pth --outdir vis_depth \
      [--int8] [--device cuda]

One pipeline serves every image of the run, so the memory bank carries
across the sorted images of a directory, as vdn's does.  Reading and
writing the images needs cv2 (and matplotlib unless ``--grayscale``);
``build_pipeline`` needs neither.
"""

from __future__ import annotations

import argparse
import os

from vdn_torch.cli.run_metric import _list_images, save_depth_image


def build_pipeline(encoder: str, checkpoint: str, compute_dtype: str = "fp32",
                   int8: bool = False, device: str = "cuda"):
    """DepthAnythingV2Pipeline over ``encoder`` with the checkpoint's
    weights; ``int8``: the W8A8-dynamic serving mode (quantize="int8")."""
    from vdn_torch.core.checkpoint import load_checkpoint
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline

    model = build_depth_anything_v2(encoder, compute_dtype=compute_dtype,
                                    device=device,
                                    quantize="int8" if int8 else None)
    load_checkpoint(model, checkpoint)
    return DepthAnythingV2Pipeline(model)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Depth Anything V2 "
                                                 "(vdn_torch)")
    parser.add_argument("--img-path", type=str, required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--outdir", type=str, default="./vis_depth")
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--pred-only", action="store_true")
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--int8", action="store_true",
                        help="W8A8-dynamic int8 encoder matmuls (serving "
                             "mode; vdn_torch/kernels/int8.py)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import cv2
    from vdn_torch.utils.video_io import colorize_depth

    pipe = build_pipeline(args.encoder, args.checkpoint, args.compute_dtype,
                          int8=args.int8, device=args.device)
    filenames = _list_images(args.img_path)
    os.makedirs(args.outdir, exist_ok=True)
    for k, filename in enumerate(filenames):
        print(f"Progress {k + 1}/{len(filenames)}: {filename}")
        raw = cv2.imread(filename)
        if raw is None:
            continue
        depth = pipe.infer_image(raw, args.input_size)
        vis = colorize_depth(depth, cmap="Spectral_r",
                             grayscale=args.grayscale)
        out_name = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(filename))[0] + ".png")
        save_depth_image(out_name, raw, vis, args.pred_only)


if __name__ == "__main__":
    main()
