"""DA-2K relative-depth benchmark CLI (vdn/cli/eval_da2k.py; reference
DA-2K.md protocol).

Usage:
  python -m vdn_torch.cli.eval_da2k --benchmark-root /path/to/DA-2K \
      --encoder vitl --checkpoint depth_anything_v2_vitl.pth \
      [--scene-type indoor] [--device cuda]

Prints one JSON object: the accuracy overall and per scene type.  Reading
the images needs cv2.
"""

from __future__ import annotations

import argparse
import json


def make_infer(pipe, input_size: int = 518):
    """BGR image -> relative depth, the memory bank cleared before every
    image: DA-2K's images are independent."""
    def infer(raw_bgr):
        pipe.clear_memory()
        return pipe.infer_image(raw_bgr, input_size)
    return infer


def main(argv=None):
    parser = argparse.ArgumentParser(description="DA-2K eval (vdn_torch)")
    parser.add_argument("--benchmark-root", required=True)
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--scene-type", default=None)
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from vdn_torch.cli.run import build_pipeline
    from vdn_torch.eval.da2k import evaluate_da2k

    pipe = build_pipeline(args.encoder, args.checkpoint, args.compute_dtype,
                          device=args.device)
    out = evaluate_da2k(args.benchmark_root,
                        make_infer(pipe, args.input_size), args.scene_type)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
