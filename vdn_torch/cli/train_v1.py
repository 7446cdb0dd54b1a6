"""v1 research-model training CLI (vdn/cli/train_v1.py; reference
scripts/train.py:413-530).

Depth+normal objective over the dual-Hiera model, with per-epoch
validation (reference ``validate``, train.py:376-410), asynchronous
checkpoints and deterministic resume — the same harness as
`vdn_torch.cli.train` (``run_epoch`` / ``train`` there), fp32 as vdn
trains it.

Usage:
  python -m vdn_torch.cli.train_v1 --dataset-config configs/train_dataset_config.yaml \
      --datasets Sintel --encoder hiera_base_224 [--epochs 200] [--device cuda]

The encoder is a hub MAE Hiera (``hiera_*_224``) or a SAM2 hieradet trunk
(``hiera_tiny`` ... ``hiera_large``); at 256 px and above the hieradet
trunks' global blocks take C2 and its backward D2 (fp32 at their head
widths, 96 / 56 / 72).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="vdn_torch v1 "
                                     "depth+normal training")
    parser.add_argument("--config", type=str, default=None,
                        help="master experiment config (the reference "
                        "configs/config.yaml switchboard, made live): "
                        "its values become the defaults below, explicit "
                        "flags still win, and its datasets: section "
                        "drives --datasets/--dataset-config (.json is "
                        "read without PyYAML)")
    parser.add_argument("--dataset-config", type=str, default=None)
    parser.add_argument("--datasets", nargs="+", default=None)
    parser.add_argument("--encoder", default="hiera_base_224",
                        help="hub-MAE names (hiera_*_224) or SAM2 hieradet "
                        "names (hiera_tiny, ...)")
    parser.add_argument("--sequence-length", type=int, default=16)
    parser.add_argument("--attention-levels", default="2,3",
                        help="comma-separated pyramid levels that get the "
                        "(temporal-spatial)x2 attention stacks "
                        "(reference video_depth_head_v2_sangyu.py:179)")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=6)
    parser.add_argument("--initial-lr", type=float, default=1e-4)
    parser.add_argument("--final-lr", type=float, default=1e-7)
    parser.add_argument("--alpha", type=float, default=0.0)
    parser.add_argument("--stable-scale", type=float, default=0.0)
    parser.add_argument("--normal-loss-scale", type=float, default=0.0)
    parser.add_argument("--use-residual", action="store_true", default=True)
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint "
                        "(model+optimizer+scheduler+epoch + deterministic "
                        "data restart), like vdn_torch.cli.train")
    parser.add_argument("--log-dir", default="./logs")
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--use-wandb", action="store_true")
    parser.add_argument("--val-interval", type=int, default=1)
    parser.add_argument("--save-interval", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--debug-nans", action="store_true",
                        help="numeric sanitizer: autograd's anomaly mode "
                        "with NaN checks + a finite-loss guard per step")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def levels(args) -> tuple:
    return tuple(int(v) for v in args.attention_levels.split(","))


def build_model(args):
    """VideoDepthEstimationModel at ``args.encoder`` on ``args.device``
    (fp32), the port's seeded initializers."""
    import torch

    from vdn_torch.models.video_depth_v1 import build_video_depth_v1
    return build_video_depth_v1(
        args.encoder, device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
        sequence_length=args.sequence_length,
        attention_feature_levels=levels(args),
        use_residual=args.use_residual, use_final_relu=True)


def build_trainer(model, args):
    from vdn_torch.train.trainer import V1Trainer
    return V1Trainer(
        model, initial_lr=args.initial_lr, final_lr=args.final_lr,
        alpha=args.alpha, stable_scale=args.stable_scale,
        normal_loss_scale=args.normal_loss_scale)


def to_batch(batch) -> Dict[str, np.ndarray]:
    """The v1 batch contract (vdn's ``_to_batch``)."""
    return {
        "rgb": batch["rgb"].astype(np.float32),
        "depth_anything_v2": batch["depth_anything_v2"].astype(np.float32),
        "depth": batch["depth"].astype(np.float32),
        "mask": batch["mask"].astype(np.float32),
    }


def train(args, model=None, loaders=None) -> list:
    """The CLI's run on ``model`` (built from ``args`` if None) and
    ``loaders`` ((train, val); from the dataset config if None), through
    ``vdn_torch.cli.train.train``.  Returns each epoch's logged metrics."""
    from vdn_torch.cli import train as refine
    if loaders is None:
        _, *loaders = refine.build_loaders(args.datasets, args.dataset_config,
                                           args.batch_size, args.seed)
    if model is None:
        model = build_model(args)
    return refine.train(args, model, loaders, name="video_depth_normal_v1",
                        trainer_fn=build_trainer, to_batch_fn=to_batch)


def main(argv=None):
    from vdn_torch.cli._common import parse_with_master_config
    return train(parse_with_master_config(build_parser(), argv,
                                          family="v1"))


if __name__ == "__main__":
    main()
