"""Refinement training CLI (vdn/cli/train.py; v4 semantics, reference
scripts/train_v4.py).

Usage:
  python -m vdn_torch.cli.train --dataset-config configs/train_dataset_config.yaml \
      --datasets Sintel --encoder vitl [--from-pretrained ckpt.pth] \
      [--epochs 10] [--batch-size 2] [--device cuda]

``main`` parses the arguments and builds the datasets; the model and
trainer (``build_trainer``), the loaders (``build_loaders``) and one epoch
of train / validate / log / save (``run_epoch``) are functions of their
own, which a caller can drive with weights or datasets of its own
(``train``).  The model trains on ``--device`` (cuda by default; without a
card the builder raises), the batches are made on the host and copied
ahead (``prefetch_to_device``).  Checkpoints are the port's own
(``TrainCheckpointer``: model, AdamW, LambdaLR and the epoch).
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="vdn_torch refinement "
                                     "training")
    parser.add_argument("--config", type=str, default=None,
                        help="master experiment config (the reference "
                        "configs/config.yaml switchboard, made live): "
                        "its values become the defaults below, explicit "
                        "flags still win, and its datasets: section "
                        "drives --datasets/--dataset-config (.json is "
                        "read without PyYAML)")
    parser.add_argument("--dataset-config", type=str, default=None)
    parser.add_argument("--datasets", nargs="+", default=None)
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitl"])
    parser.add_argument("--model-version", type=int, default=4)
    parser.add_argument("--from-pretrained", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--initial-lr", type=float, default=1e-5)
    parser.add_argument("--final-lr", type=float, default=0.0)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--stable-scale", type=float, default=10.0)
    parser.add_argument("--ssim-loss-scale", type=float, default=0.0)
    parser.add_argument("--freeze-temporal-head", type=int, default=None,
                        help="1/0; default: frozen for v4/v5 (reference "
                        "train_v4.py:493), trainable for v2/v3")
    parser.add_argument("--use-residual", action="store_true", default=True)
    parser.add_argument("--input-normal", action="store_true", default=True)
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                        "--checkpoint-dir (model+optimizer+scheduler+"
                        "epoch, with a deterministic data-stream restart)")
    parser.add_argument("--log-dir", default="./logs")
    parser.add_argument("--run-name", default=None,
                        help="experiment name; with --resume, re-attaches "
                        "to this tracked run (and its wandb id) instead of "
                        "allocating a new E### entry")
    parser.add_argument("--use-wandb", action="store_true")
    parser.add_argument("--debug-nans", action="store_true",
                        help="numeric sanitizer: autograd's anomaly mode "
                        "with NaN checks (raises at the backward op that "
                        "produced the first NaN) + a finite-loss guard per "
                        "step")
    parser.add_argument("--val-interval", type=int, default=1)
    parser.add_argument("--save-interval", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def build_loaders(datasets, dataset_config: str, batch_size: int,
                  seed: int):
    """(train ConcatDataset, train loader, val loader) as vdn's CLI makes
    them: a WeightedSampler over the train splits, the val splits in
    order, drop-last batches."""
    from vdn_torch.data.factory import (BatchLoader, ConcatDataset,
                                        WeightedSampler, create_datasets)
    train_sets = create_datasets(datasets, dataset_config, "train", seed)
    val_sets = create_datasets(datasets, dataset_config, "val", seed)
    train_concat = ConcatDataset(train_sets)
    sampler = WeightedSampler(train_concat, seed=seed)
    train_loader = BatchLoader(train_concat, batch_size, sampler=sampler)
    val_loader = BatchLoader(ConcatDataset(val_sets), batch_size,
                             shuffle=False)
    return train_concat, train_loader, val_loader


def build_model(args):
    """RefineVideoDepth at ``args.encoder`` / ``args.model_version`` on
    ``args.device``: the ``--from-pretrained`` checkpoint's weights
    (reference names, ``V4_RENAME_MAP`` applied), else the port's seeded
    initializers."""
    import torch

    from vdn_torch.core.checkpoint import load_checkpoint
    from vdn_torch.models.refine import build_refine_video_depth
    from vdn_torch.train.trainer import V4_RENAME_MAP, rename_with_map
    model = build_refine_video_depth(
        args.model_version, args.encoder, compute_dtype=args.compute_dtype,
        device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
        use_residual=args.use_residual, input_normal=args.input_normal)
    if args.from_pretrained:
        load_checkpoint(model, args.from_pretrained,
                        rename=lambda k: rename_with_map(k, V4_RENAME_MAP))
    return model


def build_trainer(model, args):
    """RefineTrainer with the CLI's recipe; the temporal head frozen for
    v4 / v5 unless ``--freeze-temporal-head`` says otherwise."""
    from vdn_torch.train.trainer import RefineTrainer
    freeze = (args.model_version >= 4 if args.freeze_temporal_head is None
              else bool(args.freeze_temporal_head))
    return RefineTrainer(
        model, initial_lr=args.initial_lr, final_lr=args.final_lr,
        alpha=args.alpha, stable_scale=args.stable_scale,
        ssim_loss_scale=args.ssim_loss_scale,
        freeze_temporal_head=freeze)


def to_batch(batch) -> Dict[str, np.ndarray]:
    """The refinement batch contract (vdn's ``_to_batch``)."""
    return {
        "depth_anything_v2": batch["depth_anything_v2"].astype(np.float32),
        "depth": batch["depth"].astype(np.float32),
        "mask": batch["mask"].astype(np.float32),
    }


def loss_means(step, loader, device, to_batch_fn=to_batch,
               debug_nans: bool = False, epoch: int = 0) -> Dict[str, float]:
    """Each loss of ``step(batch)`` averaged over ``loader``'s batches (the
    host's float64 sums, as vdn's); with ``debug_nans`` every step runs
    under autograd's anomaly mode and a non-finite total raises."""
    import torch

    from vdn_torch.data.factory import prefetch_to_device
    sums: Dict[str, float] = {}
    count = 0
    guard = (lambda: torch.autograd.detect_anomaly(check_nan=True)) \
        if debug_nans else contextlib.nullcontext
    for batch in prefetch_to_device(map(to_batch_fn, loader),
                                    device=device):
        with guard():
            loss_dict = step(batch)
        total = float(loss_dict["total_loss"])
        if debug_nans and not np.isfinite(total):
            raise FloatingPointError(
                f"non-finite loss {total} at epoch {epoch} "
                f"step {count} (--debug-nans)")
        for k, v in loss_dict.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    return {k: v / max(count, 1) for k, v in sums.items()}


def run_epoch(trainer, train_loader, val_loader, logger, ckpt, epoch: int,
              args, to_batch_fn=to_batch) -> Dict[str, float]:
    """One epoch as vdn's CLI runs it: the training steps over
    ``train_loader`` (its order a function of (seed, epoch)), validation
    every ``args.val_interval`` epochs, one log record at step epoch + 1,
    and a checkpoint every ``args.save_interval`` epochs (asynchronous:
    the file is written while the next epoch runs).  Returns the logged
    metrics."""
    device = trainer.device
    train_loader.set_epoch(epoch)
    metrics = {f"training/{k}": v for k, v in loss_means(
        trainer.train_step, train_loader, device, to_batch_fn,
        args.debug_nans, epoch).items()}
    if (epoch + 1) % args.val_interval == 0:
        metrics.update({f"validation/{k}": v for k, v in loss_means(
            trainer.eval_step, val_loader, device, to_batch_fn).items()})
    metrics["epoch"] = epoch + 1
    logger.add_metrics(metrics)
    logger.send_log(step=epoch + 1)
    if (epoch + 1) % args.save_interval == 0:
        ckpt.save(epoch + 1, {"model": trainer.model,
                              "optimizer": trainer.optimizer,
                              "scheduler": trainer.scheduler,
                              "epoch": epoch + 1})
    return metrics


def train(args, model=None, loaders=None, name: Optional[str] = None,
          trainer_fn=build_trainer, to_batch_fn=to_batch) -> list:
    """The CLI's run on ``model`` (built from ``args`` if None) and
    ``loaders`` ((train, val); built from the dataset config if None):
    resume if asked, then ``run_epoch`` up to ``args.epochs``.  Returns
    each epoch's logged metrics."""
    from vdn_torch.core.checkpoint import TrainCheckpointer
    from vdn_torch.utils.logging import MetricWriter
    if loaders is None:
        _, *loaders = build_loaders(args.datasets, args.dataset_config,
                                    args.batch_size, args.seed)
    train_loader, val_loader = loaders
    if model is None:
        model = build_model(args)
    trainer = trainer_fn(model, args)
    logger = MetricWriter(args.log_dir, run_name=args.run_name,
                          use_wandb=args.use_wandb, resume=args.resume)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    ckpt = TrainCheckpointer(os.path.join(
        args.checkpoint_dir, name or f"refine_v{args.model_version}"))
    start_epoch = 0
    if args.resume:
        restored = ckpt.restore_latest(trainer.model, trainer.optimizer,
                                       trainer.scheduler)
        if restored is not None:
            start_epoch = restored
            print(f"resumed from epoch {start_epoch}")
    out = []
    try:
        for epoch in range(start_epoch, args.epochs):
            out.append(run_epoch(trainer, train_loader, val_loader, logger,
                                 ckpt, epoch, args, to_batch_fn))
    finally:
        ckpt.close()
        logger.finish()
    return out


def main(argv=None):
    from vdn_torch.cli._common import parse_with_master_config
    args = parse_with_master_config(build_parser(), argv, family="refine")
    return train(args)


if __name__ == "__main__":
    main()
