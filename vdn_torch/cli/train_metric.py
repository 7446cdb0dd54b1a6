"""Metric-depth training CLI (vdn/cli/train_metric.py; reference
metric_depth/train.py:43-208 + dist_train.sh).

Usage:
  python -m vdn_torch.cli.train_metric --dataset hypersim \
      --train-list splits/hypersim_train.txt --val-list splits/hypersim_val.txt \
      --encoder vitl --max-depth 20 --epochs 40 [--device cuda]

``--distributed`` joins the default process group
(``vdn_torch.parallel.launch.initialize_distributed``) and only rank 0
logs and saves; as in vdn's CLI, which hands its trainer no mesh, each
rank trains on its own.  The model and trainer (``build_model`` /
``build_trainer``), one epoch of train / validate / log / save
(``run_epoch``) and the whole run (``train``) can be driven apart from
``main``'s parsing.  The file datasets decode with cv2 (and h5py for
Hypersim) on the host.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="vdn_torch metric-depth "
                                     "training")
    parser.add_argument("--dataset", default="hypersim",
                        choices=["hypersim", "vkitti2"])
    parser.add_argument("--train-list", required=True)
    parser.add_argument("--val-list", default=None)
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--img-size", type=int, default=518)
    parser.add_argument("--min-depth", type=float, default=0.001)
    parser.add_argument("--max-depth", type=float, default=20.0)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--lr", type=float, default=5e-6)
    parser.add_argument("--from-pretrained", default=None,
                        help="relative-depth .pth to warm-start the encoder"
                        " (keeps only pretrained.* keys like the reference,"
                        " metric_depth/train.py:91)")
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--log-dir", default="./logs")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--use-wandb", action="store_true")
    parser.add_argument("--resume-run", action="store_true",
                        help="re-attach logging to the tracked run named "
                        "--run-name (or the latest) incl. its wandb id")
    parser.add_argument("--debug-nans", action="store_true",
                        help="numeric sanitizer: autograd's anomaly mode "
                        "with NaN checks + a finite-loss guard per step")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def build_model(args):
    """MetricDepthAnythingV2 at ``args.encoder`` on ``args.device``, the
    port's seeded initializers, the encoder (``pretrained.*``) warm-started
    from ``--from-pretrained`` where given (every other key of the file is
    dropped; an encoder key missing from it raises)."""
    import torch

    from vdn_torch.core.checkpoint import load_torch_checkpoint
    from vdn_torch.models.metric_depth import build_metric_depth_anything_v2
    model = build_metric_depth_anything_v2(
        args.encoder, compute_dtype=args.compute_dtype, device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
        max_depth=args.max_depth)
    if args.from_pretrained:
        state = {k: v for k, v in load_torch_checkpoint(
            args.from_pretrained).items() if k.startswith("pretrained")}
        want = {k for k in model.state_dict() if k.startswith("pretrained")}
        missing = sorted(want - set(state))
        unexpected = sorted(set(state) - want)
        if missing or unexpected:
            raise KeyError(f"{args.from_pretrained}: encoder keys missing "
                           f"{missing}, unexpected {unexpected}")
        model.load_state_dict(state, strict=False)
    return model


def build_datasets(args):
    """(train dataset, val dataset or None, train loader)."""
    from vdn_torch.data.factory import BatchLoader
    from vdn_torch.data.metric_datasets import VKITTI2, Hypersim
    cls = Hypersim if args.dataset == "hypersim" else VKITTI2
    size = (args.img_size, args.img_size)
    train_ds = cls(args.train_list, "train", size, seed=args.seed)
    val_ds = cls(args.val_list, "val", size) if args.val_list else None
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               seed=args.seed)
    return train_ds, val_ds, train_loader


def build_trainer(model, args, iters_per_epoch: int):
    from vdn_torch.train.metric_depth import MetricDepthTrainer
    total_iters = args.epochs * iters_per_epoch
    return MetricDepthTrainer(model, base_lr=args.lr,
                              total_iters=max(total_iters, 1),
                              min_depth=args.min_depth,
                              max_depth=args.max_depth)


def validate(model, val_ds, min_depth: float, max_depth: float
             ) -> Dict[str, float]:
    """The nine metrics averaged over ``val_ds``'s samples that hold a
    valid pixel; each prediction, at the network's size, resized to the
    GT's (bilinear, align_corners, as vdn's ``resize2d``) on the device."""
    import torch

    from vdn_torch.ops.resize import resize2d
    from vdn_torch.train.metric_depth import eval_depth
    device = next(model.parameters()).device
    sums: Dict[str, float] = {}
    n = 0
    with torch.no_grad():
        for i in range(len(val_ds)):
            s = val_ds[i]
            pred = model(torch.from_numpy(s["image"][None]).to(device))[0]
            if tuple(pred.shape) != s["depth"].shape:
                # predictions are at network res; GT stays at original
                # res in val mode (reference metric_depth/train.py:166+)
                pred = resize2d(pred[None, :, :, None], s["depth"].shape,
                                "bilinear", align_corners=True)[0, :, :, 0]
            pred = pred.float().cpu().numpy()
            valid = (s["valid_mask"] & (s["depth"] >= min_depth)
                     & (s["depth"] <= max_depth))
            if not valid.any():
                continue
            m = eval_depth(pred[valid], s["depth"][valid])
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
    return {k: v / n for k, v in sums.items()} if n else {}


def run_epoch(trainer, train_loader, val_ds, logger, rng, epoch: int,
              args) -> Dict[str, float]:
    """One epoch as vdn's CLI runs it: the steps over ``train_loader``
    (shuffled by its own generator; flips drawn from ``rng``), validation
    where there is a val list, and on the primary rank one log record at
    step epoch + 1 and the model's weights saved under vdn's name stem
    (``<run>_metric_<encoder>_epoch_<n>.pth``).  Returns the logged
    metrics."""
    import torch

    from vdn_torch.core.checkpoint import save_pytree
    total, count = 0.0, 0
    for batch in train_loader:
        if args.debug_nans:
            with torch.autograd.detect_anomaly(check_nan=True):
                loss = trainer.train_step(batch, rng)
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss {loss} at epoch {epoch} "
                    f"step {count} (--debug-nans)")
        else:
            loss = trainer.train_step(batch, rng)
        total += loss
        count += 1
    metrics = {"train/loss": total / max(count, 1), "epoch": epoch + 1}
    if val_ds is not None:
        metrics.update({f"val/{k}": v for k, v in validate(
            trainer.model, val_ds, args.min_depth, args.max_depth).items()})
    if logger:
        logger.add_metrics(metrics)
        logger.send_log(step=epoch + 1)
        save_pytree(os.path.join(
            args.checkpoint_dir,
            f"{logger.run_name}_metric_{args.encoder}"
            f"_epoch_{epoch + 1}.pth"), trainer.model)
    return metrics


def train(args, model=None, datasets: Optional[tuple] = None) -> list:
    """The CLI's run on ``model`` (built from ``args`` if None) and
    ``datasets`` ((train dataset, val dataset or None, train loader);
    from the file lists if None).  Returns each epoch's metrics."""
    from vdn_torch.parallel.launch import is_primary
    from vdn_torch.utils.logging import MetricWriter
    if args.distributed:
        from vdn_torch.parallel.launch import initialize_distributed
        initialize_distributed(device=args.device)
    _, val_ds, train_loader = datasets or build_datasets(args)
    if model is None:
        model = build_model(args)
    trainer = build_trainer(model, args, len(train_loader))
    logger = MetricWriter(args.log_dir, project="vdn-metric",
                          run_name=args.run_name, use_wandb=args.use_wandb,
                          resume=args.resume_run) if is_primary() else None
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    out = []
    try:
        for epoch in range(args.epochs):
            out.append(run_epoch(trainer, train_loader, val_ds, logger, rng,
                                 epoch, args))
    finally:
        if logger:
            logger.finish()
    return out


def main(argv=None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
