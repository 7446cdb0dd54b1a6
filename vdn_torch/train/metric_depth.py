"""Metric-depth training: SiLog loss, poly LR, the train step
(vdn/train/metric_depth.py; reference metric_depth/train.py:43-208,
util/loss.py:5-16, util/metric.py:4-26).

- Two AdamW groups (vdn's optax.multi_transform): the encoder
  (``pretrained``) at the base LR, everything else at 10x; both decay as
  (1 - iter / total)^0.9 per step through a ``LambdaLR``.
- The random horizontal flip is drawn host-side from the caller's
  ``np.random.Generator``, as vdn's.

One process, one card: vdn's mesh (the reference's DDP) is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

from vdn_torch.train.trainer import lr_lambda

__all__ = ["silog_loss", "eval_depth", "poly_schedule",
           "MetricDepthTrainer"]


def silog_loss(pred: torch.Tensor, target: torch.Tensor,
               valid_mask: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    """(reference metric_depth/util/loss.py:5-16)"""
    m = valid_mask.float()
    n = m.sum().clamp_min(1.0)
    safe_pred = torch.where(valid_mask, pred, 1.0)
    safe_t = torch.where(valid_mask, target, 1.0)
    diff_log = (torch.log(safe_t) - torch.log(safe_pred)) * m
    mean_sq = (diff_log ** 2).sum() / n
    mean = diff_log.sum() / n
    return torch.sqrt((mean_sq - lambd * mean ** 2).clamp_min(0.0))


def eval_depth(pred: np.ndarray, target: np.ndarray) -> Dict[str, float]:
    """The nine metrics over flattened valid pixels (reference
    metric_depth/util/metric.py:4-26)."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    thresh = np.maximum(target / pred, pred / target)
    n = pred.size
    diff = pred - target
    diff_log = np.log(pred) - np.log(target)
    return {
        "d1": float((thresh < 1.25).sum() / n),
        "d2": float((thresh < 1.25 ** 2).sum() / n),
        "d3": float((thresh < 1.25 ** 3).sum() / n),
        "abs_rel": float(np.mean(np.abs(diff) / target)),
        "sq_rel": float(np.mean(diff ** 2 / target)),
        "rmse": float(np.sqrt(np.mean(diff ** 2))),
        "rmse_log": float(np.sqrt(np.mean(diff_log ** 2))),
        "log10": float(np.mean(np.abs(np.log10(pred) - np.log10(target)))),
        "silog": float(np.sqrt(np.mean(diff_log ** 2)
                               - 0.5 * np.mean(diff_log) ** 2)),
    }


def poly_schedule(base_lr: float, total_iters: int,
                  power: float = 0.9) -> Callable[[int], float]:
    """(reference metric_depth/train.py:142-145)"""

    def schedule(step: int) -> float:
        frac = min(max(step / total_iters, 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power

    return schedule


class MetricDepthTrainer:
    """Trains vdn_torch.models.metric_depth.MetricDepthAnythingV2 in place,
    on the device its parameters lie on."""

    def __init__(self, model: torch.nn.Module, base_lr: float = 5e-6,
                 total_iters: int = 100_000, min_depth: float = 0.001,
                 max_depth: float = 20.0, weight_decay: float = 0.01):
        self.model = model
        self.min_depth, self.max_depth = min_depth, max_depth
        encoder = [p for n, p in model.named_parameters()
                   if n.split(".")[0] == "pretrained" and p.requires_grad]
        head = [p for n, p in model.named_parameters()
                if n.split(".")[0] != "pretrained" and p.requires_grad]
        self.optimizer = torch.optim.AdamW(
            [{"params": encoder, "lr": base_lr},
             {"params": head, "lr": base_lr * 10.0}],
            betas=(0.9, 0.999), weight_decay=weight_decay)
        sched = poly_schedule(base_lr, total_iters)
        sched10 = poly_schedule(base_lr * 10.0, total_iters)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, [lr_lambda(sched, base_lr),
                             lr_lambda(sched10, base_lr * 10.0)])

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def loss(self, img, depth, valid_mask) -> torch.Tensor:
        pred = self.model(img)
        mask = (valid_mask > 0) & (depth >= self.min_depth) & (
            depth <= self.max_depth)
        return silog_loss(pred, depth, mask)

    def train_step(self, batch: Mapping, rng: np.random.Generator) -> float:
        """batch: {'image' [B, H, W, 3], 'depth' [B, H, W], 'valid_mask'
        [B, H, W]} numpy; a horizontal flip with probability 0.5 (reference
        :127-130) drawn from ``rng``.  One step; returns the loss."""
        img = np.asarray(batch["image"], np.float32)
        depth = np.asarray(batch["depth"], np.float32)
        mask = np.asarray(batch["valid_mask"], np.float32)
        if rng.random() < 0.5:
            img = img[:, :, ::-1].copy()
            depth = depth[:, :, ::-1].copy()
            mask = mask[:, :, ::-1].copy()
        dev = self.device
        loss = self.loss(*(torch.from_numpy(a).to(dev)
                           for a in (img, depth, mask)))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return float(loss.detach())
