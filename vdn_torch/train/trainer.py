"""The refinement trainer, v4 semantics, and the v1 trainer
(vdn/train/trainer.py; reference scripts/train_v4.py:443-649 and
scripts/train.py:413-460).

- AdamW (weight decay 0.01 on every trainable tensor, biases and norms
  included, as optax.adamw) with cosine annealing warm restarts (T_0 =
  10,000, T_mult = 2) through a ``LambdaLR``, stepped after every
  ``optimizer.step()``: the LR of step n is the schedule at n, where optax
  evaluates it (tests/test_trainer.py:14-27 holds it to torch's warm
  restarts).
- The temporal head is frozen (reference :493-494): ``requires_grad`` off,
  out of the optimizer, so it also takes no decay (vdn's
  ``optax.set_to_zero``); its kernels then skip their weight grads.
- Batch preprocessing: depth clamped >= 0 (+ optional per-clip masked
  min-max), GT depth -> disparity 1 / clamp(d, 1e-8) (reference :31-119,
  :558).
- Checkpoint rename map (head -> temporal_head, ...) for reference
  checkpoints (reference :475-489): ``V4_RENAME_MAP`` with
  ``rename_with_map``, key by key.

``V1Trainer`` trains the v1 research model (VideoDepthEstimationModel) on
depth + normals: VideoDepthLoss + VideoNormalLoss * normal_loss_scale, the
same AdamW and schedule over every parameter, input depths / 65,535 and GT
depth -> disparity.  optax's adamw also decays the parameters that get no
gradient (the head's unused stacks and pos-embeds); ``torch.optim.AdamW``
skips a parameter whose ``.grad`` is None, so the trainer gives those a
zero gradient.

One process, one card: vdn's mesh (data-parallel SPMD) is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from vdn_torch.ops.normals import normal_vector
from vdn_torch.train.losses import video_depth_loss, video_normal_loss

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

V4_RENAME_MAP = {
    # reference scripts/train_v4.py:475-480
    "head": "temporal_head",
    "final_res2": "shift_head",
    "final_scale2": "scale_head",
}


def rename_with_map(key: str, rename_map: Mapping[str, str]) -> str:
    for old, new in rename_map.items():
        if key.startswith(old):
            return key.replace(old, new, 1)
    return key


def cosine_warm_restarts(init_lr: float, t_0: int = 10_000, t_mult: int = 2,
                         eta_min: float = 0.0) -> Callable[[int], float]:
    """torch's CosineAnnealingWarmRestarts as a function of the step."""
    if t_mult < 1:
        raise ValueError(f"t_mult {t_mult} < 1")

    def schedule(step: int) -> float:
        if t_mult == 1:
            t_cur, t_i = step % t_0, float(t_0)
        else:
            # cycle k starts at T_0 * (t_mult^k - 1) / (t_mult - 1)
            k = math.floor(math.log(step * (t_mult - 1) / t_0 + 1)
                           / math.log(t_mult))
            t_cur = step - t_0 * (t_mult ** k - 1) / (t_mult - 1)
            t_i = t_0 * t_mult ** k
        return eta_min + (init_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t_cur / t_i))

    return schedule


def lr_lambda(schedule: Callable[[int], float],
              base_lr: float) -> Callable[[int], float]:
    """A LambdaLR factor that makes a group's LR ``schedule(step)``."""
    return lambda step: schedule(step) / base_lr if base_lr else 0.0


def preprocess_rgb_sequences(rgb: torch.Tensor) -> torch.Tensor:
    """[B, S, H, W, 3] in 0-1 -> clamped and ImageNet-normalized
    (reference train_v4.py:31-48)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.as_tensor(IMAGENET_STD, device=rgb.device)
    return (rgb.clamp(0.0, 1.0) - mean) / std


def preprocess_depth_sequences(depth: torch.Tensor,
                               masks: Optional[torch.Tensor],
                               norm: bool = True) -> torch.Tensor:
    """[B, S, H, W] -> clamped >= 0 (+ optional per-clip masked min-max
    normalization; reference train_v4.py:70-119)."""
    depth = depth.clamp_min(0.0)
    if not norm:
        return depth
    b = depth.shape[0]
    if masks is None:
        flat = depth.reshape(b, -1)
        mn = flat.amin(1).reshape(b, 1, 1, 1)
        mx = flat.amax(1).reshape(b, 1, 1, 1)
        return (depth - mn) / (mx - mn).clamp_min(1e-8)
    m = masks > 0
    inf = torch.tensor(float("inf"), device=depth.device)
    mn = torch.where(m, depth, inf).reshape(b, -1).amin(1).reshape(b, 1, 1, 1)
    mx = torch.where(m, depth, -inf).reshape(b, -1).amax(1).reshape(
        b, 1, 1, 1)
    out = ((depth - mn) / (mx - mn).clamp_min(1e-8)).clamp(0.0, 1.0)
    any_valid = m.reshape(b, -1).any(1).reshape(b, 1, 1, 1)
    return torch.where(any_valid, out, 0.0)


def _as_tensor(a, device) -> torch.Tensor:
    """A batch entry (numpy or tensor) as fp32 on ``device``."""
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a, device=device).float()


class RefineTrainer:
    """v4 refinement training: model(input depths) against GT disparity.
    The model (vdn_torch.models.refine.RefineVideoDepth) trains in place,
    on the device its parameters lie on."""

    def __init__(self, model: torch.nn.Module, initial_lr: float = 1e-5,
                 final_lr: float = 0.0, t_0: int = 10_000, t_mult: int = 2,
                 alpha: float = 0.5, stable_scale: float = 10.0,
                 ssim_loss_scale: float = 0.0,
                 freeze_temporal_head: bool = True,
                 weight_decay: float = 0.01):
        self.model = model
        self.loss_kwargs = dict(alpha=alpha, stable_scale=stable_scale,
                                ssim_loss_scale=ssim_loss_scale)
        if freeze_temporal_head and hasattr(model, "temporal_head"):
            model.temporal_head.requires_grad_(False)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.AdamW(self.params, lr=initial_lr,
                                           weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lr_lambda(cosine_warm_restarts(
                initial_lr, t_0, t_mult, final_lr), initial_lr))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _batch(self, batch: Mapping):
        dev = self.device
        mask = _as_tensor(batch["mask"], dev)
        input_depths = preprocess_depth_sequences(
            _as_tensor(batch["depth_anything_v2"], dev), mask, norm=False)
        gt_disp = 1.0 / _as_tensor(batch["depth"], dev).clamp_min(1e-8)
        return input_depths, gt_disp, mask

    def loss(self, input_depths, gt_disp, mask) -> Dict[str, torch.Tensor]:
        pred = self.model(input_depths)
        return video_depth_loss(pred, gt_disp, mask, **self.loss_kwargs)

    def train_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """batch: {'depth_anything_v2', 'depth', 'mask'}, each [B, S, H, W]
        (the reference batch contract, train_v4.py:548-559), numpy or
        tensors.  One AdamW step; returns the loss dict (detached)."""
        loss_dict = self.loss(*self._batch(batch))
        self.optimizer.zero_grad(set_to_none=True)
        loss_dict["total_loss"].backward()
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.detach() for k, v in loss_dict.items()}

    @torch.no_grad()
    def eval_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The losses of ``batch`` without an update."""
        return self.loss(*self._batch(batch))


class V1Trainer:
    """v1 research-model training: depth + normal objective over the
    dual-Hiera model (vdn_torch.models.video_depth_v1), in place, on the
    device its parameters lie on, in fp32 as vdn trains it."""

    def __init__(self, model: torch.nn.Module, initial_lr: float = 1e-5,
                 final_lr: float = 0.0, t_0: int = 10_000, t_mult: int = 2,
                 alpha: float = 0.5, stable_scale: float = 10.0,
                 normal_loss_scale: float = 1.0,
                 input_depth_max: float = 65535.0,
                 weight_decay: float = 0.01):
        self.model = model
        self.normal_loss_scale = normal_loss_scale
        self.input_depth_max = input_depth_max
        self.loss_kwargs = dict(alpha=alpha, stable_scale=stable_scale)
        self.params = list(model.parameters())
        self.optimizer = torch.optim.AdamW(self.params, lr=initial_lr,
                                           weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lr_lambda(cosine_warm_restarts(
                initial_lr, t_0, t_mult, final_lr), initial_lr))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _batch(self, batch: Mapping):
        """(input depths, rgbs, GT disparity, mask) on the model's device
        (reference train.py:426-440 preprocessing)."""
        dev = self.device
        mask = _as_tensor(batch["mask"], dev)
        rgbs = preprocess_rgb_sequences(_as_tensor(batch["rgb"], dev))
        input_depths = preprocess_depth_sequences(
            _as_tensor(batch["depth_anything_v2"], dev), mask,
            norm=False) / self.input_depth_max
        gt_disp = 1.0 / _as_tensor(batch["depth"], dev).clamp_min(1e-8)
        return input_depths, rgbs, gt_disp, mask

    def loss(self, input_depths, rgbs, gt_disp, mask
             ) -> Dict[str, torch.Tensor]:
        pred_depths, pred_normals = self.model(input_depths, rgbs)
        out = video_depth_loss(pred_depths, gt_disp, mask,
                               **self.loss_kwargs)
        out.update(video_normal_loss(pred_normals, normal_vector(gt_disp),
                                     mask))
        out["total_loss"] = (out["total_loss"]
                             + out["normal_loss"] * self.normal_loss_scale)
        return out

    def train_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """batch: rgb [B, S, H, W, 3] in 0-1, depth_anything_v2, depth and
        mask [B, S, H, W], numpy or tensors.  One AdamW step; returns the
        loss dict (detached)."""
        loss_dict = self.loss(*self._batch(batch))
        self.optimizer.zero_grad(set_to_none=True)
        loss_dict["total_loss"].backward()
        for p in self.params:
            if p.grad is None:  # decayed all the same, as optax's adamw
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.detach() for k, v in loss_dict.items()}

    @torch.no_grad()
    def eval_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The validation losses of ``batch`` without an update (reference
        train.py:376-410)."""
        return self.loss(*self._batch(batch))
