"""Depth losses (vdn/train/losses.py; reference loss/loss.py:1-408).

Shapes follow the reference: images [N, H, W], clips [B, T, H, W].  As in
vdn the masked reductions keep static shapes: trimming finds its cutoff by
exact selection (vdn_torch.ops.select) instead of sorting the kept values,
medians are torch's lower median recovered differentiably, and every loss
divides the kept residuals by the total valid pixels ("batch-based").
Sums run in fp32 in torch's order; they differ from vdn's by rounding
only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vdn_torch.ops.select import differentiable_value, kth_smallest

Tensor = torch.Tensor


def _batch_reduce(total_kept: Tensor, total_valid: Tensor) -> Tensor:
    return torch.where(total_valid > 0,
                       total_kept / torch.where(total_valid > 0,
                                                total_valid, 1.0), 0.0)


def _trimmed_abs_sum(res: Tensor, mask: Tensor, trim: float) -> Tensor:
    """Sum of the smallest (1 - trim) fraction of |res| over the valid
    entries (reference TrimmedMAELoss, loss.py:194-219); ties at the
    cutoff share the remaining slots (vdn's rule)."""
    vals = torch.where(mask.reshape(-1) > 0, res.reshape(-1).abs(),
                       torch.tensor(float("inf"), device=res.device))
    n_valid = (mask.reshape(-1) > 0).sum()
    keep_num = torch.floor(n_valid * (1.0 - trim)).to(torch.long)
    thr = kth_smallest(vals, keep_num)
    below = vals < thr
    n_below = below.sum()
    sum_below = torch.where(below, vals, 0.0).sum()
    eq = vals == thr
    tie_mean = torch.where(eq, vals, 0.0).sum() / eq.sum().clamp_min(1)
    kept = sum_below + (keep_num - n_below).to(vals.dtype) * tie_mean
    return torch.where(keep_num > 0, kept, 0.0)


def trimmed_mae_loss(prediction: Tensor, target: Tensor, mask: Tensor,
                     trim: float = 0.2) -> Tensor:
    mask = mask.to(prediction.dtype)
    kept = _trimmed_abs_sum(prediction - target, mask, trim)
    return _batch_reduce(kept, mask.sum())


def trimmed_absrel_loss(prediction: Tensor, target: Tensor, mask: Tensor,
                        trim: float = 0.2, target_min: float = 1e-3,
                        target_max: float = 70.0) -> Tensor:
    """(reference TrimmedAbsRelLoss, loss.py:164-192)"""
    valid_t = (target > target_min) & (target < target_max)
    mask = mask.to(prediction.dtype) * valid_t.to(prediction.dtype)
    res = (prediction - target) / torch.where(target == 0, 1.0, target)
    kept = _trimmed_abs_sum(res, mask, trim)
    return _batch_reduce(kept, mask.sum())


def delta1_loss(prediction: Tensor, target: Tensor, mask: Tensor,
                threshold: float = 1.25) -> Tensor:
    """Fraction of valid pixels with max(p / t, t / p) < 1.25 (reference
    Delta1Loss, loss.py:99-124)."""
    mask = mask.to(prediction.dtype)
    safe_t = torch.where(target == 0, 1.0, target)
    safe_p = torch.where(prediction == 0, 1.0, prediction)
    ratio = torch.maximum(prediction / safe_t, target / safe_p)
    res = (ratio < threshold).to(prediction.dtype) * mask
    return _batch_reduce(res.sum(), mask.sum())


def normalize_prediction_robust(target: Tensor, mask: Tensor,
                                ms: Optional[Tuple[Tensor, Tensor]] = None):
    """Median / MAD normalization (reference loss.py:53-71): the median is
    torch's lower median over the zero-filled masked product.  Returns
    (normalized, (median, scale) without gradient)."""
    mask = mask.to(target.dtype)
    n = target.shape[0]
    flat = (mask * target).reshape(n, -1)
    ssum = mask.sum((1, 2))
    valid = ssum > 0
    if ms is None:
        npix = flat.shape[1]
        med = differentiable_value(flat,
                                   kth_smallest(flat, (npix - 1) // 2 + 1))
        m = torch.where(valid, med, 0.0)
    else:
        m, s = ms
    centered = target - m.reshape(-1, 1, 1)
    if ms is None:
        sq = (mask * centered.abs()).sum((1, 2))
        s = torch.where(valid, (sq / torch.where(valid, ssum, 1.0)).clamp_min(
            1e-6), 1.0)
    return centered / s.reshape(-1, 1, 1), (m.detach(), s.detach())


def compute_scale_and_shift(prediction: Tensor, target: Tensor,
                            mask: Tensor):
    """Per-item closed-form alignment, the loss flavour: degenerate ->
    (0, 0), det + 1e-6 denominator (reference loss.py:74-96)."""
    axes = tuple(range(1, prediction.ndim))
    mask = mask.to(prediction.dtype)
    a_00 = (mask * prediction * prediction).sum(axes)
    a_01 = (mask * prediction).sum(axes)
    a_11 = mask.sum(axes)
    b_0 = (mask * prediction * target).sum(axes)
    b_1 = (mask * target).sum(axes)
    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / (det + 1e-6), 0.0)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / (det + 1e-6), 0.0)
    return x_0, x_1


def _gradient_loss_single_scale(prediction, target, mask,
                                frame_id_mask=None):
    """(reference gradient_loss, loss.py:28-51)"""
    diff = mask * (prediction - target)
    grad_x = (diff[:, :, 1:] - diff[:, :, :-1]).abs()
    mask_x = mask[:, :, 1:] * mask[:, :, :-1]
    grad_y = (diff[:, 1:, :] - diff[:, :-1, :]).abs()
    mask_y = mask[:, 1:, :] * mask[:, :-1, :]
    if frame_id_mask is not None:
        mask_x = mask_x * (frame_id_mask[:, :, 1:]
                           == frame_id_mask[:, :, :-1])
        mask_y = mask_y * (frame_id_mask[:, 1:, :]
                           == frame_id_mask[:, :-1, :])
    num = (mask_x * grad_x).sum() + (mask_y * grad_y).sum()
    return _batch_reduce(num, mask.sum())


def gradient_loss(prediction: Tensor, target: Tensor, mask: Tensor,
                  scales: int = 4, num_frame_h: int = 1) -> Tensor:
    """Multi-scale gradient matching with optional frame-boundary masking
    (reference GradientLoss, loss.py:222-254)."""
    mask = mask.to(prediction.dtype)
    frame_id_mask = None
    if num_frame_h > 1:
        frame_h = mask.shape[1] // num_frame_h
        rows = torch.arange(mask.shape[1], device=mask.device) // frame_h + 1
        frame_id_mask = rows[None, :, None].expand(mask.shape)
    total = 0.0
    for scale in range(scales):
        step = 2 ** scale
        total = total + _gradient_loss_single_scale(
            prediction[:, ::step, ::step], target[:, ::step, ::step],
            mask[:, ::step, ::step],
            frame_id_mask[:, ::step, ::step]
            if frame_id_mask is not None else None)
    return total


def trimmed_procrustes_loss(prediction: Tensor, target: Tensor,
                            mask: Tensor, alpha: float = 0.5,
                            grad_scales: int = 4, trim: float = 0.2,
                            num_frame_h: int = 1) -> Tensor:
    """Robust-normalized MAE + gradient regularizer (reference
    TrimmedProcrustesLoss, loss.py:127-153)."""
    pred_ssi, _ = normalize_prediction_robust(prediction, mask)
    target_ssi, _ = normalize_prediction_robust(target, mask)
    total = trimmed_mae_loss(pred_ssi, target_ssi, mask, trim)
    if alpha > 0:
        total = total + alpha * gradient_loss(pred_ssi, target_ssi, mask,
                                              grad_scales, num_frame_h)
    return total


def temporal_gradient_matching_loss(prediction: Tensor, target: Tensor,
                                    mask: Tensor, trim: float = 0.0,
                                    scales: int = 1, decay: float = 0.5,
                                    diff_depth_th: float = 0.05) -> Tensor:
    """Multi-scale temporal-difference matching (reference
    TemporalGradientMatchingLoss, loss.py:257-292); [B, T, H, W]."""
    maskb = mask > 0
    inf = torch.tensor(float("inf"), device=target.device)
    min_t = torch.where(maskb, target, inf).amin((2, 3))
    max_t = torch.where(maskb, target, -inf).amax((2, 3))
    target_th = (max_t - min_t) * diff_depth_th           # [B, T]
    total = 0.0
    cnt = 0
    for scale in range(scales):
        stride = 2 ** scale
        if stride >= prediction.shape[1]:
            continue
        p, t = prediction[:, ::stride], target[:, ::stride]
        m, th = maskb[:, ::stride], target_th[:, ::stride]
        pg = p[:, 1:] - p[:, :-1]
        tg = t[:, 1:] - t[:, :-1]
        tm = m[:, 1:] & m[:, :-1] & (tg.abs() < th[:, 1:, None, None])
        total = total + trimmed_mae_loss(
            pg.reshape(-1, *pg.shape[2:]), tg.reshape(-1, *tg.shape[2:]),
            tm.reshape(-1, *tm.shape[2:]).to(prediction.dtype),
            trim) * (decay ** scale)
        cnt += 1
    return total / max(cnt, 1)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> Tensor:
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim_cs_loss(prediction: Tensor, target: Tensor, mask: Tensor,
                 win_size: int = 11, sigma: float = 1.5,
                 data_range: float = 1.0) -> Tensor:
    """1 - the contrast / structure SSIM term at full resolution, the
    reference's MS_SSIM with weights [1, 0, 0, 0, 0] (DepthShallowSSIMLoss,
    loss.py:296-323; max-normalized per clip, the mask only in the
    normalizer)."""
    b = prediction.shape[0]
    m = mask.to(prediction.dtype)
    pmax = (prediction * m).reshape(b, -1).amax(1)
    tmax = (target * m).reshape(b, -1).amax(1)
    max_val = torch.maximum(pmax, tmax).clamp_min(1e-8)
    p = (prediction / max_val[:, None, None, None]).reshape(
        -1, 1, *prediction.shape[2:])
    t = (target / max_val[:, None, None, None]).reshape(
        -1, 1, *target.shape[2:])
    win = _gaussian_window(win_size, sigma).to(prediction)

    def blur(x):  # separable VALID gaussian
        x = F.conv2d(x, win.reshape(1, 1, win_size, 1))
        return F.conv2d(x, win.reshape(1, 1, 1, win_size))

    mu_p, mu_t = blur(p), blur(t)
    spp = blur(p * p) - mu_p * mu_p
    stt = blur(t * t) - mu_t * mu_t
    spt = blur(p * t) - mu_p * mu_t
    c2 = (0.03 * data_range) ** 2
    cs = (2 * spt + c2) / (spp + stt + c2)
    return 1.0 - torch.relu(cs).mean()


def video_depth_loss(prediction: Tensor, target: Tensor, mask: Tensor,
                     alpha: float = 0.5, scales: int = 4, trim: float = 0.0,
                     stable_scale: float = 10.0,
                     ssim_loss_scale: float = 0.0) -> Dict[str, Tensor]:
    """The training objective (reference VideoDepthLoss, loss.py:326-367):
    per-video scale / shift alignment, then spatial (robust SSI MAE +
    gradient) + temporal gradient matching (+ optional SSIM), with AbsRel
    and delta1 reported."""
    b, t = prediction.shape[:2]
    scale, shift = compute_scale_and_shift(
        prediction.reshape(b, -1, prediction.shape[-1]),
        target.reshape(b, -1, target.shape[-1]),
        mask.reshape(b, -1, mask.shape[-1]))
    prediction = (scale.reshape(-1, 1, 1, 1) * prediction
                  + shift.reshape(-1, 1, 1, 1))

    def flat(x):
        return x.reshape(b * t, *x.shape[2:])

    out: Dict[str, Tensor] = {}
    out["spatial_loss"] = trimmed_procrustes_loss(
        flat(prediction), flat(target), flat(mask).float(), alpha=alpha,
        grad_scales=scales, trim=trim)
    total = out["spatial_loss"]
    if stable_scale > 0:
        out["stable_loss"] = temporal_gradient_matching_loss(
            prediction, target, mask, trim=trim, scales=1, decay=0.5)
        total = total + out["stable_loss"] * stable_scale
    if ssim_loss_scale > 0:
        out["ssim_loss"] = ssim_cs_loss(prediction, target, mask)
        total = total + out["ssim_loss"] * ssim_loss_scale
    out["absRel_loss"] = trimmed_absrel_loss(prediction, target, mask, trim)
    out["d1"] = delta1_loss(prediction, target, mask)
    out["total_loss"] = total
    return out


def eroded_mask(mask: Tensor) -> Tensor:
    """3 x 3 erosion of a [B, T, H, W] validity mask, as a dilation of its
    inverse (reference VideoNormalLoss.eroded_mask, loss.py:380-387)."""
    inv = 1.0 - (mask > 0).float()
    b, t, h, w = inv.shape
    dil = F.max_pool2d(inv.reshape(b * t, 1, h, w), 3, 1, 1)
    return (dil.reshape(b, t, h, w) == 0)


def video_normal_loss(prediction: Tensor, target: Tensor, mask: Tensor
                      ) -> Dict[str, Tensor]:
    """Cosine-similarity loss on normal maps [B, T, H, W, 3] (reference
    VideoNormalLoss, loss.py:370-408)."""
    m = eroded_mask(mask)
    p = prediction.reshape(-1, 3)
    t = target.reshape(-1, 3)
    sim = (p * t).sum(-1) / (p.norm(dim=-1) * t.norm(dim=-1)).clamp_min(1e-8)
    mflat = m.reshape(-1).float()
    cos = _batch_reduce((sim * mflat).sum(), mflat.sum())
    return {"normal_loss": 1.0 - cos}
