"""Training sample visualization grids (vdn/utils/visualization.py;
reference scripts/train_v4.py:152-219 create_sample_visualization).

6 rows x S frames: RGB / aligned input depth / aligned prediction / GT /
residual (centered coolwarm) / absolute error — saved as PNG for the metric
logger's image channel.  matplotlib is imported where a grid is drawn.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from vdn_torch.ops.scale_shift import scale_and_shift_np

__all__ = ["create_sample_visualization", "create_sample_visualizations"]


def _align(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    s, t = scale_and_shift_np(pred, gt, np.ones_like(gt))
    return pred * s + t


def create_sample_visualization(rgb: np.ndarray, input_depth: np.ndarray,
                                pred_depth: np.ndarray, gt_depth: np.ndarray,
                                residual: Optional[np.ndarray],
                                save_path: str, sample_idx: int = 0):
    """rgb [S,H,W,3] in 0-1; depths [S,H,W]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import colors

    pred_aligned = _align(pred_depth, gt_depth)
    input_aligned = _align(input_depth, gt_depth)
    error = np.abs(pred_depth - gt_depth)
    if residual is None:
        residual = pred_depth - input_depth

    rows = [("RGB Image", rgb, None),
            ("Input", input_aligned, "gray"),
            ("Output", pred_aligned, "gray"),
            ("Ground Truth", gt_depth, "gray"),
            ("Residual", residual, "coolwarm"),
            ("Affine Invariant Error", error, "hot")]
    s = rgb.shape[0]
    fig, axes = plt.subplots(len(rows), s, figsize=(2 * s, 2 * len(rows)),
                             squeeze=False)
    norm = colors.CenteredNorm(vcenter=0.0)
    for r, (title, data, cmap) in enumerate(rows):
        for f in range(s):
            ax = axes[r][f]
            if cmap == "coolwarm":
                ax.imshow(data[f], cmap=cmap, norm=norm)
            elif cmap:
                ax.imshow(data[f], cmap=cmap, vmin=0, vmax=1)
            else:
                ax.imshow(np.clip(data[f], 0, 1))
            if r == 0:
                ax.set_title(f"Frame {f}", fontsize=10)
            if f == 0:
                ax.set_ylabel(title, fontsize=10, rotation=90, labelpad=15)
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle(f"Sample {sample_idx} Visualization", fontsize=14,
                 fontweight="bold")
    plt.tight_layout(rect=[0, 0, 1, 0.96])
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def create_sample_visualizations(forward_fn, dataset,
                                 sample_indices: Sequence[int],
                                 save_dir: str = "./visualizations",
                                 save_path_format: str =
                                 "sample_{sample_idx:03d}.png",
                                 input_depth_max: float = 65535.0):
    """forward_fn: [1,S,H,W] input depths (numpy) -> [1,S,H,W]
    prediction (numpy or a tensor on any device)."""
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for idx in sample_indices:
        item = dataset[idx]
        input_depth = np.clip(item["depth_anything_v2"], 0, None)
        pred = forward_fn(input_depth[None])
        if hasattr(pred, "detach"):
            pred = pred.detach().float().cpu().numpy()
        pred = np.asarray(pred)[0]
        gt_disp = 1.0 / np.clip(item["depth"], 1e-8, None)
        path = os.path.join(save_dir,
                            save_path_format.format(sample_idx=idx))
        create_sample_visualization(
            item["rgb"], input_depth / input_depth_max,
            pred / input_depth_max, gt_disp, None, path, idx)
        paths.append(path)
    return paths
