"""Automatic-mask-generation utilities on tensors (vdn/ops/amg.py;
reference sam2/utils/amg.py).

Stability scores, mask -> box, small-region removal (over connected
components: the kernel on the card, vdn_torch.ops.connected_components)
and IoU NMS run where the masks are, on the card for the AMG's masks.
RLE encoding (column-major, starting with the count of 0s) reads its
run boundaries off the device in one copy for a batch of masks; the
point grids and crop boxes are host numpy, as vdn's.

Every result is vdn's on the same input, including its orders and ties:
``remove_small_regions`` keeps the island of the first raster index among
equal largest areas when every island would go (vdn's ``np.argmax``);
``nms_boxes`` orders by score and, among equal scores, by index (see its
docstring for how that meets vdn's quicksort).
"""

from __future__ import annotations

from typing import Any, Dict, Generator, List, Tuple

import numpy as np
import torch

from vdn_torch.ops.connected_components import get_connected_components

__all__ = [
    "mask_to_rle", "masks_to_rle", "rle_to_mask", "area_from_rle",
    "calculate_stability_score", "build_point_grid",
    "build_all_layer_point_grids", "generate_crop_boxes",
    "uncrop_boxes_xyxy", "uncrop_points", "uncrop_masks",
    "remove_small_regions", "remove_small_regions_batch",
    "batched_mask_to_box", "box_xyxy_to_xywh", "batch_iterator",
    "nms_boxes", "is_box_near_crop_edge",
]


def masks_to_rle(masks: torch.Tensor) -> List[Dict[str, Any]]:
    """Binary [N, H, W] -> N uncompressed RLEs, column-major, starting with
    the count of 0s (reference amg.py:109-137): the run boundaries of all N
    masks found where they lie and copied to the host once."""
    n, h, w = masks.shape
    flat = masks.bool().transpose(1, 2).reshape(n, h * w)
    change = torch.nonzero(flat[:, 1:] != flat[:, :-1])
    first = flat[:, 0].tolist()
    rows, cols = change.cpu().numpy().T if change.numel() else (
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    splits = np.searchsorted(rows, np.arange(1, n))
    out = []
    for i, idx in enumerate(np.split(cols + 1, splits)):
        bounds = np.concatenate([[0], idx, [h * w]])
        counts = np.diff(bounds).tolist()
        if h * w and first[i]:
            counts = [0] + counts
        out.append({"size": [h, w], "counts": counts})
    return out


def mask_to_rle(mask: torch.Tensor) -> Dict[str, Any]:
    """Binary [H, W] -> uncompressed RLE (reference amg.py:109-137)."""
    return masks_to_rle(torch.as_tensor(mask)[None])[0]


def rle_to_mask(rle: Dict[str, Any]) -> torch.Tensor:
    """(reference amg.py:140-151) -> bool [H, W] on the host."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    parity = np.arange(counts.size) % 2 == 1
    flat = np.repeat(parity, counts)
    return torch.from_numpy(np.ascontiguousarray(flat.reshape(w, h).T))


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def calculate_stability_score(mask_logits: torch.Tensor,
                              mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """IoU between the high- and low-threshold binarizations (reference
    amg.py:158-178), float64 as vdn's.  mask_logits [..., H, W]."""
    hi = (mask_logits > (mask_threshold + threshold_offset)).sum((-1, -2))
    lo = (mask_logits > (mask_threshold - threshold_offset)).sum((-1, -2))
    return hi.double() / lo.clamp(min=1).double()


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] normalized (x, y) grid (reference amg.py:181-188)."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / scale_per_layer ** i))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float
                        ) -> Tuple[List[List[int]], List[int]]:
    """(reference amg.py:202-236): xyxy crop boxes per layer."""
    boxes, layer_idxs = [[0, 0, im_size[1], im_size[0]]], [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig_len, n_crops, overlap):
        return int(np.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * 2 / n_crops_per_side)
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i)
                       for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i)
                       for i in range(n_crops_per_side)]
        for x0 in crop_box_x0:
            for y0 in crop_box_y0:
                boxes.append([x0, y0, min(x0 + crop_w, im_w),
                              min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: torch.Tensor,
                      crop_box: List[int]) -> torch.Tensor:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + torch.tensor([[x0, y0, x0, y0]], dtype=boxes.dtype,
                                device=boxes.device)


def uncrop_points(points: torch.Tensor,
                  crop_box: List[int]) -> torch.Tensor:
    x0, y0 = crop_box[0], crop_box[1]
    return points + torch.tensor([[x0, y0]], dtype=points.dtype,
                                 device=points.device)


def uncrop_masks(masks: torch.Tensor, crop_box: List[int], orig_h: int,
                 orig_w: int) -> torch.Tensor:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    out = masks.new_zeros((*masks.shape[:-2], orig_h, orig_w))
    out[..., y0:y1, x0:x1] = masks
    return out


def remove_small_regions_batch(masks: torch.Tensor, area_thresh: float,
                               mode: str
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``remove_small_regions`` over bool masks [N, H, W] with one
    connected-components launch: (the masks, which of them changed [N])."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be 'holes' or 'islands', got {mode!r}")
    correct_holes = mode == "holes"
    masks = masks.bool()
    labels, areas = get_connected_components(masks ^ correct_holes)
    # a component's area is at each of its pixels: the pixels of the small
    # components are exactly vdn's np.isin(labels, small_labels)
    small = (areas > 0) & (areas < area_thresh)
    changed = small.flatten(1).any(1)
    if correct_holes:
        return masks | small, changed
    out = masks & ~small
    # every island went: keep the largest, the first raster index among
    # equal areas (vdn's np.argmax)
    emptied = changed & ~out.flatten(1).any(1)
    if bool(emptied.any()):
        flat = areas.flatten(1)
        n, hw = flat.shape
        top = flat.amax(1, keepdim=True)
        pos = torch.arange(hw, device=flat.device).expand(n, hw)
        keep = torch.where(flat == top, pos, hw).amin(1, keepdim=True)
        lab = labels.flatten(1).gather(1, keep)[:, :, None]
        out = torch.where(emptied[:, None, None], labels == lab, out)
    return out, changed


def remove_small_regions(mask: torch.Tensor, area_thresh: float,
                         mode: str) -> Tuple[torch.Tensor, bool]:
    """Remove small 'holes' or 'islands' of a bool mask [H, W] (reference
    amg.py:269-293): (the mask, whether it changed)."""
    out, changed = remove_small_regions_batch(torch.as_tensor(mask)[None],
                                              area_thresh, mode)
    return out[0], bool(changed[0])


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> xyxy boxes fp32 with inclusive max-index edges;
    empty masks -> zeros (reference amg.py:305-340)."""
    h, w = masks.shape[-2:]
    m = masks.bool()
    rows, cols = m.any(-1), m.any(-2)
    ys = torch.arange(h, device=m.device)
    xs = torch.arange(w, device=m.device)
    y0 = torch.where(rows, ys, h).amin(-1)
    y1 = torch.where(rows, ys, -1).amax(-1)
    x0 = torch.where(cols, xs, w).amin(-1)
    x1 = torch.where(cols, xs, -1).amax(-1)
    boxes = torch.stack([x0, y0, x1, y1], -1).float()
    return torch.where(rows.any(-1, keepdim=True), boxes, 0.0)


def box_xyxy_to_xywh(box: torch.Tensor) -> torch.Tensor:
    out = torch.as_tensor(box, dtype=torch.float32).clone()
    out[..., 2] -= out[..., 0]
    out[..., 3] -= out[..., 1]
    return out


def batch_iterator(batch_size: int, *args) -> Generator:
    n = len(args[0])
    for b in range(0, n, batch_size):
        yield [a[b: b + batch_size] for a in args]


def is_box_near_crop_edge(boxes: torch.Tensor, crop_box: List[int],
                          orig_box: List[int], atol: float = 20.0
                          ) -> torch.Tensor:
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    crop = torch.tensor(crop_box, dtype=torch.float32, device=boxes.device)
    orig = torch.tensor(orig_box, dtype=torch.float32, device=boxes.device)
    boxes = uncrop_boxes_xyxy(boxes, crop_box)
    near_crop = torch.isclose(boxes, crop[None], atol=atol, rtol=1e-5)
    near_img = torch.isclose(boxes, orig[None], atol=atol, rtol=1e-5)
    return (near_crop & ~near_img).any(dim=1)


def nms_boxes(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """Greedy IoU NMS over xyxy fp32 ``boxes`` [N, 4] -> the kept indices
    (int64, on the host) in the order kept; a box goes where its IoU with a
    kept box exceeds ``iou_threshold`` and stays at equality, IoU =
    inter / max(area_i + area_j - inter, 1e-9) in fp32 as vdn's.

    The IoUs of all pairs are computed where the boxes are, the greedy
    walk on the host.  The walk goes by score, highest first, and among
    equal scores by index.  vdn orders by ``np.argsort(-scores)``, numpy's
    quicksort, which does not keep equal scores in order: where the scores
    are distinct the kept set is vdn's; where two boxes tie and overlap
    past the threshold, this keeps the one of the lower index and vdn may
    keep either."""
    boxes = boxes.float()
    n = boxes.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64)
    order = torch.sort(scores, descending=True, stable=True)[1].cpu()
    b = boxes[:, None]   # row i, column j: i the kept box, j another
    xx0 = torch.maximum(b[..., 0], boxes[None, :, 0])
    yy0 = torch.maximum(b[..., 1], boxes[None, :, 1])
    xx1 = torch.minimum(b[..., 2], boxes[None, :, 2])
    yy1 = torch.minimum(b[..., 3], boxes[None, :, 3])
    inter = (xx1 - xx0).clamp(min=0) * (yy1 - yy0).clamp(min=0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iou = inter / (area[:, None] + area[None, :] - inter).clamp(min=1e-9)
    over = (iou > iou_threshold).cpu().numpy()
    gone = np.zeros(n, bool)
    keep = []
    for i in order.tolist():
        if gone[i]:
            continue
        keep.append(i)
        gone |= over[i]
    return torch.tensor(keep, dtype=torch.int64)
