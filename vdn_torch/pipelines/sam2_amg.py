"""Automatic mask generation (vdn/pipelines/sam2_amg.py; reference
sam2/automatic_mask_generator.py).

A point grid over the image, multimask predictions for each point through
Sam2ImagePredictor.predict_batch, the predicted-IoU and stability filters,
box NMS over the survivors, the small-region pass and COCO-style records
(RLE segmentation, bbox, area, scores), sorted by area.

vdn stacks every point's logits at the image's size before it filters
(3,072 x 1024 x 1024 fp32 at 32 points a side: 12.9 GB).  Here each batch
is filtered on the card as it comes (``pred_iou_thresh``, then the
stability score; each filter acts on one mask alone, so the survivors are
vdn's) and only the survivors' binary masks are kept.  The small-region
pass runs the holes of all kept masks in one connected-components launch,
then the islands in a second, the same order per mask as vdn's; each
record's ``bbox`` is the box taken before it, as vdn's.  RLE encoding
copies the masks' run boundaries to the host once.

vdn's gaps carry over: no crops past layer 0 (``crop_n_layers`` only
builds the grids), no ``use_m2m``, no ``output_mode``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from vdn_torch.models.sam2_image import Sam2ImagePredictor
from vdn_torch.ops.amg import (area_from_rle, batch_iterator,
                               batched_mask_to_box, box_xyxy_to_xywh,
                               build_all_layer_point_grids,
                               calculate_stability_score, masks_to_rle,
                               nms_boxes, remove_small_regions_batch)


class Sam2AutomaticMaskGenerator:
    def __init__(self, predictor: Sam2ImagePredictor,
                 points_per_side: int = 32,
                 points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.8,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 mask_threshold: float = 0.0,
                 box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0,
                 crop_n_points_downscale_factor: int = 1,
                 min_mask_region_area: int = 0):
        self.predictor = predictor
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area
        self.point_grids = build_all_layer_point_grids(
            points_per_side, crop_n_layers,
            crop_n_points_downscale_factor)

    def _filter(self, logits: torch.Tensor, ious: torch.Tensor):
        """One batch's [P, M, H, W] logits and [P, M] IoUs -> the surviving
        masks' (points within the batch, binary masks, IoUs, stability
        scores), in vdn's order (point, then mask)."""
        m = logits.shape[1]
        logits, ious = logits.flatten(0, 1), ious.flatten()
        # vdn compares each IoU as a Python float (float64)
        keep = ious.double() > self.pred_iou_thresh
        stability = calculate_stability_score(
            logits, self.mask_threshold, self.stability_score_offset)
        keep &= stability >= self.stability_score_thresh
        idx = torch.nonzero(keep).flatten()
        return (idx.cpu().numpy() // m, logits[idx] > self.mask_threshold,
                ious[idx], stability[idx])

    @torch.no_grad()
    def generate(self, image_rgb: np.ndarray) -> List[Dict[str, Any]]:
        h, w = image_rgb.shape[:2]
        self.predictor.set_image(image_rgb)
        points = self.point_grids[0] * np.array([w, h], np.float32)

        parts = []
        for (batch,) in batch_iterator(self.points_per_batch, points):
            logits, ious, _ = self.predictor.predict_batch(
                point_coords=batch, multimask_output=True,
                return_logits=True)
            at, masks, ious, stability = self._filter(logits, ious)
            del logits
            parts.append((batch[at], masks, ious, stability))
        pts = np.concatenate([p[0] for p in parts])
        if pts.shape[0] == 0:
            return []
        masks, ious, stability = (torch.cat([p[i] for p in parts])
                                  for i in (1, 2, 3))

        boxes = batched_mask_to_box(masks)
        order = nms_boxes(boxes, ious, self.box_nms_thresh)
        sel = order.to(masks.device)
        masks, ious, boxes = masks[sel], ious[sel], boxes[sel]
        stability, pts = stability[sel], pts[order.numpy()]
        if self.min_mask_region_area > 0:
            masks, _ = remove_small_regions_batch(
                masks, self.min_mask_region_area, "holes")
            masks, _ = remove_small_regions_batch(
                masks, self.min_mask_region_area, "islands")
        rles = masks_to_rle(masks)
        boxes = box_xyxy_to_xywh(boxes).tolist()
        records = []
        for rle, iou, box, st, pt in zip(rles, ious.tolist(), boxes,
                                         stability.tolist(), pts):
            records.append({
                "segmentation": rle,
                "area": area_from_rle(rle),
                "bbox": box,
                "predicted_iou": float(iou),
                "point_coords": [pt.tolist()],
                "stability_score": float(st),
            })
        records.sort(key=lambda r: r["area"], reverse=True)
        return records
