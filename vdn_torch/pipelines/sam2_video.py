"""SAM2's video predictor (vdn/pipelines/sam2_video.py; reference
sam2/sam2_video_predictor.py).

Drives Sam2VideoModel per frame and per object.  Each object is tracked on
its own memory (batch-1 slices, as the reference's): a prompted frame is
conditioned through the no-memory path, and a later frame cross-attends to
a memory assembled from up to ``num_maskmem`` mask memories (conditioning
frames at temporal position 0, then the nearest tracked frames) and the
object pointers with signed temporal encodings: the reference's
eval-stride-1 selection (sam2_base.py:522-556, :588-640), mirrored for
reverse tracking.

The surface, as vdn's: point / box prompts (correction clicks on tracked
frames feed the previous mask logits back into the decoder), mask prompts
(``add_new_mask``), forward and reverse ``propagate``, several objects.
Memory is encoded when an output is stored (vdn's documented divergence:
the same under ``non_overlap_masks_for_mem_enc=False``).

The frames, the memory bank, the pointers and every stored output stay on
the model's device (vdn copies them through numpy each frame); outputs are
device tensors.  The host resizes a frame with cv2 only where it is not
already ``image_size`` square (``preprocess``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vdn_torch.models.sam2_image import preprocess
from vdn_torch.models.sam2_video import Sam2VideoModel
from vdn_torch.ops.resize import resize2d


class Sam2VideoPredictor:
    def __init__(self, model: Sam2VideoModel, mask_threshold: float = 0.0):
        self.model = model
        self.mask_threshold = mask_threshold

    @property
    def device(self) -> torch.device:
        return self.model.no_mem_embed.device

    def init_state(self, frames: np.ndarray) -> Dict:
        """frames [N, H, W, 3] RGB uint8 / float."""
        s = self.model.image_size
        proc = np.stack([preprocess(f, s) for f in frames])
        return {
            "images": torch.from_numpy(proc).to(self.device),
            "orig_hw": tuple(frames.shape[1:3]),
            "num_frames": len(frames),
            "features": {},          # frame_idx -> raw feature dict
            "objects": {},           # obj_id -> per-object tracking state
        }

    def _obj(self, state, obj_id) -> Dict:
        if obj_id not in state["objects"]:
            state["objects"][obj_id] = {
                "cond_outputs": {},      # frame_idx -> stored output
                "non_cond_outputs": {},
                "point_inputs": {},      # frame_idx -> (coords, labels)
                "frames_tracked": {},    # frame_idx -> {"reverse": bool}
            }
        return state["objects"][obj_id]

    def _features(self, state, frame_idx):
        if frame_idx not in state["features"]:
            state["features"][frame_idx] = self.model.encode_image_raw(
                state["images"][frame_idx][None])
        return state["features"][frame_idx]

    def _store(self, state, obj, frame_idx, high_res_masks, low_res_masks,
               iou, obj_ptr, obj_logits, cond: bool):
        feat, pos = self.model.encode_memory(
            self._features(state, frame_idx), high_res_masks, obj_logits)
        out = {"maskmem_features": feat, "maskmem_pos_enc": pos,
               "obj_ptr": obj_ptr, "pred_masks": low_res_masks, "iou": iou,
               "object_score_logits": obj_logits}
        (obj["cond_outputs"] if cond
         else obj["non_cond_outputs"])[frame_idx] = out

    @staticmethod
    def _best_mask(low_res, high_res, ious):
        """The mask of the highest IoU and its IoU (on the device: no host
        sync)."""
        best = ious[0].argmax().reshape(1)
        return (high_res.index_select(1, best),
                low_res.index_select(1, best), ious.index_select(1, best))

    def _mask_to_original(self, state, low_res_mask) -> torch.Tensor:
        """The low-res logits upsampled to the video's size, thresholded
        (reference sam2_video_predictor.py:387-407)."""
        m = resize2d(low_res_mask.float().permute(0, 2, 3, 1),
                     state["orig_hw"], "bilinear")
        return m[0, :, :, 0] > self.mask_threshold

    @torch.no_grad()
    def add_new_points(self, state: Dict, frame_idx: int, points=None,
                       labels=None, obj_id=0, box=None,
                       clear_old_points: bool = True) -> torch.Tensor:
        """A point / box prompt on a frame for one object; returns the mask
        at the video's size (reference add_new_points_or_box:161-290).  A
        box is two corner points labelled 2 / 3; on a frame already
        tracked the previous mask logits go back into the decoder."""
        obj = self._obj(state, obj_id)
        h, w = state["orig_hw"]
        s = self.model.image_size
        scale = np.array([s / w, s / h], np.float32)
        pts, lbls = [], []
        if box is not None:
            assert clear_old_points, "box prompts require clear_old_points"
            pts.append(np.asarray(box, np.float32).reshape(2, 2) * scale)
            lbls.append(np.asarray([2.0, 3.0], np.float32))
        if points is not None:
            pts.append(np.asarray(points, np.float32) * scale)
            lbls.append(np.asarray(labels, np.float32))
        pc, pl = np.concatenate(pts, axis=0), np.concatenate(lbls, axis=0)
        if not clear_old_points and frame_idx in obj["point_inputs"]:
            pc0, pl0 = obj["point_inputs"][frame_idx]
            pc, pl = np.concatenate([pc0, pc]), np.concatenate([pl0, pl])
        obj["point_inputs"][frame_idx] = (pc, pl)

        is_init = frame_idx not in obj["frames_tracked"]
        reverse = (False if is_init
                   else obj["frames_tracked"][frame_idx]["reverse"])
        # the previous mask logits on this frame -> the decoder's mask
        # input (reference :252-264, clamped to [-32, 32])
        prev = (obj["cond_outputs"].get(frame_idx)
                or obj["non_cond_outputs"].get(frame_idx))
        mask_input = None
        if prev is not None:
            mask_input = prev["pred_masks"].clamp(-32.0, 32.0).permute(
                0, 2, 3, 1)
        feats = self._features(state, frame_idx)
        if is_init:
            cond_feats = self.model.add_no_mem(feats)
        else:
            cond_feats = self.model.condition_features(
                feats, *self._assemble_memory(state, obj, frame_idx,
                                              reverse))
        dev = self.device
        # multimask only for 0 or 1 points (sam2_base._use_multimask with
        # multimask_min / max_pt_num 0 / 1)
        low, high, ious, obj_ptr, obj_logits = self.model.predict(
            cond_feats, torch.from_numpy(pc[None]).to(dev),
            torch.from_numpy(pl[None]).to(dev), mask_input=mask_input,
            multimask_output=pl.shape[0] <= 1)
        best = self._best_mask(low, high, ious)
        self._store(state, obj, frame_idx, *best, obj_ptr, obj_logits,
                    cond=True)
        return self._mask_to_original(state, best[1])

    @torch.no_grad()
    def add_new_mask(self, state: Dict, frame_idx: int, mask,
                     obj_id=0) -> torch.Tensor:
        """A binary mask prompt (reference add_new_mask:300-383 ->
        SAM2Base._use_mask_as_output)."""
        obj = self._obj(state, obj_id)
        s = self.model.image_size
        m = torch.as_tensor(np.asarray(mask), dtype=torch.float32,
                            device=self.device)[None, None]
        if tuple(m.shape[-2:]) != (s, s):
            m = resize2d(m.permute(0, 2, 3, 1), (s, s),
                         "bilinear_aa").permute(0, 3, 1, 2)
            m = (m >= 0.5).float()
        obj["point_inputs"].pop(frame_idx, None)
        feats = self._features(state, frame_idx)
        low, high, ious, obj_ptr, obj_logits = \
            self.model.use_mask_as_output(feats, m)
        self._store(state, obj, frame_idx, high, low, ious, obj_ptr,
                    obj_logits, cond=True)
        return self._mask_to_original(state, low)

    def _assemble_memory(self, state, obj, frame_idx: int, reverse: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(memory [1, n, 64], memory_pos [1, n, 64], the object-pointer
        tokens at its end)."""
        model = self.model
        sign = -1 if reverse else 1
        mems, poss = [], []

        def add(out, t_pos):
            f = out["maskmem_features"]
            p = model.maskmem_pos_with_tpos(out["maskmem_pos_enc"], t_pos)
            mems.append(f.flatten(1, 2))
            poss.append(p.flatten(1, 2))

        # conditioning frames at temporal position 0
        cond = obj["cond_outputs"]
        for t, out in sorted(cond.items()):
            add(out, 0)
        # the nearest frames at temporal positions 1 .. num_maskmem - 1,
        # mirrored when tracking in reverse (reference :536-560)
        for t_pos in range(1, model.num_maskmem):
            out = obj["non_cond_outputs"].get(
                frame_idx - sign * (model.num_maskmem - t_pos))
            if out is not None:
                add(out, t_pos)
        # object pointers: the conditioning frames in the tracking past,
        # then up to max_obj_ptrs - 1 earlier tracked frames, offsets signed
        # by direction (reference :588-640)
        pos_and_ptrs = [(sign * (frame_idx - t), out["obj_ptr"])
                        for t, out in sorted(cond.items())
                        if (t >= frame_idx if reverse else t <= frame_idx)]
        max_ptrs = min(state["num_frames"], model.max_obj_ptrs_in_encoder)
        for t_diff in range(1, max_ptrs):
            t = frame_idx - sign * t_diff
            if t < 0 or t >= state["num_frames"]:
                break
            out = obj["non_cond_outputs"].get(t)
            if out is not None:
                pos_and_ptrs.append((t_diff, out["obj_ptr"]))
        n_obj_tokens = 0
        if pos_and_ptrs:
            t_diffs = torch.tensor([p for p, _ in pos_and_ptrs],
                                   dtype=torch.float32, device=self.device)
            ptrs = torch.cat([ptr for _, ptr in pos_and_ptrs], dim=0)
            tokens, tok_pos = model.obj_ptr_tokens(ptrs, t_diffs)
            n_obj_tokens = tokens.shape[0]
            mems.append(tokens[None])
            poss.append(tok_pos[None])
        return torch.cat(mems, dim=1), torch.cat(poss, dim=1), n_obj_tokens

    def _track_one(self, state, obj, frame_idx: int, reverse: bool):
        feats = self._features(state, frame_idx)
        cond_feats = self.model.condition_features(
            feats, *self._assemble_memory(state, obj, frame_idx, reverse))
        low, high, ious, obj_ptr, obj_logits = self.model.predict(
            cond_feats, multimask_output=True)
        best = self._best_mask(low, high, ious)
        self._store(state, obj, frame_idx, *best, obj_ptr, obj_logits,
                    cond=False)
        return best[1]

    @torch.no_grad()
    def propagate(self, state: Dict, start: Optional[int] = None,
                  end: Optional[int] = None, reverse: bool = False):
        """Yield (frame_idx, {obj_id: mask}) in processing order (reference
        propagate_in_video:536-632): forward start .. end - 1, reverse
        start .. 0.  A frame holding an object's conditioning output
        yields the stored mask again."""
        objects = state["objects"]
        assert objects, "no prompts added"
        if start is None:
            start = min(t for o in objects.values()
                        for t in o["cond_outputs"])
        if reverse:
            order = range(start, -1, -1) if start > 0 else []
        else:
            order = range(start, state["num_frames"] if end is None
                          else end)
        for t in order:
            masks = {}
            for obj_id, obj in objects.items():
                if t in obj["cond_outputs"]:
                    low = obj["cond_outputs"][t]["pred_masks"]
                else:
                    existing = obj["non_cond_outputs"].get(t)
                    if existing is not None and t in obj["frames_tracked"]:
                        low = existing["pred_masks"]
                    else:
                        low = self._track_one(state, obj, t, reverse)
                obj["frames_tracked"][t] = {"reverse": reverse}
                masks[obj_id] = self._mask_to_original(state, low)
            yield t, masks
