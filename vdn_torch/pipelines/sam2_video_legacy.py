"""SAM2's legacy video predictor API (vdn/pipelines/sam2_video_legacy.py;
reference sam2/sam2_video_predictor_legacy.py).

The legacy predictor differs from the modern per-object API
(vdn_torch.pipelines.sam2_video) in three observable ways:

1. **Consolidated multi-object state**: prompts are staged in temporary
   per-object dicts and consolidated when propagation starts
   (``propagate_in_video_preflight``, legacy:593-661).  Every known
   object receives an output on every prompted frame; an object without a
   prompt there gets ``NO_OBJ_SCORE`` placeholder masks, an object score
   of 10.0 and the object pointer of an *empty mask* on that frame
   (legacy:556-591, :426-554), and those placeholders are memory-encoded,
   so they condition the object's later tracking.
2. **No new objects after tracking starts** (legacy:130-162): a new id
   raises.
3. **Batched outputs**: ``add_new_points_or_box`` / ``add_new_mask`` /
   ``propagate_in_video`` return ``(frame_idx, obj_ids, logits)`` with the
   mask logits of all objects stacked at the video's size, [num_obj, 1,
   H, W] (legacy:301-315, :738-745), optionally after the non-overlap
   constraint (sam2_base.py _apply_non_overlapping_constraints).

The reference runs all objects batched along dim 0 through one
``track_step``; every per-object slice of it is independent, so this runs
the same math per object through the modern predictor's steps on the
model (``add_no_mem``, ``condition_features``, ``predict``,
``use_mask_as_output``, ``encode_memory``) and its memory assembly, as
vdn's does with its jitted ones.  A prompted frame's memory is encoded at
preflight from the consolidated low-res masks upsampled to the image size
(legacy:533-554).  Frames, memories, pointers and outputs stay on the
model's device; the resizes run A5a / A5b there (vdn_torch.ops.resize).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vdn_torch.models.sam2_image import NO_OBJ_SCORE
from vdn_torch.models.sam2_video import Sam2VideoModel
from vdn_torch.ops.resize import resize2d
from vdn_torch.pipelines.sam2_video import Sam2VideoPredictor

__all__ = ["NO_OBJ_SCORE", "Sam2VideoPredictorLegacy"]


def _resize_nchw(x: torch.Tensor, hw, method: str) -> torch.Tensor:
    return resize2d(x.permute(0, 2, 3, 1), hw, method).permute(0, 3, 1, 2)


class Sam2VideoPredictorLegacy:
    """The reference legacy SAM2VideoPredictor's surface."""

    def __init__(self, model: Sam2VideoModel, mask_threshold: float = 0.0,
                 non_overlap_masks: bool = False,
                 add_all_frames_to_correct_as_cond: bool = False):
        self._p = Sam2VideoPredictor(model, mask_threshold)
        self.non_overlap_masks = non_overlap_masks
        self.add_all_frames_to_correct_as_cond = \
            add_all_frames_to_correct_as_cond

    @property
    def model(self) -> Sam2VideoModel:
        return self._p.model

    # -- state ----------------------------------------------------------
    def init_state(self, frames: np.ndarray) -> Dict:
        """frames [N, H, W, 3] RGB uint8 / float (the reference loads a
        video path)."""
        state = self._p.init_state(frames)
        state.update(
            obj_id_to_idx={}, obj_idx_to_id={}, obj_ids=[],
            point_inputs_per_obj={}, mask_inputs_per_obj={},
            # per-object output dicts under the modern predictor's key
            # names, so that its _assemble_memory applies unchanged
            output_dict_per_obj={}, temp_output_dict_per_obj={},
            consolidated_frame_inds={"cond": set(), "non_cond": set()},
            tracking_has_started=False,
            frames_already_tracked={},
        )
        return state

    def _obj_id_to_idx(self, state, obj_id) -> int:
        """(legacy:130-162): new ids only before tracking."""
        obj_idx = state["obj_id_to_idx"].get(obj_id)
        if obj_idx is not None:
            return obj_idx
        if state["tracking_has_started"]:
            raise RuntimeError(
                f"Cannot add new object id {obj_id} after tracking starts. "
                f"All existing object ids: {state['obj_ids']}. "
                f"Please call 'reset_state' to restart from scratch.")
        obj_idx = len(state["obj_id_to_idx"])
        state["obj_id_to_idx"][obj_id] = obj_idx
        state["obj_idx_to_id"][obj_idx] = obj_id
        state["obj_ids"] = list(state["obj_id_to_idx"])
        state["point_inputs_per_obj"][obj_idx] = {}
        state["mask_inputs_per_obj"][obj_idx] = {}
        state["output_dict_per_obj"][obj_idx] = {
            "cond_outputs": {}, "non_cond_outputs": {}}
        state["temp_output_dict_per_obj"][obj_idx] = {
            "cond_outputs": {}, "non_cond_outputs": {}}
        return obj_idx

    def _num_obj(self, state) -> int:
        return len(state["obj_idx_to_id"])

    # -- prompts --------------------------------------------------------
    @torch.no_grad()
    def add_new_points_or_box(self, state: Dict, frame_idx: int, obj_id,
                              points=None, labels=None,
                              clear_old_points: bool = True,
                              normalize_coords: bool = True, box=None
                              ) -> Tuple[int, List, torch.Tensor]:
        """(legacy add_new_points_or_box:173-315).  Returns ``(frame_idx,
        obj_ids, mask logits at the video's size [num_obj, 1, H, W])``."""
        obj_idx = self._obj_id_to_idx(state, obj_id)
        if (points is None) != (labels is None):
            raise ValueError("points and labels must be provided together")
        if points is None and box is None:
            raise ValueError(
                "at least one of points or box must be provided as input")
        pts = (np.zeros((0, 2), np.float32) if points is None
               else np.asarray(points, np.float32).reshape(-1, 2))
        lbl = (np.zeros((0,), np.float32) if labels is None
               else np.asarray(labels, np.float32).reshape(-1))
        if box is not None:
            if not clear_old_points:
                raise ValueError(
                    "cannot add box without clearing old points, since box "
                    "prompt must be provided before any point prompt")
            pts = np.concatenate(
                [np.asarray(box, np.float32).reshape(2, 2), pts], axis=0)
            lbl = np.concatenate(
                [np.asarray([2.0, 3.0], np.float32), lbl], axis=0)
        s = self.model.image_size
        if normalize_coords:
            h, w = state["orig_hw"]
            pts = pts / np.asarray([w, h], np.float32)
        pts = pts * s
        if not clear_old_points and \
                frame_idx in state["point_inputs_per_obj"][obj_idx]:
            pc0, pl0 = state["point_inputs_per_obj"][obj_idx][frame_idx]
            pts = np.concatenate([pc0, pts], axis=0)
            lbl = np.concatenate([pl0, lbl], axis=0)
        state["point_inputs_per_obj"][obj_idx][frame_idx] = (pts, lbl)
        state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)

        is_init = frame_idx not in state["frames_already_tracked"]
        reverse = (False if is_init else
                   state["frames_already_tracked"][frame_idx]["reverse"])
        is_cond = is_init or self.add_all_frames_to_correct_as_cond
        storage = "cond_outputs" if is_cond else "non_cond_outputs"

        # the previous mask logits -> the decoder's input (correction
        # clicks, legacy:272-287: temp dict first, then cond, then non-cond)
        obj_out = state["output_dict_per_obj"][obj_idx]
        prev = (state["temp_output_dict_per_obj"][obj_idx][storage]
                .get(frame_idx)
                or obj_out["cond_outputs"].get(frame_idx)
                or obj_out["non_cond_outputs"].get(frame_idx))
        mask_input = None
        if prev is not None:
            mask_input = prev["pred_masks"].clamp(-32.0, 32.0).permute(
                0, 2, 3, 1)

        p, model = self._p, self.model
        feats = p._features(state, frame_idx)
        if is_init:
            cond_feats = model.add_no_mem(feats)
        else:
            cond_feats = model.condition_features(
                feats, *p._assemble_memory(state, obj_out, frame_idx,
                                           reverse))
        dev = p.device
        low, high, ious, obj_ptr, obj_logits = model.predict(
            cond_feats, torch.from_numpy(pts[None]).to(dev),
            torch.from_numpy(lbl[None]).to(dev), mask_input=mask_input,
            multimask_output=lbl.shape[0] <= 1)
        _, best_low, best_iou = p._best_mask(low, high, ious)
        # memory encoding waits for preflight (legacy:288-301)
        state["temp_output_dict_per_obj"][obj_idx][storage][frame_idx] = {
            "obj_ptr": obj_ptr, "pred_masks": best_low, "iou": best_iou,
            "object_score_logits": obj_logits}
        return (frame_idx, list(state["obj_ids"]),
                self._consolidate_video_res(state, frame_idx))

    # legacy:316-319 deprecation alias
    add_new_points = add_new_points_or_box

    @torch.no_grad()
    def add_new_mask(self, state: Dict, frame_idx: int, obj_id,
                     mask) -> Tuple[int, List, torch.Tensor]:
        """(legacy add_new_mask:321-404 -> _use_mask_as_output)."""
        obj_idx = self._obj_id_to_idx(state, obj_id)
        p, model = self._p, self.model
        s = model.image_size
        m = torch.as_tensor(np.asarray(mask), dtype=torch.float32,
                            device=p.device)[None, None]
        if tuple(m.shape[-2:]) != (s, s):
            m = (_resize_nchw(m, (s, s), "bilinear_aa") >= 0.5).float()
        state["mask_inputs_per_obj"][obj_idx][frame_idx] = m
        state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        is_init = frame_idx not in state["frames_already_tracked"]
        is_cond = is_init or self.add_all_frames_to_correct_as_cond
        storage = "cond_outputs" if is_cond else "non_cond_outputs"
        feats = p._features(state, frame_idx)
        low, _high, ious, obj_ptr, obj_logits = model.use_mask_as_output(
            feats, m)
        state["temp_output_dict_per_obj"][obj_idx][storage][frame_idx] = {
            "obj_ptr": obj_ptr, "pred_masks": low, "iou": ious,
            "object_score_logits": obj_logits}
        return (frame_idx, list(state["obj_ids"]),
                self._consolidate_video_res(state, frame_idx))

    # -- consolidation --------------------------------------------------
    def _lookup(self, state, obj_idx, frame_idx) -> Optional[Dict]:
        """temp (either bucket) -> per-object cond -> non-cond
        (legacy:487-500)."""
        temp = state["temp_output_dict_per_obj"][obj_idx]
        out = (temp["cond_outputs"].get(frame_idx)
               or temp["non_cond_outputs"].get(frame_idx))
        if out is None:
            obj_out = state["output_dict_per_obj"][obj_idx]
            out = (obj_out["cond_outputs"].get(frame_idx)
                   or obj_out["non_cond_outputs"].get(frame_idx))
        return out

    def _consolidate_video_res(self, state, frame_idx) -> torch.Tensor:
        """Every object's current mask on a frame at the video's size,
        NO_OBJ_SCORE for a missing one (legacy:426-530 with
        consolidate_at_video_res=True, run_mem_encoder=False); the present
        objects' masks resized in one call."""
        h, w = state["orig_hw"]
        n = self._num_obj(state)
        out = torch.full((n, 1, h, w), NO_OBJ_SCORE, dtype=torch.float32,
                         device=self._p.device)
        found = [(i, e) for i in range(n)
                 if (e := self._lookup(state, i, frame_idx)) is not None]
        if found:
            idx = torch.tensor([i for i, _ in found], device=out.device)
            low = torch.cat([e["pred_masks"] for _, e in found])
            out[idx] = _resize_nchw(low.float(), (h, w), "bilinear")
        if self.non_overlap_masks:
            out = self._apply_non_overlapping_constraints(out)
        return out

    def _empty_mask_ptr(self, state, frame_idx) -> torch.Tensor:
        """The pointer of an empty mask (legacy:556-591; the reference
        routes it through track_step, which under
        use_mask_input_as_output_without_sam is _use_mask_as_output)."""
        s = self.model.image_size
        feats = self._p._features(state, frame_idx)
        empty = torch.zeros((1, 1, s, s), dtype=torch.float32,
                            device=self._p.device)
        return self.model.use_mask_as_output(feats, empty)[3]

    def _consolidate_and_encode(self, state, frame_idx, storage: str):
        """Give every object an output on ``frame_idx`` and memory-encode
        it (legacy _consolidate_temp_output_across_obj with
        run_mem_encoder=True + _add_output_per_object)."""
        p, model = self._p, self.model
        s = model.image_size
        feats = p._features(state, frame_idx)
        empty_ptr = None
        for obj_idx in range(self._num_obj(state)):
            entry = self._lookup(state, obj_idx, frame_idx)
            if entry is None:
                if empty_ptr is None:
                    empty_ptr = self._empty_mask_ptr(state, frame_idx)
                dev = p.device
                entry = {
                    "obj_ptr": empty_ptr,
                    "pred_masks": torch.full((1, 1, s // 4, s // 4),
                                             NO_OBJ_SCORE,
                                             dtype=torch.float32,
                                             device=dev),
                    # sigmoid(10) = 1: assume present (legacy:477-483)
                    "object_score_logits": torch.full(
                        (1, 1), 10.0, dtype=torch.float32, device=dev),
                    "placeholder": True}
            low = entry["pred_masks"]
            high = _resize_nchw(low, (s, s), "bilinear")
            feat, pos = model.encode_memory(feats, high,
                                            entry["object_score_logits"])
            obj_out = state["output_dict_per_obj"][obj_idx]
            obj_out[storage][frame_idx] = {
                **entry, "maskmem_features": feat, "maskmem_pos_enc": pos}

    @torch.no_grad()
    def propagate_in_video_preflight(self, state) -> None:
        """(legacy:593-661)."""
        state["tracking_has_started"] = True
        inds = state["consolidated_frame_inds"]
        for storage in ("non_cond_outputs", "cond_outputs"):
            key = "cond" if storage == "cond_outputs" else "non_cond"
            temp_frames = set()
            for temp in state["temp_output_dict_per_obj"].values():
                temp_frames.update(temp[storage].keys())
            inds[key].update(temp_frames)
            for frame_idx in sorted(temp_frames):
                self._consolidate_and_encode(state, frame_idx, storage)
            for temp in state["temp_output_dict_per_obj"].values():
                temp[storage].clear()
        # a cond output supersedes any earlier non-cond one (legacy:644-651)
        for obj_out in state["output_dict_per_obj"].values():
            for frame_idx in obj_out["cond_outputs"]:
                obj_out["non_cond_outputs"].pop(frame_idx, None)
        inds["non_cond"] -= inds["cond"]
        # the consolidated frames are exactly the prompted ones
        # (legacy:653-661)
        input_frames = set()
        for d in state["point_inputs_per_obj"].values():
            input_frames.update(d.keys())
        for d in state["mask_inputs_per_obj"].values():
            input_frames.update(d.keys())
        assert inds["cond"] | inds["non_cond"] == input_frames

    # -- tracking -------------------------------------------------------
    def _track_obj(self, state, obj_idx, frame_idx, reverse) -> torch.Tensor:
        p, model = self._p, self.model
        obj_out = state["output_dict_per_obj"][obj_idx]
        feats = p._features(state, frame_idx)
        cond_feats = model.condition_features(
            feats, *p._assemble_memory(state, obj_out, frame_idx, reverse))
        low, high, ious, obj_ptr, obj_logits = model.predict(
            cond_feats, multimask_output=True)
        best_high, best_low, best_iou = p._best_mask(low, high, ious)
        feat, pos = model.encode_memory(feats, best_high, obj_logits)
        obj_out["non_cond_outputs"][frame_idx] = {
            "maskmem_features": feat, "maskmem_pos_enc": pos,
            "obj_ptr": obj_ptr, "pred_masks": best_low, "iou": best_iou,
            "object_score_logits": obj_logits}
        return best_low

    @torch.no_grad()
    def propagate_in_video(self, state, start_frame_idx: Optional[int] =
                           None, max_frame_num_to_track: Optional[int] =
                           None, reverse: bool = False):
        """Yield ``(frame_idx, obj_ids, mask logits at the video's size
        [num_obj, 1, H, W])`` (legacy:663-745)."""
        self.propagate_in_video_preflight(state)
        inds = state["consolidated_frame_inds"]
        if not inds["cond"]:
            raise RuntimeError(
                "No points are provided; please add points first")
        num_frames = state["num_frames"]
        if start_frame_idx is None:
            start_frame_idx = min(inds["cond"])
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        if reverse:
            end = max(start_frame_idx - max_frame_num_to_track, 0)
            order = (range(start_frame_idx, end - 1, -1)
                     if start_frame_idx > 0 else [])
        else:
            end = min(start_frame_idx + max_frame_num_to_track,
                      num_frames - 1)
            order = range(start_frame_idx, end + 1)
        for frame_idx in order:
            if frame_idx in inds["cond"] or frame_idx in inds["non_cond"]:
                bucket = ("cond_outputs" if frame_idx in inds["cond"]
                          else "non_cond_outputs")
                lows = [state["output_dict_per_obj"][i][bucket][frame_idx]
                        ["pred_masks"]
                        for i in range(self._num_obj(state))]
            else:
                # the reference's one batched track_step over all objects
                # (legacy:718-731); its per-object slices are independent
                lows = [self._track_obj(state, i, frame_idx, reverse)
                        for i in range(self._num_obj(state))]
            state["frames_already_tracked"][frame_idx] = {
                "reverse": reverse}
            masks = _resize_nchw(torch.cat(lows).float(), state["orig_hw"],
                                 "bilinear")
            if self.non_overlap_masks:
                masks = self._apply_non_overlapping_constraints(masks)
            yield frame_idx, list(state["obj_ids"]), masks

    # -- bookkeeping ----------------------------------------------------
    @staticmethod
    def _apply_non_overlapping_constraints(masks: torch.Tensor
                                           ) -> torch.Tensor:
        """Keep the argmax object per pixel, the first among equal logits
        (np.argmax's); clamp the rest to <= -10 (reference sam2_base.py
        _apply_non_overlapping_constraints)."""
        n = masks.shape[0]
        if n == 1:
            return masks
        top = masks.amax(0, keepdim=True)
        objs = torch.arange(n, device=masks.device).reshape(n, 1, 1, 1)
        best = torch.where(masks == top, objs, n).amin(0, keepdim=True)
        return torch.where(best == objs, masks, masks.clamp(max=-10.0))

    def clear_all_prompts_in_frame(self, state, frame_idx, obj_id,
                                   need_output: bool = True):
        """(legacy:777-848)."""
        obj_idx = self._obj_id_to_idx(state, obj_id)
        state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        temp = state["temp_output_dict_per_obj"][obj_idx]
        temp["cond_outputs"].pop(frame_idx, None)
        temp["non_cond_outputs"].pop(frame_idx, None)
        frame_has_input = any(
            frame_idx in state["point_inputs_per_obj"][i]
            or frame_idx in state["mask_inputs_per_obj"][i]
            for i in range(self._num_obj(state)))
        if not frame_has_input:
            inds = state["consolidated_frame_inds"]
            was_cond = frame_idx in inds["cond"]
            inds["cond"].discard(frame_idx)
            inds["non_cond"].discard(frame_idx)
            if was_cond:
                # the frame's cond outputs become non-cond (legacy:810-821)
                state["frames_already_tracked"].pop(frame_idx, None)
            for obj_out in state["output_dict_per_obj"].values():
                out = obj_out["cond_outputs"].pop(frame_idx, None)
                if out is not None:
                    obj_out["non_cond_outputs"][frame_idx] = out
            if not inds["cond"]:
                self._reset_tracking_results(state)
        if not need_output:
            return None
        with torch.no_grad():
            return (frame_idx, list(state["obj_ids"]),
                    self._consolidate_video_res(state, frame_idx))

    def remove_object(self, state, obj_id, strict: bool = False,
                      need_output: bool = True):
        """(legacy:1042-1155): per-object dicts make the reference's
        re-slicing of batched tensors a remapping of keys."""
        old_idx = state["obj_id_to_idx"].get(obj_id)
        updated_frames = []
        if old_idx is None:
            if not strict:
                return state["obj_ids"], updated_frames
            raise RuntimeError(
                f"Cannot remove object id {obj_id} as it doesn't exist. "
                f"All existing object ids: {state['obj_ids']}.")
        if len(state["obj_id_to_idx"]) == 1:
            self.reset_state(state)
            return state["obj_ids"], updated_frames
        input_frames = set(state["point_inputs_per_obj"][old_idx])
        input_frames |= set(state["mask_inputs_per_obj"][old_idx])
        for frame_idx in input_frames:
            self.clear_all_prompts_in_frame(state, frame_idx, obj_id,
                                            need_output=False)
        remain = [i for i in range(self._num_obj(state)) if i != old_idx]
        new_ids = [state["obj_idx_to_id"][i] for i in remain]
        for key in ("point_inputs_per_obj", "mask_inputs_per_obj",
                    "output_dict_per_obj", "temp_output_dict_per_obj"):
            container = state[key]
            state[key] = {new: container[old]
                          for new, old in enumerate(remain)}
        state["obj_id_to_idx"] = {oid: i for i, oid in enumerate(new_ids)}
        state["obj_idx_to_id"] = dict(enumerate(new_ids))
        state["obj_ids"] = new_ids
        if need_output:
            inds = state["consolidated_frame_inds"]
            with torch.no_grad():
                updated_frames = [
                    (f, self._consolidate_video_res(state, f))
                    for f in sorted(inds["cond"] | inds["non_cond"])]
        return state["obj_ids"], updated_frames

    def _reset_tracking_results(self, state) -> None:
        for d in state["point_inputs_per_obj"].values():
            d.clear()
        for d in state["mask_inputs_per_obj"].values():
            d.clear()
        for d in state["output_dict_per_obj"].values():
            d["cond_outputs"].clear()
            d["non_cond_outputs"].clear()
        for d in state["temp_output_dict_per_obj"].values():
            d["cond_outputs"].clear()
            d["non_cond_outputs"].clear()
        state["consolidated_frame_inds"]["cond"].clear()
        state["consolidated_frame_inds"]["non_cond"].clear()
        state["tracking_has_started"] = False
        state["frames_already_tracked"].clear()

    def reset_state(self, state) -> None:
        """(legacy:848-858)."""
        self._reset_tracking_results(state)
        state["obj_id_to_idx"].clear()
        state["obj_idx_to_id"].clear()
        state["obj_ids"].clear()
        state["point_inputs_per_obj"].clear()
        state["mask_inputs_per_obj"].clear()
        state["output_dict_per_obj"].clear()
        state["temp_output_dict_per_obj"].clear()
