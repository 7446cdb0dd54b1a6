"""SAM2's legacy video predictor in the port against vdn's on the CPU
(vdn_torch.pipelines.sam2_video_legacy against
vdn.pipelines.sam2_video_legacy): three objects, one prompted by a point
and one by a box on frame 0 and one by a mask on frame 2, so that each
prompted frame carries memory-encoded NO_OBJ_SCORE placeholders; forward
propagation, the non-overlap constraint and a reverse pass from the last
prompted frame; the refusal of a new id once tracking has started; and
``remove_object`` / ``clear_all_prompts_in_frame`` before and after
tracking.

The weights are tests/test_torch_sam2_video.py's (vdn's SAM2 test cut: a
four-block trunk, image 128, d_model 32, mem_dim 16; the object-score
head's output bias at +8, so that the logits compared are live); fp32.
One vdn legacy predictor serves every test, so its jitted steps compile
once.  Tolerances: logits, pointers and object scores rtol 1e-4 and atol
1e-4 of the output's scale; the placeholder rows and the bookkeeping
exactly.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_sam2 import _close, _np
from tests.test_torch_sam2_video import (N_FRAMES, SIZE, _frames,  # noqa
                                         models)

torch.set_num_threads(2)

PTS = np.array([[60.0, 50.0]], np.float32)
LBL = np.array([1.0], np.float32)
BOX = np.array([20.0, 70.0, 60.0, 120.0], np.float32)
MASK = np.zeros((SIZE, SIZE), np.float32)
MASK[40:90, 70:120] = 1.0
MASK_FRAME = 2


@pytest.fixture(scope="module")
def legacy(models):
    """(vdn's legacy predictor, the port's), on the shared weights."""
    from vdn.pipelines.sam2_video_legacy import \
        Sam2VideoPredictorLegacy as JLeg
    from vdn_torch.pipelines.sam2_video_legacy import \
        Sam2VideoPredictorLegacy as TLeg
    jm, tm, params, _ = models
    return JLeg(jm, params), TLeg(tm)


def _prompt(pred, state):
    """Objects 1 (point) and 2 (box) on frame 0, 3 (mask) on frame 2."""
    return [pred.add_new_points_or_box(state, 0, 1, points=PTS, labels=LBL),
            pred.add_new_points_or_box(state, 0, 2, box=BOX),
            pred.add_new_mask(state, MASK_FRAME, 3, MASK)]


def _same_output(got, want):
    """(frame_idx, obj_ids, [num_obj, 1, H, W] logits): the same frame and
    ids, placeholder rows exactly NO_OBJ_SCORE in both, live rows within
    tolerance."""
    from vdn.pipelines.sam2_video_legacy import NO_OBJ_SCORE
    assert got[0] == want[0] and list(got[1]) == list(want[1])
    g, w = _np(got[2]), np.asarray(want[2])
    assert g.shape == w.shape == (len(want[1]), 1, SIZE, SIZE)
    for i in range(w.shape[0]):
        if np.all(w[i] == NO_OBJ_SCORE):
            np.testing.assert_array_equal(g[i], w[i])
        else:
            _close(g[i], w[i])


def _same_store(tstate, jstate):
    """The per-object stores: the same frames in each bucket, and their
    low-res logits, pointers and object scores within tolerance."""
    for i, jo in jstate["output_dict_per_obj"].items():
        to = tstate["output_dict_per_obj"][i]
        for bucket in ("cond_outputs", "non_cond_outputs"):
            assert sorted(to[bucket]) == sorted(jo[bucket])
            for t, j in jo[bucket].items():
                for key in ("pred_masks", "obj_ptr", "object_score_logits"):
                    _close(to[bucket][t][key], j[key])


def _record_constraint(pred, calls):
    """Wrap ``pred``'s non-overlap constraint to record (input, output)."""
    op = type(pred)._apply_non_overlapping_constraints

    def recorded(masks):
        out = op(masks)
        calls.append((masks, out))
        return out
    pred._apply_non_overlapping_constraints = recorded


@pytest.mark.parametrize("mode", ["forward", "non_overlap", "reverse"])
def test_legacy_matches_vdn(legacy, mode):
    """The three prompts (the batched outputs at prompt time: frame 0 has
    a placeholder for object 3, frame 2 for objects 1 and 2), then
    propagate_in_video over every frame: forward, forward under
    non_overlap_masks, or forward and then reverse from frame 2.  Each
    yielded frame and the stores as vdn's.  Under non_overlap_masks the
    logits before the constraint are held to vdn's (a pixel where two
    objects' logits tie within rounding may go to either, and the other
    is clamped to -10), and the port's constraint to vdn's op on the
    port's own logits, exactly."""
    from vdn.pipelines.sam2_video_legacy import \
        Sam2VideoPredictorLegacy as JLeg
    jleg, tleg = legacy
    frames = _frames()
    calls = ([], [])
    if mode == "non_overlap":
        for p, c in zip(legacy, calls):
            p.non_overlap_masks = True
            _record_constraint(p, c)
    try:
        js, ts = jleg.init_state(frames), tleg.init_state(frames)
        outs = [(_prompt(tleg, ts), _prompt(jleg, js))]
        runs = [{}]
        if mode == "reverse":
            runs.append(dict(start_frame_idx=MASK_FRAME, reverse=True))
        for kw in runs:
            want = list(jleg.propagate_in_video(js, **kw))
            got = list(tleg.propagate_in_video(ts, **kw))
            assert [g[0] for g in got] == [w[0] for w in want]
            outs.append((got, want))
            _same_store(ts, js)
        assert [w[0] for w in want] == (
            [2, 1, 0] if mode == "reverse" else list(range(N_FRAMES)))
    finally:
        for p in legacy:
            p.non_overlap_masks = False
            p.__dict__.pop("_apply_non_overlapping_constraints", None)
    pairs = [(g, w) for got_, want_ in outs for g, w in zip(got_, want_)]
    if mode != "non_overlap":
        for g, w in pairs:
            _same_output(g, w)
    else:
        assert len(calls[0]) == len(calls[1]) == len(pairs) > 0
        for (g, w), (wc, gc) in zip(pairs, zip(*calls)):
            _same_output((g[0], g[1], gc[0]), (w[0], w[1], wc[0]))
            assert gc[1] is g[2]
            np.testing.assert_array_equal(
                _np(g[2]), JLeg._apply_non_overlapping_constraints(
                    _np(gc[0])))
    # the placeholders were memory-encoded on both prompted frames
    for i, frame in ((2, 0), (0, MASK_FRAME), (1, MASK_FRAME)):
        out = ts["output_dict_per_obj"][i]["cond_outputs"][frame]
        assert out.get("placeholder") and "maskmem_features" in out
    # and a live object's mask is not empty somewhere after frame 0
    assert any((_np(g[2][0]) > 0).any() for g in got[1:])


def test_legacy_new_id_after_tracking_raises(legacy):
    """No new object id once tracking has started, in either package."""
    frames = _frames()
    for pred in legacy:
        state = pred.init_state(frames)
        pred.add_new_points_or_box(state, 0, 1, points=PTS, labels=LBL)
        next(iter(pred.propagate_in_video(state)))
        with pytest.raises(RuntimeError, match="Cannot add new object"):
            pred.add_new_points_or_box(state, 1, 99, points=PTS,
                                       labels=LBL)


def _bookkeeping(state):
    return (list(state["obj_ids"]), dict(state["obj_id_to_idx"]),
            {k: sorted(v)
             for k, v in state["consolidated_frame_inds"].items()},
            state["tracking_has_started"],
            {i: sorted(d) for i, d in state["point_inputs_per_obj"].items()},
            {i: sorted(d) for i, d in state["mask_inputs_per_obj"].items()},
            {i: {b: sorted(v) for b, v in d.items()}
             for i, d in state["output_dict_per_obj"].items()})


@pytest.mark.parametrize("when", ["before", "after"])
def test_legacy_remove_and_clear_match_vdn(legacy, when):
    """remove_object (a missing id, strict and not; then object 3 before
    tracking, whose frame no other object prompts: vdn's quirk resets
    every input, legacy:838-841; or object 2 after tracking) and, after
    tracking, propagation again and clear_all_prompts_in_frame on frame
    0: the same bookkeeping and outputs as vdn's, then reset_state."""
    jleg, tleg = legacy
    frames = _frames()
    states = []
    for pred in (jleg, tleg):
        state = pred.init_state(frames)
        _prompt(pred, state)
        if when == "after":
            for _ in pred.propagate_in_video(state):
                pass
        states.append(state)
    (js, ts) = states
    outs = []
    for pred, state in zip((jleg, tleg), states):
        ids, _ = pred.remove_object(state, 99)
        assert ids == [1, 2, 3]
        with pytest.raises(RuntimeError, match="doesn't exist"):
            pred.remove_object(state, 99, strict=True)
        outs.append(pred.remove_object(state, 3 if when == "before" else 2))
    (jids, jupd), (tids, tupd) = outs
    assert tids == jids == ([1, 2] if when == "before" else [1, 3])
    assert [f for f, _ in tupd] == [f for f, _ in jupd]
    for (f, g), (_, w) in zip(tupd, jupd):
        _same_output((f, tids, g), (f, jids, w))
    assert _bookkeeping(ts) == _bookkeeping(js)
    if when == "after":
        _same_store(ts, js)
        got = list(tleg.propagate_in_video(ts))
        want = list(jleg.propagate_in_video(js))
        for g, w in zip(got, want):
            _same_output(g, w)
        res = [pred.clear_all_prompts_in_frame(state, 0, 1)
               for pred, state in ((jleg, js), (tleg, ts))]
        _same_output(res[1], res[0])
    else:
        assert not any(ts["point_inputs_per_obj"].values())
        for pred, state in zip(legacy, states):
            with pytest.raises(RuntimeError, match="No points"):
                next(pred.propagate_in_video(state))
    assert _bookkeeping(ts) == _bookkeeping(js)
    tleg.reset_state(ts)
    assert ts["obj_ids"] == [] and ts["output_dict_per_obj"] == {}


def test_non_overlap_constraint_matches_vdn():
    """The non-overlap constraint, exactly vdn's: the first object of the
    largest logit keeps it (ties included), the others clamp to <= -10; a
    single object passes through."""
    from vdn.pipelines.sam2_video_legacy import \
        Sam2VideoPredictorLegacy as JLeg
    from vdn_torch.pipelines.sam2_video_legacy import \
        Sam2VideoPredictorLegacy as TLeg
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 1, 16, 16)).astype(np.float32)
    logits[2, 0, :4] = logits[0, 0, :4]     # ties between objects 0 and 2
    logits[1, 0, 4:6] = 30.0
    want = JLeg._apply_non_overlapping_constraints(logits)
    got = TLeg._apply_non_overlapping_constraints(torch.from_numpy(logits))
    np.testing.assert_array_equal(_np(got), want)
    one = torch.from_numpy(logits[:1])
    assert TLeg._apply_non_overlapping_constraints(one) is one
