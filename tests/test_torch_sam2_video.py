"""SAM2's video path in the port against vdn on the CPU: Sam2VideoModel's
memory pieces (encode_memory, obj_ptr_tokens, use_mask_as_output,
condition_features) and the video predictor over 5 frames, prompted with
points and with ``add_new_mask`` (the image path:
tests/test_torch_sam2.py).

One set of weights, drawn with numpy from a seed in vdn's flax layout,
goes to both packages through ``load_flax_params``; fp32.  The
configuration is vdn's own SAM2 tests' cut (a four-block trunk, image 128,
d_model 32, mem_dim 16; 7 mask memories, 16 pointers).  The object-score
head's output bias is set to +8 in the shared weights, so that every
frame scores as an object and the masks compared are live logits, not
the constant NO_OBJ_SCORE.  Tolerances: rtol 1e-4 and atol 1e-4 of the
output's scale; thresholded masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sam2 import SAM2_TRUNK, _close, _np, _t, seeded_tree

torch.set_num_threads(2)

D, MEM, SIZE = 32, 16, 128
N_FRAMES = 5
OBJ_BIAS = 8.0


@pytest.fixture(scope="module")
def models():
    """(vdn's Sam2VideoModel, the port's, vdn's params, vdn's predictor:
    one, so that both prompts reuse its compiled steps)."""
    import vdn.nn.hiera as jh
    import vdn_torch.nn.hiera as th
    from vdn.models.sam2_video import Sam2VideoModel as JV
    from vdn.pipelines.sam2_video import Sam2VideoPredictor as JPred
    from vdn_torch.core.convert import load_flax_params
    from vdn_torch.models.sam2_video import build_sam2_video_model
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jh, th):
            mp.setitem(mod.HIERA_CONFIGS, "sam2_test", dict(SAM2_TRUNK))
        rng = np.random.default_rng(0)
        jm = JV(trunk_variant="sam2_test", d_model=D, mem_dim=MEM,
                image_size=SIZE)
        tm = build_sam2_video_model("sam2_test", SIZE, device="cpu",
                                    d_model=D, mem_dim=MEM)
        params = seeded_tree(tm, rng)
        head = params["params"]["sam_mask_decoder"]["pred_obj_score_head"]
        head["layers_2"]["bias"] = np.full((1,), OBJ_BIAS, np.float32)
        load_flax_params(tm, params["params"])
        yield jm, tm, params, JPred(jm, params)


def _frames():
    """5 frames of a bright square drifting over noise, uint8."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 120, (N_FRAMES, SIZE, SIZE, 3), np.uint8)
    for t in range(N_FRAMES):
        frames[t, 30 + 4 * t:80 + 4 * t, 40:95] = 230
    return frames


@pytest.mark.parametrize("prompt", ["points", "mask"])
def test_video_predictor_matches_vdn(models, prompt):
    """Sam2VideoPredictor over 5 frames: a positive and a negative point
    (or a mask through add_new_mask) on frame 0, then propagate: per
    frame the same thresholded masks at the video's size, and the stored
    low-res logits, object pointers and object scores within tolerance."""
    from vdn_torch.pipelines.sam2_video import Sam2VideoPredictor as TPred
    _, tm, _, jp = models
    frames = _frames()
    tp = TPred(tm)
    js, ts = jp.init_state(frames), tp.init_state(frames)
    if prompt == "points":
        pts = np.array([[60.0, 50.0], [10.0, 10.0]], np.float32)
        lbl = np.array([1.0, 0.0], np.float32)
        jw = jp.add_new_points(js, 0, pts, lbl)
        tg = tp.add_new_points(ts, 0, pts, lbl)
    else:
        mask = np.zeros((SIZE, SIZE), bool)
        mask[30:80, 40:95] = True
        jw = jp.add_new_mask(js, 0, mask)
        tg = tp.add_new_mask(ts, 0, mask)
    np.testing.assert_array_equal(_np(tg), jw)
    jout = dict(jp.propagate(js))
    tout = dict(tp.propagate(ts))
    assert sorted(tout) == list(range(N_FRAMES)) == sorted(jout)
    jo, to = js["objects"][0], ts["objects"][0]
    for t in range(N_FRAMES):
        np.testing.assert_array_equal(_np(tout[t][0]), jout[t][0])
        store = "cond_outputs" if t == 0 else "non_cond_outputs"
        for key in ("pred_masks", "obj_ptr"):
            _close(to[store][t][key], jo[store][t][key])
        assert float(to[store][t]["object_score_logits"]) > 0
    assert any(np.asarray(jout[t][0]).any() for t in range(1, N_FRAMES))


def test_memory_pieces_match_vdn(models):
    """On one frame, through vdn's predictor's compiled steps (the shapes
    of the runs above, so nothing compiles again): encode_image_raw,
    use_mask_as_output (the 4x antialiased downsample of the mask's
    logits, the pointer through the mask prompt), encode_memory (the
    memory feature and its pos enc), maskmem_pos_with_tpos, obj_ptr_tokens
    (signed offsets) and condition_features over two mask memories and
    two pointers (frame 2's memory)."""
    _, tm, params, jp = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((1, 1, SIZE, SIZE), np.float32)
    mask[..., 30:90, 40:100] = 1.0
    ptrs = rng.standard_normal((2, D)).astype(np.float32)
    t_diffs = np.array([2.0, -1.0], np.float32)
    with torch.no_grad():
        f = tm.encode_image_raw(_t(x))
        masked = tm.use_mask_as_output(f, _t(mask))
        feat, pos = tm.encode_memory(f, masked[1], masked[4])
        b, h, w, c = feat.shape
        mpos = [tm.maskmem_pos_with_tpos(pos, t) for t in (0, 6)]
        tok, tpos = tm.obj_ptr_tokens(_t(ptrs), _t(t_diffs))
        mem = torch.cat([feat.reshape(b, h * w, c)] * 2 + [tok[None]], 1)
        mem_pos = torch.cat([p.reshape(b, h * w, c) for p in mpos]
                            + [tpos[None]], 1)
        cond = tm.condition_features(f, mem, mem_pos, tok.shape[0])
    jf = jp._encode_raw(params, x)
    jmasked = jp._use_mask(params, jf, jnp.asarray(mask))
    jfeat, jpos = jp._encode_memory(params, jf, jmasked[1], jmasked[4])
    jmpos = [jp._maskmem_tpos(params, jpos, t) for t in (0, 6)]
    jtok, jtpos = jp._obj_tokens(params, ptrs, jnp.asarray(t_diffs))
    jmem = jnp.concatenate([jfeat.reshape(b, h * w, c)] * 2 + [jtok[None]],
                           1)
    jmem_pos = jnp.concatenate([p.reshape(b, h * w, c) for p in jmpos]
                               + [jtpos[None]], 1)
    jcond = jp._condition(params, jf, jmem, jmem_pos, jtok.shape[0])
    got = (f, masked, (feat, pos), mpos, (tok, tpos), mem_pos, cond)
    want = (jf, jmasked, (jfeat, jpos), jmpos, (jtok, jtpos), jmem_pos,
            jcond)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w)
