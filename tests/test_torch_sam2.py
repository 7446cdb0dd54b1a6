"""SAM2's image path in the port against vdn on the CPU: the resize modes
it adds (``nearest``, ``bilinear_aa``), C2's plain version at SAM2's head
widths (D 56 and 256, bf16 and fp32) against vdn's Pallas kernel in
interpret mode, the prompt encoder, the mask decoder, the FPN neck, the
trunk at hiera_base_plus's head widths, Sam2ImageModel and the image
predictor, and the ``embedding`` conversion rule (the video path:
tests/test_torch_sam2_video.py).

One set of weights, drawn with numpy from a seed in vdn's flax layout,
goes to both packages through ``load_flax_params``.  fp32 (vdn's default;
XLA's CPU dots are full fp32).  The configuration is cut to CPU size as vdn's own
SAM2 tests cut it: a four-block trunk (``SAM2_TRUNK``), image 128,
d_model 32.  Tolerances: modules rtol 1e-4 and atol 1e-4 of the output's
scale; C2's plain version 1e-5 relative L2 in fp32 and 4 bf16 ulps of the
output's scale in bf16 (vdn's kernel rounds p against its running max);
resizes 1e-6 of the scale (the same taps, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdn_torch.core.convert import load_flax_params, state_dict_from_flax

torch.set_num_threads(2)

D = 32
SIZE = 128
SAM2_TRUNK = dict(embed_dim=D, num_heads=1, stages=(1, 1, 2, 1),
                  global_att_blocks=(3,), window_spec=(8, 4, 14, 7),
                  window_pos_embed_bkg_spatial_size=(14, 14))
# hiera_base_plus's widths and heads (stage 3: 448 channels in 8 heads of
# 56), cut to the same four blocks
PLUS_TRUNK = {**SAM2_TRUNK, "embed_dim": 112, "num_heads": 2}


@pytest.fixture(scope="module", autouse=True)
def _trunks():
    """The cut trunks, registered in both packages' Hiera tables."""
    import vdn.nn.hiera as jh
    import vdn_torch.nn.hiera as th
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jh, th):
            mp.setitem(mod.HIERA_CONFIGS, "sam2_test", dict(SAM2_TRUNK))
            mp.setitem(mod.HIERA_CONFIGS, "sam2_plus_test", dict(PLUS_TRUNK))
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, rtol=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _params(shapes, rng):
    """vdn-style magnitudes: kernels ~ N(0, 1/fan_in), scales near 1, small
    biases and embeddings."""
    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("embedding", "positional_encoding_gaussian_matrix"):
            return rng.standard_normal(shape).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pair(jm, tm, rng, *args, method=None, **kwargs):
    """vdn params for ``jm`` called with ``args`` (numpy arrays and Python
    flags), the same loaded into ``tm``; returns them and the parameters
    of ``tm`` that vdn's init does not create."""
    shapes = jax.eval_shape(
        lambda key: jm.init(key, *args, method=method, **kwargs),
        jax.random.PRNGKey(0))["params"]
    params = _params(shapes, rng)
    missing = load_flax_params(tm, params)
    return {"params": params}, missing


def seeded_tree(tm, rng):
    """vdn's params for the whole of the port's module ``tm`` at vdn-style
    magnitudes, drawn with numpy in the reference's torch layout (where
    tracing vdn's init would cost seconds): vdn's own converter makes its
    flax tree, which load_flax_params carries into ``tm``, every
    parameter covered."""
    import re
    from vdn.core.convert import (DEFAULT_EMBEDDING_PATTERNS,
                                  convert_torch_state)
    embed = [re.compile(p) for p in DEFAULT_EMBEDDING_PATTERNS]
    state = {}
    for key, v in tm.state_dict().items():
        shape = tuple(v.shape)
        leaf = key.rsplit(".", 1)[-1]
        if (key.endswith("gaussian_matrix")
                or any(p.search(key) for p in embed)):
            x = rng.standard_normal(shape)
        elif leaf == "weight" and len(shape) > 1:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf == "weight":
            x = 1 + 0.1 * rng.standard_normal(shape)
        else:
            x = 0.05 * rng.standard_normal(shape)
        state[key] = x.astype(np.float32)
    tree = convert_torch_state(state)
    assert load_flax_params(tm, tree) == []
    return {"params": tree}


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------- resizes
@pytest.mark.parametrize("in_hw,out_hw,method,c,pallas", [
    ((16, 12), (32, 24), "nearest", 8, False),   # the FPN's top-down 2x
    ((16, 12), (32, 24), "nearest", 8, True),
    ((128, 128), (32, 32), "bilinear_aa", 1, False),  # 4x: 8 taps a row
    ((128, 128), (32, 32), "bilinear_aa", 1, True),
    ((96, 64), (40, 24), "bilinear_aa", 2, True),
    ((32, 32), (128, 128), "bilinear_aa", 1, True),  # up: plain bilinear
])
def test_resize_modes_match_vdn(in_hw, out_hw, method, c, pallas,
                                monkeypatch):
    """``nearest`` and ``bilinear_aa`` through A5a / A5b's plain versions
    against vdn's resize2d: its take path, and (``pallas``) its Pallas
    kernels in interpret mode as vdn's resize tests force them."""
    import vdn.ops.resize as jr
    from vdn_torch.kernels.resize import MAX_TAPS, rows_plan
    from vdn_torch.ops.resize import plan_axis, resize2d
    rng = np.random.default_rng(sum(in_hw) + c)
    x = rng.standard_normal((2, *in_hw, c)).astype(np.float32)
    if method == "bilinear_aa" and in_hw[0] == 4 * out_hw[0]:
        idx, w = plan_axis(out_hw[0], in_hw[0], method, False, None)
        assert rows_plan(idx, w, "cpu")[0].shape[1] == MAX_TAPS
    if pallas:
        monkeypatch.setattr(jr, "_FORCE_PALLAS", True)
        with pltpu.force_tpu_interpret_mode():
            want = jr.resize2d(jnp.asarray(x), out_hw, method, False)
    else:
        want = jr.resize2d(jnp.asarray(x), out_hw, method, False)
    got = resize2d(_t(x), out_hw, method)
    _close(got, want, rtol=1e-6)


# ------------------------------------------------- C2 at SAM2's widths
@pytest.mark.parametrize("d,h,tq,tk", [(56, 2, 300, 260),
                                       (256, 1, 130, 388)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sam2_widths_match_vdn(d, h, tq, tk, dtype):
    """C2's plain version at D 56 (the trunk's global blocks) and 256 (the
    memory attention) against vdn's flash_attention (Pallas, interpret
    mode), ragged Tk (260 = 2 * 128 + 4, as 4100 is at 4096 + 4)."""
    from vdn.ops.pallas import flash_attention as jfa
    from vdn_torch.kernels import flash_attention as tfa
    rng = np.random.default_rng(d + tq + tk)
    q, k, v = (rng.standard_normal((1, t, h, d)).astype(np.float32)
               for t in (tq, tk, tk))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    got = tfa.flash_attention(*(_t(a).to(td) for a in (q, k, v)))
    assert got.dtype == td and got.shape == (1, tq, h, d)
    if dtype == "float32":
        assert _rel_l2(got, want) <= 1e-5
    else:
        scale = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert float(np.abs(_np(got) - want).max()) <= 4 * ulp


# ------------------------------------------------- modules
def test_prompt_encoder_matches_vdn():
    """Points (padded, and beside a box), boxes and masks; the dense grid
    encoding and the no-mask embedding."""
    from vdn.nn.sam2 import PromptEncoder as JP
    from vdn_torch.nn.sam2 import PromptEncoder as TP
    rng = np.random.default_rng(0)
    emb, size = (8, 8), (SIZE, SIZE)
    jm, tm = JP(D, emb, size, 16), TP(D, emb, size, 16)
    pts = (rng.random((2, 3, 2)) * SIZE).astype(np.float32)
    lbl = np.array([[1, 0, -1], [2, 3, 1]], np.float32)
    box = (rng.random((2, 4)) * SIZE).astype(np.float32)
    masks = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    # one init through every path: the prompts, then the no-mask dense
    params, missing = pair(jm, tm, rng, pts, lbl, box, masks,
                           method=lambda m, *a: (m(*a), m.no_mask_dense(2)))
    assert missing == []
    cases = (dict(points=pts, labels=lbl),
             dict(points=pts, labels=lbl, boxes=box),
             dict(boxes=box, masks=masks))
    wants = jax.jit(lambda p: [jm.apply(p, **kw) for kw in cases] + [
        jm.apply(p, method=JP.get_dense_pe)])(params)
    with torch.no_grad():
        for kw, want in zip(cases, wants):
            got = tm(**{k: _t(v) for k, v in kw.items()})
            for g, w in zip(got, want):
                _close(g, w)
        _close(tm.get_dense_pe(), wants[-1])


@pytest.fixture(scope="module")
def decoder_case():
    """vdn's sam2.1 decoder and the port's on one set of inputs, with
    vdn's outputs in both modes from one compiled call."""
    from vdn.nn.sam2 import MaskDecoder as JM
    from vdn_torch.nn.sam2 import MaskDecoder as TM
    rng = np.random.default_rng(1)
    jm = JM(transformer_dim=D, iou_prediction_use_sigmoid=True)
    tm = TM(D, iou_prediction_use_sigmoid=True)
    emb = rng.standard_normal((2, 8, 8, D)).astype(np.float32)
    pe = rng.standard_normal((1, 8, 8, D)).astype(np.float32)
    sparse = rng.standard_normal((2, 3, D)).astype(np.float32)
    dense = rng.standard_normal((2, 8, 8, D)).astype(np.float32)
    hr = (rng.standard_normal((2, 32, 32, D // 8)).astype(np.float32),
          rng.standard_normal((2, 16, 16, D // 4)).astype(np.float32))
    params, missing = pair(jm, tm, rng, emb, pe, sparse, dense, True,
                           high_res_features=hr)
    assert [m for m in missing if "conv_s" not in m] == []
    wants = jax.jit(lambda p, *a: {mm: jm.apply(
        p, *a[:4], mm, high_res_features=a[4:]) for mm in (True, False)})(
        params, emb, pe, sparse, dense, *hr)
    return tm, (emb, pe, sparse, dense), hr, wants


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_vdn(decoder_case, multimask):
    """The sam2.1 decoder with the high-res skips and object scores;
    multimask (3 masks) and the dynamic single mask (stability)."""
    tm, inputs, hr, wants = decoder_case
    want = wants[multimask]
    with torch.no_grad():
        got = tm(*map(_t, inputs), multimask,
                 high_res_features=tuple(map(_t, hr)))
    assert got[0].shape == ((2, 3, 32, 32) if multimask else (2, 1, 32, 32))
    for g, w in zip(got, want):
        _close(g, w)


def test_fpn_neck_matches_vdn():
    """Four trunk levels -> the d_model maps (nearest top-down at levels
    2 and 3) and their sine encodings."""
    from vdn.nn.sam2 import FpnNeck as JF
    from vdn_torch.nn.sam2 import FpnNeck as TF
    rng = np.random.default_rng(2)
    chans = [8 * D, 4 * D, 2 * D, D]
    xs = [rng.standard_normal((1, 32 // 2 ** i, 32 // 2 ** i, D * 2 ** i))
          .astype(np.float32) for i in range(4)]
    jm, tm = JF(D, chans), TF(D, chans)
    params, missing = pair(jm, tm, rng, xs)
    assert missing == []
    want = jax.jit(jm.apply)(params, xs)
    with torch.no_grad():
        got = tm([_t(x) for x in xs])
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            _close(g, w)


def test_trunk_plus_widths_take_c2_at_d56(monkeypatch):
    """hiera_base_plus's head widths at 256 px: the global block sees 16 x
    16 = 256 tokens in 8 heads of 56 and takes C2 (its plain version
    here), q, k and v as slices of the fused qkv, where vdn runs XLA."""
    import vdn.nn.hiera as jh
    import vdn_torch.nn.hiera as th
    import vdn_torch.ops.attention as ta
    routed = []
    real = ta.flash_attention
    monkeypatch.setattr(ta, "flash_attention", lambda *a: routed.append(
        (tuple(a[0].shape), a[0].is_contiguous())) or real(*a))
    jm, tm = jh.make_hiera("sam2_plus_test"), th.make_hiera("sam2_plus_test")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 256, 256, 3)).astype(np.float32)
    params, missing = pair(jm, tm, rng, x)
    assert missing == []
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    for g, w in zip(got, want):
        _close(g, w)
    assert routed == [((1, 256, 8, 56), False)]


def test_image_model_and_predictor_match_vdn():
    """Sam2ImageModel through Sam2ImagePredictor: set_image on a uint8
    image at the model's size (encode_image's features), predict with a
    box (two labelled corners, the dynamic single mask), predict_batch
    over 5 single points (multimask): the same thresholded masks, and
    logits, IoUs and features within tolerance."""
    from vdn.models.sam2_image import Sam2ImageModel as JI
    from vdn.models.sam2_image import Sam2ImagePredictor as JPred
    from vdn_torch.models.sam2_image import (Sam2ImagePredictor as TPred,
                                             build_sam2_image_model)
    rng = np.random.default_rng(4)
    jm = JI(trunk_variant="sam2_test", d_model=D, image_size=SIZE)
    tm = build_sam2_image_model("sam2_test", SIZE, device="cpu", d_model=D)
    params = seeded_tree(tm, rng)
    img = rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)
    jp, tp = JPred(jm, params), TPred(tm)
    jp.set_image(img)
    tp.set_image(img)
    for k in ("image_embed", "high_res_0", "high_res_1"):
        _close(tp._features[k], jp._features[k])
    box = np.array([20.0, 30.0, 100.0, 110.0], np.float32)
    jw = jp.predict(box=box, multimask_output=False, return_logits=True)
    tg = tp.predict(box=box, multimask_output=False, return_logits=True)
    assert tg[0].shape == (1, SIZE, SIZE)
    for g, w in zip(tg, jw):
        _close(g, w)
    np.testing.assert_array_equal(_np(tg[0] > 0), jw[0] > 0)
    pts = (rng.random((5, 2)) * SIZE).astype(np.float32)
    jw = jp.predict_batch(pts, return_logits=True)
    tg = tp.predict_batch(pts, return_logits=True)
    assert tg[0].shape == (5, 3, SIZE, SIZE)
    for g, w in zip(tg, jw):
        _close(g, w)
    np.testing.assert_array_equal(_np(tg[0] > 0), jw[0] > 0)


def test_embedding_leaves_round_trip():
    """A reference-layout state dict of the prompt encoder and the mask
    decoder (nn.Embedding ``weight`` rows among Linears, convs, the
    ConvTranspose2d upscaling and the gaussian matrix) through vdn's
    convert_torch_state (``embedding`` leaves) and back through
    state_dict_from_flax comes back equal."""
    from vdn.core.convert import convert_torch_state
    from vdn_torch.nn.layers import init_parameters
    from vdn_torch.nn.sam2 import MaskDecoder, PromptEncoder
    g = torch.Generator().manual_seed(6)
    for module in (PromptEncoder(D, (8, 8), (SIZE, SIZE)), MaskDecoder(D)):
        init_parameters(module, g)
        state = {k: v.numpy() for k, v in module.state_dict().items()}
        tree = convert_torch_state(state)
        flat = [p[-1].key for p, _ in
                jax.tree_util.tree_flatten_with_path(tree)[0]]
        assert "embedding" in flat
        back = state_dict_from_flax(tree)
        assert set(back) == set(state)
        for k, v in back.items():
            assert torch.equal(v, torch.from_numpy(state[k])), k


def test_build_sam2_defaults_to_the_card(monkeypatch):
    """The builders' default device is the card: without one they raise."""
    from vdn_torch.models.sam2_image import build_sam2_image_model
    from vdn_torch.models.sam2_video import build_sam2_video_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (build_sam2_image_model, build_sam2_video_model):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build("sam2_test", SIZE, d_model=D)
