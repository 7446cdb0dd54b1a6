"""The v1 slice of the port against vdn on the CPU: the resize backward on
wide transposed plans, C2 at fp32 / D = 96 and its backward D2 (plain
versions against vdn's Pallas kernels in interpret mode), the attention
router's ``use_flash``, hieradet, the MAE Hiera, the encoders, the video
heads and the v1 conversion rules (the model and its trainer:
tests/test_torch_v1_train.py).

One set of weights, drawn with numpy from a seed in vdn's flax layout,
goes to both packages through ``state_dict_from_flax``.  fp32 throughout.
Depth is cut where CPU time asks for it (``_short_hiera``: hiera_base and
hiera_base_224 at stages (1, 1, 2, 1), the same block kinds at the same
widths; vits at 2 blocks), never the width.  Tolerances, as the earlier
port tests state them:

- kernels' plain versions against vdn's Pallas kernels in interpret mode:
  forward 1e-5, backward 2e-5 relative L2 (sums in another order);
- the resize backward against jax.grad of vdn's resize2d: 2e-5 rel L2;
- modules: rtol 1e-4, atol 1e-4 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdn.core.convert import convert_torch_state
from vdn_torch.core.convert import (V1_HEAD_CONVT_PATTERNS,
                                    V2_HEAD_CONVT_PATTERNS, load_flax_params,
                                    state_dict_from_flax)

torch.set_num_threads(2)

SHORT = dict(stages=(1, 1, 2, 1))


@pytest.fixture(scope="module", autouse=True)
def _short_hiera():
    """hiera_base (global block 3: stage 2 at 16 x 16 tokens from 256 px)
    and hiera_base_224 cut to stages (1, 1, 2, 1) in both packages, and
    vits to 2 blocks, for CPU time; widths and heads stay."""
    import vdn.nn.hiera as jh
    import vdn.nn.hiera_mae as jhm
    import vdn.nn.vit as jvit
    import vdn_torch.nn.hiera as th
    import vdn_torch.nn.hiera_mae as thm
    import vdn_torch.nn.vit as tvit
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jh, th):
            mp.setitem(mod.HIERA_CONFIGS, "hiera_base",
                       {**mod.HIERA_CONFIGS["hiera_base"], **SHORT,
                        "global_att_blocks": (3,)})
        for mod in (jhm, thm):
            mp.setitem(mod.HIERA_MAE_CONFIGS, "hiera_base_224",
                       {**mod.HIERA_MAE_CONFIGS["hiera_base_224"], **SHORT})
        for mod in (jvit, tvit):
            mp.setitem(mod.VIT_CONFIGS, "vits",
                       {**mod.VIT_CONFIGS["vits"], "depth": 2})
        yield


def _rel_l2(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _params(shapes, rng):
    """vdn-style magnitudes: kernels ~ N(0, 1/fan_in), scales near 1,
    running variances in [1, 1.3], small biases, means and embeddings."""
    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "running_var":
            return (1 + 0.1 * np.abs(rng.standard_normal(shape))).astype(
                np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(jm, tm, rng, *args, convt=(), method=None):
    """vdn params for ``jm`` at ``args``, the same loaded into ``tm``."""
    init = jm.init if method is None else (
        lambda key, *a: jm.init(key, *a, method=method))
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0),
                            *jax.tree.map(jnp.asarray, args))["params"]
    params = _params(shapes, rng)
    load_flax_params(tm, params, convt)
    return {"params": params}


# ------------------------------------------------- resize: wide plans
@pytest.mark.parametrize("out_hw", [(64, 64), (56, 56)])
def test_resize_backward_wide_plan_matches_vdn(out_hw):
    """hieradet's bicubic pos-embed at 256 px (14 -> 64) and 224 px (14 ->
    56): the transposed H plan has more than MAX_TAPS taps (19 at 64) and
    runs through A5b's dense form; the gradient equals jax.grad of vdn's
    resize2d."""
    import vdn.ops.resize as jr
    from vdn_torch.kernels.resize import MAX_TAPS, rows_plan, transpose_plan
    from vdn_torch.ops.resize import plan_axis, resize2d
    idx, w = plan_axis(out_hw[0], 14, "bicubic", False, None)
    assert rows_plan(*transpose_plan(idx, w, 14), "cpu")[0].shape[1] \
        > MAX_TAPS
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 14, 14, 96)).astype(np.float32)
    g = rng.standard_normal((1, *out_hw, 96)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jr.resize2d(a, out_hw, "bicubic", False),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    resize2d(tx, out_hw, "bicubic", align_corners=False).backward(
        torch.from_numpy(g))
    assert _rel_l2(tx.grad, want) <= 2e-5


# ------------------------------------------------- C2 fp32 D 96 and D2
@pytest.mark.parametrize("b,tq,tk,h", [(2, 256, 256, 1), (1, 324, 300, 2)])
def test_flash_attention_fp32_d96_matches_vdn(b, tq, tk, h):
    """C2's plain version at fp32 / D = 96 against vdn's flash_attention
    (Pallas, interpret mode), and its gradient through the port's autograd
    Function (D2's plain version) against vdn's custom VJP
    (_flash_bwd_bhtd in interpret mode); (324, 300): ragged tails."""
    from vdn.ops.pallas import flash_attention as jfa
    from vdn_torch.kernels import flash_attention as tfa
    rng = np.random.default_rng(tq)
    q, k, v = (rng.standard_normal((b, t, h, 96)).astype(np.float32)
               for t in (tq, tk, tk))
    g = rng.standard_normal((b, tq, h, 96)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a),
                            *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(g))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_(True)
                     for a in (q, k, v))
    out = tfa.flash_attention(tq_, tk_, tv_)
    assert _rel_l2(tfa.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v))), want) <= 1e-5
    assert _rel_l2(out, want) <= 1e-5
    out.backward(torch.from_numpy(g))
    for got, w in zip((tq_, tk_, tv_), grads):
        assert _rel_l2(got.grad, w) <= 2e-5


def test_dot_product_attention_use_flash(monkeypatch):
    """use_flash=False stays plain at 256 tokens, None takes C2 there (and
    stays plain at 255), True takes it at any length."""
    import vdn_torch.ops.attention as ta
    calls = []
    real = ta.flash_attention
    monkeypatch.setattr(ta, "flash_attention", lambda *a: calls.append(
        a[0].shape[1]) or real(*a))
    rng = np.random.default_rng(3)

    def qkv(t):
        return [torch.from_numpy(rng.standard_normal((1, t, 2, 48)).astype(
            np.float32)) for _ in range(3)]

    x = qkv(256)
    plain = ta.dot_product_attention(*x, use_flash=False)
    assert calls == []
    routed = ta.dot_product_attention(*x)
    assert calls == [256]
    torch.testing.assert_close(routed, plain, rtol=1e-5, atol=1e-6)
    ta.dot_product_attention(*qkv(255))
    ta.dot_product_attention(*qkv(16), use_flash=True)
    assert calls == [256, 16]


# ------------------------------------------------- encoders
@pytest.mark.parametrize("size", [64, 256])
def test_hiera_matches_vdn(size, monkeypatch):
    """hieradet (hiera_base's widths, windows and global block at stage 2)
    on one image; at 256 px the global block sees 16 x 16 = 256 tokens and
    takes C2 (its plain version here) where vdn runs XLA."""
    import vdn.nn.hiera as jh
    import vdn_torch.nn.hiera as th
    import vdn_torch.ops.attention as ta
    routed = []
    real = ta.flash_attention
    monkeypatch.setattr(ta, "flash_attention", lambda *a: routed.append(
        tuple(a[0].shape)) or real(*a))
    jm, tm = jh.make_hiera("hiera_base"), th.make_hiera("hiera_base")
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    params = _pair(jm, tm, rng, x)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == 4
    for a, b in zip(got, want):
        _close(a, b)
    assert routed == ([(1, 256, 4, 96)] if size == 256 else [])


def test_hiera_mae_and_encoders_match_vdn():
    """The MAE Hiera (hiera_base_224, one 224 image; the pooled output and
    the four stage maps), HieraImageEncoder over both families and
    DINOv2Encoder (vits)."""
    from vdn.nn.encoders import DINOv2Encoder as JDino
    from vdn.nn.encoders import HieraImageEncoder as JEnc
    from vdn.nn.hiera_mae import make_hiera_mae as jmake
    from vdn_torch.nn.encoders import DINOv2Encoder, HieraImageEncoder
    from vdn_torch.nn.hiera_mae import make_hiera_mae
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    jm, tm = jmake("hiera_base_224"), make_hiera_mae("hiera_base_224")
    params = _pair(jm, tm, rng, x)
    jpool, jfeats = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tpool, tfeats = tm(torch.from_numpy(x))
    _close(tpool, jpool)
    assert [tuple(f.shape) for f in tfeats] == [
        (1, 56, 56, 96), (1, 28, 28, 192), (1, 14, 14, 384), (1, 7, 7, 768)]
    for a, b in zip(tfeats, jfeats):
        _close(a, b)

    x64 = x[:, :64, :64]
    for name in ("hiera_base_224", "sam2_hiera_base"):
        jm, tm = JEnc(name), HieraImageEncoder(name)
        params = _pair(jm, tm, rng, x64)
        jout = jax.jit(jm.apply)(params, jnp.asarray(x64))
        with torch.no_grad():
            tout = tm(torch.from_numpy(x64))
        assert (tout[0] is None) == (jout[0] is None)
        if tout[0] is not None:
            _close(tout[0], jout[0])
        for a, b in zip(tout[1], jout[1]):
            _close(a, b)

    x28 = x[:, :28, :28]
    jm, tm = JDino("dinov2_vits14"), DINOv2Encoder("dinov2_vits14")
    params = _pair(jm, tm, rng, x28)
    with torch.no_grad():
        got = tm(torch.from_numpy(x28))
    assert got.shape == (1, 4, 384)
    _close(got, jax.jit(jm.apply)(params, jnp.asarray(x28)))


# ------------------------------------------------- heads
CH = (96, 192, 384, 768)


def _pyramid(rng, s, sizes=(16, 8, 4, 2)):
    return [rng.standard_normal((1, s, z, z, c)).astype(np.float32)
            for z, c in zip(sizes, CH)]


def test_video_heads_match_vdn():
    """VideoDepthHeadSangyu (levels 2 and 3), VideoDepthHeadV1,
    VideoDepthHeadV2 and FusionLayer on one parameter draw each."""
    from vdn.nn import video_heads as jvh
    from vdn_torch.nn import video_heads as tvh
    rng = np.random.default_rng(6)
    feats = _pyramid(rng, 2)
    tfeats = [torch.from_numpy(f) for f in feats]
    cases = [
        (jvh.VideoDepthHeadSangyu(sequence_length=2),
         tvh.VideoDepthHeadSangyu(sequence_length=2), (feats,), (), (4, 64)),
        (jvh.VideoDepthHeadV2(sequence_length=2),
         tvh.VideoDepthHeadV2(sequence_length=2), (feats,),
         V2_HEAD_CONVT_PATTERNS, (4, 64)),
    ]
    for jm, tm, args, convt, (rank, hw) in cases:
        params = _pair(jm, tm, rng, *args, convt=convt)
        want = jax.jit(jm.apply)(params, *args)
        with torch.no_grad():
            got = tm(tfeats)
        assert got.shape == (1, 2, hw, hw, 3)
        _close(got, want)

    tokens = rng.standard_normal((2, 16, 384)).astype(np.float32)
    jm = jvh.VideoDepthHeadV1(input_dim=384, sequence_length=2,
                              img_size=(56, 56))
    tm = tvh.VideoDepthHeadV1(input_dim=384, sequence_length=2,
                              img_size=(56, 56))
    params = _pair(jm, tm, rng, tokens, convt=V1_HEAD_CONVT_PATTERNS)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.shape == (1, 2, 56, 56, 3)
    _close(got, jax.jit(jm.apply)(params, tokens))

    lhs = rng.standard_normal((1, 2, 8, 8, 16)).astype(np.float32)
    rhs = rng.standard_normal((1, 2, 16, 16, 8)).astype(np.float32)
    jm, tm = jvh.FusionLayer(out_channels=8), tvh.FusionLayer(16, 8)
    params = _pair(jm, tm, rng, lhs, rhs)
    with torch.no_grad():
        got = tm(torch.from_numpy(lhs), torch.from_numpy(rhs))
    _close(got, jax.jit(jm.apply)(params, lhs, rhs))


# ------------------------------------------------- conversion
def _v1_models(seq, encoder="hiera_test", **kw):
    """vdn's and the port's VideoDepthEstimationModel, the port's seeded."""
    from vdn.models.video_depth_v1 import VideoDepthEstimationModel as JV1
    from vdn_torch.models.video_depth_v1 import build_video_depth_v1
    jm = JV1(sequence_length=seq, encoder=encoder, **kw)
    tm = build_video_depth_v1(encoder, device="cpu", sequence_length=seq,
                              generator=torch.Generator().manual_seed(seq),
                              **kw)
    return jm, tm


def _v1_inputs(rng, b, s, hw=64):
    depth = rng.random((b, s, hw, hw)).astype(np.float32)
    img = rng.standard_normal((b, s, hw, hw, 3)).astype(np.float32)
    return depth, img


def test_v1_conversion_round_trip():
    """A reference-layout state dict (in_proj_weight, NCHW pos-embed
    tables, the ConvTranspose heads) through vdn's convert_torch_state
    and back through state_dict_from_flax comes back equal, and lands on
    vdn's own parameter tree."""
    from vdn.models.video_depth_v1 import VideoDepthEstimationModel as JV1
    from vdn_torch.nn import video_heads as tvh
    from vdn_torch.nn.layers import init_parameters
    jm, tm = _v1_models(2)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, _v1_inputs(
                                np.random.default_rng(9), 1, 2)))["params"]
    assert isinstance(jm, JV1)
    g = torch.Generator().manual_seed(9)
    heads = [(tm, ()), (tvh.VideoDepthHeadV1(384, 2, (56, 56)),
                        V1_HEAD_CONVT_PATTERNS),
             (tvh.VideoDepthHeadV2(2), V2_HEAD_CONVT_PATTERNS)]
    for module, convt in heads:
        init_parameters(module, g)
        with torch.no_grad():
            for p in module.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
        state = {k: v.numpy() for k, v in module.state_dict().items()}
        tree = convert_torch_state(state, convt_patterns=convt)
        back = state_dict_from_flax(tree, convt)
        assert set(back) == set(state)
        for k, v in back.items():
            assert torch.equal(v, torch.from_numpy(state[k])), k
    # the model's converted tree holds vdn's whole tree, leaf for leaf
    tree = convert_torch_state({k: v.numpy()
                                for k, v in tm.state_dict().items()})
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        assert flat[path].shape == s.shape, path
