"""vitg (DINOv2 ViT-g/14 with its SwiGLU FFN) in the port against vdn, on
the CPU, at the full width.

Widths are vitg's own: embed 1536, 24 heads of 64, SwiGLU hidden 4096, the
DPT head at features 384 and out_channels 1536 x 4 (motion modules at C
1536 and 384).  The depth is cut to 4 blocks in both packages
(``_short_vitg``, as tests/test_torch_train.py's ``_short_vits``): the
per-block math does not change with it.  Frames are 70 x 70 (5 x 5
patches, so the pos-embed is interpolated).  One set of weights, drawn
with numpy from a seed in vdn's flax layout, goes to both packages through
``state_dict_from_flax``.  Tolerances:

- float modules and models: rtol 1e-4 and atol 1e-4 (of the output's
  scale for the models), as tests/test_torch_modules.py and
  tests/test_torch_slice.py state them;
- F5 against vdn's Pallas kernel in interpret mode: F4's bounds in
  tests/test_torch_int8.py (rel L2 1e-5 in fp32, 4e-3 in bf16; int8
  operands equal but at ties, <= 0.1% of them, by one);
- the int8 encoder block by block on vdn's input: within twice the
  block's own chaos floor (``perturbed_distance``, CHAOS_FACTOR of
  tests/test_torch_int8.py).  At vitg's width one block is already
  chaotic: moving its fp32 weights by one rounding moves its int8 output
  by 3e-3 to 7e-3 (rel L2, measured on two seeds), as one int8 tie that
  lands apart does (a tie in F3's operand moves its row's F5 hidden
  scales, and the attention spreads a tie in F1's over its frame); the
  port sits 1e-7 to 4e-3 from vdn.  vits' 1e-3 does not carry over;
- the calibrated absmax of the 1536-channel head convs: 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_int8 import (CHAOS_FACTOR, assert_operands,
                                   perturbed_distance, rel_l2)
from tests.test_torch_slice import _close, _numpy_params
from vdn.ops.pallas import int8 as jint8
from vdn_torch.core.convert import (load_flax_params, load_quant_stats,
                                    state_dict_from_flax)
from vdn_torch.kernels import int8 as tint8

torch.set_num_threads(2)

SIZE = 70
C, HIDDEN, HEADS = 1536, 4096, 24
ROWS = (2, 37)


@pytest.fixture(scope="module", autouse=True)
def _short_vitg():
    """vitg cut to its first 4 blocks (the DPT head reads blocks 0-3) in
    both packages, for CPU time and memory."""
    import vdn.nn.vit as jvit
    import vdn_torch.nn.vit as tvit
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jvit, tvit):
            mp.setitem(mod.VIT_CONFIGS, "vitg",
                       {**mod.VIT_CONFIGS["vitg"], "depth": 4})
            mp.setitem(mod.INTERMEDIATE_LAYER_IDX, "vitg", [0, 1, 2, 3])
        yield


def _module_pair(jmod, tmod, x, seed):
    """vdn's module with numpy weights, and the port's with the same."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    params = _numpy_params(shapes, np.random.default_rng(seed))
    missing, unexpected = tmod.load_state_dict(
        state_dict_from_flax(params), strict=False)
    assert not missing and not unexpected
    return params


# ---------------------------------------------------------------- modules
def test_swiglu_ffn_matches_vdn():
    from vdn.nn.layers import SwiGLUFFN as JSwiGLU
    from vdn_torch.nn.layers import SwiGLUFFN
    x = np.random.default_rng(0).standard_normal(
        (*ROWS, C)).astype(np.float32)
    jm, tm = JSwiGLU(HIDDEN, C), SwiGLUFFN(C, HIDDEN)
    params = _module_pair(jm, tm, jnp.asarray(x), 1)
    assert tuple(tm.w12.weight.shape) == (2 * HIDDEN, C)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_swiglu_block_matches_vdn():
    """A swiglufused Block at vitg's width: the hidden size (2/3 * 4 *
    1536, rounded to a multiple of 8) and the float path."""
    from vdn.nn.vit import Block as JBlock
    from vdn_torch.nn.vit import Block
    x = np.random.default_rng(2).standard_normal(
        (*ROWS, C)).astype(np.float32)
    jm = JBlock(num_heads=HEADS, ffn="swiglufused")
    tm = Block(C, HEADS, ffn="swiglufused")
    params = _module_pair(jm, tm, jnp.asarray(x), 3)
    assert tuple(tm.mlp.w3.weight.shape) == (C, HIDDEN)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------- F5
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 4e-3)}


def _f5_args(rng):
    """LN scale / bias, w12 [C, 2F] (vdn's layout, [gate | value]) with its
    bias, w3 [F, C] with its bias, gamma: numpy, fp32."""
    p = dict(ls=1 + 0.1 * rng.standard_normal(C),
             lb=0.1 * rng.standard_normal(C),
             w12=rng.standard_normal((C, 2 * HIDDEN)) / np.sqrt(C),
             b12=0.1 * rng.standard_normal(2 * HIDDEN),
             w3=rng.standard_normal((HIDDEN, C)) / np.sqrt(HIDDEN),
             b3=0.1 * rng.standard_normal(C),
             g=1 + 0.05 * rng.standard_normal(C))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _vdn_f5_operands(jx, p):
    """vdn's int8 operands of F5, step by step as _ln_swiglu_int8_kernel
    forms them: the LN rows, and the hidden rows per (row, F / 2 chunk)."""
    xf = jnp.asarray(jx, jnp.float32).reshape(-1, C)
    q, sy = jint8._quantize_rows_f32(jint8._ln_f32(
        xf, jnp.asarray(p["ls"]), jnp.asarray(p["lb"]), 1e-6))
    wq, s = jint8.quantize_weight_cols(jnp.asarray(p["w12"]))
    x12 = jint8._int8_dot(q, wq).astype(jnp.float32) * sy * s \
        + jnp.asarray(p["b12"])
    x1, x2 = x12[:, :HIDDEN], x12[:, HIDDEN:]
    sig = 1.0 / (1.0 + jnp.exp2(x1 * (-1.4426950408889634)))
    h = x1 * sig * x2
    half = HIDDEN // 2
    hq = np.concatenate([np.asarray(jint8._quantize_rows_f32(
        h[:, k * half:(k + 1) * half])[0]) for k in range(2)], 1)
    return np.asarray(q), hq


@pytest.mark.parametrize("dt", list(DTYPES))
def test_f5_plain_matches_vdn(dt):
    """F5's plain version against vdn's fused_ln_swiglu_residual_int8 in
    interpret mode at vitg's widths; the wrapper on a CPU tensor is the
    plain version; the int8 operands equal but at ties."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((*ROWS, C)).astype(np.float32)
    p = _f5_args(rng)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    t = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v)
         for k, v in p.items()}
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    with pltpu.force_tpu_interpret_mode():
        want = jint8.fused_ln_swiglu_residual_int8(
            jx, j["ls"], j["lb"], j["w12"], j["b12"], j["w3"], j["b3"],
            j["g"])
    args = (tx, t["ls"], t["lb"], t["w12"], t["b12"], t["w3"], t["b3"],
            t["g"])
    ops = {}
    got = tint8.fused_ln_swiglu_residual_int8_plain(*args, operands=ops)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert rel_l2(got.float().numpy(),
                  np.asarray(jnp.asarray(want, jnp.float32))) <= tol
    assert torch.equal(tint8.fused_ln_swiglu_residual_int8(*args), got)
    yq, hq = _vdn_f5_operands(jx, p)
    assert_operands(ops["yq"].numpy(), yq)
    assert_operands(ops["hq"].numpy(), hq)
    assert ops["sh"].shape == (ROWS[0] * ROWS[1], tint8.F_CHUNKS)


def test_f5_prequantized_weights_give_the_same_result():
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v)
         for k, v in _f5_args(rng).items()}
    x = torch.from_numpy(rng.standard_normal((1, 9, C)).astype(
        np.float32)).to(torch.bfloat16)
    w12q, w3q = (tint8.quantize_weight_cols(p[k]) for k in ("w12", "w3"))
    assert torch.equal(
        tint8.fused_ln_swiglu_residual_int8(x, p["ls"], p["lb"], w12q,
                                            p["b12"], w3q, p["b3"], p["g"]),
        tint8.fused_ln_swiglu_residual_int8(x, p["ls"], p["lb"], p["w12"],
                                            p["b12"], p["w3"], p["b3"],
                                            p["g"]))


def test_vitg_int8_blocks_match_vdn(monkeypatch):
    """vitg cut to 4 blocks, quantize="int8", teacher-forced: each of the
    port's blocks (F1, the plain attention, F3, F5) on vdn's input to that
    block, against vdn's block within twice the block's chaos floor; and
    the int8 path ran (rel L2 > 1e-3 from the float block)."""
    from vdn.nn.vit import Block as JBlock
    from vdn.nn.vit import DinoVisionTransformer as JViT
    from vdn_torch.nn.vit import DinoVisionTransformer as TViT
    import vdn_torch.nn.vit as tvit
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    kw = tvit.VIT_CONFIGS["vitg"]
    x = np.random.default_rng(6).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(JViT(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    params = _numpy_params(shapes, np.random.default_rng(7))["params"]
    tm = TViT(**kw, quantize="int8")
    load_flax_params(tm, {"params": params})
    jblock = JBlock(num_heads=HEADS, ffn="swiglufused", quantize="int8")
    with pltpu.force_tpu_interpret_mode():
        japply = jax.jit(lambda p, h: jblock.apply({"params": p}, h))
    calls = []
    orig = tint8.fused_ln_swiglu_residual_int8_plain
    monkeypatch.setattr(
        tint8, "fused_ln_swiglu_residual_int8_plain",
        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        h = tm.prepare_tokens(torch.from_numpy(x)).numpy()
        for i, blk in enumerate(tm.blocks):
            with pltpu.force_tpu_interpret_mode():
                want = np.array(japply(params[f"blocks_{i}"],
                                       jnp.asarray(h)))
            calls.clear()
            got = blk(torch.from_numpy(h))
            assert calls == [1]             # F5 carried the FFN
            floor = perturbed_distance(
                blk, lambda: blk(torch.from_numpy(h)).numpy())
            assert rel_l2(got.numpy(), want) <= CHAOS_FACTOR * floor, i
            with monkeypatch.context() as mp:
                mp.delenv("VDN_FORCE_INT8")
                float_out = blk(torch.from_numpy(h))
            assert rel_l2(got.numpy(), float_out.numpy()) > 1e-3
            h = want


# ---------------------------------------------------------------- models
def _missing_only_unused(missing):
    # flax never creates the reference's unused refinenet4.resConfUnit1
    assert all(".refinenet4.resConfUnit1." in k for k in missing), missing


def test_vitg_image_forward_matches_vdn():
    """DepthAnythingV2("vitg") (two memory layers, 24 heads of 64) on one
    image with no memory, then on a second with the first in the bank."""
    from vdn.models.depth_anything_v2 import DepthAnythingV2 as JDAv2
    from vdn.models.presets import MODEL_CONFIGS
    from vdn.nn.memory import init_memory_state as jinit
    from vdn.nn.memory import update_memory_state as jupdate
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    from vdn_torch.nn.memory import (init_memory_state,
                                     update_memory_state)
    cfg = dict(num_mem_attention_layers=2)
    jm = JDAv2(**MODEL_CONFIGS["vitg"], **cfg)

    def every_param(m, x):
        depth, mem_feat = m(x, None)
        return m.encode_memory(mem_feat, depth)

    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        method=every_param))
    params = _numpy_params(shapes, np.random.default_rng(10))
    tm = build_depth_anything_v2("vitg", device="cpu", **cfg)
    _missing_only_unused(load_flax_params(tm, params))
    assert tm.memory_block.memory_attention.layers[0].self_attn \
        .num_heads == HEADS
    x = np.random.default_rng(11).standard_normal(
        (2, 1, SIZE, SIZE, 3)).astype(np.float32)
    grid = SIZE // 14
    jd, jf = jm.apply(params, jnp.asarray(x[0]), None)
    entry = jm.apply(params, jf, jd, method=jm.encode_memory)
    jstate = jupdate(jinit(1, grid * grid, C, 6), *entry)
    jd2, _ = jm.apply(params, jnp.asarray(x[1]), jstate)
    with torch.no_grad():
        td, tf = tm(torch.from_numpy(x[0]), None)
        state = update_memory_state(
            init_memory_state(1, grid * grid, C, 6, torch.float32,
                              torch.device("cpu")),
            *tm.encode_memory(tf, td))
        td2, _ = tm(torch.from_numpy(x[1]), state)
    assert td.shape == (1, SIZE, SIZE)
    _close(td.numpy(), jd)
    _close(td2.numpy(), jd2)


@pytest.fixture(scope="module")
def clip_case():
    """vdn's VideoDepthAnything("vitg") numpy weights for a 2-frame clip,
    and the clip."""
    from vdn.models.video_depth_anything import build_video_depth_anything
    x = np.random.default_rng(8).standard_normal(
        (1, 2, SIZE, SIZE, 3)).astype(np.float32)
    jm = build_video_depth_anything("vitg")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, SIZE, SIZE, 3)))
    return x, _numpy_params(shapes, np.random.default_rng(9))


def test_vitg_flax_tree_loads(clip_case):
    """Every leaf of a vitg flax tree lands on a port parameter (the SwiGLU
    ``mlp.w12`` / ``mlp.w3`` Linears transposed), and nothing is missing
    but the reference's unused refinenet4 unit."""
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything as tbuild
    _, params = clip_case
    tm = tbuild("vitg", device="cpu")
    state = state_dict_from_flax(params)
    w12 = state["pretrained.blocks.3.mlp.w12.weight"]
    assert tuple(w12.shape) == (2 * HIDDEN, C)
    np.testing.assert_array_equal(
        w12.numpy(), params["params"]["pretrained"]["blocks_3"]["mlp"][
            "w12"]["kernel"].T)
    missing, unexpected = tm.load_state_dict(state, strict=False)
    assert not unexpected
    # the motion modules rebuild their sinusoidal tables (``pe`` buffers)
    _missing_only_unused([k for k in missing if not k.endswith(".pe")])
    assert len(tm.pretrained.blocks) == 4
    assert tm.head.motion_modules[0].temporal_transformer.proj_in \
        .weight.shape[0] == C


def test_vitg_clip_forward_matches_vdn(clip_case):
    from vdn.models.video_depth_anything import build_video_depth_anything
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything as tbuild
    x, params = clip_case
    want = build_video_depth_anything("vitg").apply(params, jnp.asarray(x))
    tm = tbuild("vitg", device="cpu")
    _missing_only_unused(load_flax_params(tm, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (1, 2, SIZE, SIZE)
    _close(got.numpy(), want)


def test_vitg_quant_stats_match_vdn(clip_case):
    """int8_static at vitg: the port's calibration pass over one window
    records the absmax of the 1536-channel head convs that vdn's records
    (1e-5), and load_quant_stats carries vdn's tree onto them."""
    from vdn.models.video_depth_anything import build_video_depth_anything
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything as tbuild
    from vdn_torch.nn.layers import Conv2d, quant_calibration
    x, params = clip_case
    jm = build_video_depth_anything("vitg", quantize="int8_static")
    (want, _), stats = jm.apply(params, jnp.asarray(x),
                                method=jm.forward_window,
                                mutable=["quant_stats"])
    tm = tbuild("vitg", device="cpu", quantize="int8_static")
    load_flax_params(tm, params)
    with torch.no_grad(), quant_calibration(tm):
        got, _ = tm.forward_window(torch.from_numpy(x))
    _close(got.numpy(), want)
    from vdn_torch.core.convert import _torch_key
    flat = {_torch_key([p.key for p in path[:-1]]): float(v) for path, v in
            jax.tree_util.tree_flatten_with_path(stats["quant_stats"])[0]}
    convs = {n: m for n, m in tm.named_modules()
             if isinstance(m, Conv2d) and m.act_amax is not None}
    assert set(convs) == set(flat)
    assert tm.get_submodule("head.projects.0").weight.shape[:2] == (C, C)
    for name, value in flat.items():
        np.testing.assert_allclose(float(convs[name].act_amax), value,
                                   rtol=1e-5, err_msg=name)
        convs[name].act_amax = None
    assert load_quant_stats(tm, jax.tree.map(np.asarray, stats)) == len(flat)
    for name, value in flat.items():
        assert float(convs[name].act_amax) == np.float32(value)
