"""The port's single-image slice (memory bank, DepthAnythingV2,
MetricDepthAnythingV2, the image pipeline) against vdn, in fp32 on the CPU.

One set of weights, drawn with numpy from a seed in vdn's flax layout, goes
to both packages (the port through ``load_flax_params``).  ``CXBlock.gamma``
is drawn near 1, not at its initial 1e-6, so the memory encoder's fuser
reaches the bank.  vdn runs un-jitted except inside its own pipeline.

Tolerances, each stated where it is used:

- rtol 1e-4 and atol 1e-4 of the output's scale against vdn (two fp32
  implementations summing in different orders), as tests/test_torch_slice.py;
- rtol 1e-4 / atol 1e-5 against the fp64 golden, as tests/test_goldens.py;
- 5e-4 in normalized units for the cv2-free preprocessing, as
  tests/test_torch_modules.py states for ``preprocess_frame``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdn.models.depth_anything_v2 import DepthAnythingV2 as JDepthAnythingV2
from vdn.models.metric_depth import (
    MetricDepthAnythingV2 as JMetricDepthAnythingV2)
from vdn.nn import memory as jmem
from vdn.ops import attention as jattention
from vdn.ops import rope as jrope
from vdn_torch.core.convert import load_flax_params, state_dict_from_flax
from vdn_torch.models.depth_anything_v2 import (DepthAnythingV2,
                                                build_depth_anything_v2)
from vdn_torch.models.metric_depth import (MetricDepthAnythingV2,
                                           build_metric_depth_anything_v2)
from vdn_torch.nn import memory as tmem
from vdn_torch.ops import attention as tattention
from vdn_torch.ops import rope as trope

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

CFG = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64),
           num_mem_attention_layers=2)
SIZE = 42        # 3 x 3 patches; the wide image below gives 3 x 4


def _numpy_params(shapes, rng):
    """vdn-style magnitudes: kernels ~ N(0, 1 / fan_in), LayerNorm scales and
    gammas near 1, small biases and embeddings."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("scale", "gamma"):
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load_golden(name):
    z = np.load(os.path.join(GOLDENS, f"{name}.npz"), allow_pickle=False)
    weights = {k[3:]: torch.from_numpy(z[k]) for k in z.files
               if k.startswith("w::")}
    inputs = [z[k] for k in sorted(k for k in z.files if k.startswith("in::"))]
    outputs = [z[k] for k in sorted(k for k in z.files
                                    if k.startswith("out::"))]
    return weights, inputs, outputs


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _slot_mask(cap, hw, count):
    bias = np.zeros((cap, hw), np.float32)
    bias[:cap - count] = -np.inf
    return bias.reshape(1, 1, 1, -1)


# ---------------------------------------------------------------- ops
def test_rope_tables_match_vdn():
    for args in [(64, 4, 3), (32, 7, 7)]:
        for got, want in zip(trope.axial_rope_freqs(*args),
                             jrope.axial_rope_freqs(*args)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(trope.temporal_rope_freqs(64, 9),
                         jrope.temporal_rope_freqs(64, 9)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("repeat", [1, 3])
def test_apply_rope_matches_vdn(repeat, dtype):
    """vdn rotates [B, H, T, D] with a [T, D/2] table; the port takes that
    layout too, and [B, T, H, D] with the [T, 1, D/2] device table.  Both
    rotate in fp32 and round once: fp32 to 1e-6 (XLA may contract the
    multiply-adds), bf16 to one ulp of the largest value."""
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    gw, gh, dh, heads = 4, 3, 32, 2
    x = np.random.default_rng(0).standard_normal(
        (2, heads, repeat * gw * gh, dh)).astype(np.float32)
    cos, sin = jrope.axial_rope_freqs(dh, gw, gh)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x, jd), cos, sin,
                                       repeat_k=repeat), np.float32)
    tx = torch.from_numpy(x).to(td)
    got = trope.apply_rope(tx, cos, sin, repeat_k=repeat)
    bthd = trope.apply_rope(
        tx.transpose(1, 2),
        *trope.device_tables(dh, gw, gh, torch.device("cpu")),
        repeat_k=repeat)
    assert got.dtype == td and torch.equal(bthd.transpose(1, 2), got)
    tol = 1e-6 if dtype == "fp32" else 2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_device_side_caches_are_bounded():
    """A service fed images of many aspect ratios must not keep a device
    tensor per token grid for ever: the rope tables, the slot masks, the
    sine table and the resize plans each keep their most recent entries."""
    from vdn_torch.kernels import resize as kresize
    cpu = torch.device("cpu")
    for g in range(2, 42):
        trope.device_tables(8, g, 3, cpu)
        tmem.slot_bias(2, g, 1, cpu)
        tmem.sine_position_encoding(g, 3, 8, torch.float32, cpu)
    for fn in (trope.device_tables, tmem.slot_bias,
               tmem.sine_position_encoding):
        info = fn.cache_info()
        assert info.maxsize is not None and info.currsize <= info.maxsize < 40
    first = trope.device_tables(8, 41, 3, cpu)[0]
    assert trope.device_tables(8, 41, 3, cpu)[0] is first       # still a hit
    for i in range(kresize.MAX_DEVICE_PLANS + 8):
        kresize.cached_on_device(("bound-test", i),
                                 lambda: [torch.zeros(1)], cpu)
    assert len(kresize._device_plans) == kresize.MAX_DEVICE_PLANS
    assert ("bound-test", 0, "cpu") not in kresize._device_plans


@pytest.mark.parametrize("bias_kind", ["none", "column", "general"])
def test_dot_product_attention_matches_vdn(bias_kind):
    """Tq, Tk >= 256: the port routes no bias to C2's wrapper and a column
    bias to C1's (here their plain versions), a general bias to the plain
    path; vdn on the CPU takes its XLA path for all three.  fp32, 2e-5:
    vdn's own kernel-vs-XLA bound."""
    rng = np.random.default_rng(1)
    tq, cap, h, d = 260, 2, 2, 64
    q, k, v = (rng.standard_normal((1, t, h, d)).astype(np.float32)
               for t in (tq, cap * tq, cap * tq))
    bias = {"none": None, "column": _slot_mask(cap, tq, 1),
            "general": rng.standard_normal((1, h, tq, cap * tq)).astype(
                np.float32)}[bias_kind]
    assert tattention.flash_enabled(tq, cap * tq, None if bias is None
                                    else torch.from_numpy(bias)) == (
        bias_kind != "general")
    want = jattention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias))
    got = tattention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias is None else torch.from_numpy(bias))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------- memory
def test_memory_attention_golden():
    """The SAM2 video flags (relu, pos enc on the keys) against the fp64
    torch-reference golden, at tests/test_goldens.py's tolerance."""
    weights, (curr, memory, curr_pos, memory_pos), outs = load_golden(
        "memory_attention")
    model = tmem.MemoryAttention(d_model=32, num_heads=2, num_layers=2,
                                 dim_feedforward=64, activation="relu",
                                 pos_enc_at_cross_attn_queries=False,
                                 pos_enc_at_cross_attn_keys=True,
                                 kv_in_dim=memory.shape[-1])
    model.load_state_dict(weights)
    with torch.no_grad():
        got = model(torch.from_numpy(curr), torch.from_numpy(memory),
                    torch.from_numpy(curr_pos), (6, 6),
                    memory_pos=torch.from_numpy(memory_pos))
    np.testing.assert_allclose(got.numpy(), outs[0].astype(np.float32),
                               rtol=1e-4, atol=1e-5)


GRID = (3, 4)
CHANNELS = 128   # two heads of 64


@pytest.fixture(scope="module")
def blocks():
    jm = jmem.MemoryBlock(CHANNELS, 6, 2)
    hw = GRID[0] * GRID[1]

    def every_param(m, feat, depth):
        return m(feat, GRID, None), m.encode(feat, depth, GRID)

    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, CHANNELS)),
                        jnp.zeros((1, 14 * GRID[0], 14 * GRID[1], 1)),
                        method=every_param))
    params = _numpy_params(shapes, np.random.default_rng(2))
    tm = tmem.MemoryBlock(CHANNELS, 6, 2)
    assert load_flax_params(tm, params) == []
    return jm, params, tm.eval()


def test_memory_encoder_matches_vdn(blocks):
    jm, params, tm = blocks
    rng = np.random.default_rng(3)
    hw = GRID[0] * GRID[1]
    feat = rng.standard_normal((2, hw, CHANNELS)).astype(np.float32)
    depth = rng.standard_normal(
        (2, 14 * GRID[0], 14 * GRID[1], 1)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(feat), jnp.asarray(depth), GRID,
                    method=jm.encode)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(feat), torch.from_numpy(depth), GRID)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("count", [None, 1, 3, 6])
def test_memory_block_matches_vdn(blocks, count):
    """State None (the no_mem_embed branch) and a bank with 1, 3 and 6
    written slots; the empty slots hold noise, which the mask must hide."""
    jm, params, tm = blocks
    rng = np.random.default_rng(4)
    hw, cap = GRID[0] * GRID[1], 6
    feat = rng.standard_normal((2, hw, CHANNELS)).astype(np.float32)
    bank = rng.standard_normal((2, cap, hw, CHANNELS)).astype(np.float32)
    jstate = tstate = None
    if count is not None:
        jstate = {"features": jnp.asarray(bank), "pos": jnp.asarray(bank),
                  "count": jnp.asarray(count, jnp.int32)}
        tstate = {"features": torch.from_numpy(bank),
                  "pos": torch.from_numpy(bank), "count": count}
    want = jm.apply(params, jnp.asarray(feat), GRID, jstate)
    with torch.no_grad():
        got = tm(torch.from_numpy(feat), GRID, tstate)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def test_update_memory_state_matches_vdn():
    """8 updates of a 6-slot ring: fills, then shifts; exact."""
    rng = np.random.default_rng(5)
    jstate = jmem.init_memory_state(2, 5, 8, 6)
    tstate = tmem.init_memory_state(2, 5, 8, 6)
    for step in range(8):
        feat, pos = (rng.standard_normal((2, 5, 8)).astype(np.float32)
                     for _ in range(2))
        jstate = jmem.update_memory_state(jstate, jnp.asarray(feat),
                                          jnp.asarray(pos))
        tstate = tmem.update_memory_state(tstate, torch.from_numpy(feat),
                                          torch.from_numpy(pos))
        assert tstate["count"] == int(jstate["count"]) == min(step + 1, 6)
        for key in ("features", "pos"):
            np.testing.assert_array_equal(tstate[key].numpy(),
                                          np.asarray(jstate[key]))
        np.testing.assert_array_equal(
            tmem.slot_bias(6, 5, tstate["count"], torch.device("cpu")).numpy().reshape(-1),
            np.repeat(np.where(np.arange(6) >= 6 - tstate["count"], 0.0,
                               -np.inf), 5).astype(np.float32))


# ---------------------------------------------------------------- models
def _every_param(m, x):
    depth, mem_feat = m(x, None)
    return m.encode_memory(mem_feat, depth)


@pytest.fixture(scope="module")
def models():
    jm = JDepthAnythingV2(**CFG)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                        method=_every_param))
    params = _numpy_params(shapes, np.random.default_rng(6))
    tm = build_depth_anything_v2(**CFG, device="cpu")
    missing = load_flax_params(tm, params)
    # flax never creates the reference's unused refinenet4.resConfUnit1
    assert all(".refinenet4.resConfUnit1." in k for k in missing)
    return jm, params, tm


@pytest.mark.parametrize("hw", [(SIZE, SIZE), (SIZE, 56)])
def test_depth_anything_v2_forward(models, hw):
    """One frame with no state, its bank entry, then a second frame that
    attends to it; square and 3 x 4 patches."""
    jm, params, tm = models
    rng = np.random.default_rng(7)
    x0, x1 = (rng.standard_normal((1, *hw, 3)).astype(np.float32)
              for _ in range(2))
    jd, jf = jm.apply(params, jnp.asarray(x0), None)
    jentry = jm.apply(params, jf, jd, method=jm.encode_memory)
    jstate = jmem.update_memory_state(
        jmem.init_memory_state(1, jf.shape[1], jf.shape[2], 6), *jentry)
    jd1, jf1 = jm.apply(params, jnp.asarray(x1), jstate)
    with torch.no_grad():
        td, tf = tm(torch.from_numpy(x0), None)
        tentry = tm.encode_memory(tf, td)
        tstate = tmem.update_memory_state(
            tmem.init_memory_state(1, tf.shape[1], tf.shape[2], 6), *tentry)
        td1, tf1 = tm(torch.from_numpy(x1), tstate)
    assert td.shape == (1, *hw) and td.dtype == torch.float32
    for got, want in ((td, jd), (tf, jf), (tentry[0], jentry[0]),
                      (tentry[1], jentry[1]), (td1, jd1), (tf1, jf1)):
        _close(got, want)


@pytest.mark.parametrize("raw_hw", [(SIZE, 56), (60, 80)])
def test_image_pipeline_matches_vdn(models, raw_hw):
    """8 images through both pipelines: the bank fills at image 6 and
    shifts from image 7.  A 42 x 56 image needs no input resize; a 60 x 80
    image goes through the bicubic input resize (torch here, cv2 in vdn:
    5e-4 apart at most per input value, far less on average) and through
    the final resize back to 60 x 80.  Both hold rtol 1e-4 and atol 1e-4 of
    the scale (measured: 3e-6 and 8e-6 of the scale)."""
    from vdn.pipelines.infer_image import DepthAnythingV2Pipeline as JPipe
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    jm, params, tm = models
    images = np.random.default_rng(8).integers(
        0, 256, (8, *raw_hw, 3), dtype=np.uint8)
    jpipe, tpipe = JPipe(jm, params), DepthAnythingV2Pipeline(tm)
    for i, img in enumerate(images):
        want = jpipe.infer_image(img, SIZE)
        got = tpipe.infer_image(img, SIZE)
        assert got.shape == raw_hw and got.dtype == np.float32
        assert tpipe.state["count"] == int(jpipe.state["count"]) == min(
            i + 1, 6)
        _close(got, want)
    tpipe.clear_memory()
    assert tpipe.state is None
    # the bank reaches the depth: the last image without it differs
    alone = tpipe.infer_image(images[-1], SIZE)
    assert np.abs(alone - got).max() > 1e-3 * np.abs(got).max()


def test_metric_depth_matches_vdn():
    cfg = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64),
               max_depth=20.0)
    jm = JMetricDepthAnythingV2(**cfg)
    x = np.random.default_rng(9).standard_normal(
        (2, SIZE, 56, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, 56, 3)))
    params = _numpy_params(shapes, np.random.default_rng(10))
    tm = build_metric_depth_anything_v2(**cfg, device="cpu")
    missing = load_flax_params(tm, params)
    assert all(".refinenet4.resConfUnit1." in k for k in missing)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, SIZE, 56) and got.dtype == torch.float32
    assert 0 < float(got.min()) and float(got.max()) < 20.0
    _close(got, want)


@pytest.mark.parametrize("which", ["depth_anything_v2", "metric_depth"])
def test_load_flax_params_covers_every_leaf(which):
    """Every leaf of vdn's tree lands on a parameter of the port's model
    and comes back unchanged through vdn's own converter: the CXBlock
    gammas, the three (1, ., C) embeddings and the stride-conv kernels of
    the mask downsampler included."""
    from vdn.core.convert import convert_torch_state
    x = jnp.zeros((1, SIZE, SIZE, 3))
    if which == "depth_anything_v2":
        jm, tm = JDepthAnythingV2(**CFG), DepthAnythingV2(**CFG)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                                method=_every_param))
    else:
        cfg = {k: v for k, v in CFG.items()
               if k != "num_mem_attention_layers"}
        jm, tm = JMetricDepthAnythingV2(**cfg), MetricDepthAnythingV2(**cfg)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes["params"])
    missing = load_flax_params(tm, params)
    assert all(".refinenet4.resConfUnit1." in k for k in missing)
    sd = state_dict_from_flax(params)
    state = tm.state_dict()
    for key, value in sd.items():
        assert torch.equal(state[key], value), key
    if which == "depth_anything_v2":
        enc = "memory_block.memory_encoder."
        assert sd["memory_block.maskmem_tpos_enc"].shape == (1, 6, 384)
        assert sd[enc + "fuser.layers.0.gamma"].shape == (384,)
        assert sd[enc + "fuser.layers.0.dwconv.weight"].shape == (384, 1, 7, 7)
        assert sd[enc + "mask_downsampler.1.encoder.0.weight"].shape == (
            49, 1, 7, 7)
    back = convert_torch_state({k: v.numpy() for k, v in sd.items()})
    want, got = dict(flat(params)), dict(flat(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


# ---------------------------------------------------------------- host side
@pytest.mark.parametrize("hw", [(300, 400), (518, 518)])
def test_image2tensor_bgr_matches_cv2(hw):
    """Channel flip + the cv2-free preprocess_frame against vdn's cv2
    version; 5e-4 in normalized units, preprocess_frame's tolerance."""
    from vdn.pipelines.transform import image2tensor_bgr as cv2_version
    from vdn_torch.pipelines.transform import image2tensor_bgr
    img = np.random.default_rng(12).integers(0, 256, hw + (3,),
                                             dtype=np.uint8)
    want, want_hw = cv2_version(img, 518)
    got, got_hw = image2tensor_bgr(img, 518)
    assert got_hw == want_hw == hw
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("build", [build_depth_anything_v2,
                                   build_metric_depth_anything_v2])
def test_build_functions_default_to_the_card(build):
    """No CUDA device in the test environment: the default raises, and
    device="cpu" builds."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("vits")


@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_quantize_is_not_ported(quantize):
    """The int8 serving mode is ported (tests/test_torch_int8.py holds it to
    vdn): the build takes the flag as vdn's model does, the encoder dynamic
    int8 in both modes and the DPT head's convs in the given mode, the fp32
    output island and the memory block float."""
    from vdn_torch.nn.layers import Conv2d
    model = build_depth_anything_v2("vits", device="cpu", quantize=quantize)
    assert model.quantize == quantize
    assert all(b.quantize == "int8" for b in model.pretrained.blocks)
    head = {m.quantize for m in model.depth_head.modules()
            if isinstance(m, Conv2d) and m.accum_dtype is None}
    assert head == {quantize, None}
    assert model.depth_head.scratch.output_conv2[0].quantize is None
    assert all(m.quantize is None for m in model.memory_block.modules()
               if isinstance(m, Conv2d))
