"""F6 (int8 flash attention) and C3 (head-major fused-qkv attention) of
the port against vdn's, on the CPU.

The same inputs, drawn with numpy from a seed, go through vdn's Pallas
kernels under ``pltpu.force_tpu_interpret_mode()`` (as
tests/test_flash_attention.py runs them) and through the port's plain
versions.  ``VDN_FLASH_INT8`` picks the port's mode (monkeypatch); vdn
reads it once at import, so its mode is set by monkeypatching
``vdn.ops.pallas.flash_attention._INT8_FLASH_MODE``, with a fresh ``jit``
per mode (a trace keeps the mode it saw).  Tolerances:

- F6's plain version against vdn's kernel, in "qk", "pv" and "all", at
  vdn's test inputs (channel-mean outliers on k and v) and a ragged T 257:
  the int8 codes equal but at ties (<= 0.1% differ, by one: the means over
  tokens sum in another order, and exp2 differs in its last bit); the
  output within rel L2 4e-3 in bf16 (F1-F4's bound) and 1.5e-4 in fp32.
  The fp32 bound is twice the largest measured (7.5e-5, "all" at T 290):
  one code moved by one at a tie moves its row by ~1e-2 relative, so F1-
  F4's 1e-5 does not hold for attention, whose every row reads every key;
- F6 in mode "0" is A1, bit for bit; F6 against fp32 attention within
  vdn's own quantization bounds (rms / std < 0.01, max / std < 0.12);
- C3's plain version against vdn's kernel: rtol / atol 2e-5 in fp32 (vdn's
  test), and in bf16 one bf16 ulp of the output's scale (the two sum the
  fp32 products in another order before rounding);
- the int8 ViT block by block on vdn's input (vits cut to 4 blocks at
  224 px: 257 tokens, the smallest grid past the 256-token flash gate;
  vdn's side built with ``use_flash=True``, its gate also asks for a TPU),
  in each mode: F6 on the qkv of vdn's F1 against vdn's F6 within the
  fp32 bound above, and the block within twice its chaos floor.  F1's
  ties move qkv by ~1e-4 and F6 requantizes whole rows on them, so a
  block moves by up to 3.3e-3 (1e-3 holds the blocks with A1 in
  tests/test_torch_int8.py); the floor is the largest of four draws of
  the weights moved by one fp32 rounding, since one draw lands a tie or
  not (2e-4 to 3.5e-3 at these blocks);
- the slice in "all": the int8_static image pipeline over 3 frames at 224
  px and one 32-frame clip window in "int8" (both heads narrowed to
  features 32 for CPU time; the int8 head convs are held in
  test_torch_int8.py),
  within twice the chaos floor
  (test_torch_int8.py's CHAOS_FACTOR: one fp32 rounding of every weight
  moves the int8 depth by that much).

``infer_video_depth(cache_encoder=False)`` against vdn's is in
tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_int8 import CHAOS_FACTOR, rel_l2
from tests.test_torch_slice import _numpy_params
from tests.test_torch_train import _short_vits  # noqa: F401 (autouse)
from vdn.ops.attention import _xla_attention
from vdn.ops.pallas import flash_attention as jfa
from vdn.ops.pallas import int8 as jint8
from vdn_torch.core.convert import load_flax_params
from vdn_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)

MODES = ("qk", "pv", "all")
LOG2E = 1.4426950408889634
DTYPES = {"fp32": (jnp.float32, torch.float32, 1.5e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 4e-3)}
SIZE = 224                           # 16 x 16 patches + cls: 257 tokens


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def assert_codes(got, want) -> None:
    """int8 codes equal but at ties: <= 0.1% differ, by at most 1."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _qkv(t, seed=7, b=2, h=4):
    """vdn's F6 test input (test_flash_attention.py:205-207): normal draws
    with channel-mean outliers on k and v."""
    qkv = np.random.default_rng(seed).standard_normal(
        (b, t, 3, h, 64)).astype(np.float32)
    qkv[:, :, 1, :, 3] += 4.0
    qkv[:, :, 2, :, 5] += 3.0
    return qkv


def _vdn_codes(qkv, mode, jdt) -> dict:
    """The int8 codes of vdn's ``_flash_cols_int8_kernel`` by its own steps
    (flash_attention.py:822-886), per (batch, head): qi, ki, vi [B, H, T, D]
    and pi [B, H, T, T]."""
    x = jnp.asarray(qkv, jdt)
    b, _, _, h, d = x.shape
    scale = d ** -0.5
    c2f = jnp.asarray(scale * LOG2E, jnp.float32)
    codes = {}
    for bb in range(b):
        for hh in range(h):
            qh, kh, vh = (x[bb, :, i, hh] for i in range(3))
            if mode in ("qk", "all"):
                qf, kf = qh.astype(jnp.float32), kh.astype(jnp.float32)
                kf = kf - jnp.mean(kf, axis=0, keepdims=True)
                aq = jnp.maximum(jnp.max(jnp.abs(qf), axis=1, keepdims=True),
                                 1e-30) * (1.0 / 127.0)
                ak = jnp.maximum(jnp.max(jnp.abs(kf)), 1e-30) * (1.0 / 127.0)
                qi = jnp.round(qf * (1.0 / aq)).astype(jnp.int8)
                ki = jnp.round(kf * (1.0 / ak)).astype(jnp.int8)
                si = jax.lax.dot_general(qi, ki, (((1,), (1,)), ((), ())),
                                         preferred_element_type=jnp.int32)
                s = si.astype(jnp.float32) * (aq * (ak * c2f))
                codes.setdefault("qi", []).append(qi)
                codes.setdefault("ki", []).append(ki)
            else:
                s = jax.lax.dot_general(
                    qh * jnp.asarray(scale * LOG2E, qh.dtype), kh,
                    (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32)
            m = jnp.max(s, axis=1, keepdims=True)
            if mode in ("pv", "all"):
                vf = vh.astype(jnp.float32)
                vf = vf - jnp.mean(vf, axis=0, keepdims=True)
                av = jnp.maximum(jnp.max(jnp.abs(vf), axis=0, keepdims=True),
                                 1e-30) * (1.0 / 127.0)
                codes.setdefault("vi", []).append(
                    jnp.round(vf * (1.0 / av)).astype(jnp.int8))
                codes.setdefault("pi", []).append(jnp.round(jnp.exp2(
                    s - (m - 6.988684686772166))).astype(jnp.int8))
    return {k: np.stack([np.asarray(a) for a in v]).reshape(
        b, h, *np.asarray(v[0]).shape) for k, v in codes.items()}


# ---------------------------------------------------------------- F6
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t", [290, 257])
@pytest.mark.parametrize("mode", MODES)
def test_int8_attention_plain_matches_vdn(mode, t, dt):
    """F6's plain version against vdn's kernel: codes and output; the
    wrapper on a CPU tensor is the plain version."""
    jdt, tdt, tol = DTYPES[dt]
    qkv = _qkv(t)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_int8_fused_qkv(jnp.asarray(qkv, jdt), None,
                                                  128, mode=mode)
    x = torch.from_numpy(qkv).to(tdt)
    ops = {}
    got = tfa.flash_attention_int8_fused_qkv_plain(x, mode=mode, operands=ops)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert rel_l2(_np(got), _np(want)) <= tol
    codes = _vdn_codes(qkv, mode, jdt)
    assert set(codes) == {k for k in ops if k in ("qi", "ki", "vi", "pi")}
    for key, value in codes.items():
        assert ops[key].dtype == torch.int8
        assert_codes(ops[key].numpy(), value)
    assert torch.equal(tfa.flash_attention_int8_fused_qkv(x, mode=mode), got)


def test_int8_attention_mode_off_is_a1(monkeypatch):
    """Mode "0" (and an unset VDN_FLASH_INT8) is A1's plain version, bit
    for bit; so is a head config vdn's column-block gate turns away."""
    x = torch.from_numpy(_qkv(130, seed=8, b=1, h=2))
    a1 = tfa.flash_attention_fused_qkv_plain(x)
    assert torch.equal(tfa.flash_attention_int8_fused_qkv_plain(x, mode="0"),
                       a1)
    monkeypatch.delenv("VDN_FLASH_INT8", raising=False)
    assert torch.equal(tfa.flash_attention_int8_fused_qkv(x), a1)
    monkeypatch.setenv("VDN_FLASH_INT8", "all")
    assert not torch.equal(tfa.flash_attention_int8_fused_qkv(x), a1)
    odd = torch.from_numpy(_qkv(130, seed=8, b=1, h=3)[..., :48].copy())
    assert not tfa.int8_heads_ok(3, 48)
    assert torch.equal(tfa.flash_attention_int8_fused_qkv(odd),
                       tfa.flash_attention_fused_qkv_plain(odd))


@pytest.mark.parametrize("mode", MODES)
def test_int8_attention_close_to_fp32(mode):
    """vdn's own bound on the quantization noise against fp32 attention
    (test_flash_attention.py:196-220)."""
    qkv = _qkv(290)
    q, k, v = (jnp.asarray(qkv[:, :, i]) for i in range(3))
    ref = np.asarray(_xla_attention(q, k, v, 64 ** -0.5))
    got = tfa.flash_attention_int8_fused_qkv_plain(torch.from_numpy(qkv),
                                                   mode=mode).numpy()
    d = np.abs(got - ref)
    assert np.sqrt(np.mean(d ** 2)) / np.std(ref) < 0.01
    assert d.max() < 0.12 * np.std(ref)


# ---------------------------------------------------------------- C3
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t,h,d", [(300, 3, 64), (130, 2, 32), (130, 16, 64)])
def test_qkv_heads_plain_matches_vdn(t, h, d, dt):
    """C3's plain version against vdn's flash_attention_qkv ([B, H, T, D]
    out; H 16 runs vdn's 8-head groups)."""
    jdt, tdt, _ = DTYPES[dt]
    qkv = np.random.default_rng(1).standard_normal(
        (2, t, 3, h, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jfa.flash_attention_qkv(jnp.asarray(qkv, jdt),
                                           block_q=128))
    x = torch.from_numpy(qkv).to(tdt)
    got = tfa.flash_attention_qkv_plain(x)
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (2, h, t, d)
    if dt == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(_np(got) - want).max() <= ulp
    assert torch.equal(tfa.flash_attention_qkv(x), got)


# ---------------------------------------------------------------- ViT
@pytest.fixture(scope="module")
def vits():
    """vits (4 blocks) in vdn's flax layout, the port's int8 and float
    ViTs on those weights, and one 224-px frame."""
    from vdn.nn.vit import DinoVisionTransformer as JViT
    from vdn_torch.nn.vit import DinoVisionTransformer as TViT
    kw = dict(embed_dim=384, depth=4, num_heads=6)
    shapes = jax.eval_shape(JViT(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    params = _numpy_params(shapes, np.random.default_rng(9))["params"]
    tm, tf = TViT(**kw, quantize="int8"), TViT(**kw)
    load_flax_params(tm, {"params": params})
    load_flax_params(tf, {"params": params})
    x = np.random.default_rng(8).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32)
    return params, tm, tf, x


def chaos_floor(model, run, draws: int = 4, base=None) -> float:
    """The largest rel L2 move of run() (from ``base``, run() by default)
    over ``draws`` draws of every parameter of ``model`` moved by one fp32
    rounding (the first draw is test_torch_int8's perturbed_distance)."""
    base = run() if base is None else base
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    moves = []
    for seed in range(draws):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=g))
        try:
            moves.append(rel_l2(run(), base))
        finally:
            model.load_state_dict(saved)
    return max(moves)


@pytest.mark.parametrize("mode", MODES)
def test_vit_int8_attention_matches_vdn(vits, mode, monkeypatch):
    """Teacher-forced: in each of the port's int8 blocks (F1, F6, F3, F4)
    on vdn's input to that block, F6 on vdn's qkv against vdn's F6, and
    the block against vdn's block in the same mode; the mode reached the
    attention (the block differs from mode "0")."""
    from vdn.nn.vit import Block as JBlock
    params, tm, tf, x = vits
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    monkeypatch.setenv("VDN_FLASH_INT8", mode)
    monkeypatch.setattr(jfa, "_INT8_FLASH_MODE", mode)
    jblock = JBlock(num_heads=6, quantize="int8", use_flash=True)
    japply = jax.jit(lambda p, h: jblock.apply({"params": p}, h))
    with torch.no_grad():
        h = tm.prepare_tokens(torch.from_numpy(x)).numpy()
        assert h.shape[1] == 257
        for i, blk in enumerate(tm.blocks):
            p = params[f"blocks_{i}"]
            with pltpu.force_tpu_interpret_mode():
                want = np.array(japply(p, jnp.asarray(h)))
                qkv = jint8.int8_ln_linear(
                    jnp.asarray(h), p["norm1"]["scale"], p["norm1"]["bias"],
                    p["attn"]["qkv"]["kernel"], p["attn"]["qkv"]["bias"]
                ).reshape(1, -1, 3, 6, 64)
                attn = np.asarray(jfa.flash_attention_int8_fused_qkv(qkv))
            got_attn = tfa.flash_attention_int8_fused_qkv(
                torch.from_numpy(np.array(qkv))).numpy()
            assert rel_l2(got_attn, attn) <= DTYPES["fp32"][2], f"F6 {i}"
            got = blk(torch.from_numpy(h)).numpy()
            floor = chaos_floor(blk, lambda: blk(torch.from_numpy(h)).numpy())
            assert rel_l2(got, want) <= CHAOS_FACTOR * floor, f"block {i}"
            monkeypatch.setenv("VDN_FLASH_INT8", "0")
            off = blk(torch.from_numpy(h)).numpy()
            monkeypatch.setenv("VDN_FLASH_INT8", mode)
            assert rel_l2(got, off) > 0, f"block {i}: the mode never ran"
            h = want


# ---------------------------------------------------------------- slice
def test_image_int8_all_matches_vdn(monkeypatch):
    """Three 224-px images through DepthAnythingV2's memory bank in
    int8_static with F6 in "all" (the first image calibrates): within twice
    the chaos floor of vdn's pipeline."""
    from vdn.models.depth_anything_v2 import DepthAnythingV2 as JDAv2
    from vdn.pipelines.infer_image import DepthAnythingV2Pipeline as JPipe
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    monkeypatch.setenv("VDN_FLASH_INT8", "all")
    monkeypatch.setattr(jfa, "_INT8_FLASH_MODE", "all")
    cfg = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64),
               num_mem_attention_layers=2)     # a narrow head: CPU time
    jm = JDAv2(**cfg, quantize="int8_static", use_flash=True)

    def every_param(m, x):
        depth, mem_feat = m(x, None)
        return m.encode_memory(mem_feat, depth)

    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        method=every_param))
    params = _numpy_params(shapes, np.random.default_rng(13))
    tm = build_depth_anything_v2(**cfg, device="cpu", quantize="int8_static")
    load_flax_params(tm, params)
    images = np.random.default_rng(14).integers(
        0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    jpipe = JPipe(jm, params)
    with pltpu.force_tpu_interpret_mode():
        want = np.stack([jpipe.infer_image(img, SIZE) for img in images])

    def run():
        for m in tm.modules():           # every run calibrates afresh
            if hasattr(m, "act_amax"):
                m.act_amax = None
        pipe = DepthAnythingV2Pipeline(tm)
        return np.stack([pipe.infer_image(img, SIZE) for img in images])

    got = run()
    assert got.shape == want.shape and np.isfinite(got).all()
    floor = chaos_floor(tm, run, draws=1, base=got)
    assert rel_l2(got, want) <= CHAOS_FACTOR * floor


def test_clip_window_int8_all_matches_vdn(monkeypatch):
    """One 32-frame window at 224 px, quantize="int8", F6 in "all":
    forward_window within twice the chaos floor of vdn's."""
    from vdn.models.video_depth_anything import build_video_depth_anything
    from vdn_torch.models.video_depth_anything import (
        build_video_depth_anything as tbuild)
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    monkeypatch.setenv("VDN_FLASH_INT8", "all")
    monkeypatch.setattr(jfa, "_INT8_FLASH_MODE", "all")
    head = dict(features=32, out_channels=(32, 32, 64, 64))  # CPU time
    jm = build_video_depth_anything("vits", **head, quantize="int8",
                                    use_flash=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, SIZE, SIZE, 3)))
    params = _numpy_params(shapes, np.random.default_rng(10))
    tm = tbuild("vits", **head, device="cpu", quantize="int8")
    load_flax_params(tm, params)
    x = np.random.default_rng(11).uniform(
        -2, 2, (1, 32, SIZE, SIZE, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(lambda p, x: jm.apply(
            p, x, method=jm.forward_window))(params, jnp.asarray(x))[0])

    def run():
        with torch.no_grad():
            return tm.forward_window(torch.from_numpy(x))[0].numpy()

    got = run()
    assert got.shape == want.shape == (1, 32, SIZE, SIZE)
    assert np.isfinite(got).all()
    floor = chaos_floor(tm, run, draws=1, base=got)
    assert rel_l2(got, want) <= CHAOS_FACTOR * floor
