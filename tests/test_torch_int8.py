"""The port's int8 serving mode against vdn's, on the CPU.

The same inputs and weights, drawn with numpy from a seed, go through
vdn (its Pallas kernels under ``pltpu.force_tpu_interpret_mode()``, as
tests/test_int8.py runs them) and through the port's plain versions of
F1-F4 and its int8 conv.  ``VDN_FORCE_INT8`` (set with monkeypatch, so it
never outlives a test) drives both packages down the int8 path at these
small sizes.  Tolerances:

- the quantizers: bit-equal int8 values and scales;
- F1-F4 against vdn's kernels: rel L2 <= 1e-5 in fp32 and 4e-3 in bf16;
  the int8 operands equal but at quantization ties, where <= 0.1% may
  differ, by one (the two packages sum the LayerNorm and GELU in another
  order, which can move a value across a rounding boundary);
- the int8 conv: the int32 sums are exact and the dequantization's
  products the same, so fp32 outputs agree to 1e-6 relative and bf16 to
  one bf16 ulp; the gate's decisions are equal over a table of shapes;
- the ViT block by block on vdn's inputs: rel L2 <= 1e-3; the clip, stream
  and image slices: each int8 conv call as the conv test, the calibrated
  absmax of every conv within 1e-5 relative of vdn's, and the depth within
  twice the chaos floor (see CHAOS_FACTOR below: past one kernel, int8
  rounding makes these random-weight models chaotic).

The models are vits cut to 4 blocks in both packages (``_short_vits``) at
56 px (4 x 4 patches); the preset's head (features 64) gives the convs
with Cin, Cout >= 64 that the forced gate quantizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_slice import _numpy_params
from tests.test_torch_train import _short_vits  # noqa: F401 (autouse)
from vdn.ops import int8_conv as jconv
from vdn.ops.pallas import int8 as jint8
from vdn.ops.pallas.mlp import _gelu_f32 as jgelu
from vdn_torch.core.convert import load_flax_params, load_quant_stats
from vdn_torch.kernels import int8 as tint8
from vdn_torch.kernels import layer_norm_f32
from vdn_torch.kernels.mlp import gelu_f32 as tgelu
from vdn_torch.nn.layers import Conv2d, quant_calibration
from vdn_torch.ops import int8_conv as tconv

torch.set_num_threads(2)

SIZE = 56
ROWS = (2, 37)
C, F = 128, 256
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 4e-3)}


def rel_l2(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def assert_operands(got, want) -> None:
    """int8 operands equal but at ties: <= 0.1% differ, by at most 1."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


# ---------------------------------------------------------------- quantizers
def test_quantize_weight_cols_matches_vdn():
    w = np.random.default_rng(0).standard_normal((C, F)).astype(np.float32)
    wq, s = jint8.quantize_weight_cols(jnp.asarray(w))
    tq, ts = tint8.quantize_weight_cols(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s)[0])


@pytest.mark.parametrize("chunks", [1, 2])
def test_quantize_rows_matches_vdn(chunks):
    x = np.random.default_rng(1).standard_normal((74, F)).astype(np.float32)
    x[3] = 0.0                     # an all-zero row takes the 1e-30 floor
    tq, ts = tint8.quantize_rows(torch.from_numpy(x), chunks)
    kc = F // chunks
    for j in range(chunks):
        q, s = jint8._quantize_rows_f32(jnp.asarray(x[:, j * kc:(j + 1) * kc]))
        np.testing.assert_array_equal(tq.numpy()[:, j * kc:(j + 1) * kc],
                                      np.asarray(q))
        np.testing.assert_array_equal(ts.numpy()[:, j], np.asarray(s)[:, 0])


def test_quantize_weight_ochan_matches_vdn():
    w = np.random.default_rng(2).standard_normal(
        (3, 3, 64, 96)).astype(np.float32)
    wq, s = jconv.quantize_weight_ochan(jnp.asarray(w))
    tq, ts = tconv.quantize_weight_ochan(
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(wq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


def test_quantize_frames_matches_vdn():
    x = np.random.default_rng(3).standard_normal(
        (3, 9, 11, 64)).astype(np.float32)
    q, s = jconv.quantize_frames(jnp.asarray(x))
    tq, ts = tconv.quantize_frames(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


# ---------------------------------------------------------------- F1-F4
def _f_args(rng, dt):
    """x [2, 37, C]; LN scale / bias; fc1-like w [C, F] (vdn's layout) with
    its bias; fc2-like w2 [F, C] with its bias; a square w3 [C, C]; gamma;
    a residual."""
    jdt, tdt, _ = DTYPES[dt]
    x = rng.standard_normal((*ROWS, C)).astype(np.float32)
    p = dict(
        ls=1 + 0.1 * rng.standard_normal(C), lb=0.1 * rng.standard_normal(C),
        w=rng.standard_normal((C, F)) / np.sqrt(C),
        b=0.1 * rng.standard_normal(F),
        w2=rng.standard_normal((F, C)) / np.sqrt(F),
        b2=0.1 * rng.standard_normal(C),
        w3=rng.standard_normal((C, C)) / np.sqrt(C),
        g=1 + 0.05 * rng.standard_normal(C))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    res = rng.standard_normal((*ROWS, C)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    t = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v)
         for k, v in p.items()}
    jx, jres = jnp.asarray(x, jdt), jnp.asarray(res, jdt)
    tx, tres = torch.from_numpy(x).to(tdt), torch.from_numpy(res).to(tdt)
    return (jx, jres, j), (tx, tres, t)


def _vdn_first_operands(name, jx, j):
    xf = jnp.asarray(jx, jnp.float32).reshape(-1, C)
    if name in ("int8_ln_linear", "fused_ln_mlp_residual_int8"):
        xf = jint8._ln_f32(xf, j["ls"], j["lb"], 1e-6)
    return jint8._quantize_rows_f32(xf)[0]


def _port_first_operands(name, tx, t):
    xf = tx.reshape(-1, C).float()
    if name in ("int8_ln_linear", "fused_ln_mlp_residual_int8"):
        xf = layer_norm_f32(xf, t["ls"], t["lb"], 1e-6)
    return tint8.quantize_rows(xf)[0]


def _hidden_operands(jx, j, tx, t, dt):
    """F4's hidden int8 operands, per (row, F / 2 chunk), by each package's
    own steps."""
    jdt = DTYPES[dt][0]
    xf = jnp.asarray(jx, jnp.float32).reshape(-1, C)
    q, sy = jint8._quantize_rows_f32(jint8._ln_f32(xf, j["ls"], j["lb"],
                                                   1e-6))
    w1q, s1 = jint8.quantize_weight_cols(j["w"])
    h = jint8._int8_dot(q, w1q).astype(jnp.float32) * sy * s1 + j["b"]
    h = jgelu(h, jdt)
    want = np.concatenate([np.asarray(jint8._quantize_rows_f32(
        h[:, k * F // 2:(k + 1) * F // 2])[0]) for k in range(2)], 1)
    tq, tsy = tint8.quantize_rows(layer_norm_f32(tx.reshape(-1, C), t["ls"],
                                                 t["lb"], 1e-6))
    tw, ts1 = tint8.quantize_weight_cols(t["w"])
    th = tint8._dequant_dot(tq, tsy, tw, ts1) + t["b"]
    got = tint8.quantize_rows(tgelu(th, tx.dtype), 2)[0]
    return got.numpy(), want


F_CASES = {
    "int8_ln_linear": (
        lambda jx, jr, j: jint8.int8_ln_linear(jx, j["ls"], j["lb"], j["w"],
                                               j["b"]),
        lambda tx, tr, t: tint8.int8_ln_linear_plain(tx, t["ls"], t["lb"],
                                                     t["w"], t["b"])),
    "int8_linear": (
        lambda jx, jr, j: jint8.int8_linear(jx, j["w"], j["b"]),
        lambda tx, tr, t: tint8.int8_linear_plain(tx, t["w"], t["b"])),
    "int8_proj_residual": (
        lambda jx, jr, j: jint8.int8_proj_residual(jx, jr, j["w3"], j["b2"],
                                                   j["g"]),
        lambda tx, tr, t: tint8.int8_proj_residual_plain(tx, tr, t["w3"],
                                                         t["b2"], t["g"])),
    "fused_ln_mlp_residual_int8": (
        lambda jx, jr, j: jint8.fused_ln_mlp_residual_int8(
            jx, j["ls"], j["lb"], j["w"], j["b"], j["w2"], j["b2"], j["g"]),
        lambda tx, tr, t: tint8.fused_ln_mlp_residual_int8_plain(
            tx, t["ls"], t["lb"], t["w"], t["b"], t["w2"], t["b2"], t["g"])),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(F_CASES))
def test_int8_kernel_plain_matches_vdn(name, dt):
    """The plain version of F1-F4 against vdn's Pallas kernel, and the
    wrapper on a CPU tensor is the plain version."""
    (jx, jres, j), (tx, tres, t) = _f_args(np.random.default_rng(4), dt)
    vdn_fn, plain_fn = F_CASES[name]
    with pltpu.force_tpu_interpret_mode():
        want = vdn_fn(jx, jres, j)
    got = plain_fn(tx, tres, t)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    assert rel_l2(_np(got), _np(want)) <= DTYPES[dt][2]
    wrapper = getattr(tint8, name)
    args = {"int8_ln_linear": (tx, t["ls"], t["lb"], t["w"], t["b"]),
            "int8_linear": (tx, t["w"], t["b"]),
            "int8_proj_residual": (tx, tres, t["w3"], t["b2"], t["g"]),
            "fused_ln_mlp_residual_int8": (tx, t["ls"], t["lb"], t["w"],
                                           t["b"], t["w2"], t["b2"],
                                           t["g"])}[name]
    assert torch.equal(wrapper(*args), got)
    assert_operands(_port_first_operands(name, tx, t),
                    _vdn_first_operands(name, jx, j))
    if name == "fused_ln_mlp_residual_int8":
        assert_operands(*_hidden_operands(jx, j, tx, t, dt))


def test_prequantized_weights_give_the_same_result():
    (_, _, _), (tx, tres, t) = _f_args(np.random.default_rng(5), "bf16")
    wq = tint8.quantize_weight_cols(t["w"])
    assert torch.equal(
        tint8.int8_ln_linear(tx, t["ls"], t["lb"], wq, t["b"]),
        tint8.int8_ln_linear(tx, t["ls"], t["lb"], t["w"], t["b"]))


def test_serving_gate(monkeypatch):
    """Rows >= 1024 on the card only; the two variables override."""
    x = torch.zeros(1)
    monkeypatch.delenv("VDN_FORCE_INT8", raising=False)
    monkeypatch.delenv("VDN_DISABLE_INT8", raising=False)
    assert not tint8.int8_serving_enabled(4096, x)   # a CPU tensor
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    assert tint8.int8_serving_enabled(8, x)
    monkeypatch.setenv("VDN_DISABLE_INT8", "1")
    assert not tint8.int8_serving_enabled(8, x)


# ---------------------------------------------------------------- int8 conv
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", ["int8", "int8_static"])
@pytest.mark.parametrize("ksize", [3, 1])
def test_int8_conv_matches_vdn(ksize, mode, dt):
    jdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 11, 64)).astype(np.float32)
    w = (rng.standard_normal((ksize, ksize, 64, 96)) * 0.05).astype(
        np.float32)
    pad = ksize // 2
    amax = None
    if mode == "int8_static":   # below the data's max: values clip to 127
        amax = np.float32(0.8 * np.abs(x).max())
    want = jconv.int8_conv(jnp.asarray(x, jdt), jnp.asarray(w), (1, 1),
                           [(pad, pad), (pad, pad)],
                           amax=None if amax is None else jnp.asarray(amax))
    conv = Conv2d(64, 96, ksize, padding=pad, quantize=mode)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    got = tconv.int8_conv(torch.from_numpy(x).to(tdt), conv.int8_weight(),
                          (1, 1), (pad, pad),
                          None if amax is None else torch.tensor(amax))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if dt == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    else:
        g, wv = _np(got), _np(want)
        assert np.all(np.abs(g - wv) <= 2.0 ** (np.floor(np.log2(
            np.maximum(np.abs(wv), 1e-30))) - 7))


# (x NHWC, vdn kernel HWIO, stride, static): the vitl head's convs at the
# clip window (N 32), the stream (N 1, 8) and the image (N 1), and the
# gate's edges
GATE_TABLE = [
    ((32, 37, 37, 1024), (1, 1, 1024, 1024), 1, False),
    ((32, 37, 37, 1024), (1, 1, 1024, 256), 1, False),
    ((32, 37, 37, 1024), (3, 3, 1024, 256), 1, False),
    ((1, 37, 37, 1024), (3, 3, 1024, 256), 1, False),
    ((32, 74, 74, 512), (3, 3, 512, 256), 1, False),
    ((1, 74, 74, 256), (3, 3, 256, 256), 1, True),
    ((8, 74, 74, 256), (3, 3, 256, 256), 1, True),
    ((8, 74, 74, 256), (1, 1, 256, 256), 1, True),
    ((32, 148, 148, 256), (3, 3, 256, 256), 1, False),
    ((2, 148, 148, 256), (3, 3, 256, 256), 1, False),
    ((32, 296, 296, 256), (3, 3, 256, 256), 1, False),
    ((32, 296, 296, 256), (3, 3, 256, 256), 1, True),
    ((1, 296, 296, 256), (3, 3, 256, 128), 1, True),
    ((1, 296, 296, 256), (3, 3, 256, 128), 1, False),
    ((32, 296, 296, 128), (3, 3, 128, 32), 1, True),
    ((64, 37, 37, 1024), (3, 3, 1024, 1024), 2, False),
    ((128, 37, 37, 1024), (3, 3, 1024, 1024), 2, False),
    ((32, 37, 37, 32), (3, 3, 32, 256), 1, False),
]


@pytest.mark.parametrize("env", [None, "VDN_FORCE_INT8",
                                 "VDN_DISABLE_INT8_CONV"])
def test_int8_conv_gate_matches_vdn(env, monkeypatch):
    for var in ("VDN_FORCE_INT8", "VDN_DISABLE_INT8_CONV"):
        monkeypatch.delenv(var, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    decisions = []
    for xs, ks, stride, static in GATE_TABLE:
        want = jconv.int8_conv_enabled(jax.ShapeDtypeStruct(xs, jnp.float32),
                                       ks, (stride, stride), static)
        got = tconv.int8_conv_enabled(torch.empty(xs, device="meta"),
                                      (ks[3], ks[2], ks[0], ks[1]),
                                      (stride, stride), static)
        assert got == want, (xs, ks, stride, static)
        decisions.append(got)
    if env is None:      # the table reaches both answers, N-dependence too
        assert decisions[3] is False and decisions[0] is True
        assert decisions[5] is False and decisions[6] is True


def test_quant_stats_stay_out_of_the_state_dict():
    """The calibration pass runs the float conv and records |x|'s max; a
    calibrated int8_static conv has the float conv's state_dict, and either
    loads the other's with strict=True."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 5, 5, 64)).astype(np.float32))
    conv = Conv2d(64, 64, 3, padding=1, quantize="int8_static")
    with torch.no_grad():   # Conv2d's weight starts uninitialized
        conv.weight.copy_(torch.from_numpy(np.random.default_rng(8)
                                           .standard_normal((64, 64, 3, 3))
                                           .astype(np.float32) * 0.05))
    float_conv = Conv2d(64, 64, 3, padding=1)
    float_conv.load_state_dict(conv.state_dict(), strict=True)
    with torch.no_grad(), quant_calibration(conv):
        y = conv(x)
        assert torch.equal(y, float_conv(x))
    assert conv.act_amax == x.abs().amax()
    assert set(conv.state_dict()) == set(float_conv.state_dict())
    conv.load_state_dict(float_conv.state_dict(), strict=True)
    assert conv.act_amax is not None


# ---------------------------------------------------------------- models
# Past one kernel, the int8 path is chaotic at these sizes: a rounding that
# two implementations place apart moves an int8 value by one, and random
# weights (LayerScale near 1) amplify that block by block and conv by conv.
# Moving every fp32 weight of the port by one rounding (2^-24 relative)
# moves its int8 clip depth by 2-6e-2 where its float depth moves by 3e-6.
# So a model is held to vdn (a) teacher-forced: each block or quantized
# conv on the same input as vdn's, to the kernels' tolerances; and (b) end
# to end within CHAOS_FACTOR times that floor, measured in the test.
CHAOS_FACTOR = 2.0


def perturbed_distance(model, run) -> float:
    """rel L2 between run() and run() with every parameter of ``model``
    moved by one fp32 rounding (seeded normal noise, 2^-24 relative)."""
    base = run()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=g))
    try:
        moved = run()
    finally:
        model.load_state_dict(saved)
    return rel_l2(moved, base)


class Int8ConvCalls:
    """Records (conv, input, output) of every call of ``model``'s quantized
    convs that took the int8 route."""

    def __init__(self, model):
        from vdn_torch.nn.layers import calibrating
        self.calls = []
        self.calibrated = {}   # conv name -> act_amax after its last pass
        names = {m: n for n, m in model.named_modules()}

        def hook(m, args, out):
            static = m.quantize == "int8_static"
            if static and calibrating():
                self.calibrated[names[m]] = float(m.act_amax)
                return
            if not tconv.int8_conv_enabled(args[0], m.weight.shape, m.stride,
                                           static):
                return
            amax = m.act_amax if static else None
            self.calls.append((m, args[0].clone(), out.clone(),
                               None if amax is None else float(amax)))

        self.handles = [m.register_forward_hook(hook)
                        for m in model.modules()
                        if isinstance(m, Conv2d) and m.quantize]

    def remove(self):
        for h in self.handles:
            h.remove()

    def assert_match_vdn(self, amax_of=None):
        """Each recorded output equals vdn's int8_conv (+ bias) on the same
        input, with the conv's own calibrated absmax or ``amax_of(conv)``:
        exact int32 sums, the same fp32 dequantization."""
        assert self.calls
        for m, x, y, amax in self.calls:
            if amax_of is not None and amax is not None:
                amax = amax_of(m)
            ph, pw = m.padding
            want = jconv.int8_conv(
                jnp.asarray(x.numpy()),
                jnp.asarray(m.weight.detach().numpy().transpose(2, 3, 1, 0)),
                m.stride, [(ph, ph), (pw, pw)],
                amax=None if amax is None else jnp.float32(amax))
            if m.bias is not None:
                want = want + jnp.asarray(m.bias.detach().numpy())
            np.testing.assert_allclose(y.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


def test_vit_int8_matches_vdn(monkeypatch):
    """vits cut to 4 blocks, quantize="int8", teacher-forced: each of the
    port's blocks (F1, the plain attention, F3, F4) on vdn's input to that
    block, against vdn's block: rel L2 <= 1e-3 (a tie that lands apart
    moves a block by up to a few 1e-4)."""
    from vdn.nn.vit import Block as JBlock
    from vdn.nn.vit import DinoVisionTransformer as JViT
    from vdn_torch.nn.vit import DinoVisionTransformer as TViT
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    kw = dict(embed_dim=384, depth=4, num_heads=6)
    x = np.random.default_rng(8).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(JViT(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    params = _numpy_params(shapes, np.random.default_rng(9))["params"]
    tm, tf = TViT(**kw, quantize="int8"), TViT(**kw)
    load_flax_params(tm, {"params": params})
    load_flax_params(tf, {"params": params})
    jblock = JBlock(num_heads=6, quantize="int8")
    with pltpu.force_tpu_interpret_mode():
        japply = jax.jit(lambda p, h: jblock.apply({"params": p}, h))
    with torch.no_grad():
        h = tm.prepare_tokens(torch.from_numpy(x)).numpy()
        for i, blk in enumerate(tm.blocks):
            with pltpu.force_tpu_interpret_mode():
                want = np.array(japply(params[f"blocks_{i}"],
                                       jnp.asarray(h)))
            got = blk(torch.from_numpy(h))
            assert rel_l2(got.numpy(), want) <= 1e-3, f"block {i}"
            # the int8 path ran: quantization noise against the float block
            float_out = tf.blocks[i](torch.from_numpy(h))
            assert rel_l2(got.numpy(), float_out.numpy()) > 1e-3
            h = want


VDA = dict(encoder="vits")          # the preset head: features 64
N_CLIP = 36                         # two windows, the second cached


def _vda_params(seed):
    from vdn.models.video_depth_anything import build_video_depth_anything
    jm = build_video_depth_anything(**VDA)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, SIZE, SIZE, 3)))
    return _numpy_params(shapes, np.random.default_rng(seed))


def _vda_pair(params, quantize):
    from vdn.models.video_depth_anything import build_video_depth_anything
    from vdn_torch.models.video_depth_anything import (
        build_video_depth_anything as tbuild)
    jm = build_video_depth_anything(**VDA, quantize=quantize)
    tm = tbuild(**VDA, device="cpu", quantize=quantize)
    load_flax_params(tm, params)
    return jm, tm


def _conv_names(stats) -> set:
    from vdn_torch.core.convert import _torch_key
    return {_torch_key([p.key for p in path[:-1]]) for path, _ in
            jax.tree_util.tree_flatten_with_path(stats["quant_stats"])[0]}


def _calibrated(tm) -> set:
    return {n for n, m in tm.named_modules()
            if isinstance(m, Conv2d) and m.act_amax is not None}


@pytest.fixture(scope="module")
def clip():
    """Both packages' infer_video_depth over one clip, in both modes, with
    the head's convs int8 and the encoder float in both (VDN_DISABLE_INT8:
    Pallas's interpret mode takes ~5 s per 32-frame window; the encoder's
    int8 path is held by the ViT, stream and image tests); the port's int8
    conv calls; vdn's first-window quant_stats."""
    from vdn.pipelines.infer_video import (infer_video_depth as jinfer,
                                           make_calibrating_window_fn)
    from vdn.pipelines.transform import preprocess_frame
    from vdn_torch.pipelines.infer_video import infer_video_depth as tinfer
    params = _vda_params(10)
    frames = np.random.default_rng(11).integers(
        0, 256, (N_CLIP, SIZE, SIZE, 3), dtype=np.uint8)
    first = np.stack([preprocess_frame(f, SIZE) for f in frames[:32]])[None]
    out = {"params": params, "first": first}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VDN_FORCE_INT8", "1")
        mp.setenv("VDN_DISABLE_INT8", "1")
        for mode in ("int8_static", "int8"):
            jm, tm = _vda_pair(params, mode)
            want, _ = jinfer(jm, params, frames, 24.0, input_size=SIZE)
            run = lambda tm=tm: tinfer(tm, frames, 24.0, input_size=SIZE)[0]
            rec = Int8ConvCalls(tm)
            tconv.reset_counts()
            got = run()
            n_int8 = tconv.counts["int8_conv"]
            rec.remove()
            out[mode] = dict(tm=tm, got=got, want=want, n_int8=n_int8,
                             calls=rec, floor=perturbed_distance(tm, run))
        jm = _vda_pair(params, "int8_static")[0]
        stats = make_calibrating_window_fn(jm)(params, first)[2]
        out["stats"] = jax.tree.map(np.asarray, stats)
    return out


@pytest.mark.parametrize("mode", ["int8_static", "int8"])
def test_clip_int8_matches_vdn(clip, mode):
    """End to end within the chaos floor; every int8 conv call of the run
    equal to vdn's int8_conv on its input."""
    r = clip[mode]
    got, want = r["got"], r["want"]
    assert got.shape == (N_CLIP, SIZE, SIZE) and np.isfinite(got).all()
    assert 0 < r["floor"] and rel_l2(got, want) <= CHAOS_FACTOR * r["floor"]
    assert r["n_int8"] == len(r["calls"].calls) > 0
    r["calls"].assert_match_vdn()


def _flat_stats(stats) -> dict:
    from vdn_torch.core.convert import _torch_key
    return {_torch_key([p.key for p in path[:-1]]): float(v) for path, v in
            jax.tree_util.tree_flatten_with_path(stats["quant_stats"])[0]}


def assert_stats_match(got: dict, stats) -> None:
    """The port's absmax per conv name: the convs vdn records, each within
    1e-5 relative of vdn's."""
    want = _flat_stats(stats)
    assert set(got) == set(want) and want
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-5,
                                   err_msg=name)


def _amax_of(tm) -> dict:
    return {n: float(m.act_amax) for n, m in tm.named_modules()
            if isinstance(m, Conv2d) and m.act_amax is not None}


def test_clip_calibration_matches_vdn(clip):
    """The port's first-window calibration records an absmax for exactly
    the convs vdn records, each within 1e-5 relative of vdn's; as vdn's
    clip call, the port's leaves the model's scales as it found them."""
    tm = clip["int8_static"]["tm"]
    assert_stats_match(clip["int8_static"]["calls"].calibrated,
                       clip["stats"])
    assert not _calibrated(tm)


def test_clip_static_on_vdn_scales(clip, monkeypatch):
    """vdn's quant_stats loaded into the port (load_quant_stats): its
    first window served on identical scales, each int8 conv equal to
    vdn's with vdn's absmax, the depth within the chaos floor of vdn's
    apply with the same stats."""
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    monkeypatch.setenv("VDN_DISABLE_INT8", "1")
    jm, tm = _vda_pair(clip["params"], "int8_static")
    stats = clip["stats"]
    assert load_quant_stats(tm, stats) == len(_conv_names(stats))
    x = clip["first"]
    want, _ = jax.jit(lambda p, x: jm.apply(p, x, method=jm.forward_window))(
        {**clip["params"], **stats}, jnp.asarray(x))

    def run():
        with torch.no_grad():
            return tm.forward_window(torch.from_numpy(x))[0].numpy()

    rec = Int8ConvCalls(tm)
    got = run()
    rec.remove()
    names = {m: n for n, m in tm.named_modules()}
    flat = _flat_stats(stats)
    rec.assert_match_vdn(lambda m: flat[names[m]])
    floor = perturbed_distance(tm, run)
    assert rel_l2(got, want) <= CHAOS_FACTOR * floor


def _waited(jpipe):
    """vdn's stream pipeline with each jitted step waited for before the
    host goes on.  Its Pallas kernels run in interpret mode, whose
    callbacks dispatch JAX ops of their own from XLA's threads; with the
    pipeline's next eager op (``.at[].set`` on the step's outputs)
    dispatched while a step ran, the CPU client and the callback waited
    on each other and the test hung (about one run in six under load).
    The same steps and values, in order."""
    for name in ("_first", "_first_calib", "_step_k", "_step_batched"):
        step = getattr(jpipe, name)
        setattr(jpipe, name,
                lambda *a, step=step: jax.block_until_ready(step(*a)))
    return jpipe


def test_stream_int8_static_matches_vdn(clip, monkeypatch):
    """Three streamed frames, the encoder int8 too: the first frame
    calibrates (the same convs as vdn's), then two per-frame steps."""
    from vdn.pipelines.stream import VideoDepthStreamPipeline as JStream
    from vdn_torch.pipelines.stream import VideoDepthStreamPipeline
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    jm, tm = _vda_pair(clip["params"], "int8_static")
    frames = np.random.default_rng(12).integers(
        0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    jpipe = _waited(JStream(jm, clip["params"], input_size=SIZE))
    with pltpu.force_tpu_interpret_mode():
        want = np.stack([jpipe.infer_video_depth_one(f) for f in frames])

    def run():
        pipe = VideoDepthStreamPipeline(tm, input_size=SIZE)
        return np.stack([pipe.infer_video_depth_one(f) for f in frames])

    rec = Int8ConvCalls(tm)
    got = run()
    rec.remove()
    assert _calibrated(tm) == _conv_names({"quant_stats":
                                           jpipe.params["quant_stats"]})
    rec.assert_match_vdn()
    assert rel_l2(got, want) <= CHAOS_FACTOR * perturbed_distance(tm, run)


def _image_pair():
    """vdn's and the port's DepthAnythingV2 (vits, two memory layers) in
    int8_static on one set of weights."""
    from vdn.models.depth_anything_v2 import DepthAnythingV2 as JDAv2
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    cfg = dict(encoder="vits", features=64, out_channels=(48, 96, 192, 384),
               num_mem_attention_layers=2)
    jm = JDAv2(**cfg, quantize="int8_static")

    def every_param(m, x):
        depth, mem_feat = m(x, None)
        return m.encode_memory(mem_feat, depth)

    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        method=every_param))
    params = _numpy_params(shapes, np.random.default_rng(13))
    tm = build_depth_anything_v2(**cfg, device="cpu", quantize="int8_static")
    load_flax_params(tm, params)
    return jm, params, tm


def test_image_int8_static_matches_vdn(monkeypatch):
    """Four images through DepthAnythingV2's memory bank, the encoder int8
    too: the first (no memory) calibrates."""
    from vdn.pipelines.infer_image import DepthAnythingV2Pipeline as JPipe
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    jm, params, tm = _image_pair()
    images = np.random.default_rng(14).integers(
        0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    jpipe = JPipe(jm, params)
    with pltpu.force_tpu_interpret_mode():
        want = np.stack([jpipe.infer_image(img, SIZE) for img in images])

    def run():
        pipe = DepthAnythingV2Pipeline(tm)
        return np.stack([pipe.infer_image(img, SIZE) for img in images])

    rec = Int8ConvCalls(tm)
    got = run()
    rec.remove()
    assert _calibrated(tm) == _conv_names({"quant_stats":
                                           jpipe.params["quant_stats"]})
    rec.assert_match_vdn()
    assert rel_l2(got, want) <= CHAOS_FACTOR * perturbed_distance(tm, run)


# ------------------------------------------- recalibration (int8_static)
# vdn's calibration pass stores max(old, |x|) over the stats it starts
# with: the image and stream pipelines merge a pass into their params, so
# a first image after clear_memory() (a first frame after reset())
# calibrates on top of the last; a clip call merges into a local copy, so
# it starts from the caller's stats (load_quant_stats) every time.  The
# encoder stays float here (VDN_DISABLE_INT8, as in the clip fixture): its
# int8 path, held block by block above, would move the head's absmax by
# ~1e-4 through the chaos and hide the 1e-5 comparison of the scales.
def _clear_stats(tm) -> None:
    for m in tm.modules():
        if isinstance(m, Conv2d):
            m.act_amax = None


def test_image_recalibration_keeps_the_running_max(monkeypatch):
    """Image A, clear_memory(), image B of a smaller range: each first
    image calibrates, the scales are the max over both (not B's alone),
    equal to vdn's quant_stats, and the depth within the chaos floor."""
    from vdn.pipelines.infer_image import DepthAnythingV2Pipeline as JPipe
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    monkeypatch.setenv("VDN_DISABLE_INT8", "1")
    jm, params, tm = _image_pair()
    a = np.random.default_rng(15).integers(0, 256, (SIZE, SIZE, 3),
                                           dtype=np.uint8)
    b = (112 + a // 8).astype(np.uint8)   # the same scene, a smaller range
    jpipe = JPipe(jm, params)
    with pltpu.force_tpu_interpret_mode():
        want = [jpipe.infer_image(a, SIZE)]
        jpipe.clear_memory()
        want.append(jpipe.infer_image(b, SIZE))

    def run(images=(a, b)):
        _clear_stats(tm)
        pipe = DepthAnythingV2Pipeline(tm)
        out = []
        for img in images:
            pipe.clear_memory()
            out.append(pipe.infer_image(img, SIZE))
        return np.stack(out)

    got = run()
    both = _amax_of(tm)
    assert_stats_match(both, {"quant_stats": jpipe.params["quant_stats"]})
    assert rel_l2(got, np.stack(want)) <= CHAOS_FACTOR * perturbed_distance(
        tm, run)
    run((a,))
    only_a = _amax_of(tm)
    run((b,))
    only_b = _amax_of(tm)
    assert both == {k: max(only_a[k], only_b[k]) for k in both}
    assert any(both[k] > only_b[k] for k in both)


def test_stream_recalibration_after_reset_matches_vdn(clip, monkeypatch):
    """Two frames, reset(), two frames of a smaller range: the second first
    frame calibrates on top of the first's scales, as vdn's; the scales
    equal vdn's quant_stats and both streams' depth sits within the chaos
    floor of vdn's."""
    from vdn.pipelines.stream import VideoDepthStreamPipeline as JStream
    from vdn_torch.pipelines.stream import VideoDepthStreamPipeline
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    monkeypatch.setenv("VDN_DISABLE_INT8", "1")
    jm, tm = _vda_pair(clip["params"], "int8_static")
    first = np.random.default_rng(16).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    second = (112 + first[::-1] // 8).astype(np.uint8)
    jpipe = _waited(JStream(jm, clip["params"], input_size=SIZE))
    with pltpu.force_tpu_interpret_mode():
        want = [jpipe.infer_video_depth_one(f) for f in first]
        jpipe.reset()
        want += [jpipe.infer_video_depth_one(f) for f in second]

    def run():
        _clear_stats(tm)
        pipe = VideoDepthStreamPipeline(tm, input_size=SIZE)
        out = [pipe.infer_video_depth_one(f) for f in first]
        pipe.reset()
        return np.stack(out + [pipe.infer_video_depth_one(f)
                               for f in second])

    got = run()
    assert_stats_match(_amax_of(tm),
                       {"quant_stats": jpipe.params["quant_stats"]})
    assert rel_l2(got, np.stack(want)) <= CHAOS_FACTOR * perturbed_distance(
        tm, run)


def test_clip_calls_start_from_the_loaded_stats(clip, monkeypatch):
    """load_quant_stats, then two clip calls: each calibrates its first
    window on top of the loaded scales (half of them above the window's,
    half below), to vdn's quant_stats of the same pass; each returns the
    model's scales as loaded, so the two calls agree exactly; the depth
    within the chaos floor of vdn's infer_video_depth with those stats."""
    from vdn.pipelines.infer_video import (infer_video_depth as jinfer,
                                           make_calibrating_window_fn)
    from vdn_torch.pipelines.infer_video import infer_video_depth as tinfer
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    monkeypatch.setenv("VDN_DISABLE_INT8", "1")
    jm, tm = _vda_pair(clip["params"], "int8_static")
    leaves, tree = jax.tree_util.tree_flatten(clip["stats"])
    loaded = jax.tree_util.tree_unflatten(tree, [
        np.float32(v * (1.5 if i % 2 == 0 else 0.5))
        for i, v in enumerate(leaves)])
    params = {**clip["params"], **loaded}
    served = make_calibrating_window_fn(jm)(params, clip["first"])[2]
    frames = np.random.default_rng(11).integers(
        0, 256, (N_CLIP, SIZE, SIZE, 3), dtype=np.uint8)
    want, _ = jinfer(jm, params, frames, 24.0, input_size=SIZE)
    load_quant_stats(tm, loaded)
    run = lambda: tinfer(tm, frames, 24.0, input_size=SIZE)[0]
    rec = Int8ConvCalls(tm)
    got = run()
    assert _amax_of(tm) == _flat_stats(loaded)
    again = run()
    rec.remove()
    assert _amax_of(tm) == _flat_stats(loaded)
    np.testing.assert_array_equal(again, got)
    assert_stats_match(rec.calibrated, jax.tree.map(np.asarray, served))
    assert _flat_stats(served) != _flat_stats(clip["stats"])
    rec.assert_match_vdn()
    assert rel_l2(got, want) <= CHAOS_FACTOR * perturbed_distance(tm, run)
