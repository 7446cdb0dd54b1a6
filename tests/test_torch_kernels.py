"""The plain PyTorch versions of the port's kernels (A1-A6, B1, C1, C2) against the
JAX package's Pallas kernels, run in Pallas interpret mode on the CPU.

Same inputs for both, drawn with numpy from a seed.  Weights are handed to
the JAX kernels in flax layout ([in, out]) and to the port in torch layout
([out, in]).  Tolerances:

- fp32: rtol = atol = 2e-5, the JAX package's own kernel-vs-XLA bound
  (the Pallas GELU uses a 1.5e-7-accurate erf polynomial, torch the exact
  erf; sums run in another order);
- bf16: 4 bf16 ulps at the scale of the JAX output.  Both sides round at
  the same points; a different fp32 summation order can move a rounded
  intermediate by one ulp, and the output by a few.
- the resize kernels (A5a, A5b, B1): fp32 1e-5; bf16 bit-exact where every
  output sums two taps (bf16 x bf16 products are exact in fp32, and so is
  a two-term sum in either order), else 1 ulp.

The backwards (D1, D3, D4, and A4-A6's recompute and transposed-plan
backwards) through their autograd Functions against vdn's custom_vjps, the
Pallas backward kernels in interpret mode: fp32 ``2e-5`` of the
cotangent's scale, bf16 4 ulps at the output's scale, as above; bf16
resize backwards 1 ulp (at most 8 taps, two-term sums exact).  Each
Function against autograd of its plain forward: fp32 ``1e-5`` of scale.

The CUDA kernels themselves run only on a GPU: chip_smoke.py holds them
against these plain versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import vdn.ops.resize as jops_resize
from vdn.ops.pallas import flash_attention as jfa
from vdn.ops.pallas import geglu as jgeglu
from vdn.ops.pallas import mlp as jmlp
from vdn.ops.pallas import resize as jresize
from vdn.ops.pallas import resize_island as jisland
from vdn.ops.pallas import temporal_attention as jta
from vdn_torch.kernels import flash_attention as tfa
from vdn_torch.kernels import geglu as tgeglu
from vdn_torch.kernels import mlp as tmlp
from vdn_torch.kernels import resize as tresize
from vdn_torch.kernels import resize_island as tisland
from vdn_torch.kernels import temporal_attention as tta
from vdn_torch.ops.resize import plan_axis, resize2d

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        scale = float(np.abs(want).max())
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        err = float(np.abs(got - want).max())
        assert err <= 4 * ulp, (err, ulp)


def _pair(a: np.ndarray, dtype: str = "fp32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,t,h", [(1, 150, 2), (2, 64, 4)])
def test_flash_attention_fused_qkv(b, t, h, dtype):
    # t = 150: a ragged tail against 64-row q blocks
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((b, t, 3, h, 64), np.float32), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_fused_qkv(jq, None, 64)
    _close(tfa.flash_attention_fused_qkv(tq), want, dtype)


def _slot_mask(cap, hw, count):
    """The memory bank's bias: -inf over the leading cap - count slots."""
    bias = np.zeros((cap, hw), np.float32)
    bias[:cap - count] = -np.inf
    return bias.reshape(-1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("count", [1, 3, 6])
def test_flash_attention_colbias(count, dtype):
    """C1 at 150 queries against a bank of 6 x 150 keys (both ragged
    against 64-wide tiles; slot boundaries fall inside tiles), with the
    masks of 1, 3 and 6 written slots."""
    rng = np.random.default_rng(10)
    b, hw, cap, h, d = 1, 150, 6, 2, 64
    jq, tq = _pair(rng.standard_normal((b, hw, h, d), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((b, cap * hw, h, d), np.float32),
                   dtype)
    jv, tv = _pair(rng.standard_normal((b, cap * hw, h, d), np.float32),
                   dtype)
    bias = _slot_mask(cap, hw, count)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_colbias(jq, jk, jv, jnp.asarray(bias))
    got = tfa.flash_attention_colbias(tq, tk, tv, torch.from_numpy(bias))
    assert got.dtype == tq.dtype and bool(torch.isfinite(got).all())
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,tq,tk,h", [(1, 150, 150, 2), (2, 277, 300, 3)])
def test_flash_attention(b, tq, tk, h, dtype):
    """C2, square and cross shapes with ragged tails."""
    rng = np.random.default_rng(11)
    jq, q = _pair(rng.standard_normal((b, tq, h, 64), np.float32), dtype)
    jk, k = _pair(rng.standard_normal((b, tk, h, 64), np.float32), dtype)
    jv, v = _pair(rng.standard_normal((b, tk, h, 64), np.float32), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention(jq, jk, jv)
    got = tfa.flash_attention(q, k, v)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


def _mlp_args(rng, c, f):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(ls=1 + 0.1 * r(c), lb=0.1 * r(c), w1=r(c, f) / np.sqrt(c),
                b1=0.1 * r(f), w2=r(f, c) / np.sqrt(f), b2=0.1 * r(c),
                g=0.5 * r(c))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 150, 128), (300, 128)])
def test_fused_ln_mlp_residual(shape, dtype):
    rng = np.random.default_rng(1)
    c, f = shape[-1], 4 * shape[-1]
    jx, tx = _pair(rng.standard_normal(shape, np.float32), dtype)
    a = _mlp_args(rng, c, f)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ln_mlp_residual(
            jx, *(jnp.asarray(a[k]) for k in
                  ("ls", "lb", "w1", "b1", "w2", "b2", "g")), 1e-6)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = tmlp.fused_ln_mlp_residual(tx, t["ls"], t["lb"], t["w1"].T,
                                     t["b1"], t["w2"].T, t["b2"], t["g"])
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bn,t,c", [
    (37, 32, 256),    # mm2/mm3 width (dh 32), token count not a block multiple
    (9, 32, 1024),    # mm0/mm1 width (dh 128)
    (20, 8, 256),     # short window
    (9, 32, 1536),    # vitg's mm0/mm1 (dh 192)
    (37, 32, 384),    # vitg's mm2/mm3 (dh 48)
])
def test_temporal_attention_block(bn, t, c, dtype):
    rng = np.random.default_rng(2)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    jx, tx = _pair(r(bn, t, c), dtype)
    pe = r(t, c)
    ws = [r(c, c) / np.sqrt(c) for _ in range(4)]
    bo = 0.1 * r(c)
    scale = (c // 8) ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jta.temporal_attention_block(
            jx, jnp.asarray(pe), *(jnp.asarray(w) for w in ws),
            jnp.asarray(bo), 8, scale)
    got = tta.temporal_attention_block(
        tx, torch.from_numpy(pe), *(torch.from_numpy(w).T for w in ws),
        torch.from_numpy(bo), 8, scale)
    _close(got, want, dtype)


def test_temporal_attention_head_dims(monkeypatch):
    """A3's wrapper admits vitl's and vitg's head widths; D4's (its checks
    reached as on the card) keeps the training paths' and says why vitg's
    are left out."""
    monkeypatch.setattr(tta, "use_kernel", lambda x: True)
    for c in (256, 384, 1024, 1536):
        x = torch.zeros((2, 4, c), dtype=torch.bfloat16)
        tta._check_args("temporal_attention_block", x, 8)
        if c // 8 in (48, 192):
            with pytest.raises(ValueError, match="served only"):
                tta.temporal_attention_bwd_dx(x, *[None] * 6, 8, 1.0)
        else:
            tta._check_args("bwd", x, 8, tta.BACKWARD_HEAD_DIMS)
    with pytest.raises(ValueError):
        tta._check_args("a3", torch.zeros((2, 4, 640),
                                           dtype=torch.bfloat16), 8)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,c", [(300, 256), (64, 128)])
def test_fused_ln_geglu_residual(n, c, dtype):
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    f = 4 * c
    jx, tx = _pair(r(n, c), dtype)
    a = dict(ls=1 + 0.1 * r(c), lb=0.1 * r(c), w0=r(c, 2 * f) / np.sqrt(c),
             b0=0.1 * r(2 * f), w2=r(f, c) / np.sqrt(f), b2=0.1 * r(c))
    with pltpu.force_tpu_interpret_mode():
        want = jgeglu.fused_ln_geglu_residual(
            jx, *(jnp.asarray(a[k]) for k in
                  ("ls", "lb", "w0", "b0", "w2", "b2")))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = tgeglu.fused_ln_geglu_residual(tx, t["ls"], t["lb"], t["w0"].T,
                                         t["b0"], t["w2"].T, t["b2"])
    _close(got, want, dtype)


# (in, out, method, align_corners, scale): bilinear align-corners up and
# down, and the pos-embed's bicubic with an explicit scale factor
RESIZE_PLANS = [
    (19, 37, "bilinear", True, None),
    (37, 19, "bilinear", True, None),
    (21, 37, "bicubic", False, 37.1 / 21),
]


def _plan(in_size, out_size, method, ac, scale):
    from vdn.ops.resize import _plan_axis
    from vdn_torch.ops.resize import plan_axis
    idx, w = plan_axis(out_size, in_size, method, ac, scale)
    jidx, jw = _plan_axis(out_size, in_size, method, ac, scale)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(w, jw)
    return idx, w


def _resize_close(got: torch.Tensor, want, dtype: str, two_tap: bool):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif two_tap:
        np.testing.assert_array_equal(got, want)
    else:
        ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
        assert float(np.abs(got - want).max()) <= ulp


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("plan", RESIZE_PLANS)
def test_resize_rows(plan, dtype):
    rng = np.random.default_rng(4)
    idx, w = _plan(*plan)
    jx, tx = _pair(rng.standard_normal((2, plan[0], 8, 128), np.float32),
                   dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jresize.resize_rows(jx, idx, w, plan[1])
    got = tresize.resize_rows(tx, idx, w, plan[1])
    _resize_close(got, want, dtype, plan[2] == "bilinear")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("plan", RESIZE_PLANS)
def test_resize_mid_axis(plan, dtype):
    rng = np.random.default_rng(5)
    idx, w = _plan(*plan)
    jx, tx = _pair(rng.standard_normal((3, plan[0], 128), np.float32), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jresize.resize_mid_axis(jx, idx, w, plan[1])
    got = tresize.resize_mid_axis(tx, idx, w, plan[1])
    _resize_close(got, want, dtype, plan[2] == "bilinear")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("slab", ["onehot", "dense"])
def test_select_rows(slab, dtype):
    """The streaming window gather: a [31, 43] slab against a ring
    [N, 43, 128].  One-hot rows are exact in any dtype."""
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.standard_normal((5, 43, 128), np.float32), dtype)
    if slab == "onehot":
        sel = rng.permutation(43)[:31]
        weights = np.eye(43, dtype=np.float32)[sel]
    else:
        weights = rng.standard_normal((31, 43)).astype(np.float32) / 6
    with pltpu.force_tpu_interpret_mode():
        want = jresize.select_rows(jx, jnp.asarray(weights))
    got = tresize.select_rows(tx, torch.from_numpy(weights))
    _resize_close(got, want, dtype, slab == "onehot")


def _island_args(n, h, w, c, seed):
    # the draws of tests/test_resize_island.py
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [r(n, h, w, c), r(3, 3, c, 32) / np.sqrt(9 * c), 0.1 * r(32),
            r(32, 1) / np.sqrt(32), 0.1 * r(1)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,out_hw,sigmoid,max_depth,seed", [
    (2, 37, 37, 128, (64, 64), False, 1.0, 0),
    (1, 21, 21, 128, (37, 37), False, 1.0, 0),   # odd output width
    (1, 30, 30, 256, (53, 53), False, 1.0, 0),   # wider channels
    (1, 19, 19, 128, (40, 40), True, 20.0, 3),   # the sigmoid head
    (1, 21, 21, 192, (37, 37), False, 1.0, 0),   # vitg's C (bands of 4)
])
def test_fused_resize_island(n, h, w, c, out_hw, sigmoid, max_depth, seed,
                             dtype):
    feat, *params = _island_args(n, h, w, c, seed)
    jfeat, tfeat = _pair(feat, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jisland.fused_resize_island(
            jfeat, *(jnp.asarray(p) for p in params), out_hw, sigmoid,
            max_depth)
    got = tisland.fused_resize_island(
        tfeat, *(torch.from_numpy(p) for p in params), out_hw, sigmoid,
        max_depth)
    assert got.dtype == torch.float32
    _close(got, want, dtype)


def test_resize2d_rounds_as_vdn(monkeypatch):
    """Regression: the port's resize2d in bf16 rounds after each axis, as
    vdn's Pallas path does, and equals it bit for bit at 19^2 -> 37^2.  A
    single 2-D F.interpolate, which rounds once, does not."""
    import torch.nn.functional as F
    import vdn.ops.resize as jr
    from vdn_torch.ops.resize import resize2d
    monkeypatch.setattr(jr, "_FORCE_PALLAS", True)
    x = np.random.default_rng(7).standard_normal((2, 19, 19, 128),
                                                 np.float32)
    jx, tx = _pair(x, "bf16")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jr.resize2d(jx, (37, 37), "bilinear", True),
                          np.float32)
    got = resize2d(tx, (37, 37), "bilinear", align_corners=True)
    np.testing.assert_array_equal(got.float().numpy(), want)
    once = F.interpolate(tx.permute(0, 3, 1, 2), size=(37, 37),
                         mode="bilinear", align_corners=True)
    assert (once.permute(0, 2, 3, 1).float().numpy() != want).mean() > 0.01


def test_dispatch_by_device():
    """Dispatch is by device: only CPU tensors (or the explicit reference
    context) take the plain version; other devices never fall back."""
    from vdn_torch import kernels
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError):
        kernels.use_kernel(x)
    assert not kernels.use_kernel(torch.zeros(2))


def _close_scaled(got, want, dtype="fp32", ulps=4, rtol=2e-5):
    """Max abs error within ``rtol`` of the reference's scale (fp32) or
    ``ulps`` bf16 ulps at that scale (bf16)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    tol = (rtol * scale if dtype == "fp32"
           else ulps * 2.0 ** (math.floor(math.log2(scale)) - 7))
    assert err <= tol, (err, tol, scale)


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


# ------------------------------------------------- D1 (A1's backward)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_attention_fused_qkv_backward_matches_vdn(dtype):
    """D1's plain version through the Function against jax.grad of vdn's
    custom_vjp (the cols backward kernel in interpret mode) at two column
    blocks (h = 4), b = 2 and a ragged T = 150 against 64-row q blocks."""
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng.standard_normal((2, 150, 3, 4, 64), np.float32),
                   dtype)
    jg, tg = _pair(rng.standard_normal((2, 150, 4, 64), np.float32), dtype)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda q: jfa.flash_attention_fused_qkv(
            q, None, 64), jq)
        (want,) = vjp(jg)
    tq = _leaf(tq)
    got = tfa.flash_attention_fused_qkv(tq)
    _close_scaled(got, out, dtype)
    got.backward(tg)
    assert tq.grad.dtype == tq.dtype
    _close_scaled(tq.grad, want, dtype)


def test_flash_attention_lse_matches_vdn():
    """A1's training forward writes vdn's base-2 log-sum-exp."""
    rng = np.random.default_rng(6)
    jq, tq = _pair(rng.standard_normal((2, 150, 3, 4, 64), np.float32))
    with pltpu.force_tpu_interpret_mode():
        _, want = jfa._flash_cols_call(jq, 64 ** -0.5, 64, 2, save_lse=True)
    # vdn: [B, n_colblocks, hb, T]; the port: [B, H, T]
    _, got = tfa.flash_attention_fused_qkv_lse_plain(tq)
    _close_scaled(got, np.asarray(want).reshape(2, 4, 150))


# ------------------------------------------------- D3 (A2's backward)
def _mlp_inputs(rng, shape, c, f):
    x = rng.standard_normal(shape, np.float32)
    p = [rng.standard_normal((c,), np.float32) * 0.1 + 1.0,
         rng.standard_normal((c,), np.float32) * 0.1,
         rng.standard_normal((c, f), np.float32) * c ** -0.5,
         rng.standard_normal((f,), np.float32) * 0.1,
         rng.standard_normal((f, c), np.float32) * f ** -0.5,
         rng.standard_normal((c,), np.float32) * 0.1,
         rng.standard_normal((c,), np.float32) * 0.5]
    g = rng.standard_normal(shape, np.float32)
    return x, p, g


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(300, 64), (2, 150, 64)])
def test_ln_mlp_backward_matches_vdn(shape, dtype):
    """All eight grads of A2's Function (D3's plain version and the weight
    products) against vdn's _bwd_via_kernel (the dx kernel in interpret
    mode) at n 300, C 64, F 256; flat and frame-major."""
    rng = np.random.default_rng(7)
    c, f = 64, 256
    x, p, g = _mlp_inputs(rng, shape, c, f)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    jp = [jnp.asarray(a) for a in p]
    with pltpu.force_tpu_interpret_mode():
        want = jmlp._bwd_via_kernel(1e-6, (jx, *jp), jg)
    # torch layout: w1 [F, C], w2 [C, F]
    tp = [_leaf(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))
          for a in p]
    tx = _leaf(tx)
    out = tmlp.fused_ln_mlp_residual(tx, *tp)
    out.backward(tg)
    got = [tx.grad] + [t.grad.t() if t.ndim == 2 else t.grad for t in tp]
    # bf16: the weight grads are bf16 products (or fp32 sums of them), held
    # at their own scale like every bf16 output
    for a, b in zip(got, want):
        _close_scaled(a, b, dtype)


# ------------------------------------------------- D4 (A3's dx)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bn,t,c,heads", [(40, 8, 64, 2), (9, 32, 256, 8)])
def test_temporal_attention_backward_matches_vdn(bn, t, c, heads, dtype):
    """D4's plain version through the Function (dx only: the frozen-head
    case) against vdn's _fused_bwd_dx_impl in interpret mode."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((bn, t, c), np.float32)
    pe = rng.standard_normal((t, c), np.float32) * 0.5
    w = [rng.standard_normal((c, c), np.float32) * c ** -0.5
         for _ in range(4)]
    bo = rng.standard_normal((c,), np.float32) * 0.1
    g = rng.standard_normal((bn, t, c), np.float32)
    scale = (c // heads) ** -0.5
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jta._fused_bwd_dx_impl(jx, jnp.asarray(pe), jg,
                                      *map(jnp.asarray, w), heads, scale)
    tw = [torch.from_numpy(a.T.copy()) for a in w]
    tx = _leaf(tx)
    out = tta.temporal_attention_block(tx, torch.from_numpy(pe), *tw,
                                       torch.from_numpy(bo), heads, scale)
    out.backward(tg)
    assert all(w.grad is None for w in tw)
    _close_scaled(tx.grad, want, dtype)


def test_temporal_attention_weight_grads_match_vdn():
    """With the head trainable, the weight and pe cotangents come from
    autograd of the plain version, as vdn's from jax.vjp of its XLA
    reference."""
    rng = np.random.default_rng(9)
    bn, t, c, heads = 12, 8, 64, 4
    scale = (c // heads) ** -0.5
    x = rng.standard_normal((bn, t, c), np.float32)
    pe = rng.standard_normal((t, c), np.float32)
    w = [rng.standard_normal((c, c), np.float32) * c ** -0.5
         for _ in range(4)]
    bo = rng.standard_normal((c,), np.float32) * 0.1
    g = rng.standard_normal((bn, t, c), np.float32)
    _, vjp = jax.vjp(lambda *a: jta.xla_temporal_attention_block(
        *a, heads, scale), *map(jnp.asarray, (x, pe, *w, bo)))
    want = vjp(jnp.asarray(g))
    args = [_leaf(torch.from_numpy(a)) for a in (x, pe)] + [
        _leaf(torch.from_numpy(a.T.copy())) for a in w] + [
        _leaf(torch.from_numpy(bo))]
    tta.temporal_attention_block(*args, heads, scale).backward(
        torch.from_numpy(g))
    for i, (a, b) in enumerate(zip(args, want)):
        _close_scaled(a.grad.t() if 2 <= i < 6 else a.grad, b)


# ------------------------------------------------- A4, A5, A6 backwards
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_geglu_backward_matches_vdn(dtype):
    """A4's recompute backward against jax.grad of vdn's custom_vjp (the
    forward kernel in interpret mode, the hand-written vjp)."""
    rng = np.random.default_rng(10)
    n, c = 96, 64
    f = 4 * c
    x = rng.standard_normal((n, c), np.float32)
    p = [rng.standard_normal((c,), np.float32) * 0.1 + 1.0,
         rng.standard_normal((c,), np.float32) * 0.1,
         rng.standard_normal((c, 2 * f), np.float32) * c ** -0.5,
         rng.standard_normal((2 * f,), np.float32) * 0.1,
         rng.standard_normal((f, c), np.float32) * f ** -0.5,
         rng.standard_normal((c,), np.float32) * 0.1]
    g = rng.standard_normal((n, c), np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: jgeglu.fused_ln_geglu_residual(*a),
                         jx, *map(jnp.asarray, p))
        want = vjp(jg)
    tp = [_leaf(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))
          for a in p]
    tx = _leaf(tx)
    tgeglu.fused_ln_geglu_residual(tx, *tp).backward(tg)
    got = [tx.grad] + [t.grad.t() if t.ndim == 2 else t.grad for t in tp]
    for a, b in zip(got, want):
        _close_scaled(a, b, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("in_hw,out_hw", [((21, 24), (37, 40)),
                                          ((19, 19), (37, 37))])
def test_resize_backward_matches_vdn(in_hw, out_hw, dtype, monkeypatch):
    """A5a (H) and A5b (W) backwards on the transposed plans against
    jax.grad of vdn's resize2d through its Pallas kernels (_FORCE_PALLAS,
    interpret mode).  Each output sums at most 4 taps, so bf16 is held to
    1 ulp as the forward resize kernels are."""
    monkeypatch.setattr(jops_resize, "_FORCE_PALLAS", True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, *in_hw, 128), np.float32)
    g = rng.standard_normal((2, *out_hw, 128), np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: jops_resize.resize2d(a, out_hw, "bilinear",
                                                    True), jx)
        (want,) = vjp(jg)
    tx = _leaf(tx)
    resize2d(tx, out_hw, "bilinear", align_corners=True).backward(tg)
    _close_scaled(tx.grad, want, dtype, ulps=1)


def test_transposed_plans_fit_the_rows_kernel():
    """Every resize a vitl-518 training step differentiates (the four
    fusion upsamples and the island's 296 -> 518) has a transposed plan of
    at most MAX_TAPS taps per row."""
    for n_in, n_out in ((19, 37), (37, 74), (74, 148), (148, 296),
                        (296, 518)):
        idx, w = plan_axis(n_out, n_in, "bilinear", True, None)
        idx_t, w_t = tresize.transpose_plan(idx, w, n_in)
        pidx, _ = tresize.rows_plan(idx_t, w_t, "cpu")
        assert pidx.shape == (n_in, pidx.shape[1])
        assert pidx.shape[1] <= tresize.MAX_TAPS, (n_in, n_out, pidx.shape)


def test_resize_island_backward_matches_vdn(monkeypatch):
    """A6's composite-recompute backward against jax.grad of vdn's
    custom_vjp (forward kernel in interpret mode), all five inputs, ReLU
    and sigmoid heads, fp32."""
    monkeypatch.setattr(jops_resize, "_FORCE_PALLAS", True)
    rng = np.random.default_rng(12)
    n, h, w, c, o = 1, 16, 16, 128, 32
    args = [rng.standard_normal((n, h, w, c), np.float32),
            rng.standard_normal((3, 3, c, o), np.float32) * (9 * c) ** -0.5,
            rng.standard_normal((o,), np.float32) * 0.1,
            rng.standard_normal((o, 1), np.float32) * o ** -0.5,
            rng.standard_normal((1,), np.float32) * 0.1]
    g = rng.standard_normal((n, 29, 29, 1), np.float32)
    for sigmoid, max_depth in ((False, 1.0), (True, 1.0)):
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(lambda *a: jisland.fused_resize_island(
                *a, (29, 29), sigmoid, max_depth), *map(jnp.asarray, args))
            want = vjp(jnp.asarray(g))
        targs = [_leaf(torch.from_numpy(a)) for a in args]
        tisland.fused_resize_island(*targs, (29, 29), sigmoid,
                                    max_depth).backward(torch.from_numpy(g))
        for a, b in zip(targs, want):
            _close_scaled(a.grad, b, rtol=2e-4)


# ------------------------------------------------- Function vs plain autograd
def _function_cases(rng):
    """(name, wrapper, plain forward, inputs) for every kernel with a
    backward, fp32."""
    f32 = lambda *s, sc=1.0, off=0.0: torch.from_numpy(
        rng.standard_normal(s, np.float32) * sc + off)
    qkv = f32(2, 70, 3, 2, 64)
    yield ("A1", tfa.flash_attention_fused_qkv,
           tfa.flash_attention_fused_qkv_plain, [qkv])
    c, f = 32, 128
    mlp = [f32(3, 40, c), f32(c, sc=0.1, off=1.0), f32(c, sc=0.1),
           f32(f, c, sc=c ** -0.5), f32(f, sc=0.1), f32(c, f, sc=f ** -0.5),
           f32(c, sc=0.1), f32(c, sc=0.5)]
    yield ("A2", tmlp.fused_ln_mlp_residual, tmlp.fused_ln_mlp_residual_plain,
           mlp)
    ta = [f32(6, 8, c), f32(8, c)] + [f32(c, c, sc=c ** -0.5)
                                       for _ in range(4)] + [f32(c, sc=0.1)]
    yield ("A3", lambda *a: tta.temporal_attention_block(*a, 4, 0.25),
           lambda *a: tta.temporal_attention_block_plain(*a, 4, 0.25), ta)
    ge = [f32(30, c), f32(c, sc=0.1, off=1.0), f32(c, sc=0.1),
          f32(2 * f, c, sc=c ** -0.5), f32(2 * f, sc=0.1),
          f32(c, f, sc=f ** -0.5), f32(c, sc=0.1)]
    yield ("A4", tgeglu.fused_ln_geglu_residual,
           tgeglu.fused_ln_geglu_residual_plain, ge)
    idx, w = plan_axis(23, 9, "bilinear", True, None)
    pidx, pw = tresize.rows_plan(idx, w, "cpu")
    yield ("A5a", lambda x: tresize.resize_rows(x, idx, w, 23),
           lambda x: tresize.resize_rows_plain(x, pidx, pw), [f32(2, 9, 5, 8)])
    dense = tresize.dense_plan(idx, w, 9, torch.float32, "cpu")
    yield ("A5b", lambda x: tresize.resize_mid_axis(x, idx, w, 23),
           lambda x: tresize.mix_rows_plain(x, dense), [f32(4, 9, 16)])
    isl = [f32(1, 8, 8, 16), f32(3, 3, 16, 32, sc=1 / 12), f32(32, sc=0.1),
           f32(32, 1, sc=32 ** -0.5), f32(1, sc=0.1)]
    yield ("A6", lambda *a: tisland.fused_resize_island(*a, (14, 14)),
           lambda *a: tisland.fused_resize_island_plain(*a, (14, 14)), isl)


@pytest.mark.parametrize("which", ["A1", "A2", "A3", "A4", "A5a", "A5b",
                                   "A6"])
def test_function_backward_equals_plain_autograd(which):
    """The autograd Function of each kernel with a backward gives the
    gradients of autograd through its plain forward (fp32, every input)."""
    rng = np.random.default_rng(13)
    name, wrapper, plain, inputs = next(
        c for c in _function_cases(rng) if c[0] == which)
    a = [_leaf(t) for t in inputs]
    b = [_leaf(t) for t in inputs]
    out = wrapper(*a)
    ref = plain(*b)
    _close_scaled(out, ref.detach(), rtol=1e-5)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape), np.float32))
    out.backward(g)
    ref.backward(g)
    for x, y in zip(a, b):
        _close_scaled(x.grad, y.grad.numpy(), rtol=1e-5)


def test_kernel_inference_calls_record_no_graph():
    """Under no_grad (or with no input requiring grad) the wrappers return
    plain tensors, as before: the serving paths pay for no graph."""
    rng = np.random.default_rng(14)
    qkv = _leaf(torch.from_numpy(rng.standard_normal((1, 20, 3, 2, 64),
                                                     np.float32)))
    with torch.no_grad():
        assert tfa.flash_attention_fused_qkv(qkv).grad_fn is None
    assert tfa.flash_attention_fused_qkv(qkv.detach()).grad_fn is None
    assert tfa.flash_attention_fused_qkv(qkv).grad_fn is not None


@pytest.mark.parametrize("which", ["A1", "A2", "A3", "A5a", "A5b", "A6"])
def test_backward_dispatches_as_its_forward(which, monkeypatch):
    """A graph recorded inside plain_reference() is differentiated through
    the plain versions even where autograd runs the backward on a thread
    of its own (as it does for CUDA tensors), where the context variable
    is unset: every dispatch of the backward sees the forward's flag.  (A4's
    backward recomputes its plain version and dispatches nothing.)"""
    import threading
    from vdn_torch import kernels
    seen = []

    def spy(x):
        seen.append(kernels._PLAIN.get())
        return False

    for mod in (tfa, tgeglu, tmlp, tresize, tisland, tta):
        monkeypatch.setattr(mod, "use_kernel", spy)
    rng = np.random.default_rng(15)
    _, wrapper, _, inputs = next(
        c for c in _function_cases(rng) if c[0] == which)
    a = [_leaf(t) for t in inputs]
    with kernels.plain_reference():
        out = wrapper(*a)
    n_forward = len(seen)
    worker = threading.Thread(target=lambda: out.sum().backward())
    worker.start()
    worker.join()
    assert all(x.grad is not None for x in a)
    assert len(seen) > n_forward and all(seen), seen
