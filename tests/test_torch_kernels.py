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

The CUDA kernels themselves run only on a GPU: chip_smoke.py holds them
against these plain versions on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

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


def _pair(a: np.ndarray, dtype: str):
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
